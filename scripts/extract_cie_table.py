"""Regenerate geodesic_raytracing/render/cie1931_data.py.

Parses the public CIE 1931 2-degree chromaticity dataset (CVRL,
http://cvrl.ioo.ucl.ac.uk/) out of the reference's embedded copy
(/root/reference/chromaticity.hpp:17-493) and emits it as a Python tuple
of (x, y) rows at 1 nm from 360 to 830 nm.  Data only — the lookup code
in render/colour.py is an independent implementation.
"""

from __future__ import annotations

import re
import sys

SRC = "/root/reference/chromaticity.hpp"
DST = "geodesic_raytracing/render/cie1931_data.py"


def main() -> int:
    src = open(SRC).read()
    start = src.index("raw_horseshoe")
    body = src[start:src.index("};", start)]
    vals = [float(n) for n in re.findall(r"-?\d+\.?\d*", body)]
    assert len(vals) % 4 == 0
    rows = [vals[i:i + 4] for i in range(0, len(vals), 4)]
    assert [r[0] for r in rows] == [float(w) for w in range(360, 831)]
    for r in rows:
        assert abs(r[1] + r[2] + r[3] - 1.0) < 2e-6, r

    out = [
        '"""CIE 1931 2-degree chromaticity horseshoe, 360-830 nm at 1 nm.',
        "",
        "Data: CVRL (http://cvrl.ioo.ucl.ac.uk/) CIE 1931 2-deg observer,",
        "the same public dataset the reference embeds",
        "(chromaticity.hpp:17-493).  Each row is (x, y) chromaticity;",
        "z = 1 - x - y.  Generated by scripts/extract_cie_table.py;",
        "do not edit by hand.",
        '"""',
        "",
        "WL_START = 360.0",
        "WL_END = 830.0",
        "",
        "XY_1NM = (",
    ]
    out += [f"    ({r[1]:.6f}, {r[2]:.6f})," for r in rows]
    out.append(")")
    open(DST, "w").write("\n".join(out) + "\n")
    print(f"wrote {DST}: {len(rows)} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
