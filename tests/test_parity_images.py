"""Catalogue-wide golden-image parity (VERDICT round-1 item 5).

Every catalogue metric has a checked-in 128^2 golden rendered through the
production pipeline (scripts/make_goldens.py), plus two documented
reference scenes: redshift-on Kerr (SURVEY section 7 config 3) and the
Alcubierre paper figure (main.cpp:106).  RMSE + bad-pixel-fraction
tracking catches shading/integrator regressions per metric family.

The default run covers one representative per family (~1.5 min CPU); set
GOLDEN_ALL=1 to sweep the full catalogue (~7 min), which CI does for
release rounds and scripts/make_goldens.py regenerates after intended
visual changes.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "scripts"))
import make_goldens  # noqa: E402

from geodesic_raytracing.utils import png  # noqa: E402

FAST = make_goldens.FAST


def _all_scene_keys():
    import glob

    return sorted(
        os.path.basename(p)[:-4]
        for p in glob.glob("tests/golden/catalogue/*.png"))


KEYS = _all_scene_keys() if os.environ.get("GOLDEN_ALL") else [
    k for k in FAST if os.path.exists(f"tests/golden/catalogue/{k}.png")]


@pytest.mark.parametrize("key", KEYS)
def test_catalogue_golden(key):
    spec = make_goldens.scene_spec(key)
    assert spec is not None, f"golden {key} has no scene config"
    arr = make_goldens.render_scene(key, spec)
    golden = png.read(f"tests/golden/catalogue/{key}.png")
    # a vacuous (all-black) golden asserts nothing — never allow one in
    assert golden.max() > 0, f"golden {key} is all-black (vacuous)"
    rmse, bad = make_goldens.compare(golden, arr)
    assert rmse < make_goldens.RMSE_MAX, (key, rmse)
    assert bad < make_goldens.BAD_FRAC_MAX, (key, bad)


# Checked-in goldens that legitimately match a flat render: Minkowski
# itself and the skew chart of flat spacetime (straight rays either way).
# Everything else must carry curvature signal AGAINST THE CHECKED-IN FILES
# — the generation-time flat-guard in make_goldens only protects scenes
# that get regenerated (the round-2 alcubierre golden sat flat-like for
# two rounds because nothing re-rendered it; VERDICT r4 weak #1).
_FLAT_EXEMPT = {"minkowski", "minkowski_skew"}


def test_checked_in_goldens_differ_from_flat():
    """Every non-exempt golden PNG must fail the parity gate vs the
    checked-in minkowski.png: a metric regressing to flat space (or a
    scene preset losing its signal) must not be able to pass
    test_catalogue_golden silently.  Scenes with non-default cameras
    differ trivially — the load-bearing rows are the default-camera
    catalogue scenes, which share minkowski's exact viewpoint."""
    flat = png.read("tests/golden/catalogue/minkowski.png")
    weak = []
    for key in _all_scene_keys():
        if key in _FLAT_EXEMPT:
            continue
        g = png.read(f"tests/golden/catalogue/{key}.png")
        rmse, bad = make_goldens.compare(g, flat)
        if make_goldens.passes(rmse, bad):
            weak.append((key, rmse, bad))
    assert not weak, (
        f"goldens indistinguishable from flat space: {weak} — these carry "
        "no regression signal; give the scene a preset with curvature "
        "(scripts/make_goldens.py) or add it to _FLAT_EXEMPT with a "
        "documented signal carrier")
