"""RMSE quality harness for EWA shade variants (CPU, synthetic warp field).

Ground truth: 32-probe trilinear bilinear-probe EWA (far above any shipping
config).  Variants are scored by RMSE over the full field and over the
high-anisotropy prefix (where the variants actually differ), plus their
gather-row cost per pixel (the shade stage's currency: 1.0 per single-word
gather, 1.1 per (4,)-word quad row).

Usage: python scripts/shade_quality.py [--size WxH]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def gather_cost(segments, max_probes, probe_bilinear, trilinear, n=1.0):
    """Gather-row cost model per pixel (base tap + probe tiers)."""
    row = 1.1  # quad row vs single word
    base = row * (2.0 if trilinear else 1.0)
    segs = tuple(segments) or ((1 / 3, max_probes),)
    probes = sum(frac * iters for frac, iters in segs)
    per_probe = (row if probe_bilinear else 1.0) * (2.0 if trilinear else 1.0)
    return base + probes * per_probe


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="960x540")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from geodesic_raytracing.render import background as bg

    W, H = (int(v) for v in args.size.split("x"))
    backgrounds = bg.checker_background()

    # Synthetic lensing-like warp (same construction as shade_bench.py):
    # strong radial stretching near the centre "ring".
    yy, xx = np.meshgrid(np.linspace(0, 1, H, dtype=np.float32),
                         np.linspace(0, 1, W, dtype=np.float32), indexing="ij")
    r = np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2) + 1e-3
    warp = 1.0 + 0.2 / r
    tex = jnp.asarray(np.stack([np.mod(xx * warp, 1.0),
                                np.mod(yy * warp, 1.0)], axis=-1))
    side = jnp.ones((H, W), jnp.int32)

    def run(name, **kw):
        out = np.asarray(bg.sample_anisotropic(backgrounds, tex, side, **kw))
        return out

    gt = run("gt", max_probes=32, probe_segments=((1.0, 32),),
             trilinear=True, probe_bilinear=True)

    variants = {
        "prod-tiers(8/4/2 pt)": dict(
            max_probes=8, probe_segments=((0.072, 8), (0.11, 4), (0.17, 2)),
            trilinear=False, probe_bilinear=False),
        "flat8-point": dict(max_probes=8, probe_segments=(),
                            trilinear=False, probe_bilinear=False),
        "half-tiers(4/2/2 bilin)": dict(
            max_probes=4, probe_segments=((0.072, 4), (0.11, 2), (0.17, 2)),
            trilinear=False, probe_bilinear=True),
        "half-tiers(4/2/2 pt)": dict(
            max_probes=4, probe_segments=((0.072, 4), (0.11, 2), (0.17, 2)),
            trilinear=False, probe_bilinear=False),
        "base-only": dict(max_probes=1, probe_segments=(),
                          trilinear=False, probe_bilinear=False),
    }

    # High-anisotropy mask from the warp (where variants differ).
    gx = np.linalg.norm(np.diff(np.asarray(tex), axis=1), axis=-1)
    hot = np.zeros((H, W), bool)
    hot[:, :-1] = gx > np.quantile(gx, 0.93)

    print(f"{'variant':26s} {'rmse_all':>9s} {'rmse_hot':>9s} {'rows/px':>8s}")
    for name, kw in variants.items():
        out = run(name, **kw)
        rmse = float(np.sqrt(np.mean((out - gt) ** 2)))
        rmse_hot = float(np.sqrt(np.mean((out[hot] - gt[hot]) ** 2)))
        cost = gather_cost(kw["probe_segments"], kw["max_probes"],
                           kw["probe_bilinear"], kw["trilinear"])
        print(f"{name:26s} {rmse:9.5f} {rmse_hot:9.5f} {cost:8.2f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
