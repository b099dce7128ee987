"""Catalogue-wide 1080p throughput: the production pipeline across
representative metric families (the reference's claim is "the vast
majority of metrics" at 1080p/30fps on an RX 6700 XT, README.md:3-5).

Each metric runs the same pipelined-frames protocol as bench.py (settle
frames, then median of pipelined frames).  Spherically symmetric metrics
exercise the planar fast path; Kerr BL is the flagship; Alcubierre has no
prepass; the wormholes exercise two-sided shading.

Usage: python scripts/catalogue_bench.py [--metrics a,b,c] [--frames N]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

DEFAULT_METRICS = (
    "kerr_boyer",
    "schwarzschild",
    "schwarzschild_ingoing_ef",
    "ellis_drainhole",
    "alcubierre",
    "wormhole (morris-thorne)",
    "kerr_schild",
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--settle", type=int, default=5)
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--metrics", default=",".join(DEFAULT_METRICS))
    ap.add_argument("--all", action="store_true",
                    help="sweep the FULL catalogue (31 metrics)")
    ap.add_argument("--legacy-shade", action="store_true",
                    help="use the pre-round-2 full-res shade path "
                         "(render_data_adaptive + shade) instead of the "
                         "production traced-only render_frame — for "
                         "comparability with older recorded tables")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from geodesic_raytracing import metrics as cat
    from geodesic_raytracing.bench_config import flagship_config
    from geodesic_raytracing.ops.integrate import Features
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render import pipeline as pl

    W, H = (int(v) for v in args.size.split("x"))
    _, _, camera, base_settings, _ = flagship_config(W, H)
    backgrounds = bg.checker_background()

    names = (list(cat.list_metrics()) if args.all
             else args.metrics.split(","))
    results = {}
    for name in names:
        metric = cat.get_metric(name)
        params = metric.params()
        features = Features.for_metric(metric)
        settings = base_settings
        controller = pl.RefineBudgetController()

        def frame():
            # The PRODUCTION frame (same call as bench.py): adaptive
            # pipeline + demand-sized refinement + traced-only shading.
            if args.legacy_shade:
                rdata = pl.render_data_adaptive(metric, camera, params,
                                                settings, features,
                                                controller=controller)
                img = pl._shade_jit(rdata, backgrounds, settings)
            else:
                img = pl.render_frame(metric, camera, params, backgrounds,
                                      settings, features,
                                      controller=controller)
            return jnp.sum(img[::256, ::256])

        try:
            t0 = time.perf_counter()
            for _ in range(args.settle):
                float(frame())
            compile_s = time.perf_counter() - t0
            n = args.frames
            t0 = time.perf_counter()
            sums = [frame() for _ in range(n)]
            vals = [float(s) for s in sums]
            dt = (time.perf_counter() - t0) / n
            ok = all(np.isfinite(v) for v in vals)
            results[name] = (dt, ok)
            print(f"{name:28s} {dt * 1e3:8.1f} ms/frame "
                  f"({W * H / dt / 1e6:6.2f} Mrays/s)"
                  f"{'' if ok else '  NON-FINITE'}"
                  f"   [compile+settle {compile_s:.0f}s]", flush=True)
        except Exception as e:  # noqa: BLE001 — keep benching the rest
            print(f"{name:28s} FAILED: {type(e).__name__}: {e}", flush=True)
            results[name] = (None, False)

    good = [v for v, ok in results.values() if v and ok]
    if good:
        print(f"\n{len(good)}/{len(results)} metrics OK; median "
              f"{W * H / np.median(good) / 1e6:.2f} Mrays/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
