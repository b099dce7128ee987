"""Pipelined ablation timings: true marginal device cost of frame stages.

Sync-isolated single-stage timings include each stage's dispatch and sync
overhead, which makes small stages hard to read and sums inconsistent
with the pipelined frame.  This measures the steady-state pipelined frame
rate of ABLATED pipelines instead — the difference between two variants is
the true device cost of the removed work:

  full       the production frame (render_data_adaptive + shade)
  noshade    render data only (shade removed)
  noprobes   shade with anisotropy=1 (EWA probe path removed; base tap kept)

Usage: python scripts/ablate_bench.py [--frames N] [--variants a,b,c]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--variants", default="full,noshade,noprobes")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from geodesic_raytracing.bench_config import flagship_config
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render import pipeline as pl

    W, H = 1920, 1080
    metric, params, camera, settings, features = flagship_config(W, H)
    backgrounds = bg.checker_background()

    def make_frame(variant: str):
        vsettings = settings
        if variant == "noprobes":
            vsettings = dataclasses.replace(settings, anisotropy=1,
                                            probe_segments=())
        controller = pl.RefineBudgetController()

        def frame():
            rdata = pl.render_data_adaptive(metric, camera, params, vsettings,
                                            features, controller=controller)
            if variant == "noshade":
                return jnp.sum(rdata.tex_coord[::256])
            img = pl._shade_jit(rdata, backgrounds, vsettings)
            return jnp.sum(img[::256, ::256])

        return frame

    results = {}
    for variant in args.variants.split(","):
        frame = make_frame(variant)
        for _ in range(5):  # compile + settle controller/feedback
            float(frame())
        n = args.frames
        t0 = time.perf_counter()
        sums = [frame() for _ in range(n)]
        for s in sums:
            float(s)
        dt = (time.perf_counter() - t0) / n
        results[variant] = dt
        print(f"{variant:10s} {dt * 1e3:8.1f} ms/frame "
              f"({W * H / dt / 1e6:6.2f} Mrays/s)", flush=True)

    if "full" in results and "noshade" in results:
        print(f"shade marginal   {(results['full'] - results['noshade']) * 1e3:7.1f} ms")
    if "full" in results and "noprobes" in results:
        print(f"probes marginal  {(results['full'] - results['noprobes']) * 1e3:7.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
