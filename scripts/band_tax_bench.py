"""Band-sharding tax on a single device (VERDICT r3 item 2).

The multi-chip design (parallel/mesh.sharded_adaptive_frame) cuts the
image into horizontal quarter-row bands, one per device, with band-local
stage programs — the per-frame collective cost is one camera/params
broadcast in and one image gather out.  On one device the *banding tax*
can be measured: run the SAME band-local programs sequentially on it
(parallel/mesh.banded_adaptive_frame, bit-identical to the sharded path
by shared stage code — tests/test_parallel.py) and compare against the
unbanded pipeline.

If banding inflates total device work by a factor (1+X) and the slowest
band carries a fraction f of that work, an N-chip slice with this static
row partition runs at efficiency ~ 1 / ((1+X) * N * f) — the report
prints both terms (work inflation from the pipelined frame times;
imbalance from per-band sync times).

Height defaults to 1088 (quarter rows 544 = 2^5*17) so bands 1/2/4/8 all
divide evenly; 1080's 540 quarter rows reject 8 bands.

Usage:
    python scripts/band_tax_bench.py [--cpu] [--frames N] [--bands 1,2,4,8]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--bands", default="1,2,4,8")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--balance", type=int, default=0, metavar="CPB",
                    help="dynamic cost-balanced bands with CPB chunks per "
                         "band (0 = static contiguous bands)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from geodesic_raytracing.bench_config import flagship_config
    from geodesic_raytracing.parallel.mesh import banded_adaptive_frame
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render.pipeline import render_frame

    W, H = args.width, args.height
    band_list = [int(b) for b in args.bands.split(",")]
    metric, params, camera, settings, features = flagship_config(W, H)
    backgrounds = bg.checker_background()
    n_rays = W * H

    sync = jax.block_until_ready

    def timed(frame_fn, label):
        """bench.py's pipelined protocol: warm, issue all frames, drain."""
        img = frame_fn()
        assert np.isfinite(np.asarray(img[:2, :2])).all(), label
        for _ in range(2):
            sync(frame_fn())
        t0 = time.perf_counter()
        imgs = [frame_fn() for _ in range(args.frames)]
        sync(imgs)
        dt = (time.perf_counter() - t0) / args.frames
        print(f"{label:>28}: {dt * 1e3:8.1f} ms/frame   "
              f"{n_rays / dt / 1e6:6.2f} Mrays/s", flush=True)
        return dt

    # Unbanded production pipeline (static refine budget — the banded path
    # has no RefineBudgetController, so compare like with like).
    t_unbanded = timed(
        lambda: render_frame(metric, camera, params, backgrounds, settings,
                             features),
        "unbanded render_frame")

    bal = args.balance or None
    tag = f" bal{bal}" if bal else ""
    results = {}
    for nb in band_list:
        t = timed(
            lambda nb=nb: banded_adaptive_frame(
                metric, camera, params, backgrounds, settings, nb, features,
                balance=bal),
            f"banded x{nb}{tag}")
        results[nb] = t

    # Per-band times (sync per band: each sync drains the pipeline, so
    # read SHAPE, not absolute level, from these).
    for nb in band_list:
        if nb == 1:
            continue
        stamps = []

        def band_sync(b, img, stamps=stamps):
            sync(img)
            stamps.append(time.perf_counter())

        per_band = []
        for _ in range(3):
            stamps.clear()
            t0 = time.perf_counter()
            banded_adaptive_frame(metric, camera, params, backgrounds,
                                  settings, nb, features,
                                  band_sync=band_sync, balance=bal)
            per_band.append(np.diff([t0] + stamps))
        pb = np.median(np.stack(per_band), axis=0)
        share = pb / pb.sum()
        print(f"  x{nb} per-band ms (sync-isolated): "
              + " ".join(f"{v * 1e3:.0f}" for v in pb)
              + f"   max share {share.max():.3f} (balanced={1 / nb:.3f})",
              flush=True)

    base = results.get(1, t_unbanded)
    print("\nwork inflation (pipelined, vs 1 band):")
    for nb in band_list:
        print(f"  x{nb}: {results[nb] / base:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
