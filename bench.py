"""Benchmark: 1080p Kerr (Boyer-Lindquist) adaptive frames on one device.

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "Mrays/s", "vs_baseline": N,
     "device": {"platform": ..., "kind": ..., "count": ...}}

Baseline: the reference renders 1080p at >= 30 fps on an RX 6700 XT
(README.md:5) = 62.2 Mrays/s at 1 ray/pixel.

Usage: python bench.py [timed_frames]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_MRAYS = 1920 * 1080 * 30 / 1e6  # 62.2
SETTLE_FRAMES = 4


def main() -> int:
    from geodesic_raytracing.utils import compile_cache

    compile_cache.enable()
    import jax

    from geodesic_raytracing.bench_config import flagship_config
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render.pipeline import (
        RefineBudgetController,
        render_frame,
    )

    W, H = 1920, 1080
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 5

    metric, params, camera, settings, features = flagship_config(W, H)
    backgrounds = bg.checker_background()
    # Demand-sized refinement (the reference dispatches exactly its atomic
    # refinement count; the controller re-specialises k across frames).
    controller = RefineBudgetController()

    def frame():
        return jax.block_until_ready(render_frame(
            metric, camera, params, backgrounds, settings, features,
            controller=controller))

    arr = np.asarray(frame())  # compile + first run + sanity fetch
    assert np.isfinite(arr).all(), "non-finite pixels in bench frame"

    # Settle until the budget controller has picked its bucket (a bucket
    # change recompiles the refine chain; that compile must not land in
    # the timed frames).
    for _ in range(SETTLE_FRAMES):
        frame()
    times = []
    for _ in range(max(frames, 1)):
        t0 = time.perf_counter()
        frame()
        times.append(time.perf_counter() - t0)
    mrays = W * H / float(np.median(times)) / 1e6
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "kerr_1080p_rays_per_s",
        "value": round(mrays, 4),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
