"""Bisect the 256^2 fit-gradient NaN: sweep soft_decay_bits and
grad_step_cap at the failing configuration and report gradient
finiteness + magnitude (the shadow-edge signal must survive the fix).

The NaN-free recipe (probe pre-kill + ds=0 freeze + launch-state
substitution + soft Lyapunov window) was calibrated at 128^2/1024 with
decay 1.0 bit/step against ~1 bit/step measured worst-lane backward
growth — zero margin.  At 256^2 the kept ray closest to the critical
impact parameter dwells longer on the photon sphere and the backward
sweep overflows fp32 (loss finite, grads NaN on step 1).

Usage: python scripts/fit_nan_probe.py [--cpu] [--size 256]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--max-steps", type=int, default=2048)
    ap.add_argument("--configs",
                    default="512:1.0,512:1.5,512:2.0,384:1.0,256:1.0",
                    help="cap:decay[:hard_cap] triples")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from geodesic_raytracing import metrics
    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.fit import _render_target
    from geodesic_raytracing.ops.integrate import Features, TraceOptions
    from geodesic_raytracing.parallel.mesh import make_train_step, ray_mesh
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render.pipeline import RenderSettings

    metric = metrics.get_metric("kerr_boyer")
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(256, 512)
    mesh = ray_mesh(jax.devices()[:1])
    settings = RenderSettings(
        width=args.size, height=args.size,
        trace=TraceOptions(max_steps=args.max_steps, method="scan",
                           remat_every=128),
    )
    features = Features.for_metric(metric)

    for cfg in args.configs.split(","):
        parts = cfg.split(":")
        cap, decay = int(parts[0]), float(parts[1])
        hard = int(parts[2]) if len(parts) > 2 else None
        step = make_train_step(metric, mesh, settings, features,
                               grad_step_cap=cap, grad_hard_cap=hard,
                               soft_decay_bits=decay)
        target = _render_target(metric, camera, metric.params(rs=1.1),
                                backgrounds, settings, features,
                                grad_step_cap=cap)
        t0 = time.perf_counter()
        loss, g = step.loss_and_grad(
            metric.params(rs=0.95, a=-0.55), camera, target, backgrounds)
        gr, ga = float(g["rs"]), float(g["a"])
        print(f"hard {hard}: " if hard else "", end="")
        print(f"cap {cap:4d} decay {decay:.1f}: loss {float(loss):.6f} "
              f"g_rs {gr:+.3e} g_a {ga:+.3e} "
              f"finite={np.isfinite(gr) and np.isfinite(ga)} "
              f"[{time.perf_counter()-t0:.0f}s]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
