"""Differentiable-path benchmark: seconds per production train step.

Times mesh.make_train_step (default 256^2 pixels / 2048-step scan,
remat 128), reporting steady-state s/step.

Usage:
    python scripts/fit_bench.py [--cpu] [--size 256] [--max-steps 2048]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--max-steps", type=int, default=2048)
    ap.add_argument("--remat-every", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--grad-step-cap", type=int, default=512)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

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
                           remat_every=args.remat_every),
    )
    features = Features.for_metric(metric)
    step = make_train_step(metric, mesh, settings, features,
                           grad_step_cap=args.grad_step_cap)
    target = _render_target(metric, camera, metric.params(rs=1.1),
                            backgrounds, settings, features,
                            grad_step_cap=args.grad_step_cap)

    params = metric.params(rs=0.95)
    # Compile + settle.
    params, loss = step(params, camera, target, backgrounds,
                        jnp.float32(0.02))
    print(f"first step: loss {float(loss):.6f} "
          f"rs {float(params['rs']):.5f}", flush=True)

    ts = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, loss = step(params, camera, target, backgrounds,
                            jnp.float32(0.02))
        lf = float(loss)  # sync (scalar fetch forces the step)
        ts.append(time.perf_counter() - t0)
        print(f"step {i}: {ts[-1]:.3f} s  loss {lf:.6f} "
              f"rs {float(params['rs']):.5f}", flush=True)
        assert np.isfinite(lf)
    print(f"median {float(np.median(ts)):.3f} s/step at "
          f"{args.size}^2/{args.max_steps} (remat {args.remat_every}, "
          f"cap {args.grad_step_cap})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
