"""Differentiable-rendering parameter fitting — the capability the reference
does not have (BASELINE.json north star; SURVEY §7.7).

Renders a target image with "true" metric parameters, then recovers them by
gradient descent from a perturbed start, with gradients flowing through the
remat-scan geodesic integrator, sharded over the device mesh with a psum.

Usage:
    python -m geodesic_raytracing.fit --metric schwarzschild \
        --true rs=1.1 --start rs=0.9 --steps 30 --size 32
    python -m geodesic_raytracing.fit --metric alcubierre \
        --true velocity=2.1 --start velocity=1.9 --cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_kv(items):
    out = {}
    for kv in items or []:
        k, v = kv.split("=", 1)
        out[k] = float(v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metric", default="schwarzschild")
    ap.add_argument("--true", action="append", metavar="NAME=VALUE",
                    help="true parameter values for the target render")
    ap.add_argument("--start", action="append", metavar="NAME=VALUE",
                    help="initial parameter values for the fit")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--lr-decay", type=float, default=0.93,
                    help="per-step learning-rate decay")
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--max-steps", type=int, default=192)
    ap.add_argument("--remat-every", type=int, default=32)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint directory (resume if present)")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: all devices)")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from .utils import compile_cache

    compile_cache.enable()

    from . import metrics
    from .camera import Camera
    from .ops.integrate import Features, TraceOptions
    from .parallel.mesh import make_train_step, ray_mesh
    from .render import background as bg
    from .render.pipeline import RenderSettings
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    metric = metrics.get_metric(args.metric)
    true_params = metric.params(**parse_kv(args.true))
    params = metric.params(**parse_kv(args.start))

    devices = jax.devices()
    if args.devices:
        devices = devices[: args.devices]
    mesh = ray_mesh(devices)
    print(f"mesh: {mesh.devices.size} x {mesh.devices[0].platform}")

    settings = RenderSettings(
        width=args.size, height=args.size,
        trace=TraceOptions(max_steps=args.max_steps, method="scan",
                           remat_every=args.remat_every),
    )
    features = Features.for_metric(metric)
    step = make_train_step(metric, mesh, settings, features)

    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(256, 512)

    # Target via one lr=0 step's internal render path: use the loss at the
    # true params as reference and fit against the true-rendered image.
    from .parallel import mesh as _pm  # noqa: F401

    target = _render_target(metric, camera, true_params, backgrounds,
                            settings, features)

    start_step = 0
    if args.checkpoint:
        ck = load_checkpoint(args.checkpoint)
        if ck:
            start_step, saved, _, _ = ck
            params = {k: jnp.float32(v) for k, v in saved.items()}
            print(f"resumed from step {start_step}: "
                  f"{ {k: float(v) for k, v in params.items()} }")

    t0 = time.time()
    for i in range(start_step, args.steps):
        lr_i = args.lr * args.lr_decay ** i
        params, loss = step(params, camera, target, backgrounds,
                            jnp.float32(lr_i))
        vals = {k: round(float(v), 5) for k, v in params.items()}
        print(f"step {i:3d} loss {float(loss):.6f} params {vals}",
              flush=True)
        if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint, i + 1, params)

    print(f"fit done in {time.time() - t0:.1f}s")
    for k in true_params:
        print(f"  {k}: fitted {float(params[k]):+.5f} "
              f"true {float(true_params[k]):+.5f}")
    return 0


def _render_target(metric, camera, true_params, backgrounds, settings,
                   features, grad_step_cap: int = 512):
    """Render the fitting target with the same loss-path renderer (quarter
    the machinery: trace + nearest-mip shade) so the fit compares
    like-for-like."""
    import jax.numpy as jnp

    from .camera import observer_tetrad
    from .ops import integrate
    from .render import background as bgm
    from .render import pipeline as pl

    import dataclasses as _dc

    state, ku, _ = pl.init_camera_rays(
        metric, camera, true_params, _dc.replace(settings, planar=False),
        features,
    )
    fin = integrate.trace_rays(metric, state, true_params, features=features,
                               opts=settings.trace)
    # Same consumed-pixel rule as mesh.local_loss (grad_safe_final with the
    # train step's HARD cap), so the target and the fit render compare
    # like-for-like.
    hard_cap = min(2 * grad_step_cap, settings.trace.max_steps)
    fin, consumed = pl.grad_safe_final(metric, state, fin, true_params,
                                       features, step_cap=hard_cap)
    rdata = pl.compute_render_data(metric, fin, ku, true_params, features)
    rgb = bgm.read_mipmap(backgrounds, rdata.side, rdata.tex_coord,
                          jnp.full(rdata.side.shape, 3.0))
    rgb = jnp.where(consumed[..., None], rgb, 0.0)
    return rgb.reshape(settings.height, settings.width, 3)


if __name__ == "__main__":
    sys.exit(main())
