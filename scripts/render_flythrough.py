"""Render a fly-through frame sequence: camera riding a timelike geodesic.

The animation analogue of the reference's "Snapshot Camera Geodesic" +
play controls (main.cpp:1935-1966): record the worldline once, transport the
tetrads, then render frames at evenly spaced proper times, writing PNGs
through the native async writer.

    python scripts/render_flythrough.py --metric ellis_drainhole \
        --speed -0.6 0 0 --tau-max 10 --frames 24 --out-dir /tmp/fly --cpu
Assemble with e.g. ffmpeg -i /tmp/fly/frame_%03d.png out.mp4.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metric", default="ellis_drainhole")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--camera", type=float, nargs=4,
                    default=[0.0, 7.0, np.pi / 2, -np.pi / 2])
    ap.add_argument("--speed", type=float, nargs=3, default=[-0.5, 0.0, 0.0])
    ap.add_argument("--tau-max", type=float, default=8.0)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--max-steps", type=int, default=4096)
    ap.add_argument("--out-dir", default="flythrough")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from geodesic_raytracing import metrics, runtime
    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.ops import tetrad as tet
    from geodesic_raytracing.ops.integrate import Features, TraceOptions
    from geodesic_raytracing.physics import (
        interpolate_camera,
        parallel_transport_tetrads,
        record_geodesic,
    )
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render import colour
    from geodesic_raytracing.render.pipeline import (
        RenderSettings,
        camera_to_generic,
        render_frame,
    )

    metric = metrics.get_metric(args.metric)
    params = metric.params()
    feats = Features.for_metric(metric)
    base = Camera.default()._replace(
        polar_position=jnp.asarray(args.camera, dtype=jnp.float32),
        basis_speed=jnp.asarray(args.speed, dtype=jnp.float32),
    ).rotate(pitch=-np.pi / 2)

    # Record the camera worldline once (main.cpp:2675-2759).
    x0 = camera_to_generic(metric, base, params)
    gab = metric.fn(x0, params)
    es0, _ = tet.frame_basis(gab)
    es0 = tet.boost_tetrad(es0, base.basis_speed, gab)
    path = record_geodesic(metric, x0, es0[0], params, feats, n_steps=8192)
    tets = parallel_transport_tetrads(metric, path, es0, params)
    max_tau = float(path.proper_time[int(path.count) - 1])
    tau_max = min(args.tau_max, max_tau)
    print(f"worldline: {int(path.count)} nodes, proper time <= {max_tau:.2f}")

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    settings = RenderSettings(
        width=args.width, height=args.height, anisotropy=4,
        trace=TraceOptions(max_steps=args.max_steps),
    )
    backgrounds = bg.checker_background(512, 1024)

    writer = runtime.AsyncFrameWriter(threads=2)
    t0 = time.time()
    for i in range(args.frames):
        tau = tau_max * i / max(args.frames - 1, 1)
        pos, vel, frame = interpolate_camera(path, tets, tau)
        cam = base.on_geodesic(pos, frame)
        img = render_frame(metric, cam, params, backgrounds, settings, feats)
        srgb = np.asarray(colour.lin_to_srgb(img))
        rgb8 = (np.clip(srgb, 0, 1) * 255).astype(np.uint8)
        writer.submit(str(out_dir / f"frame_{i:03}.png"), rgb8)
        print(f"frame {i:3d} tau={tau:6.2f} "
              f"r={float(pos[1]):7.3f}", flush=True)
    writer.close()
    print(f"{args.frames} frames in {time.time() - t0:.1f}s -> {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
