"""Command-line renderer — the framework's user surface.

Analogue of the reference application's headless paths: metric selection,
camera placement, screenshot output, and the ``-bench`` frametime protocol
(main.cpp:970-986, 2864-2871).

Usage:
    python -m geodesic_raytracing.cli --metric schwarzschild \
        --width 512 --height 512 --out out.png
    python -m geodesic_raytracing.cli --bench kerr_boyer --frames 5
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metric", default="schwarzschild")
    ap.add_argument("--bench", metavar="METRIC", default=None,
                    help="benchmark mode: print per-frame 'Frametime Elapsed: MS'")
    ap.add_argument("--list", action="store_true", help="list metrics and exit")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--fov", type=float, default=90.0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--background", default=None, help="equirect image path")
    ap.add_argument("--background2", default=None, help="far-side image path")
    ap.add_argument("--camera", type=float, nargs=4,
                    default=[0.0, 7.0, np.pi / 2, -np.pi / 2],
                    metavar=("T", "R", "THETA", "PHI"),
                    help="camera position in polar coordinates")
    ap.add_argument("--pitch", type=float, default=0.0,
                    help="camera pitch in degrees (-90 looks at the origin "
                         "from the default position)")
    ap.add_argument("--yaw", type=float, default=0.0)
    ap.add_argument("--roll", type=float, default=0.0)
    ap.add_argument("--speed", type=float, nargs=3, default=[0.0, 0.0, 0.0],
                    metavar=("VX", "VY", "VZ"),
                    help="observer 3-velocity in the tetrad frame (|v| < 1)")
    ap.add_argument("--redshift", action="store_true")
    ap.add_argument("--old-redshift", action="store_true",
                    help="reference use_old_redshift feature: no blueshift "
                         "energy redistribution")
    ap.add_argument("--dominant-colour", action="store_true",
                    help="per-pixel dominant-wavelength redshift variant")
    ap.add_argument("--spectral-redshift", action="store_true",
                    help="experimental: shift each pixel's CIE dominant "
                         "wavelength along the 1931 horseshoe")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive sampling: quarter-density trace + "
                         "error-driven refinement (reference default)")
    ap.add_argument("--geodesic-camera", type=float, metavar="TAU",
                    default=None,
                    help="attach the camera to a timelike geodesic launched "
                         "from the camera position with --speed, rendered at "
                         "proper time TAU (fly-through mode)")
    ap.add_argument("--max-steps", type=int, default=16384)
    ap.add_argument("--supersample", type=int, default=1, metavar="K",
                    help="render at K x resolution and box-downsample "
                         "(graphics_settings supersampling, "
                         "main.cpp:1760-1792)")
    ap.add_argument("--frames", type=int, default=10, help="bench frame count")
    ap.add_argument("--anisotropy", type=int, default=8)
    ap.add_argument("--param", action="append", default=[],
                    metavar="NAME=VALUE", help="metric parameter override")
    ap.add_argument("--content", action="append", default=[],
                    metavar="DIR", help="load a metric content pack directory "
                                        "(reference workshop/scripts folders)")
    ap.add_argument("--cube", type=float, nargs=4, action="append",
                    default=[], metavar=("T", "X", "Y", "Z"),
                    help="place a unit cube object at this spacetime point "
                         "(GR triangle rendering).  T must lie in the "
                         "camera's PAST (e.g. -30): camera rays integrate "
                         "backwards in time, and the object's worldline is "
                         "traced forward from T, so a cube at T=0 never "
                         "crosses any ray")
    ap.add_argument("--obj", action="append", default=[], metavar="SPEC",
                    help="place an .obj mesh: path,t,x,y,z[,scale]")
    ap.add_argument("--tri-intersector", default="dense",
                    choices=("dense", "binned", "grouped", "compact"),
                    help="triangle intersector: dense (exact, small "
                         "scenes), binned (reference-style chunk bins), "
                         "grouped (two-level object/patch), compact "
                         "(worklist-compacted — dense orbital scenes)")
    ap.add_argument("--dump-hlo", metavar="FILE", default=None,
                    help="write the lowered trace program (the reference's "
                         "argument_string.txt compile-line dump analogue)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a jax.profiler trace (TensorBoard-readable) "
                         "around the render")
    ap.add_argument("--trace-stats", action="store_true",
                    help="print ray statistics (status counts, step "
                         "percentiles) from a dedicated full-res trace")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--trace-method", default="while",
                    choices=("while", "scan"),
                    help="integrator driver: whole-batch while (the "
                         "production path) or the fixed-length remat scan")
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
    from .render import background as bg
    from .render import colour
    from .render.pipeline import RenderSettings, render_frame

    for pack_dir in args.content:
        from .content import load_pack

        pack = load_pack(pack_dir)
        loaded = ", ".join(sorted(pack.metrics)) or "none"
        print(f"loaded pack {pack_dir}: {loaded}")
        for stem, err in pack.broken.items():
            print(f"  (broken) {stem}: {err}")

    if args.list:
        for name in metrics.list_metrics():
            print(name)
        return 0

    name = args.bench or args.metric
    metric = metrics.get_metric(name)

    overrides = {}
    for kv in args.param:
        k, v = kv.split("=", 1)
        overrides[k] = float(v)
    params = metric.params(**overrides)

    cam = Camera.default()._replace(
        polar_position=jnp.asarray(args.camera, dtype=jnp.float32),
        basis_speed=jnp.asarray(args.speed, dtype=jnp.float32),
    )
    d2r = np.pi / 180.0
    if args.pitch or args.yaw or args.roll:
        cam = cam.rotate(
            yaw=args.yaw * d2r, pitch=args.pitch * d2r, roll=args.roll * d2r
        )

    if args.geodesic_camera is not None:
        # "Snapshot Camera Geodesic" (main.cpp:2675-2759): record an
        # infalling worldline from the camera state, transport the tetrad,
        # attach the camera at the requested proper time.
        from .ops import tetrad as tet
        from .physics import (
            interpolate_camera,
            parallel_transport_tetrads,
            record_geodesic,
        )
        from .render.pipeline import camera_to_generic

        feats0 = Features.for_metric(metric)
        x0 = camera_to_generic(metric, cam, params)
        gab = metric.fn(x0, params)
        es0, _ = tet.frame_basis(gab)
        es0 = tet.boost_tetrad(es0, cam.basis_speed, gab)
        path = record_geodesic(metric, x0, es0[0], params, feats0,
                               n_steps=4096)
        tets = parallel_transport_tetrads(metric, path, es0, params)
        pos, vel, frame = interpolate_camera(path, tets, args.geodesic_camera)
        cam = cam.on_geodesic(pos, frame)
        print(f"geodesic camera: tau={args.geodesic_camera:g} "
              f"pos={np.asarray(pos).round(3).tolist()}")

    if args.background:
        backgrounds = bg.load_background(args.background, args.background2)
    else:
        backgrounds = bg.checker_background()

    ss = max(1, args.supersample)
    trace = TraceOptions(max_steps=args.max_steps, method=args.trace_method)
    settings = RenderSettings(
        width=args.width * ss,
        height=args.height * ss,
        fov_degrees=args.fov,
        anisotropy=args.anisotropy,
        redshift=args.redshift,
        old_redshift=args.old_redshift,
        dominant_colour=args.dominant_colour,
        spectral_redshift=args.spectral_redshift,
        adaptive_sampling=args.adaptive,
        trace=trace,
    )
    features = Features.for_metric(metric)

    if args.dump_hlo:
        import dataclasses as _dch

        from .render.pipeline import _trace_frame_jit

        lowered = _trace_frame_jit.lower(
            metric, cam, params,
            _dch.replace(settings, adaptive_sampling=False), features,
        )
        with open(args.dump_hlo, "w") as f:
            f.write(lowered.as_text())
        print(f"wrote lowered trace program to {args.dump_hlo}")
        return 0

    if args.bench:
        # Warm-up compile, then the reference's frametime protocol
        # (main.cpp:2864-2871; the string must not change).
        from .render.pipeline import RefineBudgetController

        controller = RefineBudgetController()
        sync = jax.block_until_ready

        # Settle warmup: the budget controller's first bucket change
        # recompiles the refine chain — keep that out of the printed
        # frametimes (bench.py does the same).
        n_warm = 4 if settings.adaptive_sampling else 1
        for _ in range(n_warm):
            sync(render_frame(metric, cam, params, backgrounds, settings,
                              features, controller=controller))
        for _ in range(args.frames):
            t0 = time.perf_counter()
            sync(render_frame(metric, cam, params, backgrounds, settings,
                              features, controller=controller))
            ms = (time.perf_counter() - t0) * 1e3
            print(f"Frametime Elapsed: {ms:f}")
        return 0

    t0 = time.perf_counter()
    if args.profile:
        from .utils.profiling import xla_profile

        with xla_profile(args.profile):
            img = render_frame(metric, cam, params, backgrounds, settings,
                               features)
            img.block_until_ready()  # complete inside the trace
    else:
        img = render_frame(metric, cam, params, backgrounds, settings,
                           features)

    if args.trace_stats:
        from .render.pipeline import trace_frame
        from .utils.profiling import trace_stats

        fin, _ = trace_frame(metric, cam, params, settings, features)
        print(trace_stats(fin))

    if args.cube or args.obj:
        # GR triangle rendering: precompute each object's worldline, trace
        # rays with path recording, composite hits over the background image.
        from .render.pipeline import init_camera_rays
        from .triangles import (
            TriangleScene,
            make_cube,
            object_from_obj,
            precompute_object,
            render_triangles,
        )

        objects = [make_cube(c) for c in args.cube]
        for spec in args.obj:
            parts = spec.split(",")
            path_, rest = parts[0], [float(v) for v in parts[1:]]
            scale = rest[4] if len(rest) > 4 else 1.0
            objects.append(object_from_obj(path_, rest[:4], scale=scale))
        geos = [
            precompute_object(metric, o, params, features, n_steps=1024,
                              segments=48)
            for o in objects
        ]
        scene = TriangleScene.build(objects)
        import dataclasses as _dc

        tsettings = settings
        if settings.adaptive_sampling:
            tsettings = _dc.replace(settings, adaptive_sampling=False)
        state, _, _ = init_camera_rays(
            metric, cam, params, _dc.replace(tsettings, planar=False),
            features,
        )
        _, hit, tri_col = render_triangles(
            metric, state, params, scene, geos, features=features,
            opts=TraceOptions(max_steps=min(args.max_steps, 4096),
                              method="while"),
            # short segments: the in-segment interpolation misses
            # near-field objects when one slot spans the whole approach
            n_slots=64, steps_per_slot=8,
            binned=args.tri_intersector == "binned",
            grouped=args.tri_intersector == "grouped",
            compact=args.tri_intersector == "compact",
        )
        import jax.numpy as _jnp

        hit = hit.reshape(settings.height, settings.width)
        tri_col = tri_col.reshape(settings.height, settings.width, 3)
        img = _jnp.where(hit[..., None], tri_col, img)

    if ss > 1:  # box-downsample the supersampled frame
        img = img.reshape(args.height, ss, args.width, ss, 3).mean((1, 3))
    img.block_until_ready()
    dt = time.perf_counter() - t0

    srgb = np.asarray(colour.lin_to_srgb(img))
    arr = (np.clip(srgb, 0, 1) * 255).astype(np.uint8)
    _write_png(args.out, arr)
    print(f"wrote {args.out} ({args.width}x{args.height}, {name}) in {dt:.2f}s")
    return 0


def _write_png(path: str, arr: np.ndarray) -> None:
    from .utils import png

    png.write(path, arr)


if __name__ == "__main__":
    sys.exit(main())
