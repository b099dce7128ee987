"""Multi-device scaling: rays/s at mesh sizes 1, 2, 4, 8 for BOTH the
simple sharded trace and the PRODUCTION adaptive pipeline
(sharded_adaptive_frame: replicated prepass + band-local quarter trace,
budgeted refinement and traced-only shading over quarter-row bands).

North-star metric: >= 85% rays/s scaling efficiency at N >= 2 (BASELINE.json).
Runs on whatever devices exist — on this rig that is the virtual CPU mesh
(the same shard_map code carries to pod slices unchanged), so numbers
validate collective structure and per-band overhead, not real speedup.

Usage:
    python scripts/scaling_bench.py [--size 192] [--cpu-devices 8]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--cpu-devices", type=int, default=8)
    ap.add_argument("--max-steps", type=int, default=2048)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax

    # Default to the virtual CPU mesh (this rig has one real chip); pass
    # --cpu-devices 0 to use whatever real devices exist.
    if args.cpu_devices > 0:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_devices)

    import numpy as np

    from geodesic_raytracing import metrics
    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.ops.integrate import Features, TraceOptions
    from geodesic_raytracing.parallel.mesh import ray_mesh, sharded_trace
    from geodesic_raytracing.render.pipeline import (
        RenderSettings,
        init_camera_rays,
    )

    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    settings = RenderSettings(
        width=args.size, height=args.size,
        trace=TraceOptions(max_steps=args.max_steps),
    )
    feats = Features.for_metric(m)
    state, _, _ = init_camera_rays(m, camera, params, settings, feats)
    n_rays = state.position.shape[0]

    all_devices = jax.devices()
    sizes = [n for n in (1, 2, 4, 8) if n <= len(all_devices)]
    results = {}
    base = None
    for nd in sizes:
        mesh = ray_mesh(all_devices[:nd])

        def run():
            fin = sharded_trace(m, mesh, state, params, feats, settings.trace)
            jax.block_until_ready(fin.status)
            return fin

        run()  # compile
        best = min(
            _timeit(run) for _ in range(args.repeats)
        )
        rate = n_rays / best / 1e6
        if base is None:
            base = rate
        eff = rate / (base * nd)
        results[nd] = {"mrays_s": round(rate, 4),
                       "efficiency": round(eff, 4)}
        print(f"devices={nd}: {rate:.3f} Mrays/s  efficiency={eff:.2%}",
              flush=True)

    # ----- production adaptive pipeline over quarter-row bands ----------
    from geodesic_raytracing.parallel.mesh import sharded_adaptive_frame
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render import pipeline as pl

    backgrounds = bg.checker_background(64, 128)
    asettings = RenderSettings(
        width=args.size, height=args.size, anisotropy=2,
        adaptive_sampling=True, refine_budget=1.0, shade_traced_only=True,
        trace=TraceOptions(max_steps=args.max_steps, method="while"),
    )
    n_pix = args.size * args.size
    single = np.asarray(pl.render_frame(m, camera, params, backgrounds,
                                        asettings, feats))
    adaptive = {}
    abase = None
    for nd in sizes:
        if (args.size // 2) % nd:
            continue  # quarter rows must divide the mesh
        mesh = ray_mesh(all_devices[:nd])

        def arun():
            img = sharded_adaptive_frame(m, mesh, camera, params,
                                         backgrounds, asettings, feats)
            jax.block_until_ready(img)
            return img

        img = np.asarray(arun())  # compile + correctness
        d = np.abs(single - img).max(axis=-1)
        rows_per_band = args.size // nd
        interior = np.ones(args.size, bool)
        for band in range(nd):
            interior[band * rows_per_band:band * rows_per_band + 2] = False
            interior[(band + 1) * rows_per_band - 2:
                     (band + 1) * rows_per_band] = False
        bad = float((d[interior] > 0.05).mean())
        assert bad < 0.02, f"devices={nd}: sharded frame diverges ({bad})"
        best = min(_timeit(arun) for _ in range(args.repeats))
        rate = n_pix / best / 1e6
        if abase is None:
            abase = rate
        eff = rate / (abase * nd)
        adaptive[nd] = {"mrays_s": round(rate, 4),
                        "efficiency": round(eff, 4),
                        "interior_mismatch": round(bad, 5)}
        print(f"adaptive devices={nd}: {rate:.3f} Mrays/s  "
              f"efficiency={eff:.2%}  interior_mismatch={bad:.4f}",
              flush=True)

    virtual = all_devices[0].platform == "cpu" and args.cpu_devices > 0
    if virtual:
        print(
            "NOTE: virtual CPU devices multiplex one physical CPU — this run "
            "validates correctness and collective structure, not speedup. "
            "Real efficiency needs a real multi-chip slice; the workload "
            "is embarrassingly parallel over ray tiles (one parameter "
            "broadcast + one image gather per frame).",
            file=sys.stderr,
        )
    print(json.dumps({"scaling": results, "adaptive_scaling": adaptive,
                      "n_rays": n_rays,
                      "platform": all_devices[0].platform,
                      "virtual_devices": virtual}))
    return 0


def _timeit(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    sys.exit(main())
