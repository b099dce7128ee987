"""Triangle benchmark: a production-shaped scene through the binned
intersector (VERDICT round-1 item 6).

Scene: 12 subtriangulated cubes orbiting a Schwarzschild hole — ~100k
triangles, ~800k swept-AABB entries at 8 geodesic segments/object (the
regime the reference dimensionates render_state.hpp:64-91 for).  Rays:
960x540 (1080p-class; quarter counts keep one sweep under the 10 min
tool cap), traced with path recording (16 slots), then intersected in
host-chained jitted ray slabs of 32k (the (slab, M) overlap matrix is the
memory governor: 128 blocks x 800k entries x 4 B = 400 MB live).

Prints per-budget: Mrays/s for the intersect phase, dropped-candidate
total and worst-chunk overlap (with_stats=True) — budget overflow must be
measured, not silent.

Usage: python scripts/triangle_bench.py [--cpu] [--tris N] [--budgets 64,128]
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
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--tris", type=int, default=100_000)
    ap.add_argument("--budgets", default="64,128")
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--slab-blocks", type=int, default=128)
    ap.add_argument("--grouped", action="store_true",
                    help="two-level object/patch intersector (VERDICT r3 "
                    "item 4): --budgets sweeps the OBJECT-segment budget")
    ap.add_argument("--compact", action="store_true",
                    help="worklist-compacted two-level intersector "
                    "(round 5): sphere-prefiltered pair/patch worklists")
    ap.add_argument("--pair-budget", type=int, default=1 << 17)
    ap.add_argument("--tri-budget", type=int, default=1 << 18)
    ap.add_argument("--patch-size", type=int, default=32)
    ap.add_argument("--patch-slots", type=int, default=8,
                    help="compact phase C: per-pair patch slot budget "
                    "(0 = legacy flat (Wp x P) nonzero)")
    ap.add_argument("--patch-budget", type=int, default=8)
    ap.add_argument("--chunk-budget", type=int, default=None)
    ap.add_argument("--stage", default="3",
                    help="grouped cost decomposition, comma list of "
                    "0 binning, 1 +object solve/sphere, 2 +patch cull, "
                    "3 full (default)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from geodesic_raytracing import metrics
    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.ops import integrate
    from geodesic_raytracing.ops.integrate import Features, TraceOptions
    from geodesic_raytracing.render import pipeline as pl
    from geodesic_raytracing.render.pipeline import RenderSettings
    from geodesic_raytracing.triangles import (
        TriangleScene, make_cube, precompute_object, subtriangulate)
    from geodesic_raytracing.triangles.render import (
        build_swept_triangles, intersect_scene_binned,
        intersect_scene_compact, intersect_scene_grouped)

    m = metrics.get_metric("schwarzschild")
    params = m.params()
    feats = Features.for_metric(m)

    # --- scene: 12 cubes on a near-circular r=4 orbit (v_circ ~ 0.41 for
    # rs=1 keeps them on station for the whole frame), subtriangulated to
    # ~tris total.  T = -6: camera rays integrate BACKWARDS in time, object
    # worldlines forward from T, so objects must start slightly in the
    # camera's past (see the --cube CLI help) and must still be around when
    # the rays sweep by (a plunging object at T = -40 is long gone).
    n_obj = 12
    per_obj = args.tris // n_obj
    # each subdivision x4: 12 -> 12*4^d; pick max_edge for the target count
    depth = max(0, int(np.ceil(np.log(per_obj / 12) / np.log(4))))
    max_edge = 1.5 / (2 ** depth) + 1e-6
    base = make_cube([0, 0, 0, 0], scale=0.6)
    v, t = subtriangulate(base.vertices, base.triangles, max_edge=max_edge)
    objs = []
    for i in range(n_obj):
        ang = 2 * np.pi * i / n_obj
        v_circ = 0.408
        o = make_cube([-6.0, 4 * np.cos(ang), 4 * np.sin(ang), 0.0],
                      scale=0.6,
                      velocity=(v_circ * -np.sin(ang), v_circ * np.cos(ang),
                                0))
        o.vertices, o.triangles = v, t
        objs.append(o)
    scene = TriangleScene.build(objs)
    print(f"triangles: {len(scene.v0)}", flush=True)

    t0 = time.perf_counter()
    geos = [precompute_object(m, o, params, feats, n_steps=512,
                              segments=args.segments) for o in objs]
    swept = build_swept_triangles(scene, geos)
    M = swept.lo.shape[0]
    print(f"swept entries: {M} (precompute {time.perf_counter()-t0:.1f}s)",
          flush=True)

    # --- rays: production camera, recorded paths
    W, H = args.width, args.height
    cam = Camera.default().rotate(pitch=-np.pi / 2)
    settings = RenderSettings(width=W, height=H,
                              trace=TraceOptions(max_steps=256,
                                                 method="scan"))
    state, _, _ = pl.init_camera_rays(m, cam, params, settings, feats)
    t0 = time.perf_counter()
    final, path = integrate.trace_rays_recorded(
        m, state, params, features=feats, opts=settings.trace,
        n_slots=32, steps_per_slot=8)
    path = jax.block_until_ready(path)
    print(f"path trace: {time.perf_counter()-t0:.1f}s "
          f"({W*H} rays x 32 slots)", flush=True)

    N = W * H
    block = 256
    slab = args.slab_blocks * block

    stages = [int(v) for v in str(args.stage).split(",")]
    if args.compact and args.stage == "3":
        # compact has 5 stages (0 dense A, 1 +pair compaction/re-solve,
        # 2 +patch slab, 3 +extraction/item nonzero/tri gathers, 4 full);
        # map the grouped-path default "3" to full.
        stages = [4]
    for budget, stage in [(b, st)
                          for b in [int(v) for v in args.budgets.split(",")]
                          for st in stages]:

        def run_slab(p_slab, budget=budget, stage=stage):
            if args.compact:
                return intersect_scene_compact(
                    m, p_slab, scene, geos, params, block=block,
                    obj_budget=budget, pair_budget=args.pair_budget,
                    tri_budget=args.tri_budget,
                    patch_size=args.patch_size,
                    patch_slots=args.patch_slots, with_stats=True,
                    stage=stage)
            if args.grouped:
                # budget = object-segment entries per chunk; per-triangle
                # work happens in the object's local frame (patch culling).
                return intersect_scene_grouped(
                    m, p_slab, scene, geos, params, block=block,
                    obj_budget=budget, chunk_budget=args.chunk_budget,
                    patch_budget=args.patch_budget, with_stats=True,
                    stage=stage)
            return intersect_scene_binned(
                m, p_slab, scene, geos, params, block=block,
                budget=budget, with_stats=True)

        jrun = jax.jit(run_slab)
        # compile on the first slab shape
        outs = []
        t0 = time.perf_counter()
        for s0 in range(0, N, slab):
            p = path[:, s0:s0 + slab]
            if p.shape[1] < slab:  # pad the tail slab to the jitted shape
                p = jnp.concatenate(
                    [p, jnp.broadcast_to(p[:, -1:],
                                         (p.shape[0], slab - p.shape[1], 4))],
                    axis=1)
            outs.append(jrun(p))
        # sync via a scalar reduction fetch
        hit_total = int(sum(np.asarray(o[0].sum()) for o in outs))
        dt = time.perf_counter() - t0
        dropped = int(sum(np.asarray(o[2]["dropped"]) for o in outs))
        max_ov = int(max(np.asarray(o[2]["max_overlap"]) for o in outs))
        # Per-(block x segment)-chunk average over the ACTUAL chunk count
        # (tail-slab padding duplicates the last ray, so hit/dropped totals
        # carry a small padded-ray overcount — bounded by slab/N per slab).
        n_slabs = -(-N // slab)
        n_chunks = n_slabs * (slab // block) * args.segments
        extra = ""
        if args.grouped or args.compact:
            sp = sum(float(np.asarray(o[2]["sphere_pass"])) for o in outs)
            pp = sum(float(np.asarray(o[2]["patch_pass"])) for o in outs)
            extra = (f", sphere_pass {sp:.3g}, patch_pass {pp:.3g} "
                     f"(stage {stage})")
        print(f"budget {budget:4d}: {N/1e6/dt:6.3f} Mrays/s "
              f"({dt:.2f}s intersect, first call incl. compile), "
              f"hits {hit_total}, dropped {dropped} "
              f"({dropped/max(n_chunks,1):.2f}/chunk avg over {n_chunks} "
              f"chunks), max_overlap {max_ov}{extra}", flush=True)
        # steady-state: second pass without compile
        t0 = time.perf_counter()
        outs = []
        for s0 in range(0, N, slab):
            p = path[:, s0:s0 + slab]
            if p.shape[1] < slab:
                p = jnp.concatenate(
                    [p, jnp.broadcast_to(p[:, -1:],
                                         (p.shape[0], slab - p.shape[1], 4))],
                    axis=1)
            outs.append(jrun(p))
        _ = int(np.asarray(outs[-1][0].sum()))
        dt = time.perf_counter() - t0
        print(f"budget {budget:4d}: {N/1e6/dt:6.3f} Mrays/s steady-state",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
