"""GR triangle renderer: flat-space oracle — in Minkowski the toblerone
pipeline must reduce to ordinary raytracing of a cube."""

import jax.numpy as jnp
import numpy as np

from geodesic_raytracing import metrics
from geodesic_raytracing.ops.integrate import (
    Features,
    TraceOptions,
    init_ray_state,
)
from geodesic_raytracing.triangles import (
    TriangleScene,
    make_cube,
    precompute_object,
    render_triangles,
    subtriangulate,
)


def test_subtriangulate_splits_edges():
    cube = make_cube([0, 0, 0, 0])
    v, t = subtriangulate(cube.vertices, cube.triangles, max_edge=0.6)
    assert len(t) > len(cube.triangles)
    edges = v[t[:, 1]] - v[t[:, 0]]
    assert np.linalg.norm(edges, axis=1).max() <= 0.6 + 1e-5


def test_scene_build():
    cube = make_cube([0, 0, 0, 0], scale=2.0)
    scene = TriangleScene.build([cube])
    assert scene.v0.shape == (12, 3)
    assert np.all(scene.parent == 0)
    assert np.abs(scene.v0).max() == 1.0  # scaled by 2


def test_minkowski_cube_hits():
    """Rays aimed at a static cube hit it; rays aimed away miss."""
    m = metrics.get_metric("minkowski")
    params = m.params()
    feats = Features.for_metric(m)

    # Cube sitting at the spatial origin, worldline traced from t = -40.
    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    geo = precompute_object(m, cube, params, feats, n_steps=256, segments=32)
    assert np.isfinite(np.asarray(geo.positions)).all()
    # Static object: spatial position fixed, time advancing.
    np.testing.assert_allclose(
        np.asarray(geo.positions)[:, 1:], 0.0, atol=1e-4
    )
    scene = TriangleScene.build([cube])

    # Camera rays from (t=0, x=-7): some aimed at the cube (+x), some away.
    n = 9
    offsets = np.linspace(-3.0, 3.0, n)  # y-offsets of target
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    dirs = np.stack(
        [np.full(n, 7.0), offsets, np.zeros(n)], -1
    )
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vel = np.concatenate(
        [-np.ones((n, 1)), dirs], axis=1
    ).astype(np.float32)  # backwards in time, like render rays
    st = init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel), params, feats)

    _, hit, colour = render_triangles(
        m, st, params, scene, [geo], features=feats,
        opts=TraceOptions(max_steps=512), n_slots=8, steps_per_slot=32,
    )
    hit = np.asarray(hit)
    # Target y-offsets within the half-extent 0.5 must hit; |y| > ~0.55
    # misses (allow the boundary ray either way).
    b = np.abs(offsets) / 7.0 * 7.0  # impact offset at the cube plane ~ y
    assert hit[np.abs(offsets) < 0.45].all(), (offsets, hit)
    assert not hit[np.abs(offsets) > 0.8].any(), (offsets, hit)
    # Hit colour is a face normal magnitude: one channel ~1.
    cols = np.asarray(colour)[hit]
    assert (cols.max(axis=1) > 0.9).all()


def test_binned_matches_dense():
    """The AABB-binned intersector agrees with the dense one whenever the
    per-chunk overlap count fits the budget (it does here by a wide
    margin)."""
    m = metrics.get_metric("minkowski")
    params = m.params()
    feats = Features.for_metric(m)

    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    geo = precompute_object(m, cube, params, feats, n_steps=256, segments=16)
    # Second object off to the side exercises multi-object concatenation.
    cube2 = make_cube([-40.0, 0.0, 2.0, 0.0], scale=0.8)
    geo2 = precompute_object(m, cube2, params, feats, n_steps=256,
                             segments=16)
    scene = TriangleScene.build([cube, cube2])

    n = 16
    offsets = np.linspace(-1.0, 3.0, n)
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    dirs = np.stack([np.full(n, 7.0), offsets, np.zeros(n)], -1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vel = np.concatenate([-np.ones((n, 1)), dirs], axis=1).astype(np.float32)
    st = init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel), params, feats)

    common = dict(features=feats, opts=TraceOptions(max_steps=512),
                  n_slots=8, steps_per_slot=32)
    _, hit_d, col_d = render_triangles(m, st, params, scene, [geo, geo2],
                                       **common)
    _, hit_b, col_b = render_triangles(m, st, params, scene, [geo, geo2],
                                       binned=True, block=8, budget=96,
                                       **common)
    np.testing.assert_array_equal(np.asarray(hit_d), np.asarray(hit_b))
    assert np.asarray(hit_b).any()  # the comparison is not vacuous
    np.testing.assert_allclose(np.asarray(col_d), np.asarray(col_b),
                               atol=1e-5)


def test_binned_budget_prunes():
    """A tiny budget still finds hits for simple scenes (earliest segments
    win, like the reference's overflowing bins)."""
    m = metrics.get_metric("minkowski")
    params = m.params()
    feats = Features.for_metric(m)
    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    geo = precompute_object(m, cube, params, feats, n_steps=256, segments=16)
    scene = TriangleScene.build([cube])

    pos = np.array([[0.0, -7.0, 0.0, 0.0]], dtype=np.float32)
    vel = np.array([[-1.0, 1.0, 0.0, 0.0]], dtype=np.float32)
    st = init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel), params, feats)
    _, hit, _ = render_triangles(
        m, st, params, scene, [geo], features=feats,
        opts=TraceOptions(max_steps=512), n_slots=8, steps_per_slot=32,
        binned=True, block=8, budget=16,
    )
    assert np.asarray(hit)[0]


def test_schwarzschild_nearfield_cube_hits():
    """Regression: a cube between camera and hole in strong field must be
    hit.  At the old coarse recording (16 slots x 64 steps) slot 0 spanned
    the whole camera->horizon approach and the within-segment linear
    interpolation missed every near-field object (zero hits)."""
    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.render.pipeline import (
        RenderSettings,
        init_camera_rays,
    )

    m = metrics.get_metric("schwarzschild")
    params = m.params()
    feats = Features.for_metric(m)
    cube = make_cube([-6.0, 0.0, -3.0, 0.0])
    geo = precompute_object(m, cube, params, feats, n_steps=512, segments=48)
    scene = TriangleScene.build([cube])
    cam = Camera.default().rotate(pitch=-np.pi / 2)
    settings = RenderSettings(
        width=48, height=48, planar=False,
        trace=TraceOptions(max_steps=512, method="scan"))
    st, _, _ = init_camera_rays(m, cam, params, settings, feats)
    _, hit, _ = render_triangles(m, st, params, scene, [geo], feats,
                                 settings.trace, binned=True, budget=64)
    frac = float(np.asarray(hit).mean())
    # the cube subtends ~14 deg of the 90 deg fov ~ 2% of pixels
    assert frac > 0.005, frac


def test_binned_overflow_counter():
    """with_stats must report dropped candidates when the budget is too
    small, zero when it fits, and the well-budgeted result must match."""
    from geodesic_raytracing.triangles.render import intersect_scene_binned
    from geodesic_raytracing.ops import integrate as ops_integrate

    m = metrics.get_metric("minkowski")
    params = m.params()
    feats = Features.for_metric(m)
    cube = make_cube([-8.0, 0.0, -3.0, 0.0])
    geo = precompute_object(m, cube, params, feats, n_steps=128, segments=8)
    scene = TriangleScene.build([cube])
    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.render.pipeline import (
        RenderSettings,
        init_camera_rays,
    )

    cam = Camera.default().rotate(pitch=-np.pi / 2)
    settings = RenderSettings(
        width=32, height=32, planar=False,
        trace=TraceOptions(max_steps=128, method="scan"))
    st, _, _ = init_camera_rays(m, cam, params, settings, feats)
    _, path = ops_integrate.trace_rays_recorded(
        m, st, params, features=feats, opts=settings.trace,
        n_slots=16, steps_per_slot=8)
    hit_small, _, stats_small = intersect_scene_binned(
        m, path, scene, [geo], params, budget=2, with_stats=True)
    hit_big, _, stats_big = intersect_scene_binned(
        m, path, scene, [geo], params, budget=96, with_stats=True)
    assert int(stats_small["dropped"]) > 0
    assert int(stats_big["dropped"]) == 0
    assert int(stats_big["max_overlap"]) <= 96
    assert int(np.asarray(hit_big).sum()) > 0


def test_grouped_matches_dense():
    """The two-level object/patch intersector (intersect_scene_grouped)
    agrees with the dense one on hit/miss away from edge rays: the
    object-level fixed point approximates the per-triangle one, which for
    small rigid objects moves the local ray by less than a triangle."""
    m = metrics.get_metric("minkowski")
    params = m.params()
    feats = Features.for_metric(m)

    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    geo = precompute_object(m, cube, params, feats, n_steps=256, segments=16)
    cube2 = make_cube([-40.0, 0.0, 2.0, 0.0], scale=0.8)
    geo2 = precompute_object(m, cube2, params, feats, n_steps=256,
                             segments=16)
    scene = TriangleScene.build([cube, cube2])

    n = 16
    offsets = np.linspace(-1.0, 3.0, n)
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    dirs = np.stack([np.full(n, 7.0), offsets, np.zeros(n)], -1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vel = np.concatenate([-np.ones((n, 1)), dirs], axis=1).astype(np.float32)
    st = init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel), params, feats)

    common = dict(features=feats, opts=TraceOptions(max_steps=512),
                  n_slots=8, steps_per_slot=32)
    _, hit_d, col_d = render_triangles(m, st, params, scene, [geo, geo2],
                                       **common)
    _, hit_g, col_g = render_triangles(m, st, params, scene, [geo, geo2],
                                       grouped=True, block=8, budget=16,
                                       **common)
    hit_d, hit_g = np.asarray(hit_d), np.asarray(hit_g)
    assert hit_d.any()
    # Identical hit/miss pattern on this scene (no grazing rays).
    np.testing.assert_array_equal(hit_d, hit_g)
    both = hit_d & hit_g
    np.testing.assert_allclose(np.asarray(col_d)[both],
                               np.asarray(col_g)[both], atol=1e-3)


def test_compact_matches_dense_and_grouped():
    """The worklist-compacted intersector (intersect_scene_compact) must
    reproduce the dense intersector's hit/miss pattern (same object-level
    fixed point as grouped; compaction is a reordering, not an
    approximation) and report zero drops when its budgets cover the
    survivor counts."""
    from geodesic_raytracing.triangles.render import (
        intersect_scene_compact)

    m = metrics.get_metric("minkowski")
    params = m.params()
    feats = Features.for_metric(m)

    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    geo = precompute_object(m, cube, params, feats, n_steps=256, segments=16)
    cube2 = make_cube([-40.0, 0.0, 2.0, 0.0], scale=0.8)
    geo2 = precompute_object(m, cube2, params, feats, n_steps=256,
                             segments=16)
    scene = TriangleScene.build([cube, cube2])

    n = 16
    offsets = np.linspace(-1.0, 3.0, n)
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    dirs = np.stack([np.full(n, 7.0), offsets, np.zeros(n)], -1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vel = np.concatenate([-np.ones((n, 1)), dirs], axis=1).astype(np.float32)
    st = init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel), params, feats)

    common = dict(features=feats, opts=TraceOptions(max_steps=512),
                  n_slots=8, steps_per_slot=32)
    _, hit_d, col_d = render_triangles(m, st, params, scene, [geo, geo2],
                                       **common)
    _, hit_c, col_c = render_triangles(m, st, params, scene, [geo, geo2],
                                       compact=True, block=8, budget=16,
                                       **common)
    _, hit_g, col_g = render_triangles(m, st, params, scene, [geo, geo2],
                                       grouped=True, block=8, budget=16,
                                       **common)
    hit_d, hit_c = np.asarray(hit_d), np.asarray(hit_c)
    assert hit_d.any()
    np.testing.assert_array_equal(hit_d, hit_c)
    np.testing.assert_array_equal(np.asarray(hit_g), hit_c)
    both = hit_d & hit_c
    np.testing.assert_allclose(np.asarray(col_d)[both],
                               np.asarray(col_c)[both], atol=1e-3)
    np.testing.assert_allclose(np.asarray(col_g)[both],
                               np.asarray(col_c)[both], atol=1e-5)

    # Budgets cover this scene -> zero drops reported.
    from geodesic_raytracing.ops.integrate import trace_rays_recorded
    _, path = trace_rays_recorded(m, st, params, **common)
    hit_s, col_s, stats = intersect_scene_compact(
        m, path, scene, [geo, geo2], params, block=8, obj_budget=16,
        with_stats=True)
    assert float(stats["dropped"]) == 0.0
    assert float(stats["sphere_pass"]) > 0

    # The per-pair slot extraction (patch_slots, default 8) must be
    # bit-identical to the legacy flat (Wp x P) nonzero when no pair
    # overflows its slots.
    hit_f, col_f, stats_f = intersect_scene_compact(
        m, path, scene, [geo, geo2], params, block=8, obj_budget=16,
        patch_slots=0, with_stats=True)
    np.testing.assert_array_equal(np.asarray(hit_s), np.asarray(hit_f))
    np.testing.assert_array_equal(np.asarray(col_s), np.asarray(col_f))
    assert float(stats_f["dropped"]) == 0.0

    # Starving the slots (patch_slots=1 on a scene whose pairs hit
    # several patches) must surface in the drop counter, not silently.
    _, _, stats_1 = intersect_scene_compact(
        m, path, scene, [geo, geo2], params, block=8, obj_budget=16,
        patch_size=4, patch_slots=1, with_stats=True)
    assert float(stats_1["dropped"]) > 0.0


def test_grouped_overflow_counters():
    """intersect_scene_grouped with_stats reports candidate/chunk drops."""
    from geodesic_raytracing.triangles.render import (
        intersect_scene_grouped)
    from geodesic_raytracing.ops.integrate import trace_rays_recorded

    m = metrics.get_metric("minkowski")
    params = m.params()
    feats = Features.for_metric(m)
    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    geo = precompute_object(m, cube, params, feats, n_steps=256, segments=16)
    scene = TriangleScene.build([cube])

    n = 8
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    vel = np.tile([-1.0, 1.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    st = init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel), params, feats)
    _, path = trace_rays_recorded(m, st, params, features=feats,
                                  opts=TraceOptions(max_steps=512),
                                  n_slots=8, steps_per_slot=32)
    # obj_budget 1 < overlapping segments per chunk -> drops counted
    hit, _, stats = intersect_scene_grouped(
        m, path, scene, [geo], params, block=8, obj_budget=1,
        with_stats=True)
    assert int(stats["max_overlap"]) > 1
    assert int(stats["dropped"]) > 0
    # (budget 1 may well keep the WRONG temporal segment and miss — that
    # is exactly what the counters exist to expose)
    hit2, _, stats2 = intersect_scene_grouped(
        m, path, scene, [geo], params, block=8, obj_budget=16,
        with_stats=True)
    assert int(stats2["dropped"]) == 0
    assert np.asarray(hit2).any()
