"""Multi-device sharding on the virtual 8-CPU mesh: sharded trace equals
single-device trace; the distributed train step runs and reduces loss."""

import jax
import jax.numpy as jnp
import numpy as np

from geodesic_raytracing import metrics
from geodesic_raytracing.camera import Camera
from geodesic_raytracing.ops.integrate import (
    Features,
    TraceOptions,
    init_ray_state,
    trace_rays,
)
from geodesic_raytracing.parallel.mesh import (
    make_train_step,
    ray_mesh,
    sharded_trace,
)
from geodesic_raytracing.render import background as bg
from geodesic_raytracing.render.pipeline import RenderSettings


def test_sharded_trace_matches_single_device():
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    feats = Features.for_metric(m)
    n = 64
    ang = np.linspace(0.05, 0.8, n)
    pos = jnp.asarray(
        np.tile([0.0, 7.0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    )
    vel = jnp.asarray(
        np.stack(
            [np.ones(n), -np.cos(ang), np.zeros(n), np.sin(ang) / 7.0], -1
        ).astype(np.float32)
    )
    st = init_ray_state(m, pos, vel, params, feats)
    opts = TraceOptions(max_steps=1024)

    single = trace_rays(m, st, params, features=feats, opts=opts)
    mesh = ray_mesh()
    assert mesh.devices.size == 8
    sharded = sharded_trace(m, mesh, st, params, feats, opts)
    sharded = jax.tree.map(lambda x: x[:n], sharded)

    np.testing.assert_array_equal(
        np.asarray(single.status), np.asarray(sharded.status)
    )
    np.testing.assert_allclose(
        np.asarray(single.position), np.asarray(sharded.position),
        rtol=1e-5, atol=1e-5,
    )


def test_sharded_adaptive_frame_matches_single_device():
    """The PRODUCTION adaptive pipeline sharded over quarter-row bands must
    reproduce the single-device frame.  Band boundaries fall under the
    must-refine border rule, so boundary blocks are TRACED in the sharded
    frame where the single-device frame may interpolate — those pixels can
    differ by the interpolation softening; everything else matches.

    Fast tier: 48^2/384 steps (~1 min on the 2-core CI box); SUITE_FULL=1
    restores the 64^2/2048 configuration (the full run took 20+ min — half
    the old suite time)."""
    from conftest import tier

    from geodesic_raytracing.parallel.mesh import sharded_adaptive_frame
    from geodesic_raytracing.render import pipeline as pl

    size = tier(48, 64)
    max_steps = tier(384, 2048)
    m = metrics.get_metric("kerr_boyer")
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(64, 128)
    settings = RenderSettings(
        width=size, height=size, anisotropy=2, adaptive_sampling=True,
        refine_budget=1.0, shade_traced_only=True,
        trace=TraceOptions(max_steps=max_steps, method="while"),
    )
    feats = Features.for_metric(m)
    single = np.asarray(pl.render_frame(m, camera, m.params(), backgrounds,
                                        settings, feats))
    mesh = ray_mesh()
    # mirror=False: this test's interior mask assumes contiguous bands;
    # the mirrored layout has its own test below.
    sharded = np.asarray(sharded_adaptive_frame(
        m, mesh, camera, m.params(), backgrounds, settings, feats,
        mirror=False))
    assert sharded.shape == single.shape
    assert np.isfinite(sharded).all()
    d = np.abs(single - sharded).max(axis=-1)
    # Rows away from band boundaries must match exactly; boundary rows may
    # differ (traced vs interpolated).
    Hb2 = size // 8  # full-res rows per band
    interior = np.ones(size, bool)
    for b in range(8):
        interior[b * Hb2:b * Hb2 + 2] = False      # band top block row
        interior[(b + 1) * Hb2 - 2:(b + 1) * Hb2] = False  # band bottom
    assert (d[interior] > 0.05).mean() < 0.02, (d[interior] > 0.05).mean()
    assert (d > 0.1).mean() < 0.15, (d > 0.1).mean()


def test_distributed_train_step_reduces_loss():
    """Fit rs from a target image rendered at rs=1.1, starting at rs=1.0 —
    gradient descent through the sharded differentiable integrator."""
    m = metrics.get_metric("schwarzschild")
    mesh = ray_mesh()
    settings = RenderSettings(
        width=16, height=16,
        trace=TraceOptions(max_steps=192, method="scan", remat_every=32),
    )
    feats = Features.for_metric(m)
    step = make_train_step(m, mesh, settings, feats)

    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(32, 64)

    # Target rendered by the same loss-path renderer at rs = 1.1.
    from geodesic_raytracing.parallel import mesh as pm

    target_params = m.params(rs=1.1)
    params0 = m.params(rs=1.0)

    # Use the train step itself at lr=0 to extract the loss at both points.
    _, loss_at_true = step(target_params, camera,
                           jnp.zeros((16, 16, 3)), backgrounds,
                           jnp.float32(0.0))

    new_params, loss0 = step(params0, camera, jnp.zeros((16, 16, 3)),
                             backgrounds, jnp.float32(0.01))
    assert np.isfinite(float(loss0))
    assert np.all(np.isfinite(np.asarray(new_params["rs"])))
    # The parameter moved.
    assert abs(float(new_params["rs"]) - 1.0) > 0


def test_train_step_grad_finite_at_scale():
    """Regression: the 128^2/1024-step Kerr fit NaN'd its parameter
    gradient before the two-pass pre-kill (dying rays' divergent trial
    evaluations feed inf primals into reverse mode; photon-ring rays past
    the Lyapunov step cap overflow fp32 tangents).  Optimisation steps
    through the failing configuration must stay finite and reduce the
    loss.  Fast tier runs 64^2/512 (same recipe, same Kerr shadow edge in
    frame); SUITE_FULL=1 restores the exact 128^2/1024 failing config."""
    import numpy as np

    from conftest import tier

    from geodesic_raytracing import metrics
    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.fit import _render_target
    from geodesic_raytracing.ops.integrate import Features, TraceOptions
    from geodesic_raytracing.parallel.mesh import make_train_step, ray_mesh
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render.pipeline import RenderSettings

    metric = metrics.get_metric("kerr_boyer")
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(128, 256)
    mesh = ray_mesh(jax.devices()[:1])
    settings = RenderSettings(
        width=tier(64, 128), height=tier(64, 128),
        trace=TraceOptions(max_steps=tier(512, 1024), method="scan",
                           remat_every=tier(64, 128)),
    )
    features = Features.for_metric(metric)
    step = make_train_step(metric, mesh, settings, features)
    true_params = metric.params(rs=1.1)
    target = _render_target(metric, camera, true_params, backgrounds,
                            settings, features)
    params = metric.params(rs=0.95)
    losses = []
    for _ in range(2):
        params, loss = step(params, camera, target, backgrounds,
                            jnp.float32(0.05))
        losses.append(float(loss))
        assert all(np.isfinite(float(v)) for v in params.values()), params
    assert losses[1] < losses[0]


def test_banded_adaptive_frame_matches_sharded():
    """banded_adaptive_frame (sequential band chains on ONE device, explicit
    row0) must reproduce sharded_adaptive_frame (shard_map over the mesh,
    row0 from axis_index) EXACTLY — the stage code is shared, so the two
    paths differ only in how bands are dispatched.  This is what makes the
    single-chip band-tax measurement (scripts/band_tax_bench.py) evidence
    about the sharded path rather than about a look-alike."""
    from conftest import tier

    from geodesic_raytracing.parallel.mesh import (
        banded_adaptive_frame,
        sharded_adaptive_frame,
    )

    size = tier(48, 64)
    max_steps = tier(256, 1024)
    m = metrics.get_metric("kerr_boyer")
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(64, 128)
    settings = RenderSettings(
        width=size, height=size, anisotropy=2, adaptive_sampling=True,
        refine_budget=1.0, shade_traced_only=True,
        trace=TraceOptions(max_steps=max_steps, method="while"),
    )
    feats = Features.for_metric(m)
    mesh = ray_mesh()
    n_bands = mesh.devices.size
    sharded = np.asarray(sharded_adaptive_frame(
        m, mesh, camera, m.params(), backgrounds, settings, feats))
    band_heights = []
    banded = np.asarray(banded_adaptive_frame(
        m, camera, m.params(), backgrounds, settings, n_bands, feats,
        band_sync=lambda b, img: band_heights.append(img.shape[0])))
    assert band_heights == [size // n_bands] * n_bands
    np.testing.assert_array_equal(banded, sharded)


def test_cost_band_layout_properties():
    """_cost_band_layout: every band gets exactly cpb chunks (static
    shapes), the rows partition [0, Hh), the stitch permutation inverts,
    and the greedy-LPT max band cost never exceeds the static contiguous
    partition's max band cost."""
    from geodesic_raytracing.parallel.mesh import _cost_band_layout

    rng = np.random.default_rng(7)
    Hh, Wh, B, cpb = 32, 4, 8, 2
    # Skewed cost field (hot middle rows, like a centred black hole).
    # ~3x row-cost skew.  A steeper field is chunk-granularity-limited,
    # not algorithm-limited.
    row_cost = (1.0 + 2.0 * np.exp(-((np.arange(Hh) - 14.0) / 8.0) ** 2)
                + rng.uniform(0, 0.5, Hh)).astype(np.float32)
    cost = jnp.asarray(np.repeat(row_cost / Wh, Wh))
    kill = jnp.asarray(rng.uniform(size=Hh * Wh) < 0.3)

    kill_p, row_map, inv_fullres = _cost_band_layout(
        kill, cost, Hh, Wh, B, cpb)
    rows = np.asarray(row_map)
    assert rows.shape == (B, Hh // B)
    # Partition of [0, Hh).
    assert sorted(rows.reshape(-1).tolist()) == list(range(Hh))
    # Each band = cpb contiguous chunks.
    Hc = Hh // (B * cpb)
    for b in range(B):
        r = rows[b].reshape(cpb, Hc)
        assert all((np.diff(chunk) == 1).all() and chunk[0] % Hc == 0
                   for chunk in r)
    # The permuted kill map matches a gather of the original.
    np.testing.assert_array_equal(
        np.asarray(kill_p).reshape(-1, Wh),
        np.asarray(kill).reshape(Hh, Wh)[rows.reshape(-1)])
    # Stitch inverts: band-major full-res rows -> image order.
    full_order = np.stack([2 * rows.reshape(-1),
                           2 * rows.reshape(-1) + 1], 1).reshape(-1)
    np.testing.assert_array_equal(
        full_order[np.asarray(inv_fullres)], np.arange(2 * Hh))
    # Balance beats the static contiguous partition on this skewed field.
    band_cost = row_cost[rows].sum(axis=1)
    contig_cost = row_cost.reshape(B, Hh // B).sum(axis=1)
    assert band_cost.max() <= contig_cost.max() + 1e-4
    # And is near the ideal equal split on this field.
    assert band_cost.max() / (row_cost.sum() / B) < 1.25


def test_cost_balanced_banded_frame_matches_sharded_and_single():
    """Dynamic cost-balanced bands: banded (sequential, explicit b) must
    equal sharded (shard_map, axis_index) EXACTLY — shared stage programs
    — and both must match the single-device frame away from chunk
    boundary rows (boundary rows are must-refine seams: traced where the
    single-device frame may interpolate)."""
    from conftest import tier

    from geodesic_raytracing.parallel.mesh import (
        banded_adaptive_frame,
        sharded_adaptive_frame,
    )
    from geodesic_raytracing.render import pipeline as pl

    size = 64
    n_bands, cpb = 2, 2      # Hh=32 -> Hb=16, chunks of 8 quarter rows
    max_steps = tier(256, 1024)
    m = metrics.get_metric("kerr_boyer")
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(64, 128)
    settings = RenderSettings(
        width=size, height=size, anisotropy=2, adaptive_sampling=True,
        refine_budget=1.0, shade_traced_only=True,
        trace=TraceOptions(max_steps=max_steps, method="while"),
    )
    feats = Features.for_metric(m)
    single = np.asarray(pl.render_frame(m, camera, m.params(), backgrounds,
                                        settings, feats))
    banded = np.asarray(banded_adaptive_frame(
        m, camera, m.params(), backgrounds, settings, n_bands, feats,
        balance=cpb))
    mesh = ray_mesh(jax.devices()[:n_bands])
    sharded = np.asarray(sharded_adaptive_frame(
        m, mesh, camera, m.params(), backgrounds, settings, feats,
        balance=cpb))
    np.testing.assert_array_equal(banded, sharded)

    assert banded.shape == single.shape
    assert np.isfinite(banded).all()
    d = np.abs(single - banded).max(axis=-1)
    # Chunk = 8 quarter rows = 16 full-res rows; chunk tops/bottoms (2
    # full-res rows each) are the seam/boundary set.
    chunk = 16
    interior = np.ones(size, bool)
    for c0 in range(0, size, chunk):
        interior[c0:c0 + 2] = False
        interior[c0 + chunk - 2:c0 + chunk] = False
    # Full tier (1024 steps) measured 0.0221: deeper traces interpolate
    # more blocks in the single-device frame where the banded frame's
    # seam rules force traces, and the softening reaches one block past
    # the excluded boundary rows.  The load-bearing banded==sharded
    # bit-equality above is tier-independent.
    lim = tier(0.02, 0.03)
    assert (d[interior] > 0.05).mean() < lim, (d[interior] > 0.05).mean()
    assert (d > 0.1).mean() < 0.2, (d > 0.1).mean()


def test_mirrored_banded_frame_matches_single_device():
    """Mirrored half-bands (cost balancing): band b covers a top chunk and
    its mirrored bottom chunk; seam/boundary rows are must-refine, so away
    from chunk edges the stitched image must match the single-device frame
    exactly (the stages share all per-ray code; only the row partition and
    the stitch differ)."""
    from conftest import tier

    from geodesic_raytracing.parallel.mesh import banded_adaptive_frame
    from geodesic_raytracing.render import pipeline as pl

    size = 64
    n_bands = 2          # Hb = 16 quarter rows, half-chunk 8 -> mirror legal
    max_steps = tier(256, 1024)
    m = metrics.get_metric("kerr_boyer")
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(64, 128)
    settings = RenderSettings(
        width=size, height=size, anisotropy=2, adaptive_sampling=True,
        refine_budget=1.0, shade_traced_only=True,
        trace=TraceOptions(max_steps=max_steps, method="while"),
    )
    feats = Features.for_metric(m)
    single = np.asarray(pl.render_frame(m, camera, m.params(), backgrounds,
                                        settings, feats))
    banded = np.asarray(banded_adaptive_frame(
        m, camera, m.params(), backgrounds, settings, n_bands, feats,
        mirror=True))
    assert banded.shape == single.shape
    assert np.isfinite(banded).all()
    d = np.abs(single - banded).max(axis=-1)
    # Half-chunk size: 8 quarter rows = 16 full-res rows; chunk tops and
    # bottoms (2 full-res rows each) are the boundary/seam set.
    chunk = 16
    interior = np.ones(size, bool)
    for c0 in range(0, size, chunk):
        interior[c0:c0 + 2] = False
        interior[c0 + chunk - 2:c0 + chunk] = False
    assert (d[interior] > 0.05).mean() < 0.02, (d[interior] > 0.05).mean()
    assert (d > 0.1).mean() < 0.2, (d > 0.1).mean()
