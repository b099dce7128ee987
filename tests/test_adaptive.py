"""Adaptive-sampling pipeline (the production bench path): quarter trace +
prepass kill + budgeted refinement + assembly must reproduce the dense
render (handle_adaptive_sampling cl.cl:5223-5344 semantics: refined blocks
exact, interpolated blocks only below the angular-error threshold)."""

import dataclasses

import numpy as np

from geodesic_raytracing import metrics
from geodesic_raytracing.camera import Camera
from geodesic_raytracing.ops.integrate import TraceOptions
from geodesic_raytracing.render import background as bg
from geodesic_raytracing.render import pipeline as pl


def _frames(name, anisotropy=2, **adaptive_kw):
    m = metrics.get_metric(name)
    cam = Camera.default().rotate(pitch=-np.pi / 2)
    b = bg.checker_background(128, 256)
    base = pl.RenderSettings(width=64, height=64, anisotropy=anisotropy,
                             trace=TraceOptions(max_steps=4096))
    adaptive_kw.setdefault("shade_traced_only", False)
    dense = pl.render_frame(m, cam, m.params(), b, base)
    adap = pl.render_frame(
        m, cam, m.params(), b,
        dataclasses.replace(base, adaptive_sampling=True, **adaptive_kw))
    return np.asarray(dense), np.asarray(adap)


def test_adaptive_matches_dense_kerr():
    dense, adap = _frames("kerr_boyer")
    assert np.isfinite(adap).all()
    # Refined/traced pixels are exact; interpolated ones sit below the
    # angular threshold, so the images must agree except on a small
    # fraction of edge pixels.
    d = np.abs(dense - adap).max(axis=-1)
    assert (d > 0.1).mean() < 0.06, (d > 0.1).mean()
    assert np.median(d) < 1e-3


def test_adaptive_full_budget_schwarzschild():
    dense, adap = _frames("schwarzschild", refine_budget=1.0)
    d = np.abs(dense - adap).max(axis=-1)
    # Full budget: every block refines -> odd/even-offset pixels traced
    # exactly; only interpolated-but-below-threshold cells may differ.
    assert (d > 0.1).mean() < 0.05, (d > 0.1).mean()


def test_traced_only_shading_corners_exact():
    """shade_traced_only: quarter corners and refined pixels are shaded off
    their own traced render data, so at anisotropy 1 (no probe-budget
    prefix, whose membership legitimately differs between the full-res and
    per-set pixel orderings) they must match the dense render wherever the
    dense path agrees with the data-interpolating adaptive path."""
    dense, adap = _frames("kerr_boyer", anisotropy=1, shade_traced_only=True)
    assert np.isfinite(adap).all()
    # Tolerance: the corner's EWA lod uses the quarter-grid derivative
    # (halved), the dense render its true full-res neighbour — a small lod
    # delta under trilinear blending, never a structural difference.
    corners = np.abs(dense[0::2, 0::2] - adap[0::2, 0::2]).max(axis=-1)
    assert (corners > 0.05).mean() < 0.03, (corners > 0.05).mean()
    # Interpolated pixels are bilinear RGB blends of the quarter corners —
    # softer than the reference's interpolate-data-then-sample on hard
    # texture edges, but never structurally wrong: the mean error stays
    # small and the median pixel is exact.
    # 64x64 on a hard checker is the softening worst case: a quarter block
    # spans ~3% of the sky here vs 0.1% at 1080p.  Production softening is
    # measured by scripts/shade_quality.py and tests/test_shade_quality.py.
    d = np.abs(dense - adap).max(axis=-1)
    assert np.median(d) < 0.01
    assert d.mean() < 0.06, d.mean()


def test_traced_only_black_mask_semantics():
    """Interpolated pixels take the block centre's terminated flag
    (cl.cl:5111-5133): inside the shadow every pixel must be black in both
    paths."""
    dense, adap = _frames("schwarzschild", anisotropy=1,
                          shade_traced_only=True)
    black_d = (dense.max(axis=-1) == 0.0)
    black_a = (adap.max(axis=-1) == 0.0)
    # Shadow interiors agree; only block-boundary pixels may differ.
    disagree = black_d != black_a
    assert disagree.mean() < 0.02, disagree.mean()


def test_prepass_kill_upsample_semantics():
    """The shift+repeat upsample must match the per-ray probe definition
    (round-indexed 5-neighbour AND) it replaced."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    W, H = 64, 48
    pw, ph = W // 16, H // 16
    dead = rng.random((ph, pw)) < 0.5
    got = np.asarray(
        pl._prepass_kill(jnp.asarray(dead), W, H, W // 2, H // 2)
    ).reshape(H // 2, W // 2)

    qx = 2.0 * np.arange(W // 2)
    qy = 2.0 * np.arange(H // 2)
    lx = np.clip(np.round(qx / W * pw).astype(int), 0, pw - 1)
    ly = np.clip(np.round(qy / H * ph).astype(int), 0, ph - 1)

    def probe(dx, dy):
        xx = np.clip(lx[None, :] + dx, 0, pw - 1)
        yy = np.clip(ly[:, None] + dy, 0, ph - 1)
        inb = ((lx[None, :] + dx >= 0) & (lx[None, :] + dx <= pw - 1)
               & (ly[:, None] + dy >= 0) & (ly[:, None] + dy <= ph - 1))
        return np.where(inb, dead[yy, xx], False)

    want = (probe(-1, 0) & probe(0, 0) & probe(1, 0) & probe(0, -1)
            & probe(0, 1))
    # Interior must match exactly; the border row/column may differ (the
    # upsample clamps instead of declaring out-of-bounds un-killable).
    assert (got[1:-1, 1:-1] == want[1:-1, 1:-1]).all()


def test_refine_budget_controller_logic():
    """Bucket selection: grow immediately, shrink only with patience."""
    from geodesic_raytracing.render.pipeline import RefineBudgetController

    c = RefineBudgetController(margin=1.3, latency=0, down_patience=3)
    assert c.fraction(0.375) == 0.375  # no data yet -> the cap
    c.observe(np.float32(0.10))  # want 0.13 -> bucket 3/16
    assert c.fraction(0.375) == 3 / 16
    c.observe(np.float32(0.40))  # want 0.52 -> bucket 3/4, grows at once
    assert c.fraction(0.375) == 0.375  # capped
    assert c.fraction(1.0) == 3 / 4
    # shrink needs down_patience consecutive low frames
    c.observe(np.float32(0.05))
    c.observe(np.float32(0.05))
    assert c.fraction(1.0) == 3 / 4
    c.observe(np.float32(0.05))
    assert c.fraction(1.0) == 1 / 8
    # demand above every bucket clamps to 1.0
    c2 = RefineBudgetController(latency=0)
    c2.observe(np.float32(0.9))
    assert c2.fraction(1.0) == 1.0


def test_refine_budget_controller_render_stream():
    """A controlled frame stream renders identically to the fixed budget
    when the settled bucket covers the frame's demand."""
    from geodesic_raytracing.render.pipeline import RefineBudgetController

    metric = metrics.get_metric("schwarzschild")
    params = metric.params()
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    b = bg.checker_background(64, 128)
    settings = pl.RenderSettings(width=64, height=64, anisotropy=2,
                                 adaptive_sampling=True,
                                 trace=TraceOptions(max_steps=2048))
    ref = np.asarray(pl.render_frame(metric, camera, params, b, settings))

    c = RefineBudgetController(latency=0)
    last = None
    for _ in range(3):
        last = pl.render_frame(metric, camera, params, b, settings,
                               controller=c)
    assert c.fraction(1.0) in c.BUCKETS
    # The settled render must stay finite and close to the full-budget one
    # (identical when demand fits the bucket; interpolated otherwise).
    last = np.asarray(last)
    assert np.isfinite(last).all()
    assert np.abs(last - ref).mean() < 0.01
