"""Quantitative parity anchors: rendered shadow edges vs closed-form GR.

The reference documents its validation anchors as external images (Kerr
reference picture main.cpp:49, Alcubierre figure main.cpp:106).  Those
URLs are unfetchable here, but the underlying physics is exact: a Kerr
photon with equatorial impact parameter b = L/E is captured iff its
radial potential R(r) = ((r^2+a^2) - b a)^2 - Delta (b-a)^2 stays
positive between the horizon and the observer (Bardeen 1973).  These
tests render the production pipeline, locate the shadow edge on the
equatorial scanline, recover each edge ray's conserved b from its initial
state with an independent float64 metric, and assert the rendered edge
brackets the analytic critical impact parameter — validating camera
tetrad + integrator + pipeline against theory to sub-pixel accuracy.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from geodesic_raytracing import metrics
from geodesic_raytracing.camera import Camera
from geodesic_raytracing.ops.integrate import Features, TraceOptions
from geodesic_raytracing.render import background as bg
from geodesic_raytracing.render import pipeline as pl
from geodesic_raytracing.render.pipeline import RenderSettings, render_frame

# Fast tier renders 128^2 (edge brackets are pixel-relative, so the
# analytic assertions hold at any resolution); SUITE_FULL=1 restores the
# 192^2 renders (sharper brackets, ~3x the CPU time).
from conftest import tier  # noqa: E402

W = H = tier(128, 192)
R_CAM = 7.0


def kerr_metric_np(r, th, rs, a):
    """Boyer-Lindquist Kerr metric, independent float64 (numpy only)."""
    M = rs / 2.0
    ct, st = np.cos(th), np.sin(th)
    sigma = r * r + a * a * ct * ct
    delta = r * r - 2 * M * r + a * a
    g = np.zeros((4, 4))
    g[0, 0] = -(1.0 - 2 * M * r / sigma)
    g[1, 1] = sigma / delta
    g[2, 2] = sigma
    g[3, 3] = (r * r + a * a + 2 * M * r * a * a * st * st / sigma) * st * st
    g[0, 3] = g[3, 0] = -2 * M * r * a * st * st / sigma
    return g


def captured(b, M, a, r0):
    """True if an equatorial photon with impact parameter b, falling in
    from r0, reaches the horizon (no turning point: R(r) > 0 throughout)."""
    r_h = M + np.sqrt(max(M * M - a * a, 0.0))
    r = np.linspace(r_h * (1 + 1e-5), r0, 40001)
    R = ((r * r + a * a) - b * a) ** 2 - (r * r - 2 * M * r + a * a) * (
        b - a) ** 2
    return bool((R > 0).all())


def critical_b(M, a, r0):
    """(b_minus, b_plus): the capture interval's endpoints by bisection."""
    out = []
    for sgn in (-1.0, 1.0):
        lo, hi = 0.0, 12.0 * M  # captured at b=0; escapes by 12M
        assert captured(sgn * lo, M, a, r0)
        assert not captured(sgn * hi, M, a, r0)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if captured(sgn * mid, M, a, r0):
                lo = mid
            else:
                hi = mid
        out.append(sgn * 0.5 * (lo + hi))
    return out[0], out[1]


def _midrow_b_and_angle(metric, camera, params, settings, rs, a):
    """Conserved b = p_phi / (-p_t) and gnomonic view angle for every
    pixel of the equatorial scanline, via the pipeline's own ray init and
    an independent float64 metric."""
    position, es = pl.camera_frame(metric, camera, params)
    cy = jnp.full((W,), H / 2.0, jnp.float32)
    cx = jnp.arange(W, dtype=jnp.float32)
    state, _, _ = pl.rays_for_pixels(
        metric, camera, position, es, params, settings,
        Features.for_metric(metric), cx, cy, planar=False)
    pos = np.asarray(position, np.float64)
    v = np.asarray(state.velocity, np.float64)  # (W, 4), BL components
    # the scanline must be equatorial: no polar motion
    assert np.abs(v[:, 2]).max() < 1e-4 * np.abs(v).max()
    g = kerr_metric_np(pos[1], pos[2], rs, a)
    p = v @ g  # p_mu
    b = p[:, 3] / (-p[:, 0])
    f_stop = (W / 2) / np.tan(np.deg2rad(settings.fov_degrees) / 2)
    chi = np.arctan((np.arange(W) - W / 2.0) / f_stop)
    return b, chi


def _shadow_cols(img):
    """Column indices of the equatorial scanline that are shadow-black."""
    row = np.asarray(img)[H // 2]
    return np.where(row.sum(-1) < 1e-4)[0]


def _render(name, params):
    metric = metrics.get_metric(name)
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    settings = RenderSettings(width=W, height=H, anisotropy=4,
                              trace=TraceOptions(max_steps=8192))
    img = render_frame(metric, camera, params, bg.checker_background(),
                       settings, Features.for_metric(metric))
    return metric, camera, settings, img


def _check_edges(name, rs, a):
    params = {"rs": rs, "a": a} if a is not None else {"rs": rs}
    metric, camera, settings, img = _render(name, params)
    cols = _shadow_cols(img)
    assert cols.size > 4, "no shadow on the equatorial scanline"
    assert np.all(np.diff(cols) == 1), "shadow not contiguous (speckle)"
    b, chi = _midrow_b_and_angle(metric, camera, params, settings,
                                 rs, a or 0.0)
    M = rs / 2.0
    b_lo, b_hi = critical_b(M, a or 0.0, R_CAM)
    # the capture interval's endpoints must each fall between the last
    # shadow pixel's b and its first non-shadow neighbour's
    edges = [(cols[0] - 1, cols[0]), (cols[-1], cols[-1] + 1)]
    crit = sorted((b_lo, b_hi))
    got = sorted(
        (min(b[i], b[j]) - 1e-9, max(b[i], b[j]) + 1e-9) for i, j in edges)
    for (lo, hi), bc in zip(got, crit):
        assert lo <= bc <= hi, (
            f"{name}: analytic critical b {bc:.4f} outside rendered edge "
            f"bracket [{lo:.4f}, {hi:.4f}]")
    return cols, b, chi, M, settings


def test_schwarzschild_shadow_impact_parameter():
    """Schwarzschild shadow edge must bracket b_c = 3 sqrt(3) M, and the
    rendered angular radius must match sin(alpha) =
    b_c sqrt(1 - rs/r0) / r0 (exact for a static observer) to a pixel."""
    rs = 1.0
    cols, b, chi, M, settings = _check_edges("schwarzschild", rs, None)
    b_c = 3 * np.sqrt(3) * M
    b_lo, b_hi = critical_b(M, 0.0, R_CAM)
    assert abs(b_lo + b_c) < 2e-3 and abs(b_hi - b_c) < 2e-3
    alpha = np.arcsin(b_c * np.sqrt(1 - rs / R_CAM) / R_CAM)
    # ~coarse pixel scale from the ACTUAL render fov
    px_step = np.deg2rad(settings.fov_degrees) / W
    for edge in (cols[0], cols[-1]):
        assert abs(abs(chi[edge]) - alpha) < 2.5 * px_step, (
            np.rad2deg(abs(chi[edge])), np.rad2deg(alpha))


def test_kerr_shadow_impact_parameters():
    """Kerr a/M = 0.9: the D-shaped shadow's equatorial edges must bracket
    the two analytic critical impact parameters (asymmetric: frame
    dragging shrinks the prograde side)."""
    cols, b, chi, M, _ = _check_edges("kerr_boyer", 1.0, -0.45)
    b_lo, b_hi = critical_b(M, -0.45, R_CAM)
    # sanity on the anchor itself: strongly asymmetric capture interval
    assert abs(abs(b_lo) - abs(b_hi)) > 0.8 * M, (b_lo, b_hi)


def test_kerr_shadow_spin_dependence():
    """The rendered shadow must track the analytic spin dependence: the
    extremal flagship default (a = -0.5) shifts the shadow centre by a
    measurably different amount than a = -0.25."""
    widths = {}
    centres = {}
    for a in (-0.5, -0.25):
        _, _, _, img = _render("kerr_boyer", {"rs": 1.0, "a": a})
        cols = _shadow_cols(img)
        widths[a] = cols.size
        centres[a] = cols.mean()
    # analytic: capture-interval width and centre from critical b
    for a in (-0.5, -0.25):
        b_lo, b_hi = critical_b(0.5, a, R_CAM)
        widths[(a, "analytic")] = b_hi - b_lo
        centres[(a, "analytic")] = 0.5 * (b_lo + b_hi)
    # higher spin -> more asymmetric (centre farther from b = 0), both in
    # the analytic prediction and the render
    assert abs(centres[(-0.5, "analytic")]) > abs(
        centres[(-0.25, "analytic")])
    assert abs(centres[-0.5] - W / 2) > abs(centres[-0.25] - W / 2)
