"""Differentiability: pixel/endpoint gradients w.r.t. metric parameters
through the integrator, validated against finite differences
(BASELINE.json north star; SURVEY §7.7)."""

import jax
import jax.numpy as jnp
import numpy as np

from geodesic_raytracing import metrics
from geodesic_raytracing.ops.integrate import (
    ESCAPED,
    Features,
    TraceOptions,
    init_ray_state,
    trace_rays,
)

OPTS = TraceOptions(max_steps=256, method="scan", remat_every=32)


def endpoint_loss(metric, params, pos, vel, feats):
    st = init_ray_state(metric, pos, vel, params, feats)
    fin = trace_rays(metric, st, params, features=feats, opts=OPTS)
    # Smooth observable: mean final phi weighted by escape mask (the mask
    # itself is non-differentiable, but fixed at the evaluation point).
    esc = (fin.status == ESCAPED).astype(jnp.float32)
    return jnp.sum(fin.position[:, 3] * esc) / jnp.maximum(jnp.sum(esc), 1.0)


def test_grad_wrt_mass_matches_fd():
    m = metrics.get_metric("schwarzschild")
    feats = Features.for_metric(m)
    n = 8
    ang = np.linspace(0.5, 0.9, n)
    pos = jnp.asarray(
        np.tile([0.0, 7.0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    )
    vel = jnp.asarray(
        np.stack(
            [np.ones(n), -np.cos(ang), np.zeros(n), np.sin(ang) / 7.0], -1
        ).astype(np.float32)
    )

    def loss(rs):
        return endpoint_loss(m, {"rs": rs}, pos, vel, feats)

    g = jax.grad(loss)(jnp.float32(1.0))
    eps = 1e-3
    fd = (loss(jnp.float32(1.0 + eps)) - loss(jnp.float32(1.0 - eps))) / (
        2 * eps
    )
    assert np.isfinite(float(g))
    # Deflection increases with mass; gradient must be significant and match
    # the finite difference within fp32 integration noise.
    np.testing.assert_allclose(float(g), float(fd), rtol=0.15)
    assert abs(float(g)) > 1e-3


def test_grad_wrt_kerr_spin_finite():
    m = metrics.get_metric("kerr_boyer")
    feats = Features.for_metric(m)
    n = 4
    ang = np.linspace(0.55, 0.8, n)
    pos = jnp.asarray(
        np.tile([0.0, 7.0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    )
    vel = jnp.asarray(
        np.stack(
            [np.ones(n), -np.cos(ang), np.zeros(n), np.sin(ang) / 7.0], -1
        ).astype(np.float32)
    )

    def loss(a):
        return endpoint_loss(m, {"rs": jnp.float32(1.0), "a": a}, pos, vel,
                             feats)

    g = jax.grad(loss)(jnp.float32(-0.5))
    eps = 2e-3
    fd = (loss(jnp.float32(-0.5 + eps)) - loss(jnp.float32(-0.5 - eps))) / (
        2 * eps
    )
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=0.2, atol=5e-3)


def test_grad_wrt_camera_pose():
    """North-star: pixel observables differentiate w.r.t. camera pose too.
    Gradient of the mean escape angle w.r.t. the camera radius vs FD."""
    import dataclasses

    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.render import pipeline as pl

    m = metrics.get_metric("schwarzschild")
    feats = Features.for_metric(m)
    settings = pl.RenderSettings(
        width=8, height=8, planar=False,
        trace=TraceOptions(max_steps=192, method="scan", remat_every=32),
    )
    params = m.params()

    def loss(cam_r):
        cam = Camera.default().rotate(pitch=-np.pi / 2)
        cam = cam._replace(
            polar_position=cam.polar_position.at[1].set(cam_r)
        )
        st, ku, _ = pl.init_camera_rays(m, cam, params, settings, feats)
        fin = trace_rays(m, st, params, features=feats, opts=settings.trace)
        esc = (fin.status == ESCAPED).astype(jnp.float32)
        return jnp.sum(fin.position[:, 3] * esc) / jnp.maximum(
            jnp.sum(esc), 1.0
        )

    g = jax.grad(loss)(jnp.float32(7.0))
    eps = 1e-2
    fd = (loss(jnp.float32(7.0 + eps)) - loss(jnp.float32(7.0 - eps))) / (
        2 * eps
    )
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=0.15, atol=1e-4)


def test_grad_wrt_alcubierre_velocity_matches_fd():
    """North-star config 5: gradients through the warp-drive metric
    (grads w.r.t. the bubble velocity parameter vs finite differences).

    Also a regression test for the sqrt(0) NaN in the step controller's
    error norm: Alcubierre is EXACTLY flat outside the bubble (acc == 0),
    which used to NaN every reverse-mode gradient.

    The adaptive integrator's committed step SEQUENCE is discontinuous in
    params, so FD is only meaningful for rays whose step count is stable
    under the probe; the test validates per-ray on the FD-consistent rays
    (two probe sizes agreeing) and requires a quorum.
    """
    m = metrics.get_metric("alcubierre")
    feats = Features.for_metric(m)
    n = 6
    # Rays passing near (but outside) the bubble wall at the origin.
    off = np.linspace(2.5, 4.0, n)
    pos = jnp.asarray(
        np.stack([np.zeros(n), np.full(n, 8.0), off, np.zeros(n)], -1)
        .astype(np.float32)
    )
    vel = jnp.asarray(
        np.stack([np.ones(n), -np.ones(n), np.zeros(n), np.zeros(n)], -1)
        .astype(np.float32)
    )
    base = dict(m.params())

    def endpoints(v):
        p = dict(base)
        p["velocity"] = v
        st = init_ray_state(m, pos, vel, p, feats)
        fin = trace_rays(m, st, p, features=feats, opts=OPTS)
        return fin.position[:, 2]

    g = np.asarray(jax.jacrev(endpoints)(jnp.float32(2.0)))
    assert np.isfinite(g).all()

    def fd(eps):
        hi = np.asarray(endpoints(jnp.float32(2.0 + eps)))
        lo = np.asarray(endpoints(jnp.float32(2.0 - eps)))
        return (hi - lo) / (2 * eps)

    fd1, fd2 = fd(1e-2), fd(5e-3)
    stable = np.abs(fd1 - fd2) <= 0.05 * np.maximum(
        np.abs(fd1), np.abs(fd2)
    )
    assert stable.sum() >= 2, f"no FD-stable rays ({fd1} vs {fd2})"
    np.testing.assert_allclose(g[stable], fd1[stable], rtol=0.15)


def test_grad_wrt_double_unequal_kerr_mass_matches_fd():
    """North-star config 5: gradients through the double unequal Kerr
    superposition w.r.t. one hole's mass."""
    m = metrics.get_metric("double_unequal_kerr")
    feats = Features.for_metric(m)
    n = 6
    ang = np.linspace(0.5, 0.9, n)
    pos = jnp.asarray(
        np.tile([0.0, 10.0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    )
    vel = jnp.asarray(
        np.stack(
            [np.ones(n), -np.cos(ang), np.zeros(n), np.sin(ang) / 10.0], -1
        ).astype(np.float32)
    )
    base = dict(m.params())

    def loss(m1):
        p = dict(base)
        p["m1"] = m1
        st = init_ray_state(m, pos, vel, p, feats)
        fin = trace_rays(m, st, p, features=feats, opts=OPTS)
        esc = (fin.status == ESCAPED).astype(jnp.float32)
        return jnp.sum(fin.position[:, 3] * esc) / jnp.maximum(
            jnp.sum(esc), 1.0
        )

    g = jax.grad(loss)(jnp.float32(0.15))
    eps = 2e-3
    fd = (loss(jnp.float32(0.15 + eps)) - loss(jnp.float32(0.15 - eps))) / (
        2 * eps
    )
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=0.2, atol=5e-3)


def test_soft_lyapunov_window_grad_matches_fd():
    """The Lyapunov-weighted training loss (soft step-cap decay instead of
    a hard exclusion, mesh.make_train_step) is a plain weighted L2 with
    stop-gradient weights — its autodiff gradient must match the finite
    difference of the SAME loss, with shadow-edge pixels (past the soft
    cap) contributing."""
    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.fit import _render_target
    from geodesic_raytracing.parallel.mesh import make_train_step, ray_mesh
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render import pipeline as pl

    from conftest import tier

    m = metrics.get_metric("schwarzschild")
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(64, 128)
    mesh = ray_mesh(jax.devices()[:1])
    settings = pl.RenderSettings(
        width=tier(32, 48), height=tier(32, 48),
        trace=TraceOptions(max_steps=tier(384, 512), method="scan",
                           remat_every=64),
    )
    feats = Features.for_metric(m)
    step = make_train_step(m, mesh, settings, feats, grad_step_cap=128)
    target = _render_target(m, camera, m.params(rs=1.05), backgrounds,
                            settings, feats, grad_step_cap=128)

    frozen = m.params(rs=1.0)

    def loss_at(rs):
        # Freeze the probe at the evaluation point: the probe's discrete
        # masks/weights are stop-gradient constants for autodiff, so the FD
        # must hold them constant too.
        loss, _ = step.loss_and_grad(m.params(rs=rs), camera, target,
                                     backgrounds, probe_params=frozen)
        return float(loss)

    loss0, g = step.loss_and_grad(m.params(rs=1.0), camera, target,
                                  backgrounds)
    g = float(g["rs"])
    assert np.isfinite(g) and abs(g) > 1e-6
    eps = 2e-3
    fd = (loss_at(1.0 + eps) - loss_at(1.0 - eps)) / (2 * eps)
    # The adaptive integrator's committed step sequence is discontinuous in
    # params, so FD carries noise; the weighted loss must still agree.
    np.testing.assert_allclose(g, fd, rtol=0.2)


def test_grad_finite_with_dead_rays():
    """Rays that die mid-trace (horizon capture, blowup kill) must not
    poison the backward sweep: the integrator freezes a dying ray at its
    last FINITE state (the trial-state probe runs before the commit), so
    the remat-scan VJP stays NaN-free even when ~10% of the batch dies.
    Regression for the pre-commit finiteness probe in make_step_fn."""
    import dataclasses

    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.ops import integrate
    from geodesic_raytracing.render import pipeline as pl

    metric = metrics.get_metric("kerr_boyer")
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    feats = Features.for_metric(metric)
    settings = pl.RenderSettings(
        width=32, height=32, adaptive_sampling=False,
        trace=TraceOptions(max_steps=2048, method="scan", remat_every=128),
    )

    def trace(params):
        st, ku, _ = pl.init_camera_rays(
            metric, camera, params,
            dataclasses.replace(settings, planar=False), feats,
        )
        return integrate.trace_rays(metric, st, params, features=feats,
                                    opts=settings.trace)

    params = metric.params()
    fin = trace(params)
    s = np.asarray(fin.status)
    assert (s == integrate.DEAD).sum() > 50, s  # the config must kill rays
    assert np.all(np.isfinite(np.asarray(fin.position)))
    assert np.all(np.isfinite(np.asarray(fin.velocity)))

    def loss(params):
        fin = trace(params)
        ok = (fin.status == ESCAPED)[:, None]
        val = jnp.where(ok, fin.velocity[:, 1:3], 0.0)
        return jnp.sum(val ** 2)

    g = jax.grad(loss)(params)
    for k, v in g.items():
        assert np.isfinite(float(v)), (k, v)
