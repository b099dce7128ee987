"""Integrator physics anchors (SURVEY §4): straight lines in Minkowski,
photon-sphere capture threshold, conserved quantities on Kerr, null-norm
drift, and while/scan driver agreement."""

import jax
import jax.numpy as jnp
import numpy as np

from geodesic_raytracing import metrics
from geodesic_raytracing.ops import geometry
from geodesic_raytracing.ops.integrate import (
    ACTIVE,
    DEAD,
    ESCAPED,
    Features,
    TraceOptions,
    init_ray_state,
    trace_rays,
)


def make_rays(n, r0=7.0, angles=None):
    pos = np.tile([0.0, r0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    if angles is None:
        angles = np.linspace(0.05, 0.8, n)
    vel = np.stack(
        [
            np.ones(n),
            -np.cos(angles),
            np.zeros(n),
            np.sin(angles) / r0,
        ],
        axis=-1,
    ).astype(np.float32)
    return jnp.asarray(pos), jnp.asarray(vel)


def test_minkowski_rays_travel_straight():
    m = metrics.get_metric("minkowski")
    params = m.params()
    n = 8
    # cartesian coordinates: start at origin-ish, random directions
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos = np.zeros((n, 4), dtype=np.float32)
    pos[:, 1] = 0.5
    vel = np.concatenate([np.ones((n, 1)), dirs], axis=1).astype(np.float32)
    feats = Features.for_metric(m)
    st = init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel), params, feats)
    fin = trace_rays(m, st, params, features=feats,
                     opts=TraceOptions(max_steps=512))
    # All escape the universe sphere...
    assert np.all(np.asarray(fin.status) == ESCAPED)
    # ...and the displacement is parallel to the initial direction.
    disp = np.asarray(fin.position)[:, 1:] - pos[:, 1:]
    disp /= np.linalg.norm(disp, axis=1, keepdims=True)
    np.testing.assert_allclose(disp, dirs, atol=1e-4)


def test_schwarzschild_capture_threshold():
    """Critical impact parameter b_crit = 3*sqrt(3)/2 * rs ~ 2.598: rays
    aimed closer than that are captured (dead/black), farther escape."""
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    r0 = 7.0
    n = 24
    b_crit = 3 * np.sqrt(3) / 2
    angles = np.arcsin(
        np.linspace(0.55, 1.15, n) * b_crit * np.sqrt(1 - 1 / r0) / r0
    )
    pos, vel = make_rays(n, r0, angles)
    feats = Features.for_metric(m)
    st = init_ray_state(m, pos, vel, params, feats)
    # Exact impact parameter from the null-fixed initial state: b = L/E with
    # E = -g_tt tdot, L = g_phiphi phidot (equatorial Schwarzschild Killing
    # invariants).
    gab = np.asarray(jax.vmap(m.fn, in_axes=(0, None))(st.position, params))
    v0 = np.asarray(st.velocity)
    E = -gab[:, 0, 0] * v0[:, 0]
    L = gab[:, 3, 3] * v0[:, 3]
    b = np.abs(L / E)
    fin = trace_rays(m, st, params, features=feats,
                     opts=TraceOptions(max_steps=16384))
    status = np.asarray(fin.status)
    captured = status != ESCAPED
    # Allow a one-sample band around the threshold (fp32 + adaptive steps).
    assert np.all(captured[b < b_crit * 0.97]), (b, status)
    assert np.all(~captured[b > b_crit * 1.03]), (b, status)


def test_kerr_conserved_quantities():
    """Energy E = -g_t.v and angular momentum L = g_phi.v are Killing
    invariants along Kerr geodesics; check drift stays small."""
    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    pos, vel = make_rays(6, 7.0, np.linspace(0.35, 0.5, 6))
    feats = Features.for_metric(m)
    st = init_ray_state(m, pos, vel, params, feats)

    def invariants(state):
        x = state.position.T
        v = state.velocity.T / state.running_dlambda_dnew[None, :]
        gab = m.fn(x, params)
        E = -(gab[0, 0] * v[0] + gab[0, 1] * v[1] + gab[0, 2] * v[2]
              + gab[0, 3] * v[3])
        L = (gab[3, 0] * v[0] + gab[3, 1] * v[1] + gab[3, 2] * v[2]
             + gab[3, 3] * v[3])
        return np.asarray(E), np.asarray(L)

    E0, L0 = invariants(st)
    fin = trace_rays(m, st, params, features=feats,
                     opts=TraceOptions(max_steps=16384))
    E1, L1 = invariants(fin)
    esc = np.asarray(fin.status) == ESCAPED
    assert esc.any()
    np.testing.assert_allclose(E1[esc], E0[esc], rtol=2e-2)
    np.testing.assert_allclose(L1[esc], L0[esc], rtol=2e-2)


def test_null_norm_drift():
    """g(v, v) = 0 at init (fix_null) and stays small along the ray."""
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    pos, vel = make_rays(6, 7.0, np.linspace(0.5, 0.8, 6))
    feats = Features.for_metric(m)
    st = init_ray_state(m, pos, vel, params, feats)

    def null_norm(state):
        x = state.position.T
        v = state.velocity.T / state.running_dlambda_dnew[None, :]
        gab = m.fn(x, params)
        out = 0.0
        for i in range(4):
            for j in range(4):
                out = out + gab[i, j] * v[i] * v[j]
        return np.asarray(out)

    nn0 = null_norm(st)
    np.testing.assert_allclose(nn0, 0.0, atol=1e-5)
    fin = trace_rays(m, st, params, features=feats,
                     opts=TraceOptions(max_steps=16384))
    esc = np.asarray(fin.status) == ESCAPED
    nn1 = null_norm(fin)
    # normalise by E^2-ish scale (velocities are O(1))
    assert np.all(np.abs(nn1[esc]) < 5e-2), nn1


def test_scan_method_matches_while():
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    pos, vel = make_rays(8)
    feats = Features.for_metric(m)
    st = init_ray_state(m, pos, vel, params, feats)
    a = trace_rays(m, st, params, features=feats,
                   opts=TraceOptions(max_steps=512, method="while"))
    b = trace_rays(m, st, params, features=feats,
                   opts=TraceOptions(max_steps=512, method="scan",
                                     remat_every=64))
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    np.testing.assert_allclose(
        np.asarray(a.position), np.asarray(b.position), rtol=1e-5, atol=1e-5
    )


def test_euler_integrator_close_to_verlet():
    """step_euler parity (cl.cl:3352-3377): first-order path, same fates."""
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    pos, vel = make_rays(8, 7.0, np.linspace(0.5, 0.8, 8))
    feats = Features.for_metric(m)
    st = init_ray_state(m, pos, vel, params, feats)
    a = trace_rays(m, st, params, features=feats,
                   opts=TraceOptions(max_steps=4096))
    b = trace_rays(m, st, params, features=feats,
                   opts=TraceOptions(max_steps=4096, integrator="euler"))
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    esc = np.asarray(a.status) == ESCAPED
    np.testing.assert_allclose(
        np.asarray(a.position)[esc, 3], np.asarray(b.position)[esc, 3],
        atol=0.1,
    )


def test_kerr_frame_dragging_capture_asymmetry():
    """Frame dragging: prograde photons are captured at smaller impact
    parameters than retrograde ones.  With spin a=-0.5 the equatorial
    capture thresholds must split around the Schwarzschild b_crit."""
    m = metrics.get_metric("kerr_boyer")
    params = m.params()  # a = -0.5
    r0 = 7.0
    n = 32
    feats = Features.for_metric(m)

    def capture_fraction(sign):
        angles = sign * np.arcsin(np.linspace(0.25, 0.55, n))
        pos, vel = make_rays(n, r0, angles)
        st = init_ray_state(m, pos, vel, params, feats)
        fin = trace_rays(m, st, params, features=feats,
                         opts=TraceOptions(max_steps=16384))
        return (np.asarray(fin.status) != ESCAPED).mean()

    frac_plus = capture_fraction(+1.0)
    frac_minus = capture_fraction(-1.0)
    # One rotation sense must capture strictly more of the same |b| ladder.
    assert abs(frac_plus - frac_minus) > 0.05, (frac_plus, frac_minus)


def test_planar_mode_matches_full_4d():
    """Constant-theta planar tracing (GENERIC_CONSTANT_THETA): same fates and
    escape angles as the full 4D march for a spherically symmetric metric."""
    import dataclasses

    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.render import pipeline as pl

    m = metrics.get_metric("schwarzschild")
    cam = Camera.default().rotate(pitch=-np.pi / 2)
    feats = Features.for_metric(m)
    s4 = pl.RenderSettings(width=32, height=32, planar=False,
                           trace=TraceOptions(max_steps=4096))
    sp = dataclasses.replace(s4, planar=True)

    def rdata(settings):
        st, ku, iq = pl.init_camera_rays(m, cam, m.params(), settings, feats)
        topts = dataclasses.replace(
            settings.trace, planar=pl._planar_enabled(m, settings))
        fin = trace_rays(m, st, m.params(), features=feats, opts=topts)
        return pl.compute_render_data(m, fin, ku, m.params(), feats,
                                      inv_quat=iq)

    r4 = rdata(s4)
    rp = rdata(sp)
    t4 = np.asarray(r4.terminated)
    tp = np.asarray(rp.terminated)
    # Fates agree away from the pole column (the 4D path has pole artifacts
    # the planar path does not).
    assert (t4 == tp).mean() > 0.95
    both = (t4 == 1) & (tp == 1)
    a4 = np.asarray(r4.angles)[both]
    ap = np.asarray(rp.angles)[both]
    # compare on the unit sphere (angles wrap)
    def vec(a):
        th, ph = a[:, 0], a[:, 1]
        return np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                         np.cos(th)], -1)
    dots = np.clip((vec(a4) * vec(ap)).sum(-1), -1, 1)
    ang = np.degrees(np.arccos(dots))
    assert np.median(ang) < 1.0, np.median(ang)


def test_weak_field_deflection_angle():
    """Literature anchor: light passing a mass at impact parameter b deflects
    by ~ 2 rs / b (= 4GM/c^2 b) in the weak field."""
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    # Keep the whole path inside the uniform-step zone: the far-field step
    # growth (0.1*(r-max)) is a display-envelope optimisation, not an
    # accuracy regime.
    feats = Features.for_metric(m, universe_size=500.0,
                                max_precision_radius=500.0,
                                ambient_precision=0.5)
    r0 = 400.0
    bs = [15.0, 25.0, 40.0]
    n = len(bs)
    # Launch rays from far away along -x towards the mass, offset by b in y:
    # polar equivalent: start at (r0, pi/2, 0), velocity mostly -r with
    # angular component b/r0^2 (L/E ~ b).
    pos = np.tile([0.0, r0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    vel = np.stack(
        [np.ones(n), -np.ones(n), np.zeros(n),
         np.asarray(bs) / r0 ** 2],
        axis=-1,
    ).astype(np.float32)
    st = init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel), params, feats)
    fin = trace_rays(m, st, params, features=feats,
                     opts=TraceOptions(max_steps=16384))
    assert np.all(np.asarray(fin.status) == ESCAPED)

    def cart_dir(x, v):
        r, th, ph = x[1], x[2], x[3]
        vr, vth, vph = v[1], v[2], v[3]
        st_, ct = np.sin(th), np.cos(th)
        sp, cp = np.sin(ph), np.cos(ph)
        d = np.array([
            vr * st_ * cp + r * ct * cp * vth - r * st_ * sp * vph,
            vr * st_ * sp + r * ct * sp * vth + r * st_ * cp * vph,
            vr * ct - r * st_ * vth,
        ])
        return d / np.linalg.norm(d)

    x0 = np.asarray(st.position)
    v0 = np.asarray(st.velocity)
    x1 = np.asarray(fin.position)
    v1 = np.asarray(fin.velocity)
    for i, b in enumerate(bs):
        d0 = cart_dir(x0[i], v0[i])
        d1 = cart_dir(x1[i], v1[i])
        measured = float(np.arccos(np.clip(d0 @ d1, -1, 1)))
        # 4M/b + 15 pi M^2 / 4 b^2 with M = rs/2 = 1/2.
        expected = 2.0 / b + (15.0 * np.pi / 16.0) / b ** 2
        np.testing.assert_allclose(measured, expected, rtol=0.04,
                                   err_msg=f"b={b}")
