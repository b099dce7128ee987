"""Catalogue-wide sanity: every metric evaluates to a finite symmetric (4,4)
with Lorentzian signature at a generic point, and its coordinate transforms
round-trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import geodesic_raytracing as grt
from geodesic_raytracing.metrics import REGISTRY, get_metric

# A generic probe point per coordinate system, away from horizons/axes.
PROBE = {
    "X_Y_THETA_PHI": jnp.array([0.3, 5.1, 1.1, 0.7]),
    "CARTESIAN": jnp.array([0.3, 3.1, 2.2, 1.7]),
    "CYLINDRICAL": jnp.array([0.3, 3.7, 0.9, 1.3]),
    "OTHER": None,  # per-metric below
}

OTHER_PROBES = {
    "krasnikov_cylindrical": jnp.array([0.3, 3.7, 0.9, 1.3]),
    "misner_4d": jnp.array([-1.5, 0.4, 1.2, 0.8]),
    "kerr_rational_polynomial": jnp.array([0.3, 5.1, 0.45, 0.7]),
}


def probe_for(m):
    if m.name in OTHER_PROBES:
        return OTHER_PROBES[m.name]
    return PROBE[m.config.coordinate_system]


def test_registry_has_all_31_metrics():
    # One per reference scripts/*.js (31 metric scripts in the snapshot).
    assert len(REGISTRY) == 31, sorted(REGISTRY)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_metric_evaluates(name):
    m = get_metric(name)
    x = probe_for(m)
    g = m.g(x, m.params())
    assert g.shape == (4, 4)
    gn = np.asarray(g)
    assert np.all(np.isfinite(gn)), gn
    np.testing.assert_allclose(gn, gn.T, rtol=1e-5, atol=1e-6)
    # Lorentzian signature: exactly one negative eigenvalue.
    eigs = np.linalg.eigvalsh(np.asarray(gn, dtype=np.float64))
    assert (eigs < 0).sum() == 1, eigs


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_metric_partials_finite(name):
    m = get_metric(name)
    x = probe_for(m)
    from geodesic_raytracing.ops.geometry import metric_and_partials

    g, dg = metric_and_partials(m.fn, x, m.params())
    assert np.all(np.isfinite(np.asarray(dg))), name


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_coordinate_roundtrip(name):
    """to_polar(from_polar(x)) == x for metrics with invertible transforms.

    The ingoing-EF-variable pair deliberately never round-trips the time
    coordinate (scripts/coordinates/polar_to_ingoing_ef_variable.js), and the
    misner pair is multivalued; spatial coordinates must still round-trip.
    """
    m = get_metric(name)
    params = m.params()
    polar = jnp.array([0.2, 6.3, 1.2, 0.9])
    generic = m.from_polar(polar, params)
    back = m.to_polar(generic, params)
    if name == "misner_4d":
        pytest.skip("misner map is multivalued in (T, phi)")
    np.testing.assert_allclose(
        np.asarray(back)[1:], np.asarray(polar)[1:], rtol=2e-4, atol=2e-4
    )


def test_schwarzschild_against_closed_form():
    m = get_metric("schwarzschild")
    x = jnp.array([0.0, 4.0, jnp.pi / 3, 0.5])
    g = m.g(x, m.params(rs=1.0))
    r = 4.0
    np.testing.assert_allclose(g[0, 0], -(1 - 1 / r), rtol=1e-6)
    np.testing.assert_allclose(g[1, 1], 1 / (1 - 1 / r), rtol=1e-6)
    np.testing.assert_allclose(g[2, 2], r * r, rtol=1e-6)
    np.testing.assert_allclose(
        g[3, 3], r * r * np.sin(np.pi / 3) ** 2, rtol=1e-6
    )


def test_kerr_reduces_to_schwarzschild_at_zero_spin():
    kerr = get_metric("kerr_boyer")
    schw = get_metric("schwarzschild")
    x = jnp.array([0.0, 4.0, 1.1, 0.7])
    gk = kerr.g(x, kerr.params(a=0.0))
    gs = schw.g(x, schw.params())
    np.testing.assert_allclose(np.asarray(gk), np.asarray(gs), atol=1e-5)


def test_kerr_schild_reduces_to_schwarzschild_metric_distance():
    """Kerr-Schild at a=0 is Schwarzschild in Eddington-Finkelstein-like
    cartesian form; check g_tt agrees with 1 - rs/r."""
    ks = get_metric("kerr_schild")
    x = jnp.array([0.0, 3.0, 0.0, 4.0])  # r = 5
    g = ks.g(x, ks.params(a=0.0))
    np.testing.assert_allclose(g[0, 0], -(1 - 1.0 / 5.0), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_structure_claims(name):
    """Metric.nonzeros() must cover every actually-nonzero entry, and the
    structure-pruned inverse + geodesic acceleration must match the dense
    paths (the trace-time zero pruning in ops.geometry)."""
    from geodesic_raytracing.ops import geometry

    m = get_metric(name)
    nz = m.nonzeros()
    x = probe_for(m)
    params = m.params()
    # batched probe: the point plus jittered copies (catches accidental
    # zeros at a special point)
    rng = np.random.default_rng(7)
    xs = jnp.asarray(
        np.asarray(x)[:, None]
        + 0.05 * rng.standard_normal((4, 8)).astype(np.float32)
    )
    gab = m.fn(xs, params)
    if gab.ndim == 2:
        gab = gab[..., None]
    gn = np.asarray(gab)
    if nz is not None:
        for i in range(4):
            for j in range(i, 4):
                if (i, j) not in nz:
                    assert np.max(np.abs(gn[i, j])) < 1e-7, (
                        f"{name} has nonzero g[{i},{j}] outside declared "
                        f"structure {sorted(nz)}"
                    )
        ginv_s = np.asarray(geometry.inverse44_sym_batched(gab, nz))
        ginv_d = np.asarray(geometry.inverse44_sym_batched(gab))
        np.testing.assert_allclose(ginv_s, ginv_d, rtol=2e-5, atol=1e-6)

    vs = jnp.asarray(rng.standard_normal((4, 8)).astype(np.float32))
    acc_s = np.asarray(geometry.acceleration_batched(
        m.fn, xs, vs, params, deps=m.depends_on, nz=nz))
    acc_d = np.asarray(geometry.acceleration_batched(
        m.fn, xs, vs, params, deps=m.depends_on, nz=None))
    assert np.all(np.isfinite(acc_s)), name
    np.testing.assert_allclose(acc_s, acc_d, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_depends_on_claims(name):
    """The declared dependency set must cover every coordinate the metric
    actually varies with (finite-difference probe)."""
    m = get_metric(name)
    x = probe_for(m)
    params = m.params()
    eps = 1e-3
    g0 = np.asarray(m.g(x, params), dtype=np.float64)
    for c in range(4):
        dx = jnp.zeros(4).at[c].set(eps)
        g1 = np.asarray(m.g(x + dx, params), dtype=np.float64)
        varies = np.max(np.abs(g1 - g0)) > 1e-5
        if c not in m.depends_on:
            assert not varies, (
                f"{name} varies with coordinate {c} but depends_on="
                f"{m.depends_on}"
            )


def test_rank1_decomposition_matches_fn():
    """Metric.rank1 (Kerr-Schild fast path): fn == minkowski_plus(f, l),
    l is eta-null, and the Sherman-Morrison acceleration matches the dense
    path (VERDICT r3 item 5)."""
    import jax
    import jax.numpy as jnp

    from geodesic_raytracing.metrics.base import minkowski_plus
    from geodesic_raytracing.ops import geometry

    rng = np.random.default_rng(7)
    for name in ("kerr_schild", "kerr_newman_schild"):
        m = get_metric(name)
        assert m.rank1 is not None
        params = m.params()
        n = 64
        x = jnp.asarray(
            rng.uniform(-8, 8, size=(4, n)).astype(np.float32))
        # keep away from the ring singularity
        r2 = x[1] ** 2 + x[2] ** 2 + x[3] ** 2
        x = x.at[1].set(jnp.where(r2 < 4.0, x[1] + 4.0, x[1]))
        v = jnp.asarray(
            rng.uniform(-1, 1, size=(4, n)).astype(np.float32))

        f, lv = m.rank1(x, params)
        g_dec = minkowski_plus(f, lv)
        g_fn = m.fn(x, params)
        np.testing.assert_allclose(np.asarray(g_dec), np.asarray(g_fn),
                                   rtol=1e-6, atol=1e-6)
        # eta-nullness of l (the Sherman-Morrison denominator assumption)
        eta_ll = -lv[0] ** 2 + lv[1] ** 2 + lv[2] ** 2 + lv[3] ** 2
        np.testing.assert_allclose(np.asarray(eta_ll), 0.0, atol=2e-5)

        a_fast = geometry.acceleration_batched_rank1(m.rank1, x, v, params)
        a_dense = geometry.acceleration_batched(
            m.fn, x, v, params, deps=m.depends_on, nz=m.nonzeros())
        af, ad = np.asarray(a_fast), np.asarray(a_dense)
        scale = np.maximum(np.abs(ad).max(axis=0), 1e-3)
        np.testing.assert_allclose(af / scale, ad / scale, atol=2e-3,
                                   err_msg=name)


def test_rank1_render_matches_dense(tmp_path):
    """End-to-end: a small kerr_schild frame with the rank-1 fast path
    matches a dense-path render (fates exact, image close)."""
    import dataclasses

    import jax.numpy as jnp

    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.ops.integrate import Features, TraceOptions
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render.pipeline import (RenderSettings,
                                                         render_frame)

    m = get_metric("kerr_schild")
    dense = dataclasses.replace(m, name="kerr_schild_dense", rank1=None)
    cam = Camera.default().rotate(pitch=-np.pi / 2)
    settings = RenderSettings(width=48, height=48, anisotropy=1,
                              adaptive_sampling=False,
                              trace=TraceOptions(max_steps=3000))
    backgrounds = bg.checker_background()
    imgs = {}
    for mm in (m, dense):
        params = mm.params()
        imgs[mm.name] = np.asarray(render_frame(
            mm, cam, params, backgrounds, settings, Features.for_metric(mm)))
    d = np.abs(imgs["kerr_schild"] - imgs["kerr_schild_dense"])
    # chaotic shadow-edge pixels may flip; the bulk must agree
    assert (d > 0.1).mean() < 0.02, (d > 0.1).mean()
