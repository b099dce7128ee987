"""Observer physics: geodesic recording, parallel transport, interpolating
camera (reference cl.cl:2534-2872, 4735-4940)."""

import jax
import jax.numpy as jnp
import numpy as np

from geodesic_raytracing import metrics
from geodesic_raytracing.ops import geometry, tetrad
from geodesic_raytracing.ops.integrate import Features
from geodesic_raytracing.physics import (
    interpolate_camera,
    parallel_transport_quantity,
    parallel_transport_tetrads,
    record_geodesic,
    tetrad_inverses_along_path,
)


def make_infall():
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    x0 = jnp.array([0.0, 8.0, jnp.pi / 2, 0.0])
    gab = m.fn(x0, params)
    es, _ = tetrad.frame_basis(gab)
    # Observer initially at rest: u = e0.
    v0 = es[0]
    return m, params, x0, v0, es


def test_record_geodesic_falls_inward():
    m, params, x0, v0, es = make_infall()
    feats = Features.for_metric(m)
    path = record_geodesic(m, x0, v0, params, feats, n_steps=512)
    count = int(path.count)
    assert count > 10
    r = np.asarray(path.positions)[:count, 1]
    # Free fall from rest: r strictly decreases.
    assert r[5] < 8.0
    assert np.all(np.diff(r[:count][r[:count] > 1.05]) < 1e-5)


def test_timelike_norm_preserved_along_path():
    m, params, x0, v0, es = make_infall()
    feats = Features.for_metric(m)
    path = record_geodesic(m, x0, v0, params, feats, n_steps=512)
    count = int(path.count)
    xs = path.positions[:count]
    vs = path.velocities[:count]
    gab = jax.vmap(m.fn, in_axes=(0, None))(xs, params)
    norm = np.asarray(jnp.einsum("tab,ta,tb->t", gab, vs, vs))
    # Check away from the horizon plunge (the reference's recorder also runs
    # until the ray dies at r -> rs, where coordinates degenerate).
    ok = np.asarray(xs)[:, 1] > 1.5
    assert ok.sum() > 20
    np.testing.assert_allclose(norm[ok], -1.0, atol=5e-2)


def test_parallel_transport_preserves_inner_products():
    m, params, x0, v0, es = make_infall()
    feats = Features.for_metric(m)
    path = record_geodesic(m, x0, v0, params, feats, n_steps=256)
    count = int(path.count)

    q0 = es[1]  # spacelike unit vector
    qs = parallel_transport_quantity(m, path, q0, params)
    xs = path.positions[:count]
    gab = jax.vmap(m.fn, in_axes=(0, None))(xs, params)
    ok = np.asarray(xs)[:, 1] > 2.0
    assert ok.sum() > 20
    norms = np.asarray(
        jnp.einsum("tab,ta,tb->t", gab, qs[:count], qs[:count])
    )
    # g(q, q) = +1 preserved by parallel transport (away from the horizon).
    np.testing.assert_allclose(norms[ok], 1.0, atol=5e-2)
    # g(q, u) = 0 preserved.
    dots = np.asarray(
        jnp.einsum("tab,ta,tb->t", gab, qs[:count], path.velocities[:count])
    )
    np.testing.assert_allclose(dots[ok], 0.0, atol=5e-2)


def test_transported_tetrads_stay_orthonormal():
    m, params, x0, v0, es = make_infall()
    feats = Features.for_metric(m)
    path = record_geodesic(m, x0, v0, params, feats, n_steps=256)
    count = int(path.count)
    tets = parallel_transport_tetrads(m, path, es, params)
    xs = path.positions[:count]
    gab = jax.vmap(m.fn, in_axes=(0, None))(xs, params)
    eta = jnp.einsum("tab,tia,tjb->tij", gab, tets[:count], tets[:count])
    target = np.diag([-1.0, 1.0, 1.0, 1.0])
    np.testing.assert_allclose(
        np.asarray(eta), np.broadcast_to(target, (count, 4, 4)), atol=5e-2
    )


def test_tetrad_inverses_along_path():
    m, params, x0, v0, es = make_infall()
    feats = Features.for_metric(m)
    path = record_geodesic(m, x0, v0, params, feats, n_steps=64)
    tets = parallel_transport_tetrads(m, path, es, params)
    invs = tetrad_inverses_along_path(tets)
    prod = jnp.einsum("tij,tjk->tik", invs[:32], tets.transpose(0, 2, 1)[:32])
    np.testing.assert_allclose(
        np.asarray(prod), np.broadcast_to(np.eye(4), (32, 4, 4)), atol=1e-2
    )


def test_interpolate_camera_brackets():
    m, params, x0, v0, es = make_infall()
    feats = Features.for_metric(m)
    path = record_geodesic(m, x0, v0, params, feats, n_steps=512)
    tets = parallel_transport_tetrads(m, path, es, params)
    count = int(path.count)
    mid_tau = float(path.proper_time[count // 2])
    pos, vel, tet = interpolate_camera(path, tets, mid_tau)
    # Interpolated position lies between recorded neighbours.
    r = float(pos[1])
    rs = np.asarray(path.positions)[:count, 1]
    assert rs.min() - 1e-3 <= r <= rs.max() + 1e-3
    assert np.isfinite(np.asarray(tet)).all()
