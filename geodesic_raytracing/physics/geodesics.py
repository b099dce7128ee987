"""Timelike geodesic recording, parallel transport, interpolating camera.

Behavioural twins of the reference's observer-physics kernels:
* ``get_geodesic_path`` (cl.cl:4735-4940) — integrate one ray and record
  position/velocity/ds at every committed step,
* ``parallel_transport_quantity`` (cl.cl:2569-2637) — 2nd-order (Heun)
  transport of a 4-vector along a recorded path,
* ``parallel_transport_tetrads`` (cl.cl:2639-2736) — transport all four legs
  with per-step metric re-orthonormalisation,
* ``calculate_tetrad_inverse`` (cl.cl:2534-2567) — batch 4x4 inversions,
* ``handle_interpolating_geodesic`` (cl.cl:2738-2872) — camera attached to a
  geodesic: proper-time bracket search + lerp of position/velocity/tetrads.

Shape: one ``lax.scan`` of fixed length with a valid-count (the
reference's 64,000 / 16,000 step caps, main.cpp:1230 / physics.hpp:10);
transport is a second scan over the recorded path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..metrics.base import Metric
from ..ops import geometry, integrate, tetrad
from ..ops.geometry import HIGHEST
from ..ops.integrate import Features, TraceOptions

Array = jax.Array

CAMERA_PATH_STEPS = 64000  # main.cpp:1230
OBJECT_PATH_STEPS = 16000  # physics.hpp:10


class GeodesicPath(NamedTuple):
    """A recorded geodesic as T+1 nodes (node 0 = launch point).

    ``ds[i]`` is the affine step from node i to node i+1 (0 past the end);
    ``proper_time[i]`` is the cumulative parameter at node i.
    """

    positions: Array  # (T+1, 4)
    velocities: Array  # (T+1, 4)
    ds: Array  # (T+1,) step leaving each node (last = 0)
    proper_time: Array  # (T+1,)
    count: Array  # () int32 number of valid nodes


def record_geodesic(metric: Metric, x0: Array, v0: Array, params,
                    features: Features = Features(),
                    n_steps: int = OBJECT_PATH_STEPS) -> GeodesicPath:
    """Integrate one (typically timelike) geodesic and record every committed
    step (``get_geodesic_path`` cl.cl:4735-4940).

    ``x0``/``v0`` are (4,).  The integrator is the shared adaptive Verlet
    step on a batch of one.
    """
    state = integrate.init_ray_state(
        metric, x0[None, :], v0[None, :], params, features,
        fix_null_velocity=False,
    )
    st = integrate._transpose_in(state)
    opts = TraceOptions(max_steps=n_steps)
    step = integrate.make_step_fn(metric, features, opts,
                                  jnp.abs(st.velocity[0]), with_ds=True)

    def body(s, _):
        s2, ds_arr = step(s, params)
        committed = (s2.steps > s.steps)[0]
        rec = (s2.position[:, 0], s2.velocity[:, 0], ds_arr[0], committed)
        return s2, rec

    _, (pos, vel, ds, committed) = jax.lax.scan(body, st, None,
                                                length=n_steps)
    # Node form: prepend the launch point; ds[i] leaves node i.
    x0_fixed = state.position[0]
    v0_fixed = state.velocity[0]
    pos = jnp.concatenate([x0_fixed[None], pos])
    vel = jnp.concatenate([v0_fixed[None], vel])
    ds = jnp.where(committed, ds, 0.0)
    ds = jnp.concatenate([ds, jnp.zeros((1,), dtype=ds.dtype)])
    # Rejected adaptive trials also record (duplicate) nodes, so the valid
    # range must extend to the LAST committed node, not the commit count.
    idxs = jnp.arange(1, n_steps + 1, dtype=jnp.int32)
    last = jnp.max(jnp.where(committed, idxs, 0))
    count = last + 1
    tau = jnp.concatenate(
        [jnp.zeros((1,), dtype=ds.dtype), jnp.cumsum(ds[:-1])]
    )
    return GeodesicPath(
        positions=pos, velocities=vel, ds=ds, proper_time=tau, count=count
    )


def _transport_derivative(metric: Metric, x, v, q, params):
    """dq^mu/dlambda = -Gamma^mu_ab v^a q^b along the path (cl.cl:2586)."""
    gab, dg = geometry.metric_and_partials_batched(
        metric.fn, x[:, None], params, deps=metric.depends_on
    )
    if gab.ndim == 2:  # constant metric (no batch dim emitted)
        gab = gab[..., None]
    # Mixed contraction S_n = 1/2 v^a q^b (d_a g_nb + d_b g_na - d_n g_ab).
    S = []
    for n in range(4):
        acc = jnp.zeros((1,), dtype=x.dtype)
        for a in range(4):
            for b in range(4):
                term = 0.0
                if dg[a] is not None:
                    term = term + dg[a][n, b]
                if dg[b] is not None:
                    term = term + dg[b][n, a]
                if dg[n] is not None:
                    term = term - dg[n][a, b]
                if isinstance(term, float):
                    continue
                acc = acc + 0.5 * v[a] * q[b] * term
        S.append(acc)
    S = jnp.stack(S)[:, 0]
    ginv = geometry.inverse44_batched(gab)[:, :, 0]
    return -jnp.matmul(ginv, S, precision=HIGHEST)


def parallel_transport_quantity(metric: Metric, path: GeodesicPath,
                                q0: Array, params) -> Array:
    """Transport ``q0`` (4,) along the recorded path with Heun's method
    (``parallel_transport_quantity`` cl.cl:2569-2637).  Returns (T, 4)."""

    def body(q, rec):
        x, v, xn, vn, ds, valid = rec
        k1 = _transport_derivative(metric, x, v, q, params)
        q1 = q + ds * k1
        k2 = _transport_derivative(metric, xn, vn, q1, params)
        q_next = q + 0.5 * ds * (k1 + k2)
        q_next = jnp.where(valid, q_next, q)
        return q_next, q_next

    _, qs = jax.lax.scan(
        body, q0,
        (path.positions[:-1], path.velocities[:-1],
         path.positions[1:], path.velocities[1:],
         path.ds[:-1], path.ds[:-1] > 0),
    )
    return jnp.concatenate([q0[None], qs])


def parallel_transport_tetrads(metric: Metric, path: GeodesicPath,
                               es0: Array, params) -> Array:
    """Transport a full tetrad with re-orthonormalisation at every step
    (``parallel_transport_tetrads`` cl.cl:2639-2736; the reference
    re-Gram-Schmidts against the local metric at each step, cl.cl:2707).

    ``es0`` is (4, 4) rows = legs.  Returns (T, 4, 4).
    """

    def body(es, rec):
        x, v, xn, vn, ds, valid = rec

        def transport_leg(q):
            k1 = _transport_derivative(metric, x, v, q, params)
            q1 = q + ds * k1
            k2 = _transport_derivative(metric, xn, vn, q1, params)
            return q + 0.5 * ds * (k1 + k2)

        es_n = jax.vmap(transport_leg)(es)
        gab = metric.fn(xn, params)
        es_n = tetrad._gram_schmidt_metric(es_n, gab)
        es_n = jnp.where(valid, es_n, es)
        return es_n, es_n

    _, out = jax.lax.scan(
        body, es0,
        (path.positions[:-1], path.velocities[:-1],
         path.positions[1:], path.velocities[1:],
         path.ds[:-1], path.ds[:-1] > 0),
    )
    return jnp.concatenate([es0[None], out])


def tetrad_inverses_along_path(tetrads: Array) -> Array:
    """Batch tetrad inversions (``calculate_tetrad_inverse``
    cl.cl:2534-2567).  ``tetrads`` (T, 4, 4) -> (T, 4, 4)."""
    return jax.vmap(tetrad.tetrad_inverse)(tetrads)


def interpolate_camera(path: GeodesicPath, tetrads: Array,
                       proper_time) -> tuple[Array, Array, Array]:
    """Camera riding the geodesic: find the proper-time bracket and lerp
    position, velocity and tetrads (``handle_interpolating_geodesic``
    cl.cl:2738-2872).

    Returns ``(position, velocity, tetrad)`` at the requested proper time.
    """
    tau = jnp.asarray(proper_time)
    count = jnp.maximum(path.count, 1)
    max_tau = path.proper_time[count - 1]
    tau = jnp.clip(tau, 0.0, max_tau)

    idx = jnp.searchsorted(path.proper_time, tau)
    idx = jnp.clip(idx, 1, count - 1)
    t0 = path.proper_time[idx - 1]
    t1 = path.proper_time[idx]
    frac = jnp.where(t1 > t0, (tau - t0) / (t1 - t0), 0.0)

    def lerp(a):
        return a[idx - 1] + frac * (a[idx] - a[idx - 1])

    return lerp(path.positions), lerp(path.velocities), lerp(tetrads)
