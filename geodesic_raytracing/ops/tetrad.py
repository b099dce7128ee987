"""Tetrad (orthonormal frame) machinery.

Behavioural twin of the reference's frame-basis suite (cl.cl:1598-2224):
metric Gram-Schmidt over the coordinate basis, discovery of which resulting
vector is timelike with index swapping, tetrad<->coordinate maps, tetrad
inversion, and the Lorentz boost of arXiv:2404.05744.

Design note: the reference's data-dependent ``SWAP`` gymnastics
(cl.cl:1761-1883) become permutation gathers here so the whole construction
vmaps over batches of events (needed because the redshift pass builds a fresh
tetrad at every terminated ray's endpoint, cl.cl:5187).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .geometry import HIGHEST, _inverse44, dot_g

Array = jax.Array


def _gram_schmidt_metric(vs: Array, gab: Array) -> Array:
    """Metric Gram-Schmidt of 4 row vectors ``vs[i]`` (cl.cl:1645-1674).

    Uses g-inner products; normalisation divides by sqrt(|g(u,u)|) so timelike
    vectors normalise to g(u,u) = -1.
    """
    def proj(u, v):
        return (dot_g(gab, u, v) / dot_g(gab, u, u)) * u

    u0 = vs[0]
    u1 = vs[1] - proj(u0, vs[1])
    u2 = vs[2] - proj(u0, vs[2]) - proj(u1, vs[2])
    u3 = vs[3] - proj(u0, vs[3]) - proj(u1, vs[3]) - proj(u2, vs[3])

    def norm(u):
        return u / jnp.sqrt(jnp.abs(dot_g(gab, u, u)))

    return jnp.stack([norm(u0), norm(u1), norm(u2), norm(u3)])


def local_minkowski(es: Array, gab: Array) -> Array:
    """eta_ab = g_uv e_a^u e_b^v (reference ``get_local_minkowski``
    cl.cl:1688-1711)."""
    return jnp.einsum("uv,au,bv->ab", gab, es, es, precision=HIGHEST)


def which_timelike(es: Array, gab: Array) -> Array:
    """Index of the tetrad vector with the most negative norm
    (``calculate_which_coordinate_is_timelike`` cl.cl:1713-1758)."""
    eta = local_minkowski(es, gab)
    diag = jnp.diagonal(eta)
    idx = jnp.argmin(diag)
    # If nothing is timelike physics is broken; the reference warns and uses 0.
    return jnp.where(diag[idx] < 0.0, idx, 0)


def _swap_rows(vs: Array, i: Array, j: Array) -> Array:
    """Swap rows i and j of a (4, ...) stack, with traced indices."""
    vi = vs[i]
    vj = vs[j]
    return vs.at[i].set(vj).at[j].set(vi)


def _frame_basis_with_swap(gab: Array, swap: Array) -> tuple[Array, Array]:
    """One pass of ``calculate_frame_basis_with_swap_index`` (cl.cl:1761-1849).

    Returns ``(es, timelike_index)`` where ``es[0]`` is the candidate timelike
    leg *after* un-permuting back to coordinate order and re-swapping the
    discovered timelike vector to slot 0.
    """
    eye = jnp.eye(4, dtype=gab.dtype)
    lengths = jnp.diagonal(gab)  # dot(ri, lower(ri)) = g_ii

    order = jnp.arange(4)
    order = _swap_rows(order, jnp.asarray(0), swap)
    lengths_sw = lengths[order]

    # First slot must have a non-degenerate length for Gram-Schmidt to start.
    nonzero = jnp.abs(lengths_sw) > 1e-5
    first_nonzero = jnp.argmax(nonzero)  # first True, or 0 if none
    order = _swap_rows(order, jnp.asarray(0), first_nonzero)

    vs = eye[order]
    es = _gram_schmidt_metric(vs, gab)

    # Un-permute: result vector i corresponds to original slot order[i].
    sorted_es = jnp.zeros_like(es).at[order].set(es)

    tl = which_timelike(sorted_es, gab)
    sorted_es = _swap_rows(sorted_es, jnp.asarray(0), tl)
    return sorted_es, tl


def frame_basis(gab: Array) -> tuple[Array, Array]:
    """Orthonormal frame at a point: ``calculate_frame_basis`` (cl.cl:1852-1860).

    Two-pass construction: if the first Gram-Schmidt pass discovers the
    timelike direction is not coordinate 0 (e.g. Misner space), redo the pass
    seeding Gram-Schmidt with that coordinate first.

    Returns ``(es, timelike_coordinate)`` with ``es[0]`` timelike and rows
    contravariant: ``es[a][mu] = e_a^mu``.
    """
    es1, tl1 = _frame_basis_with_swap(gab, jnp.asarray(0))
    es2, tl2 = _frame_basis_with_swap(gab, tl1)
    take_first = tl1 == 0
    es = jnp.where(take_first, es1, es2)
    tl = jnp.where(take_first, tl1, tl2)
    return es, tl


# ---------------------------------------------------------------------------
# Batched (component-first) frame basis: gab (4, 4, N) -> es (4, 4, N)
#
# The redshift pass builds a frame at *every* ray endpoint (cl.cl:5187), so
# this runs in the integrator's component-first layout, elementwise over
# the rays, instead of as a per-ray vmap of the scalar path.
# ---------------------------------------------------------------------------

def _dot_g_b(gab, u, v):
    """g_ab u^a v^b for (4, N) vectors against (4, 4, N)."""
    out = 0.0
    for a in range(4):
        for b in range(4):
            out = out + gab[a, b] * u[a] * v[b]
    return out


def _swap0_batched(arr, j):
    """Swap row 0 with per-item row ``j``: arr (4, N), j (N,) int."""
    ridx = jax.lax.broadcasted_iota(jnp.int32, (4, 1), 0)
    rj = 0.0
    for i in range(4):
        rj = rj + jnp.where(j == i, arr[i], 0.0)
    out = jnp.where(ridx == 0, rj[None, :],
                    jnp.where(ridx == j[None, :], arr[0][None, :], arr))
    return out


def _frame_basis_swap_batched(gab: Array, swap: Array):
    """Batched ``calculate_frame_basis_with_swap_index`` (cl.cl:1761-1849).

    ``gab`` (4, 4, N); ``swap`` (N,) int32.  Returns (es (4, 4, N), tl (N,)).
    """
    n = gab.shape[-1]
    order = jnp.broadcast_to(
        jax.lax.broadcasted_iota(jnp.int32, (4, 1), 0), (4, n)
    )
    order = _swap0_batched(order, swap).astype(jnp.int32)

    # lengths_sw[i] = g[o,o] with o = order[i]
    def diag_gather(o_row):
        out = 0.0
        for mu in range(4):
            out = out + jnp.where(o_row == mu, gab[mu, mu], 0.0)
        return out

    lengths = jnp.stack([diag_gather(order[i]) for i in range(4)])
    nonzero = jnp.abs(lengths) > 1e-5
    # first True index (argmax of bool) per item
    first_nz = jnp.argmax(nonzero, axis=0).astype(jnp.int32)
    order = _swap0_batched(order, first_nz).astype(jnp.int32)

    # one-hot basis rows: vs[i][mu] = (order[i] == mu)
    vs = [
        jnp.stack([(order[i] == mu).astype(gab.dtype) for mu in range(4)])
        for i in range(4)
    ]

    # metric Gram-Schmidt (cl.cl:1645-1674)
    def proj(u, v):
        return (_dot_g_b(gab, u, v) / _dot_g_b(gab, u, u))[None, :] * u

    u0 = vs[0]
    u1 = vs[1] - proj(u0, vs[1])
    u2 = vs[2] - proj(u0, vs[2]) - proj(u1, vs[2])
    u3 = vs[3] - proj(u0, vs[3]) - proj(u1, vs[3]) - proj(u2, vs[3])

    def norm(u):
        return u / jnp.sqrt(jnp.abs(_dot_g_b(gab, u, u)))[None, :]

    us = [norm(u0), norm(u1), norm(u2), norm(u3)]

    # un-permute: sorted[order[i]] = us[i]
    sorted_es = []
    for slot in range(4):
        acc = 0.0
        for i in range(4):
            acc = acc + jnp.where(order[i] == slot, 1.0, 0.0)[None, :] * us[i]
        sorted_es.append(acc)

    # timelike discovery: eta_aa = g(e_a, e_a)
    diag = jnp.stack([_dot_g_b(gab, e, e) for e in sorted_es])
    tl = jnp.argmin(diag, axis=0).astype(jnp.int32)
    tl = jnp.where(jnp.min(diag, axis=0) < 0.0, tl, 0)

    es = jnp.stack(sorted_es)  # (4, 4, N): es[a][mu]
    # swap leg 0 <-> leg tl via masks over the leg axis
    lidx = jax.lax.broadcasted_iota(jnp.int32, (4, 1, 1), 0)
    e_tl = 0.0
    for i in range(4):
        e_tl = e_tl + jnp.where(tl[None, :] == i, es[i], 0.0)
    es_sw = jnp.where(lidx == 0, e_tl[None],
                      jnp.where(lidx == tl[None, None, :], es[0][None], es))
    return es_sw, tl


def frame_basis_batched(gab: Array):
    """Batched :func:`frame_basis`: gab (4, 4, N) -> (es (4, 4, N), tl (N,)),
    with ``es[a][mu][n] = e_a^mu`` and leg 0 timelike."""
    n = gab.shape[-1]
    es1, tl1 = _frame_basis_swap_batched(gab, jnp.zeros((n,), jnp.int32))
    es2, tl2 = _frame_basis_swap_batched(gab, tl1)
    take_first = (tl1 == 0)
    es = jnp.where(take_first[None, None, :], es1, es2)
    tl = jnp.where(take_first, tl1, tl2)
    return es, tl


def tetrad_inverse(es: Array) -> Array:
    """Inverse tetrad: rows are the covariant co-frame theta^a_mu
    (``get_tetrad_inverse`` cl.cl:2095-2114: invert the matrix whose *columns*
    are the tetrad legs)."""
    return _inverse44(es.T)


def coordinate_to_tetrad(v: Array, inv_es: Array) -> Array:
    """v^a = theta^a_mu v^mu (cl.cl:2134-2146)."""
    return jnp.matmul(inv_es, v, precision=HIGHEST)


def tetrad_to_coordinate(v: Array, es: Array) -> Array:
    """v^mu = v^a e_a^mu (cl.cl:2150-2153)."""
    return jnp.matmul(es.T, v, precision=HIGHEST)


def get_timelike_vector(basis_speed3: Array, time_direction, es: Array) -> Array:
    """Observer 4-velocity from a tetrad-frame 3-speed (cl.cl:2210-2225)."""
    v2 = jnp.matmul(basis_speed3, basis_speed3, precision=HIGHEST)
    gamma = 1.0 / jnp.sqrt(1.0 - v2)
    return (
        time_direction * gamma * es[0]
        + gamma * basis_speed3[0] * es[1]
        + gamma * basis_speed3[1] * es[2]
        + gamma * basis_speed3[2] * es[3]
    )


def lorentz_boost(time_basis: Array, observer_velocity: Array, gab: Array) -> Array:
    """Boost matrix B^u_v mapping the frame with time leg ``time_basis`` to one
    comoving with ``observer_velocity`` (cl.cl:1919-1974, arXiv:2404.05744)."""
    lT = jnp.matmul(gab, time_basis, precision=HIGHEST)
    luobs = jnp.matmul(gab, observer_velocity, precision=HIGHEST)
    gamma = -jnp.matmul(lT, observer_velocity, precision=HIGHEST)
    delta = jnp.eye(4, dtype=gab.dtype)
    T = time_basis
    uobs = observer_velocity
    return (
        delta
        + (1.0 / (1.0 + gamma)) * jnp.outer(T + uobs, lT + luobs)
        - 2.0 * jnp.outer(uobs, lT)
    )


def boost_tetrad(es: Array, basis_speed3: Array, gab: Array) -> Array:
    """Boost a tetrad so e0 comoves with the given frame 3-speed
    (``boost_tetrad`` kernel cl.cl:2441-2482 / tail of ``calculate_tetrads``
    cl.cl:2413-2433)."""
    uobs = get_timelike_vector(basis_speed3, 1.0, es)
    B = lorentz_boost(es[0], uobs, gab)
    e1 = jnp.matmul(B, es[1], precision=HIGHEST)
    e2 = jnp.matmul(B, es[2], precision=HIGHEST)
    e3 = jnp.matmul(B, es[3], precision=HIGHEST)
    return jnp.stack([uobs, e1, e2, e3])
