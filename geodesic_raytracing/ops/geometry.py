"""Core differential geometry: metrics, partials, Christoffel contraction.

Design note
-----------
The reference implements this layer as a *symbolic* pipeline: C++ dual numbers
driven from JavaScript produce expression strings that are spliced into an
OpenCL kernel as preprocessor defines (reference: metric.hpp:38-244,
equation_context.hpp:16-97).  Here the entire layer collapses to tracing a
plain Python function ``g(x, params) -> (4, 4)`` with ``jax.jacfwd`` providing
the 64 metric partials (the reference's generated ``F*_P`` expressions) and XLA
doing the common-subexpression elimination that ``equation_context::pin`` did
by hand.

Everything here is written for a *single* event ``x`` of shape ``(4,)`` and is
``vmap``-ed over ray batches by the integrator.  All ops are tiny (4, 4x4,
4x4x4) tensor algebra that runs elementwise once batched.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

Array = jax.Array

# Float32 contractions ask for full precision: a GPU may otherwise run a
# float32 dot in TF32 (~3 decimal digits), which the null fix and the
# Christoffel contraction cannot afford.
HIGHEST = jax.lax.Precision.HIGHEST

# Signature of a metric function: g(x: (4,), params: dict) -> (4, 4) symmetric.
MetricFn = Callable[..., Array]


@jax.custom_jvp
def recip(x: Array) -> Array:
    """1/x with a division-free tangent.

    fp division is a many-cycle sequence and the single biggest op class
    in the integrator step (jaxpr-counted).  JAX's builtin div JVP emits two
    more divides per tangent; this rule reuses the primal reciprocal:
        d(1/x) = -(1/x)^2 dx
    Metric functions should compute shared denominators once via ``recip``
    and multiply (see kerr_boyer_fn) — the JVP sweeps then stay div-free.
    """
    return 1.0 / x


@recip.defjvp
def _recip_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    y = recip(x)
    return y, -y * y * dx


# --- inverse trig from elementary ops ----------------------------------------
# Metric functions, to_polar transforms and origin distances — everything
# reachable from the integrator step — use these polynomial forms instead
# of the jnp originals.  They are plain jnp and run on any backend; the
# checked-in CPU goldens are rendered with them, so swapping them for the
# jnp originals moves those goldens.  Exact custom JVPs keep the derivative
# sweeps cheap and precise (the polynomial's own derivative only
# approximates 1/(1+x^2)).

_PI = 3.141592653589793
_PI_2 = 1.5707963267948966
_PI_4 = 0.7853981633974483


@jax.custom_jvp
def arctan(x: Array) -> Array:
    """atan: cephes-style two-stage range reduction to
    [0, tan(pi/8)] + odd minimax polynomial; ~2 ulp in fp32."""
    ax = jnp.abs(x)
    inv = ax > 1.0
    t = jnp.where(inv, 1.0 / jnp.maximum(ax, 1e-37), ax)
    red = t > 0.4142135623730951  # tan(pi/8)
    u = jnp.where(red, (t - 1.0) / (t + 1.0), t)
    z = u * u
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * u + u
    y = jnp.where(red, p + _PI_4, p)
    y = jnp.where(inv, _PI_2 - y, y)
    return jnp.where(x < 0, -y, y)


@arctan.defjvp
def _arctan_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    return arctan(x), dx / (1.0 + x * x)


@jax.custom_jvp
def arctan2(y: Array, x: Array) -> Array:
    """atan2 with numpy quadrant conventions."""
    y, x = jnp.broadcast_arrays(y, x)
    safe_x = jnp.where(x == 0.0, 1.0, x)
    base = arctan(y / safe_x)
    # x == 0: +-pi/2 by the sign of y (0 when y == 0 too).
    base = jnp.where(
        x == 0.0,
        jnp.where(y > 0, _PI_2, jnp.where(y < 0, -_PI_2, 0.0)),
        base,
    )
    corr = jnp.where(y < 0, -_PI, _PI)
    return jnp.where(x < 0, base + corr, base)


@arctan2.defjvp
def _arctan2_jvp(primals, tangents):
    y, x = primals
    dy, dx = tangents
    d = jnp.maximum(x * x + y * y, 1e-37)
    return arctan2(y, x), (x * dy - y * dx) / d


def pow_pos(base: Array, exponent) -> Array:
    """``base ** exponent`` for ``base >= 0`` without the ``pow``
    primitive.

    ``exp(exponent * log(base))``, with ``base == 0`` mapped to exactly 0
    (matching ``0.0 ** p`` for p > 0) instead of exp(-inf) edge cases.
    Used for schwarzschild_ingoing_ef_hawking's params-only cube roots.
    """
    safe = jnp.maximum(base, 1e-37)
    return jnp.where(base > 0, jnp.exp(jnp.log(safe) * exponent), 0.0)


def arcsin(x: Array) -> Array:
    """asin via atan2."""
    return arctan2(x, jnp.sqrt(jnp.maximum(1.0 - x * x, 0.0)))


def arccos(x: Array) -> Array:
    """acos via atan2."""
    return arctan2(jnp.sqrt(jnp.maximum(1.0 - x * x, 0.0)), x)


def metric_and_partials(g: MetricFn, x: Array, params) -> tuple[Array, Array]:
    """Evaluate ``g`` and its coordinate partials at ``x``.

    Returns ``(gab, dgab)`` with ``gab[a, b] = g_ab(x)`` and
    ``dgab[c, a, b] = d g_ab / d x^c``.

    Mirrors the reference's ``evaluate_metric2D`` dual-number sweep
    (metric.hpp:38-80): there each coordinate gets a dual seed in turn; here a
    single ``jacfwd`` performs the same four JVP passes.
    """
    gab = g(x, params)
    # jacfwd appends the derivative axis last: (4, 4, 4) with [..., c] = d/dx^c.
    dg = jax.jacfwd(lambda y: g(y, params))(x)
    dgab = jnp.moveaxis(dg, -1, 0)
    return gab, dgab


def inverse44_sym(m: Array) -> Array:
    """Inverse of a symmetric 4x4 metric (reference ``metric_inverse``
    cl.cl:469-558).  Symmetric input guarantees a symmetric inverse, so the
    general cofactor expansion is reused directly — XLA CSEs the duplicated
    minors."""
    return _inverse44(m)


def _inverse44(m: Array) -> Array:
    """General 4x4 inverse by cofactor expansion (vmap friendly).

    Behavioural twin of ``matrix_inverse`` (reference cl.cl:560-683).
    """
    a = m
    # Laplace expansion using 2x2 minors of rows (0,1) and rows (2,3).
    s0 = a[0, 0] * a[1, 1] - a[1, 0] * a[0, 1]
    s1 = a[0, 0] * a[1, 2] - a[1, 0] * a[0, 2]
    s2 = a[0, 0] * a[1, 3] - a[1, 0] * a[0, 3]
    s3 = a[0, 1] * a[1, 2] - a[1, 1] * a[0, 2]
    s4 = a[0, 1] * a[1, 3] - a[1, 1] * a[0, 3]
    s5 = a[0, 2] * a[1, 3] - a[1, 2] * a[0, 3]

    c5 = a[2, 2] * a[3, 3] - a[3, 2] * a[2, 3]
    c4 = a[2, 1] * a[3, 3] - a[3, 1] * a[2, 3]
    c3 = a[2, 1] * a[3, 2] - a[3, 1] * a[2, 2]
    c2 = a[2, 0] * a[3, 3] - a[3, 0] * a[2, 3]
    c1 = a[2, 0] * a[3, 2] - a[3, 0] * a[2, 2]
    c0 = a[2, 0] * a[3, 1] - a[3, 0] * a[2, 1]

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    invdet = 1.0 / det

    b = [
        [
            (a[1, 1] * c5 - a[1, 2] * c4 + a[1, 3] * c3) * invdet,
            (-a[0, 1] * c5 + a[0, 2] * c4 - a[0, 3] * c3) * invdet,
            (a[3, 1] * s5 - a[3, 2] * s4 + a[3, 3] * s3) * invdet,
            (-a[2, 1] * s5 + a[2, 2] * s4 - a[2, 3] * s3) * invdet,
        ],
        [
            (-a[1, 0] * c5 + a[1, 2] * c2 - a[1, 3] * c1) * invdet,
            (a[0, 0] * c5 - a[0, 2] * c2 + a[0, 3] * c1) * invdet,
            (-a[3, 0] * s5 + a[3, 2] * s2 - a[3, 3] * s1) * invdet,
            (a[2, 0] * s5 - a[2, 2] * s2 + a[2, 3] * s1) * invdet,
        ],
        [
            (a[1, 0] * c4 - a[1, 1] * c2 + a[1, 3] * c0) * invdet,
            (-a[0, 0] * c4 + a[0, 1] * c2 - a[0, 3] * c0) * invdet,
            (a[3, 0] * s4 - a[3, 1] * s2 + a[3, 3] * s0) * invdet,
            (-a[2, 0] * s4 + a[2, 1] * s2 - a[2, 3] * s0) * invdet,
        ],
        [
            (-a[1, 0] * c3 + a[1, 1] * c1 - a[1, 2] * c0) * invdet,
            (a[0, 0] * c3 - a[0, 1] * c1 + a[0, 2] * c0) * invdet,
            (-a[3, 0] * s3 + a[3, 1] * s1 - a[3, 2] * s0) * invdet,
            (a[2, 0] * s3 - a[2, 1] * s1 + a[2, 2] * s0) * invdet,
        ],
    ]
    return jnp.stack([jnp.stack(row) for row in b])


def geodesic_acceleration(gab: Array, dgab: Array, v: Array) -> Array:
    """d^2 x^mu / dlambda^2 = -Gamma^mu_ab v^a v^b without forming Gamma.

    Matches the reference's generated acceleration (``calculate_acceleration``
    metric.hpp:184-244; device contraction cl.cl:1443-1537) but contracts the
    velocity in first so only a 4-vector is solved against the inverse metric:

        S_n  = v^a v^b ( d_a g_nb  -  1/2 d_n g_ab )
        a^mu = -g^{mu n} S_n
    """
    # dgab[c, a, b] = d_c g_ab
    term1 = jnp.einsum("a,b,anb->n", v, v, dgab, precision=HIGHEST)
    term2 = 0.5 * jnp.einsum("a,b,nab->n", v, v, dgab,
                             precision=HIGHEST)
    s = term1 - term2
    ginv = _inverse44(gab)
    return -jnp.matmul(ginv, s, precision=HIGHEST)


def acceleration_at(g: MetricFn, x: Array, v: Array, params) -> Array:
    """Geodesic acceleration at position ``x`` with velocity ``v``."""
    gab, dgab = metric_and_partials(g, x, params)
    return geodesic_acceleration(gab, dgab, v)


# ---------------------------------------------------------------------------
# Batched (component-first) formulation
#
# Layout note: the hot path keeps rays on the trailing axis: states are
# (4, N), metrics (4, 4, N), so every operation is elementwise over the
# rays (per-ray ``vmap`` would instead make the 4-vectors minor).  Every metric
# function in the catalogue is written componentwise (x[0]..x[3] + elementwise
# jnp), so it evaluates transparently in either convention.
# ---------------------------------------------------------------------------

def basis_vec4(c: int, x: Array) -> Array:
    """Coordinate basis vector e_c broadcastable against ``x`` of shape
    (4, ...).  Built from an iota at the FULL broadcast rank (no captured
    array constants, no post-hoc reshape)."""
    shape = (4,) + (1,) * (x.ndim - 1)
    idx = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    return (idx == c).astype(x.dtype)


def select4(values, x: Array) -> Array:
    """A (4, 1, ..) constant vector from 4 python floats (iota-built)."""
    shape = (4,) + (1,) * (max(x.ndim, 1) - 1)
    idx = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    out = jnp.zeros_like(idx, dtype=x.dtype)
    for c, v in enumerate(values):
        out = jnp.where(idx == c, jnp.asarray(v, dtype=x.dtype), out)
    return out


def metric_and_partials_batched(g, x: Array, params,
                                deps=(0, 1, 2, 3)) -> tuple[Array, list]:
    """Batched twin of :func:`metric_and_partials` for ``x`` of shape (4, N).

    Returns ``(gab, dgab)`` where ``gab`` is (4, 4, N) and ``dgab`` is a
    4-list with ``dgab[c]`` = d g / d x^c as (4, 4, N) or ``None`` when the
    metric is declared independent of coordinate ``c`` (``deps``) — the
    trace-time sparsity that replaces the reference's symbolic
    zero-expression pruning (equation_context CSE + debiggen).

    One tangent pass per dependent coordinate — exactly the reference's
    dual-number sweep (metric.hpp:38-80), one dual seed per coordinate —
    via ``jax.linearize`` so the primal evaluation (its transcendentals and
    divides) is traced ONCE and shared across all seeds, instead of being
    re-emitted per ``jax.jvp`` call.
    """
    f = lambda y: g(y, params)
    gab, f_lin = jax.linearize(f, x)
    dgs: list = [None, None, None, None]
    for c in deps:
        seed = jnp.broadcast_to(basis_vec4(c, x), x.shape)
        dgs[c] = f_lin(seed)
    return gab, dgs


def inverse44_batched(m: Array) -> Array:
    """Closed-form 4x4 inverse for component-first batches (4, 4, N)."""
    a = m
    s0 = a[0, 0] * a[1, 1] - a[1, 0] * a[0, 1]
    s1 = a[0, 0] * a[1, 2] - a[1, 0] * a[0, 2]
    s2 = a[0, 0] * a[1, 3] - a[1, 0] * a[0, 3]
    s3 = a[0, 1] * a[1, 2] - a[1, 1] * a[0, 2]
    s4 = a[0, 1] * a[1, 3] - a[1, 1] * a[0, 3]
    s5 = a[0, 2] * a[1, 3] - a[1, 2] * a[0, 3]

    c5 = a[2, 2] * a[3, 3] - a[3, 2] * a[2, 3]
    c4 = a[2, 1] * a[3, 3] - a[3, 1] * a[2, 3]
    c3 = a[2, 1] * a[3, 2] - a[3, 1] * a[2, 2]
    c2 = a[2, 0] * a[3, 3] - a[3, 0] * a[2, 3]
    c1 = a[2, 0] * a[3, 2] - a[3, 0] * a[2, 2]
    c0 = a[2, 0] * a[3, 1] - a[3, 0] * a[2, 1]

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    invdet = 1.0 / det

    rows = [
        [
            a[1, 1] * c5 - a[1, 2] * c4 + a[1, 3] * c3,
            -a[0, 1] * c5 + a[0, 2] * c4 - a[0, 3] * c3,
            a[3, 1] * s5 - a[3, 2] * s4 + a[3, 3] * s3,
            -a[2, 1] * s5 + a[2, 2] * s4 - a[2, 3] * s3,
        ],
        [
            -a[1, 0] * c5 + a[1, 2] * c2 - a[1, 3] * c1,
            a[0, 0] * c5 - a[0, 2] * c2 + a[0, 3] * c1,
            -a[3, 0] * s5 + a[3, 2] * s2 - a[3, 3] * s1,
            a[2, 0] * s5 - a[2, 2] * s2 + a[2, 3] * s1,
        ],
        [
            a[1, 0] * c4 - a[1, 1] * c2 + a[1, 3] * c0,
            -a[0, 0] * c4 + a[0, 1] * c2 - a[0, 3] * c0,
            a[3, 0] * s4 - a[3, 1] * s2 + a[3, 3] * s0,
            -a[2, 0] * s4 + a[2, 1] * s2 - a[2, 3] * s0,
        ],
        [
            -a[1, 0] * c3 + a[1, 1] * c1 - a[1, 2] * c0,
            a[0, 0] * c3 - a[0, 1] * c1 + a[0, 2] * c0,
            -a[3, 0] * s3 + a[3, 1] * s1 - a[3, 2] * s0,
            a[2, 0] * s3 - a[2, 1] * s1 + a[2, 2] * s0,
        ],
    ]
    return jnp.stack([jnp.stack([e * invdet for e in row]) for row in rows])


# --- trace-time zero pruning ------------------------------------------------
# ``None`` is the structural zero: arithmetic helpers fold it away at trace
# time, so a sparse metric's inverse/contraction compiles only the surviving
# terms (XLA may not fold x * 0.0 — fp semantics allow
# NaN * 0 = NaN — so the pruning must happen before lowering).  This is the
# same specialisation the reference performs symbolically (debiggen /
# equation_context zero expressions, metric.hpp:665-708).

def _pmul(x, y):
    return None if x is None or y is None else x * y


def _padd(x, y):
    if x is None:
        return y
    if y is None:
        return x
    return x + y


def _psub(x, y):
    if y is None:
        return x
    if x is None:
        return -y
    return x - y


def _pneg(x):
    return None if x is None else -x


def _sym_entries(m: Array, nz: frozenset):
    """4x4 list of Array-or-None views of a symmetric batch ``m``."""
    def get(i, j):
        key = (i, j) if i <= j else (j, i)
        return m[i, j] if key in nz else None

    return [[get(i, j) for j in range(4)] for i in range(4)]


def _inv44_sym_entries(E):
    """Pruned symmetric-4x4 inverse over an entry grid (Array-or-None).

    Identical cofactor algebra to :func:`inverse44_sym_batched`; structural
    zeros drop their terms at trace time (Kerr BL's diag + t-phi structure
    collapses to the 2x2-block closed form, ~7 multiplies).  Returns the
    entry grid of the inverse (structural zeros stay ``None``)."""
    a = E[0][0]; b = E[0][1]; c = E[0][2]; d = E[0][3]
    e = E[1][1]; f = E[1][2]; g_ = E[1][3]
    h = E[2][2]; i = E[2][3]
    j = E[3][3]

    hj_ii = _psub(_pmul(h, j), _pmul(i, i))
    fj_gi = _psub(_pmul(f, j), _pmul(g_, i))
    fi_gh = _psub(_pmul(f, i), _pmul(g_, h))
    ej_gg = _psub(_pmul(e, j), _pmul(g_, g_))
    ei_gf = _psub(_pmul(e, i), _pmul(g_, f))
    eh_ff = _psub(_pmul(e, h), _pmul(f, f))
    cj_di = _psub(_pmul(c, j), _pmul(d, i))
    ci_dh = _psub(_pmul(c, i), _pmul(d, h))
    cg_df = _psub(_pmul(c, g_), _pmul(d, f))
    bj_dg = _psub(_pmul(b, j), _pmul(d, g_))
    bi_df = _psub(_pmul(b, i), _pmul(d, f))
    bg_de = _psub(_pmul(b, g_), _pmul(d, e))
    bh_cf = _psub(_pmul(b, h), _pmul(c, f))
    bf_ce = _psub(_pmul(b, f), _pmul(c, e))

    def tri(x, p, y, q, z, r):
        return _padd(_psub(_pmul(x, p), _pmul(y, q)), _pmul(z, r))

    C00 = tri(e, hj_ii, f, fj_gi, g_, fi_gh)
    C01 = _pneg(tri(b, hj_ii, f, cj_di, g_, ci_dh))
    C02 = tri(b, fj_gi, e, cj_di, g_, cg_df)
    C03 = _pneg(tri(b, fi_gh, e, ci_dh, f, cg_df))
    C11 = tri(a, hj_ii, c, cj_di, d, ci_dh)
    C12 = _pneg(tri(a, fj_gi, b, cj_di, d, cg_df))
    C13 = tri(a, fi_gh, b, ci_dh, c, cg_df)
    C22 = tri(a, ej_gg, b, bj_dg, d, bg_de)
    C23 = _pneg(tri(a, ei_gf, b, bi_df, c, bg_de))
    C33 = tri(a, eh_ff, b, bh_cf, c, bf_ce)

    det = _padd(_padd(_pmul(a, C00), _pmul(b, C01)),
                _padd(_pmul(c, C02), _pmul(d, C03)))
    inv_det = 1.0 / det

    C = [[C00, C01, C02, C03],
         [C01, C11, C12, C13],
         [C02, C12, C22, C23],
         [C03, C13, C23, C33]]
    return [[_pmul(C[r][s], inv_det) for s in range(4)] for r in range(4)]


def inverse44_sym_batched(m: Array, nz: frozenset | None = None) -> Array:
    """Closed-form inverse of a *symmetric* 4x4 (component-first batch).

    Exploits g_ij = g_ji: 10 unique inputs, 10 unique cofactors — roughly
    half the multiplies of the general adjugate, which matters in the
    arithmetic-bound integrator (reference ``metric_inverse`` cl.cl:469-558 is the
    same specialisation).  ``nz``: optional structural-nonzero entry set —
    absent entries prune their terms at trace time (see
    :func:`_inv44_sym_entries`).
    """
    if nz is not None:
        Einv = _inv44_sym_entries(_sym_entries(m, nz))
        zero = jnp.zeros_like(m[0, 0])
        return jnp.stack([
            jnp.stack([x if x is not None else zero for x in row])
            for row in Einv
        ])
    a = m[0, 0]; b = m[0, 1]; c = m[0, 2]; d = m[0, 3]
    e = m[1, 1]; f = m[1, 2]; g_ = m[1, 3]
    h = m[2, 2]; i = m[2, 3]
    j = m[3, 3]

    # Shared 2x2 minors.
    hj_ii = h * j - i * i
    fj_gi = f * j - g_ * i
    fi_gh = f * i - g_ * h
    ej_gg = e * j - g_ * g_
    ei_gf = e * i - g_ * f
    eh_ff = e * h - f * f
    cj_di = c * j - d * i
    ci_dh = c * i - d * h
    cg_df = c * g_ - d * f
    bj_dg = b * j - d * g_
    bi_df = b * i - d * f
    bg_de = b * g_ - d * e
    bh_cf = b * h - c * f
    bf_ce = b * f - c * e

    C00 = e * hj_ii - f * fj_gi + g_ * fi_gh
    C01 = -(b * hj_ii - f * cj_di + g_ * ci_dh)
    C02 = b * fj_gi - e * cj_di + g_ * cg_df
    C03 = -(b * fi_gh - e * ci_dh + f * cg_df)
    C11 = a * hj_ii - c * cj_di + d * ci_dh
    C12 = -(a * fj_gi - b * cj_di + d * cg_df)
    C13 = a * fi_gh - b * ci_dh + c * cg_df
    C22 = a * ej_gg - b * bj_dg + d * bg_de
    C23 = -(a * ei_gf - b * bi_df + c * bg_de)
    C33 = a * eh_ff - b * bh_cf + c * bf_ce

    det = a * C00 + b * C01 + c * C02 + d * C03
    inv_det = 1.0 / det

    r0 = jnp.stack([C00, C01, C02, C03])
    r1 = jnp.stack([C01, C11, C12, C13])
    r2 = jnp.stack([C02, C12, C22, C23])
    r3 = jnp.stack([C03, C13, C23, C33])
    return jnp.stack([r0, r1, r2, r3]) * inv_det


def acceleration_batched(g, x: Array, v: Array, params,
                         deps=(0, 1, 2, 3), nz: frozenset | None = None
                         ) -> Array:
    """Batched geodesic acceleration: x, v of shape (4, N) -> (4, N).

    Same contraction as :func:`geodesic_acceleration` with explicit component
    loops (unrolled 4x4x4 — XLA fuses them into a few elementwise kernels), with
    terms dropped at trace time for coordinates the metric does not depend on:
        S_n  = v^a v^b ( d_a g_nb - 1/2 d_n g_ab )
        a    = -g^{-1} S
    ``nz`` (Metric.nonzeros()): structurally-zero metric entries additionally
    prune their contraction terms and collapse the inverse (derivatives of a
    structural zero are zero) — XLA may not fold fp ``x * 0``,
    so this pruning happens at trace time, like the reference's symbolic
    zero expressions.
    """

    def present(i, j):
        return nz is None or ((i, j) if i <= j else (j, i)) in nz

    gab, dg = metric_and_partials_batched(g, x, params, deps)
    # Precompute the unique velocity products (lazily: pruned terms must not
    # pay for theirs).
    vv: dict = {}

    def vvp(a, b):
        key = (a, b) if a <= b else (b, a)
        if key not in vv:
            vv[key] = v[key[0]] * v[key[1]]
        return vv[key]

    S = []
    for n in range(4):
        acc = None
        # term1: v^a v^b d_a g_nb, only a with dg[a] present
        for a in deps:
            for b in range(4):
                if not present(n, b):
                    continue
                t = vvp(a, b) * dg[a][n, b]
                acc = t if acc is None else acc + t
        # term2: -1/2 v^a v^b d_n g_ab, only when dg[n] present
        if dg[n] is not None:
            for a in range(4):
                for b in range(a, 4):
                    if not present(a, b):
                        continue
                    w = 1.0 if a == b else 2.0
                    t = (0.5 * w) * vvp(a, b) * dg[n][a, b]
                    acc = -t if acc is None else acc - t
        S.append(acc)

    if nz is not None:
        ginv = _inv44_sym_entries(_sym_entries(gab, nz))
    else:
        dense = inverse44_sym_batched(gab)
        ginv = [[dense[r, s] for s in range(4)] for r in range(4)]
    zero = jnp.zeros_like(v[0])
    out = []
    for mu in range(4):
        acc = None
        for n in range(4):
            t = _pmul(ginv[mu][n], S[n])
            acc = _padd(acc, t)
        out.append(-acc if acc is not None else zero)
    return jnp.stack(out)


def acceleration_batched_rank1(h, x: Array, v: Array, params) -> Array:
    """Kerr-Schild fast path: geodesic acceleration for g = eta + f l ox l.

    ``h(x, params) -> (f, l)`` with ``f`` of shape (N,) and the covariant
    null vector ``l`` of shape (4, N).  The reference hand-optimises only
    the diagonal Christoffel contraction (cl.cl:685-736); this is the
    analogous structural specialisation for its non-diagonal Kerr-Schild
    scripts (scripts/kerr_schild.js, kerr_newman_schild.js), which the
    generic path treats as dense 4x4 metrics (16-component JVP sweeps +
    cofactor inverse).

    Derivation (all per-lane scalars/4-vectors):
        g_ab   = eta_ab + f l_a l_b
        d_c g_ab = (d_c f) l_a l_b + f (d_c l_a) l_b + f l_a (d_c l_b)
        S_n    = v^a v^b (d_a g_nb - 1/2 d_n g_ab)
               = (Df lv + f q) l_n + f lv w_n  -  d_n(1/2 f lv^2)|_v const
          with lv = l_a v^a, Df = v^a d_a f, w_n = v^a d_a l_n,
          q = v^b w_b
        g^-1   = eta^-1 - (f / (1 + f l.eta.l)) lt ox lt   (Sherman-
                 Morrison; lt = eta^-1 l, and l.eta.l == 0 analytically —
                 the denominator only absorbs fp32 rounding of l)
        a^mu   = -(eta^-1 S)^mu + (f/(1+f l.eta.l)) lt^mu (lt . S)

    Cost: ONE primal trace of the (f, l) chain (shared via
    ``jax.linearize``), one directional JVP (seed v) for (Df, w), and one
    transposed-linear pass (``jax.linear_transpose`` — reuses the
    linearization residuals, no second primal) for the gradient of
    1/2 f lv^2 — versus the generic path's 3 coordinate-seed tangent
    passes over all 16 g components plus a dense symmetric inverse.
    Validated exactly against the dense path in
    tests/test_metrics_catalogue.py.
    """
    fun = lambda y: h(y, params)
    (f, l), h_lin = jax.linearize(fun, x)
    Df, w = h_lin(v)
    lv = jnp.sum(l * v, axis=0)
    q = jnp.sum(w * v, axis=0)
    flv = f * lv
    # Term2_n = d_n (1/2 f lv^2) via the transpose of the SAME
    # linearization: cotangents (1/2 lv^2) on f and (f lv v^b) on l_b.
    h_lin_T = jax.linear_transpose(h_lin, x)
    (term2,) = h_lin_T((0.5 * lv * lv, flv[None, :] * v))
    term1 = (lv * Df + f * q)[None, :] * l + flv[None, :] * w
    S = term1 - term2
    sign = select4((-1.0, 1.0, 1.0, 1.0), x)
    lt = sign * l                      # eta^-1 l (contravariant)
    l_eta_l = jnp.sum(lt * l, axis=0)  # == 0 up to fp rounding
    scale = f * recip(1.0 + f * l_eta_l)
    ltS = jnp.sum(lt * S, axis=0)
    return -sign * S + (scale * ltS)[None, :] * lt


def fix_null_batched(gab: Array, v: Array) -> Array:
    """Batched :func:`fix_null` for gab (4,4,N), v (4,N)."""
    vs = v.at[0].set(0.0)
    a = gab[0, 0]
    b = 2.0 * (gab[0, 0] * vs[0] + gab[0, 1] * vs[1] + gab[0, 2] * vs[2]
               + gab[0, 3] * vs[3])
    c = 0.0
    for i in range(4):
        for j in range(4):
            c = c + gab[i, j] * vs[i] * vs[j]
    disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
    sq = jnp.sqrt(disc)
    r0 = (-b - sq) / (2.0 * a)
    r1 = (-b + sq) / (2.0 * a)
    want = v[0]
    vt = jnp.where(jnp.abs(r0 - want) < jnp.abs(r1 - want), r0, r1)
    lin = -c / jnp.where(jnp.abs(b) < 1e-12, 1e-12, b)
    vt = jnp.where(jnp.abs(a) < 1e-12, lin, vt)
    return v.at[0].set(vt)


def dot_g(gab: Array, u: Array, v: Array) -> Array:
    """g_ab u^a v^b (reference ``dot_product_big``)."""
    return jnp.einsum("ab,a,b->", gab, u, v, precision=HIGHEST)


def lower(gab: Array, v: Array) -> Array:
    """Lower an index: v_a = g_ab v^b (reference ``lower_index_big``)."""
    return jnp.matmul(gab, v, precision=HIGHEST)


def raise_(gab: Array, v: Array) -> Array:
    """Raise an index with the inverse metric."""
    return jnp.matmul(_inverse44(gab), v, precision=HIGHEST)


def fix_null(gab: Array, v: Array) -> Array:
    """Rescale the time component of ``v`` so that g(v, v) = 0.

    Behavioural twin of ``fix_light_velocity_big`` (reference metric.hpp:133-182
    / cl.cl's generated variant): solve the quadratic
    ``g_tt vt^2 + 2 g_ti vt v^i + g_ij v^i v^j = 0`` for ``vt`` keeping the
    root closest in sign to the original time component.
    """
    vs = v.at[0].set(0.0)
    a = gab[0, 0]
    b = 2.0 * jnp.matmul(gab[0], vs, precision=HIGHEST)
    c = jnp.einsum("ab,a,b->", gab, vs, vs, precision=HIGHEST)
    disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
    sq = jnp.sqrt(disc)
    r0 = (-b - sq) / (2.0 * a)
    r1 = (-b + sq) / (2.0 * a)
    want = v[0]
    vt = jnp.where(jnp.abs(r0 - want) < jnp.abs(r1 - want), r0, r1)
    # Guard a degenerate g_tt ~ 0 (null coordinate): fall back to -c/b.
    lin = -c / jnp.where(jnp.abs(b) < 1e-12, 1e-12, b)
    vt = jnp.where(jnp.abs(a) < 1e-12, lin, vt)
    return v.at[0].set(vt)
