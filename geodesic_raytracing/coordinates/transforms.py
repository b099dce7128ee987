"""Coordinate-system transforms with autodiff Jacobians.

Each entry in the reference's ``scripts/coordinates/*.js`` becomes a plain
jnp function ``f(x: (4,), params: dict) -> (4,)``.  The reference turned these
into symbolic Jacobians via ``total_diff`` (metric.hpp:247-274); here velocity
transforms are a single ``jax.jvp``.

Canonical "polar" coordinates are ``(t, r, theta, phi)``; every metric's
coordinate system declares a transform to and from them, plus an optional
periodicity vector (period per coordinate, 0 = aperiodic), mirroring
``scripts/coordinates/*_periodicity.js``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Polynomial inverse trig with exact custom JVPs (see ops.geometry): the
# to_polar transforms run inside the integrator step every iteration.
from ..ops.geometry import arccos, arctan2

Array = jax.Array


# ---------------------------------------------------------------------------
# 3-vector helpers shared by the render pipeline (reference common.cl / cl.cl)
# ---------------------------------------------------------------------------

def cartesian_to_polar3(c: Array) -> Array:
    """(x, y, z) -> (r, theta, phi)."""
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    r = jnp.sqrt(x * x + y * y + z * z)
    theta = arctan2(jnp.sqrt(x * x + y * y), z)
    phi = arctan2(y, x)
    return jnp.stack([r, theta, phi], axis=-1)


def polar_to_cartesian3(p: Array) -> Array:
    """(r, theta, phi) -> (x, y, z)."""
    r, theta, phi = p[..., 0], p[..., 1], p[..., 2]
    st, ct = jnp.sin(theta), jnp.cos(theta)
    return jnp.stack([r * st * jnp.cos(phi), r * st * jnp.sin(phi), r * ct], axis=-1)


def cartesian_velocity_to_polar_velocity(pos_cart: Array, vel_cart: Array) -> Array:
    """Push a cartesian 3-velocity through d(cart->polar) at ``pos_cart``."""
    return jax.jvp(cartesian_to_polar3, (pos_cart,), (vel_cart,))[1]


def spherical_velocity_to_cartesian_velocity(pos_polar: Array, vel_polar: Array) -> Array:
    """Push a polar 3-velocity through d(polar->cart) at ``pos_polar``."""
    return jax.jvp(polar_to_cartesian3, (pos_polar,), (vel_polar,))[1]


# ---------------------------------------------------------------------------
# 4-coordinate transforms (registry mirrors scripts/coordinates/*.js)
# ---------------------------------------------------------------------------

def polar_to_polar(x, params):
    """scripts/coordinates/polar_to_polar.js — identity."""
    return x


def cartesian_to_polar(x, params):
    """scripts/coordinates/cartesian_to_polar.js.  Componentwise (batch-safe)."""
    t, xx, y, z = x[0], x[1], x[2], x[3]
    r = jnp.sqrt(xx * xx + y * y + z * z)
    theta = arctan2(jnp.sqrt(xx * xx + y * y), z)
    phi = arctan2(y, xx)
    return jnp.stack([t, r, theta, phi])


def polar_to_cartesian(x, params):
    """scripts/coordinates/polar_to_cartesian.js.  Componentwise (batch-safe)."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    st, ct = jnp.sin(theta), jnp.cos(theta)
    return jnp.stack(
        [t, r * st * jnp.cos(phi), r * st * jnp.sin(phi), r * ct]
    )


def cartesian_skew_to_polar(x, params):
    """scripts/coordinates/cartesian_skew_to_polar.js — args are (x, t, y, z)."""
    xx, t, y, z = x[0], x[1], x[2], x[3]
    r = jnp.sqrt(xx * xx + y * y + z * z)
    theta = arctan2(jnp.sqrt(xx * xx + y * y), z)
    phi = arctan2(y, xx)
    return jnp.stack([t, r, theta, phi])


def polar_to_cartesian_skew(x, params):
    """scripts/coordinates/polar_to_cartesian_skew.js — returns (x, t, y, z)."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    st, ct = jnp.sin(theta), jnp.cos(theta)
    return jnp.stack(
        [r * st * jnp.cos(phi), t, r * st * jnp.sin(phi), r * ct]
    )


def cylindrical_to_polar(x, params):
    """scripts/coordinates/cylindrical_to_polar.js — (t, p, phi, z)."""
    t, p, phi, z = x[0], x[1], x[2], x[3]
    rr = jnp.sqrt(p * p + z * z)
    rtheta = arctan2(p, z)
    return jnp.stack([t, rr, rtheta, phi])


def polar_to_cylindrical(x, params):
    """scripts/coordinates/polar_to_cylindrical.js."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    return jnp.stack([t, r * jnp.sin(theta), phi, r * jnp.cos(theta)])


def ingoing_ef_to_polar(x, params):
    """scripts/coordinates/ingoing_ef_to_polar.js — v = t + r + rs log|r - rs|."""
    rs = params["rs"]
    v, r, theta, phi = x[0], x[1], x[2], x[3]
    t = v - (r + rs * jnp.log(jnp.abs(r - rs)))
    return jnp.stack([t, r, theta, phi])


def polar_to_ingoing_ef(x, params):
    """scripts/coordinates/polar_to_ingoing_ef.js."""
    rs = params["rs"]
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    v = t + r + rs * jnp.log(jnp.abs(r - rs))
    return jnp.stack([v, r, theta, phi])


def ingoing_ef_variable_to_polar(x, params):
    """scripts/coordinates/ingoing_ef_variable_to_polar.js — identity (the
    polar time coordinate is explicitly never round-tripped)."""
    return x


def polar_to_ingoing_ef_variable(x, params):
    """scripts/coordinates/polar_to_ingoing_ef_variable.js — identity."""
    return x


def polar_to_rational(x, params):
    """scripts/coordinates/polar_to_rational.js — X = cos(theta)."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    return jnp.stack([t, r, jnp.cos(theta), phi])


def rational_to_polar(x, params):
    """scripts/coordinates/rational_to_polar.js."""
    t, r, X, phi = x[0], x[1], x[2], x[3]
    return jnp.stack([t, r, arccos(jnp.clip(X, -1.0, 1.0)), phi])


def skewed_polar_to_polar(x, params):
    """scripts/coordinates/skewed_polar_to_polar.js — args are (r, t, ...)."""
    return jnp.stack([x[1], x[0], x[2], x[3]])


def polar_to_skewed_polar(x, params):
    """scripts/coordinates/polar_to_skewed_polar.js."""
    return jnp.stack([x[1], x[0], x[2], x[3]])


def misner_4d_to_polar(x, params):
    """scripts/coordinates/misner_4d_to_polar.js (arXiv:1102.0907 eq. 8-9)."""
    T, mphi, y, z = x[0], x[1], x[2], x[3]
    t = T * jnp.exp(mphi / 2) - jnp.exp(-mphi / 2)
    xx = T * jnp.exp(mphi / 2) + jnp.exp(-mphi / 2)
    r = jnp.sqrt(xx * xx + y * y + z * z)
    theta = arctan2(jnp.sqrt(xx * xx + y * y), z)
    phi = arctan2(y, xx)
    return jnp.stack([t, r, theta, phi])


def polar_to_misner_4d(x, params):
    """scripts/coordinates/polar_to_misner_4d.js."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    st = jnp.sin(theta)
    xx = r * st * jnp.cos(phi)
    y = r * st * jnp.sin(phi)
    z = r * jnp.cos(theta)
    mphi = -2.0 * jnp.log((xx - t) / 2.0)
    T = (xx * xx - t * t) / 4.0
    return jnp.stack([T, mphi, y, z])


# ---------------------------------------------------------------------------
# Periodicity functions (period per coordinate; 0 = aperiodic)
# ---------------------------------------------------------------------------

def polar_periodicity(params):
    """scripts/coordinates/polar_periodicity.js."""
    return jnp.array([0.0, 0.0, jnp.pi, 2 * jnp.pi])


def cylindrical_periodicity(params):
    """scripts/coordinates/cylindrical_periodicity.js — (t, p, phi, z)."""
    return jnp.array([0.0, 0.0, 2 * jnp.pi, 0.0])


def misner_periodicity(params):
    """scripts/coordinates/misner_periodicity.js — phi has period phi0."""
    return jnp.stack(
        [jnp.asarray(0.0), jnp.asarray(params["phi0"], dtype=jnp.float32),
         jnp.asarray(0.0), jnp.asarray(0.0)]
    )


TRANSFORMS = {
    "polar_to_polar": polar_to_polar,
    "cartesian_to_polar": cartesian_to_polar,
    "polar_to_cartesian": polar_to_cartesian,
    "cartesian_skew_to_polar": cartesian_skew_to_polar,
    "polar_to_cartesian_skew": polar_to_cartesian_skew,
    "cylindrical_to_polar": cylindrical_to_polar,
    "polar_to_cylindrical": polar_to_cylindrical,
    "ingoing_ef_to_polar": ingoing_ef_to_polar,
    "polar_to_ingoing_ef": polar_to_ingoing_ef,
    "ingoing_ef_variable_to_polar": ingoing_ef_variable_to_polar,
    "polar_to_ingoing_ef_variable": polar_to_ingoing_ef_variable,
    "polar_to_rational": polar_to_rational,
    "rational_to_polar": rational_to_polar,
    "skewed_polar_to_polar": skewed_polar_to_polar,
    "polar_to_skewed_polar": polar_to_skewed_polar,
    "misner_4d_to_polar": misner_4d_to_polar,
    "polar_to_misner_4d": polar_to_misner_4d,
}

PERIODICITY = {
    "polar_periodicity": polar_periodicity,
    "cylindrical_periodicity": cylindrical_periodicity,
    "misner_periodicity": misner_periodicity,
}


def get_transform(name: str):
    if not name:
        return polar_to_polar
    return TRANSFORMS[name]


def get_periodicity(name: str):
    if not name:
        return lambda params: jnp.zeros(4)
    return PERIODICITY[name]


def velocity_transform(fn, x: Array, v: Array, params) -> Array:
    """Push a 4-velocity through the Jacobian of ``fn`` at ``x``.

    Replaces the reference's symbolic ``total_diff`` (metric.hpp:247-274).
    """
    return jax.jvp(lambda y: fn(y, params), (x,), (v,))[1]
