"""Constant-theta planar tracing for spherically symmetric metrics.

Behavioural twin of the reference's ``GENERIC_CONSTANT_THETA`` machinery:
every ray's motion plane is rotated into the equator at launch
(``correct_lightray`` cl.cl:2949-2997 via ``get_theta_adjustment_quat``
cl.cl:2015-2043), the integrator pins theta = pi/2 with zero theta-dynamics
(``IS_CONSTANT_THETA`` pins, cl.cl:3990-3995), and the stored inverse
quaternion un-rotates the final position at readout
(``get_intersection_position`` cl.cl:5024-5064).

Spherical symmetry makes this exact (the plane of motion is conserved), and
it pays twice: one JVP sweep (d/dr only) instead of two, and
sin(theta) = 1 constant-folds through the metric.

All component-first batched: positions (4, N), quats (4, N) in (x, y, z, w)
layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..metrics.base import Metric

Array = jax.Array

HALF_PI = float(jnp.pi / 2)


def _normalize3(v):
    n = jnp.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    n = jnp.where(n < 1e-12, 1.0, n)
    return jnp.stack([v[0] / n, v[1] / n, v[2] / n])


def _cross3(a, b):
    return jnp.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def rot_quat_batched(v, q):
    """Rotate 3-vectors (3, N) by quaternions (4, N) (x, y, z, w)."""
    u = q[:3]
    w = q[3]
    uv = _cross3(u, v)
    uv = jnp.stack([uv[0] + w * v[0], uv[1] + w * v[1], uv[2] + w * v[2]])
    uuv = _cross3(u, uv)
    return jnp.stack([
        v[0] + 2.0 * uuv[0],
        v[1] + 2.0 * uuv[1],
        v[2] + 2.0 * uuv[2],
    ])


def theta_adjustment_quat(vel_cart, cart_pos, angle_sign):
    """Batched ``get_theta_adjustment_quat`` (cl.cl:2015-2043): quaternion
    rotating each ray's motion plane into the equatorial plane."""
    small = (vel_cart[0] ** 2 + vel_cart[1] ** 2 + vel_cart[2] ** 2) < 1e-10
    fallback = jnp.stack([jnp.zeros_like(vel_cart[0]),
                          jnp.ones_like(vel_cart[0]),
                          jnp.zeros_like(vel_cart[0])])
    pd = jnp.where(small[None, :], fallback, vel_cart)

    bx = _normalize3(pd)
    by = _normalize3(-cart_pos)
    # rejection of bx from by
    bx = _normalize3(bx - _dot3(bx, by)[None, :] * by)
    plane_n = -_normalize3(_cross3(bx, by))

    z = jnp.stack([jnp.zeros_like(plane_n[0]), jnp.zeros_like(plane_n[0]),
                   jnp.ones_like(plane_n[0])])
    cosang = jnp.clip(_dot3(plane_n, z), -1.0, 1.0)
    angle = jnp.arccos(cosang) * angle_sign

    axis = _cross3(plane_n, z)
    an = jnp.sqrt(axis[0] ** 2 + axis[1] ** 2 + axis[2] ** 2)
    degenerate = an < 1e-9  # plane already equatorial
    axis = jnp.where(degenerate[None, :],
                     jnp.stack([jnp.ones_like(an), jnp.zeros_like(an),
                                jnp.zeros_like(an)]),
                     axis / jnp.where(degenerate, 1.0, an)[None, :])
    s = jnp.sin(angle / 2)
    q = jnp.stack([axis[0] * s, axis[1] * s, axis[2] * s,
                   jnp.cos(angle / 2)])
    # normalise
    qn = jnp.sqrt(jnp.sum(q * q, axis=0))
    return q / jnp.where(qn < 1e-12, 1.0, qn)[None, :]


def _polar3_to_cart(p):
    r, th, ph = p[0], p[1], p[2]
    st, ct = jnp.sin(th), jnp.cos(th)
    return jnp.stack([r * st * jnp.cos(ph), r * st * jnp.sin(ph), r * ct])


def _cart_to_polar3(c):
    x, y, z = c[0], c[1], c[2]
    r = jnp.sqrt(x * x + y * y + z * z)
    th = jnp.arctan2(jnp.sqrt(x * x + y * y), z)
    ph = jnp.arctan2(y, x)
    return jnp.stack([r, th, ph])


def _polar_vel_to_cart(p, v):
    """d(polar->cart) pushforward, componentwise (batched)."""
    r, th, ph = p[0], p[1], p[2]
    vr, vth, vph = v[0], v[1], v[2]
    st, ct = jnp.sin(th), jnp.cos(th)
    sp, cp = jnp.sin(ph), jnp.cos(ph)
    return jnp.stack([
        vr * st * cp + r * ct * cp * vth - r * st * sp * vph,
        vr * st * sp + r * ct * sp * vth + r * st * cp * vph,
        vr * ct - r * st * vth,
    ])


def _cart_vel_to_polar(c, v):
    """d(cart->polar) pushforward, componentwise."""
    x, y, z = c[0], c[1], c[2]
    vx, vy, vz = v[0], v[1], v[2]
    rho2 = x * x + y * y
    rho = jnp.sqrt(jnp.maximum(rho2, 1e-20))
    r2 = rho2 + z * z
    r = jnp.sqrt(jnp.maximum(r2, 1e-20))
    vr = (x * vx + y * vy + z * vz) / r
    vth = (z * (x * vx + y * vy) - rho2 * vz) / (r2 * rho)
    vph = (x * vy - y * vx) / rho2
    return jnp.stack([vr, vth, vph])


def to_planar(metric: Metric, pos: Array, vel: Array, params):
    """Rotate rays into the equatorial plane (``correct_lightray``).

    ``pos``/``vel`` are (4, N) generic coordinates.  Returns
    ``(pos', vel', inverse_quat (4, N))`` with theta = pi/2 and v_theta = 0.
    """
    polar = metric.to_polar(pos, params)
    polar_vel = jax.jvp(lambda x: metric.to_polar(x, params), (pos,),
                       (vel,))[1]

    fsign = jnp.sign(polar[1])
    fsign = jnp.where(fsign == 0, 1.0, fsign)
    p3 = jnp.stack([jnp.abs(polar[1]), polar[2], polar[3]])
    v3 = jnp.stack([polar_vel[1] * fsign, polar_vel[2], polar_vel[3]])

    cart = _polar3_to_cart(p3)
    cart_v = _polar_vel_to_cart(p3, v3)

    quat = theta_adjustment_quat(cart_v, cart, 1.0)
    inv_quat = theta_adjustment_quat(cart_v, cart, -1.0)

    cart_r = rot_quat_batched(cart, quat)
    cart_vr = rot_quat_batched(cart_v, quat)

    np3 = _cart_to_polar3(cart_r)
    nv3 = _cart_vel_to_polar(cart_r, cart_vr)

    # Exact equatorial pin (the rotation lands there up to fp noise).
    half_pi = jnp.full_like(np3[1], HALF_PI)
    new_polar = jnp.stack([polar[0], np3[0] * fsign, half_pi, np3[2]])
    new_pvel = jnp.stack([polar_vel[0], nv3[0] * fsign,
                          jnp.zeros_like(nv3[1]), nv3[2]])

    new_pos = metric.from_polar(new_polar, params)
    new_vel = jax.jvp(lambda x: metric.from_polar(x, params), (new_polar,),
                      (new_pvel,))[1]
    return new_pos, new_vel, inv_quat


def unrotate_angles(snapped_polar3: Array, inv_quat: Array) -> Array:
    """Rotate a final (r, theta, phi) back out of the equatorial plane with
    the stored inverse quat (readout path of ``get_intersection_position``
    cl.cl:5056-5064 / the ray-write unrotation cl.cl:4190-4215).

    Returns (r, theta, phi) (3, N); the r sign is preserved.
    """
    fsign = jnp.sign(snapped_polar3[0])
    fsign = jnp.where(fsign == 0, 1.0, fsign)
    p3 = jnp.stack([jnp.abs(snapped_polar3[0]), snapped_polar3[1],
                    snapped_polar3[2]])
    cart = _polar3_to_cart(p3)
    cart = rot_quat_batched(cart, inv_quat)
    out = _cart_to_polar3(cart)
    return jnp.stack([out[0] * fsign, out[1], out[2]])
