"""Camera state, quaternions, pixel directions, and observer tetrads.

Behavioural twin of the reference's camera handling (``camera`` struct
main.cpp:664-734, ``calculate_pixel_direction`` cl.cl:2044-2061, and the
orientation pass of ``calculate_tetrads`` cl.cl:2288-2439).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .coordinates import transforms as tr
from .metrics.base import Metric
from .ops import geometry, tetrad
from .ops.geometry import HIGHEST

Array = jax.Array


# ---------------------------------------------------------------------------
# Quaternions: (x, y, z, w), matching the reference layout (cl.cl:1976-2013)
# ---------------------------------------------------------------------------

def quat_identity() -> Array:
    return jnp.array([0.0, 0.0, 0.0, 1.0])


def axis_angle_quat(axis: Array, angle) -> Array:
    """cl.cl:2095-2103."""
    axis = axis / jnp.linalg.norm(axis)
    s = jnp.sin(angle / 2)
    return jnp.concatenate([axis * s, jnp.cos(angle / 2)[None]])


def quat_multiply(q1: Array, q2: Array) -> Array:
    """cl.cl:2105-2116."""
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def rot_quat(v: Array, q: Array) -> Array:
    """Rotate 3-vector by quaternion (toolkit ``rot_quat``)."""
    u = q[:3]
    w = q[3]
    return v + 2.0 * jnp.cross(u, jnp.cross(u, v) + w * v)


def rot_quat_batched(v3: Array, q: Array) -> Array:
    """Rotate a component-first (3, N) batch by one quaternion.

    Same math as :func:`rot_quat`, written componentwise so every
    operation is elementwise over the ray axis."""
    ux, uy, uz, w = q[0], q[1], q[2], q[3]
    vx, vy, vz = v3[0], v3[1], v3[2]
    c1x = uy * vz - uz * vy + w * vx
    c1y = uz * vx - ux * vz + w * vy
    c1z = ux * vy - uy * vx + w * vz
    return jnp.stack([
        vx + 2.0 * (uy * c1z - uz * c1y),
        vy + 2.0 * (uz * c1x - ux * c1z),
        vz + 2.0 * (ux * c1y - uy * c1x),
    ])


# ---------------------------------------------------------------------------
# Pixel directions
# ---------------------------------------------------------------------------

def pixel_directions(width: int, height: int, quat: Array, fov_degrees) -> Array:
    """Per-pixel camera-space ray directions, rotated by the camera quat
    (``calculate_pixel_direction`` cl.cl:2044-2061).  Returns (H, W, 3)."""
    fov_rad = fov_degrees * jnp.pi / 180.0
    f_stop = (width / 2) / jnp.tan(fov_rad / 2)
    cx = jnp.arange(width, dtype=jnp.float32) - width / 2.0
    cy = jnp.arange(height, dtype=jnp.float32) - height / 2.0
    dirx, diry = jnp.meshgrid(cx, cy)  # (H, W)
    d = jnp.stack([dirx, diry, jnp.broadcast_to(f_stop, dirx.shape)], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return jax.vmap(jax.vmap(lambda v: rot_quat(v, quat)))(d)


# ---------------------------------------------------------------------------
# Observer tetrad with camera orientation
# ---------------------------------------------------------------------------

def _orthonormalise3(v1: Array, v2: Array, v3: Array):
    """Euclidean Gram-Schmidt of 3 3-vectors (reference ``orthonormalise``)."""
    u1 = v1 / jnp.linalg.norm(v1)
    u2 = v2 - jnp.matmul(v2, u1, precision=HIGHEST) * u1
    u2 = u2 / jnp.linalg.norm(u2)
    u3 = (v3 - jnp.matmul(v3, u1, precision=HIGHEST) * u1
          - jnp.matmul(v3, u2, precision=HIGHEST) * u2)
    u3 = u3 / jnp.linalg.norm(u3)
    return u1, u2, u3


def observer_tetrad(metric: Metric, position: Array, params,
                    basis_speed3: Array | None = None,
                    orient: bool = True) -> Array:
    """Full observer tetrad at a generic position: frame basis, orientation to
    the global polar axes, then Lorentz boost — ``calculate_tetrads``
    (cl.cl:2288-2439).

    Returns ``es`` with rows (e0, e1, e2, e3); ``es[a][mu] = e_a^mu``.
    """
    gab = metric.fn(position, params)
    es, _ = tetrad.frame_basis(gab)

    if orient:
        polar_camera = metric.to_polar(position, params)
        apolar = polar_camera[1:4].at[0].set(jnp.abs(polar_camera[1]))
        cart_camera = tr.polar_to_cartesian3(apolar)

        inv_es = tetrad.tetrad_inverse(es)

        def to_generic(c3):
            s3 = tr.cartesian_velocity_to_polar_velocity(cart_camera, c3)
            s3 = s3.at[0].multiply(jnp.where(polar_camera[1] < 0, -1.0, 1.0))
            v4 = jnp.concatenate([jnp.zeros((1,)), s3])
            return metric.from_polar_velocity(polar_camera, v4, params)

        gx = to_generic(jnp.array([1.0, 0.0, 0.0]))
        gy = to_generic(jnp.array([0.0, 1.0, 0.0]))
        gz = to_generic(jnp.array([0.0, 0.0, 1.0]))

        # Normalise with y first so camera controls work intuitively
        # (cl.cl:2372-2376).
        tE1 = tetrad.coordinate_to_tetrad(gy, inv_es)
        tE2 = tetrad.coordinate_to_tetrad(gx, inv_es)
        tE3 = tetrad.coordinate_to_tetrad(gz, inv_es)

        b1, b2, b3 = _orthonormalise3(tE1[1:], tE2[1:], tE3[1:])

        def back(b3v):
            return tetrad.tetrad_to_coordinate(
                jnp.concatenate([jnp.zeros((1,)), b3v]), es
            )

        # x <- basis2, y <- basis1, z <- basis3 (cl.cl:2389-2398).
        es = jnp.stack([es[0], back(b2), back(b1), back(b3)])

    if basis_speed3 is None:
        basis_speed3 = jnp.zeros(3)
    return tetrad.boost_tetrad(es, basis_speed3, gab)


class Camera(NamedTuple):
    """Interactive camera state (reference ``camera`` struct main.cpp:664).

    ``frame_override`` attaches the camera to a recorded geodesic: a
    ``(generic_position, tetrad)`` pair (from physics.interpolate_camera)
    used verbatim instead of the static-observer construction.
    """

    polar_position: Array  # (t, r, theta, phi) in polar coordinates
    quat: Array  # orientation quaternion
    basis_speed: Array  # tetrad-frame 3-velocity of the observer
    frame_override: tuple | None = None

    @classmethod
    def default(cls) -> "Camera":
        return cls(
            polar_position=jnp.array([0.0, 7.0, jnp.pi / 2, -jnp.pi / 2]),
            quat=quat_identity(),
            basis_speed=jnp.zeros(3),
        )

    def on_geodesic(self, position: Array, tetrad: Array) -> "Camera":
        """Attach to a geodesic frame (reference "Snapshot Camera Geodesic"
        flow, main.cpp:2675-2759)."""
        return self._replace(frame_override=(position, tetrad))

    def rotate(self, yaw=0.0, pitch=0.0, roll=0.0) -> "Camera":
        """Local-axis rotation, matching camera::rotate (main.cpp:686-699)."""
        q = self.quat
        for axis, angle in (
            (jnp.array([0.0, 0.0, 1.0]), roll),
            (jnp.array([1.0, 0.0, 0.0]), pitch),
            (jnp.array([0.0, 1.0, 0.0]), yaw),
        ):
            local_axis = rot_quat(axis, q)
            q = quat_multiply(axis_angle_quat(local_axis, jnp.asarray(angle)), q)
        return self._replace(quat=q)

    def translate(self, local_dir3: Array, amount) -> "Camera":
        """Move along a camera-local direction in flat cartesian terms
        (main.cpp:701-711)."""
        d = rot_quat(local_dir3, self.quat)
        apolar = self.polar_position[1:4]
        cart = tr.polar_to_cartesian3(
            apolar.at[0].set(jnp.abs(apolar[0]))
        )
        new_cart = cart + d * amount
        new_polar = tr.cartesian_to_polar3(new_cart)
        new_polar = new_polar.at[0].multiply(
            jnp.where(self.polar_position[1] < 0, -1.0, 1.0)
        )
        return self._replace(
            polar_position=jnp.concatenate(
                [self.polar_position[:1], new_polar]
            )
        )
