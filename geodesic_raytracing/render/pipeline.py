"""End-to-end render pipeline: camera -> rays -> geodesics -> image.

Mirrors the reference frame loop's kernel dispatch sequence
(main.cpp:2240-2525): ``cart_to_generic`` -> ``init_basis_vectors`` ->
``init_rays_generic`` -> ``do_generic_rays`` -> ``calculate_render_data`` ->
``render``, re-expressed as jitted stages over whole-image ray batches.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import camera as cam
from ..coordinates import transforms as tr
from ..metrics.base import Metric
from ..ops import geometry, integrate, tetrad
from ..ops.geometry import HIGHEST
from ..ops.integrate import Features, RayState, TraceOptions
from . import background as bg
from . import colour

Array = jax.Array


class RenderData(NamedTuple):
    """Per-pixel shading inputs (reference ``struct render_data``
    cl.cl:5066-5074).  ``angles`` keeps the snapped (theta, phi) so the
    adaptive sampler can measure angular error without re-deriving it."""

    tex_coord: Array  # (N, 2) in [0,1]^2
    z_shift: Array  # (N,)
    side: Array  # (N,) int32: 1 = r>=0 universe, 0 = far side
    terminated: Array  # (N,) int32 status
    angles: Array  # (N, 2) snapped (theta, phi)
    steps: Array  # (N,) committed integrator steps (cost diagnostics)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render settings (graphics_settings.hpp:8-47 subset)."""

    width: int = 1920
    height: int = 1080
    fov_degrees: float = 90.0
    anisotropy: int = 16
    redshift: bool = False
    # use_old_redshift feature (main.cpp:1139): skip the blueshift
    # energy-overflow redistribution (cl.cl:5397-5406).
    old_redshift: bool = False
    # DOMINANT_COLOUR variant (cl.cl:5724-5792): per-pixel test wavelength.
    dominant_colour: bool = False
    # Spectral-shift experiment on the CIE 1931 horseshoe (the reference's
    # unused srgb_to_wavelength, chromaticity.hpp:536).
    spectral_redshift: bool = False
    flip_geodesic_direction: bool = False
    trace: TraceOptions = TraceOptions()
    # Reference defaults: adaptive sampling on (main.cpp:1152), threshold 64
    # pixels-of-angle (main.cpp:1155); prepass per metric config.
    adaptive_sampling: bool = False
    adaptive_threshold: float = 64.0
    prepass_scale: int = 16
    # Refinement ray budget as a fraction of quarter blocks.  The reference
    # emits a variable-length refinement list via atomic_add (cl.cl:5294);
    # static shapes need a bound.  Blocks are prioritised by angular
    # error (terminated-mismatch blocks first), so when a frame wants more
    # refinement than the budget, the lowest-error blocks fall back to
    # sphere interpolation.  1.0 = trace every block densely (no budget).
    refine_budget: float = 0.375
    trilinear: bool = True  # mip blending; False = nearest level (cheaper)
    # Bilinear-filter each EWA probe (reference behaviour, 4 gathers/probe).
    # Default off: probes are gaussian-averaged anyway, and nearest-texel
    # probes cost 1 gather instead of 4.
    probe_bilinear: bool = False
    # EWA probe-iteration schedule over the sorted prefix:
    # ((frac, iters), ...) — see background.sample_anisotropic.  Empty =
    # one segment, the top third of pixels at the full anisotropy budget.
    probe_segments: tuple = ()
    # Shade only the traced rays (quarter grid + refined blocks) and
    # bilinearly interpolate RGB for blocks that passed the angular-error
    # test, instead of assembling full-res render data and shading every
    # pixel.  The reference interpolates pre-shading data and shades every
    # pixel (cl.cl:5223-5344 then 5453-5687); here every shaded pixel is
    # a set of texture gathers without texture units, and a block smooth
    # enough to interpolate render data across is smooth enough to
    # interpolate RGB across — so the gathers run only for traced rays.
    shade_traced_only: bool = True
    # Probe schedule for the refine-ray shade set under shade_traced_only.
    # Refined blocks concentrate at terminator edges and high-warp regions,
    # so their probe demand is far above the image-wide distribution; empty
    # derives a schedule from probe_segments with 4x the fractions.
    refine_probe_segments: tuple = ()
    # Constant-theta planar tracing for spherically symmetric metrics
    # (exact by symmetry; GENERIC_CONSTANT_THETA).
    planar: bool = True


# ---------------------------------------------------------------------------
# Ray initialisation
# ---------------------------------------------------------------------------

def camera_to_generic(metric: Metric, camera: cam.Camera, params) -> Array:
    """Polar camera position -> metric generic coordinates
    (``cart_to_generic_kernel`` cl.cl:6018 via from_polar)."""
    return metric.from_polar(camera.polar_position, params)


def camera_frame(metric: Metric, camera: cam.Camera, params):
    """Generic camera position + oriented, boosted observer tetrad.

    A camera riding a recorded geodesic (``frame_override``) supplies its
    interpolated position/tetrad directly (handle_interpolating_geodesic
    cl.cl:2738-2872) and skips the static-observer construction."""
    if camera.frame_override is not None:
        return camera.frame_override
    position = camera_to_generic(metric, camera, params)
    es = cam.observer_tetrad(
        metric, position, params, basis_speed3=camera.basis_speed, orient=True
    )
    return position, es


def _trace_sign(metric: Metric, settings: RenderSettings) -> float:
    sign = -1.0  # backwards-in-affine-time tracing (cl.cl:3196-3206)
    if metric.config.follow_geodesics_forward:
        sign = 1.0
    if settings.flip_geodesic_direction:
        sign = -sign
    return sign


def rays_for_pixels(metric: Metric, camera: cam.Camera, position, es, params,
                    settings: RenderSettings, features: Features,
                    cx: Array, cy: Array, planar: bool = False):
    """Null rays for arbitrary pixel index arrays (``init_rays_generic``
    cl.cl:3143-3251 + ``geodesic_to_render_ray`` cl.cl:3000-3065).

    ``cx``/``cy`` are flat float arrays of pixel coordinates in the full
    W x H image.  With ``planar`` every ray is rotated into the equatorial
    plane (``correct_lightray``).  Returns ``(state, ku_uobsu, inv_quat)``
    (inv_quat None unless planar).
    """
    W, H = settings.width, settings.height
    fov_rad = settings.fov_degrees * jnp.pi / 180.0
    f_stop = (W / 2) / jnp.tan(fov_rad / 2)
    dx = cx - W / 2.0
    dy = cy - H / 2.0
    dz = jnp.broadcast_to(jnp.asarray(f_stop, jnp.float32), cx.shape)
    inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    dirs = cam.rot_quat_batched(jnp.stack([dx * inv, dy * inv, dz * inv]),
                                camera.quat)  # (3, N) component-first

    sign = _trace_sign(metric, settings)
    velocity = (
        dirs[0][:, None] * es[1][None, :]
        + dirs[1][:, None] * es[2][None, :]
        + dirs[2][:, None] * es[3][None, :]
        + sign * es[0][None, :]
    )
    n = velocity.shape[0]
    positions = jnp.broadcast_to(position, (n, 4))

    inv_quat = None
    if planar:
        from ..ops import planar as pl_planar

        p_t, v_t, inv_quat = pl_planar.to_planar(
            metric, positions.T, velocity.T, params
        )
        positions, velocity = p_t.T, v_t.T

    state = integrate.init_ray_state(
        metric, positions, velocity, params, features, fix_null_velocity=True
    )
    if planar:
        # pin residual theta dynamics from the rotation's fp noise
        state = state._replace(
            velocity=state.velocity.at[:, 2].set(0.0),
            acceleration=state.acceleration.at[:, 2].set(0.0),
        )

    # ku_uobsu: observer-frame energy at emission (cl.cl:3047-3060).
    gab = metric.fn(position, params)
    uobs_low = jnp.matmul(gab, es[0], precision=HIGHEST)
    ku_uobsu = jnp.matmul(state.velocity, uobs_low, precision=HIGHEST)
    return state, ku_uobsu, inv_quat


def _planar_enabled(metric: Metric, settings: RenderSettings) -> bool:
    """Constant-theta planar tracing applies to spherically symmetric
    metrics (the reference's is_polar_spherically_symmetric gate,
    metric.hpp:557-622 -> GENERIC_CONSTANT_THETA)."""
    return bool(metric.spherically_symmetric) and settings.planar


def init_camera_rays(metric: Metric, camera: cam.Camera, params,
                     settings: RenderSettings,
                     features: Features = Features()):
    """Full-image ray batch, flattened to N = W*H (row-major).

    Returns ``(state, ku_uobsu, inv_quat)``."""
    W, H = settings.width, settings.height
    position, es = camera_frame(metric, camera, params)
    yy, xx = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    return rays_for_pixels(metric, camera, position, es, params, settings,
                           features, xx.reshape(-1), yy.reshape(-1),
                           planar=_planar_enabled(metric, settings))


# ---------------------------------------------------------------------------
# Render data (texture coords + redshift factor)
# ---------------------------------------------------------------------------

def angle_to_tex(angles: Array) -> Array:
    """(theta, phi) -> equirect uv (cl.cl:5081-5101)."""
    theta = jnp.mod(angles[..., 0], 2 * jnp.pi)
    phi = angles[..., 1]
    over = theta >= jnp.pi
    phi = jnp.where(over, phi + jnp.pi, phi)
    theta = jnp.where(over, theta - jnp.pi, theta)
    phi = jnp.mod(phi, 2 * jnp.pi)
    sx = phi / (2 * jnp.pi) + 0.5
    sy = theta / jnp.pi
    return jnp.stack([sx, sy], axis=-1)


def _fix_ray_position_batched(p3, v3, sphere_radius):
    """Batched :func:`_fix_ray_position`: p3/v3 (3, N) polar (r, theta, phi)
    position/velocity.  Returns snapped (3, N)."""
    sign = jnp.sign(p3[0])
    sign = jnp.where(sign == 0, 1.0, sign)
    r = jnp.abs(p3[0])
    th, ph = p3[1], p3[2]
    vr = v3[0] * sign
    vth, vph = v3[1], v3[2]

    st, ct = jnp.sin(th), jnp.cos(th)
    sp, cp = jnp.sin(ph), jnp.cos(ph)
    px = r * st * cp
    py = r * st * sp
    pz = r * ct
    # d(polar->cart) applied to (vr, vth, vph)
    vx = vr * st * cp + r * ct * cp * vth - r * st * sp * vph
    vy = vr * st * sp + r * ct * sp * vth + r * st * cp * vph
    vz = vr * ct - r * st * vth

    vn = jnp.sqrt(vx * vx + vy * vy + vz * vz)
    vn = jnp.where(vn < 1e-12, 1.0, vn)
    vx, vy, vz = vx / vn, vy / vn, vz / vn

    b = 2.0 * (vx * px + vy * py + vz * pz)
    c = px * px + py * py + pz * pz - sphere_radius * sphere_radius
    disc = b * b - 4.0 * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    t = jnp.where(jnp.abs(t0) < jnp.abs(t1), t0, t1)
    t = jnp.where(disc < 0, 0.0, t)
    nx, ny, nz = px + t * vx, py + t * vy, pz + t * vz

    nr = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    nth = jnp.arctan2(jnp.sqrt(nx * nx + ny * ny), nz)
    nph = jnp.arctan2(ny, nx)
    return jnp.stack([nr * sign, nth, nph])


def compute_render_data(metric: Metric, state: RayState, ku_uobsu: Array,
                        params, features: Features = Features(),
                        inv_quat: Array | None = None) -> RenderData:
    """``calculate_render_data`` (cl.cl:5135-5220): terminated rays are
    snapped to the universe sphere, textured by final (theta, phi), with the
    observed/emitted energy ratio z_shift.

    Component-first batched throughout (incl. the per-endpoint frame basis) —
    this stage runs at every ray of every frame, and the per-ray vmap layout
    was costing more than the integration itself.
    """
    cfg = metric.config
    n = state.position.shape[0]
    pos = state.position.T  # (4, N)
    vel = state.velocity.T
    rdl = state.running_dlambda_dnew
    status = state.status

    polar = metric.to_polar(pos, params)
    polar_vel = jax.jvp(
        lambda x: metric.to_polar(x, params), (pos,), (vel,)
    )[1]

    # Snap: escaped rays to the universe sphere; singular-terminated rays to
    # the terminator sphere (get_intersection_position cl.cl:5024-5050).
    snapped_far = _fix_ray_position_batched(polar[1:], polar_vel[1:],
                                            features.universe_size)
    if cfg.singular and cfg.traversable_event_horizon:
        # Terminator-sphere snap only for traversable horizons
        # (cl.cl:5041-5045 `#if defined(SINGULAR) && defined(TRAVERSABLE_
        # EVENT_HORIZON)`); non-traversable metrics keep the raw endpoint so
        # the |r| <= 1 black test below can fire.
        snapped_near = _fix_ray_position_batched(polar[1:], polar_vel[1:],
                                                 cfg.singular_terminator)
        is_far = jnp.abs(polar[1]) >= 0.5 * (
            features.universe_size + cfg.singular_terminator
        )
        snapped = jnp.where(is_far[None, :], snapped_far, snapped_near)
    elif cfg.singular:
        is_far = jnp.abs(polar[1]) >= 0.5 * (
            features.universe_size + cfg.singular_terminator
        )
        raw = jnp.stack([polar[1], polar[2], polar[3]])
        snapped = jnp.where(is_far[None, :], snapped_far, raw)
    else:
        snapped = snapped_far

    if inv_quat is not None:
        # Planar mode: rotate the equatorial endpoint back to the ray's true
        # plane (get_intersection_position cl.cl:5056-5064).
        from ..ops import planar as pl_planar

        snapped = pl_planar.unrotate_angles(snapped, inv_quat)

    side = jnp.where(polar[1] < 0, 0, 1).astype(jnp.int32)

    # Fresh (unoriented, unboosted) tetrad at every endpoint for the
    # observed frequency (cl.cl:5185-5208).
    gab = metric.fn(pos, params)
    if gab.ndim == 2:
        gab = jnp.broadcast_to(gab[..., None], (4, 4, n))
    es, _ = tetrad.frame_basis_batched(gab)
    e0 = es[0]  # (4, N)
    obs_low = [
        sum(gab[a, b] * e0[b] for b in range(4)) for a in range(4)
    ]
    gen_vel = vel / rdl[None, :]
    z_shift = (
        sum(gen_vel[a] * obs_low[a] for a in range(4)) / ku_uobsu - 1.0
    )
    z_shift = jnp.maximum(z_shift, -0.999)

    ang = jnp.stack([snapped[1], snapped[2]], axis=-1)  # (N, 2)
    tex = angle_to_tex(ang)

    if not cfg.traversable_event_horizon:
        # Non-traversable metrics: endpoints inside |r| <= 1 shade black
        # (cl.cl:5177-5183).
        status = jnp.where(
            (status == integrate.ESCAPED) & (jnp.abs(snapped[0]) <= 1.0),
            integrate.DEAD,
            status,
        )

    return RenderData(tex_coord=tex, z_shift=z_shift, side=side,
                      terminated=status, angles=ang, steps=state.steps)


# ---------------------------------------------------------------------------
# Adaptive sampling + prepass (reference defaults: main.cpp:1152-1155,
# handle_adaptive_sampling cl.cl:5223-5344, prepass cl.cl:4997-5020 +
# init_rays_generic:3213-3232)
# ---------------------------------------------------------------------------

def _ang_to_vec(angles: Array) -> Array:
    """(theta, phi) -> unit 3-vector, component-last."""
    th, ph = angles[..., 0], angles[..., 1]
    st = jnp.sin(th)
    return jnp.stack([st * jnp.cos(ph), st * jnp.sin(ph), jnp.cos(th)],
                     axis=-1)


def _vec_to_ang(v: Array) -> Array:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [jnp.arctan2(jnp.sqrt(x * x + y * y), z), jnp.arctan2(y, x)], axis=-1
    )


def _angle_between(a1: Array, a2: Array) -> Array:
    """Great-circle angle between two (theta, phi) fields
    (``angle_between_angles2`` cl.cl:5216-5221)."""
    d = jnp.sum(_ang_to_vec(a1) * _ang_to_vec(a2), axis=-1)
    return jnp.arccos(jnp.clip(d, -1.0, 1.0))


def _interp_rdata(c: RenderData, o: RenderData,
                  vc: Array | None = None, vo: Array | None = None
                  ) -> RenderData:
    """``interpolate_render_data`` (cl.cl:5111-5133): midpoint on the sphere,
    averaged z_shift, centre's terminated flag.

    ``vc``/``vo``: optional precomputed ``_ang_to_vec`` of the two angle
    fields — the assemble stage shares ONE conversion of the quarter grid
    across its three neighbour interpolations (the sphere trig was half the
    finish stage)."""
    if vc is None:
        vc = _ang_to_vec(c.angles)
    if vo is None:
        vo = _ang_to_vec(o.angles)
    ang = _vec_to_ang((vc + vo) / 2.0)
    return RenderData(
        tex_coord=angle_to_tex(ang),
        z_shift=(c.z_shift + o.z_shift) / 2.0,
        side=(c.side + o.side) // 2,
        terminated=c.terminated,
        angles=ang,
        steps=c.steps,
    )


def _shift2d(x: Array, dy: int, dx: int, fill):
    """2D shift with edge fill (pad + slice; no gathers)."""
    ph, pw = x.shape
    x = jnp.pad(x, ((1, 1), (1, 1)), constant_values=fill)
    return x[1 + dy:1 + dy + ph, 1 + dx:1 + dx + pw]


def _upsample_round(small: Array, cx_count: int, cy_count: int,
                    step: float, W: int, H: int) -> Array:
    """Evaluate ``small[round(cy*ph/H), round(cx*pw/W)]`` for the regular
    pixel grids ``cx = step*ix``, ``cy = step*iy`` WITHOUT per-ray gathers:
    the index map is a monotone nearest-neighbour upsample, so it is a
    static jnp.repeat + phase slice (the per-ray table gathers this
    replaces were half the ray-setup stage)."""
    ph, pw = small.shape

    def axis_index(n_out, n_small, extent):
        # round(step*i*n_small/extent) for i in [0, n_out)
        idx = np.round(np.arange(n_out) * step * n_small / extent)
        return np.clip(idx, 0, n_small - 1).astype(np.int32)

    ix = axis_index(cx_count, pw, W)
    iy = axis_index(cy_count, ph, H)
    # Static monotone indices: XLA lowers repeat/concat of slices, but the
    # cleanest exact form is take with a constant index vector per axis —
    # constant-index takes on one axis compile to slices+concats, not
    # dynamic gathers.
    rows = jnp.repeat(small, np.bincount(iy, minlength=ph), axis=0,
                      total_repeat_length=cy_count)
    return jnp.repeat(rows, np.bincount(ix, minlength=pw), axis=1,
                      total_repeat_length=cx_count)


@functools.partial(jax.jit, static_argnames=("W", "H", "qw", "qh"))
def _prepass_kill(dead: Array, W: int, H: int, qw: int, qh: int) -> Array:
    """Quarter-grid kill mask from the low-res prepass dead map: a ray skips
    tracing when its prepass cell and 4 neighbours all terminate black
    (should_early_terminate x5, cl.cl:3213-3232).  Neighbour logic runs on
    the small map (shifts), then nearest-upsamples to the quarter grid."""
    d5 = (_shift2d(dead, 0, -1, False) & dead & _shift2d(dead, 0, 1, False)
          & _shift2d(dead, -1, 0, False) & _shift2d(dead, 1, 0, False))
    return _upsample_round(d5, qw, qh, 2.0, W, H).reshape(-1)


@functools.partial(jax.jit, static_argnames=("W", "H", "qw", "qh"))
def _prepass_cost(psteps: Array, W: int, H: int, qw: int, qh: int) -> Array:
    """Per-ray cost estimate from the prepass step counts: the max over the
    ray's prepass cell and neighbours (the cost map that
    ``parallel.mesh``'s cost-balanced band layout prices row chunks by)."""
    m = jnp.maximum
    s5 = m(m(m(_shift2d(psteps, 0, -1, 0), psteps),
             m(_shift2d(psteps, 0, 1, 0), _shift2d(psteps, -1, 0, 0))),
           _shift2d(psteps, 1, 0, 0))
    return _upsample_round(s5, qw, qh, 2.0, W, H).astype(
        jnp.float32).reshape(-1)


def _init_rays(metric: Metric, camera: cam.Camera, params,
               settings: RenderSettings, features: Features,
               cx: Array, cy: Array, kill: Array | None):
    position, es = camera_frame(metric, camera, params)
    state, ku, iquat = rays_for_pixels(
        metric, camera, position, es, params, settings, features, cx, cy,
        planar=_planar_enabled(metric, settings),
    )
    if kill is not None:
        state = state._replace(
            status=jnp.where(kill, integrate.DEAD, state.status)
        )
    return state, ku, iquat


_init_rays_jit = functools.partial(
    jax.jit, static_argnames=("metric", "settings")
)(_init_rays)


@functools.partial(jax.jit, static_argnames=("metric", "settings"))
def _trace_jit(metric: Metric, state, params, settings: RenderSettings,
               features: Features):
    """One trace program: the XLA ``while`` driver over a fresh ray batch."""
    opts = dataclasses.replace(settings.trace,
                               planar=_planar_enabled(metric, settings))
    return integrate.trace_rays(metric, state, params, features=features,
                                opts=opts)


@functools.partial(jax.jit, static_argnames=("metric", "settings"))
def _prepass_dead_map(metric: Metric, camera: cam.Camera, params,
                      settings: RenderSettings, features: Features):
    position, es = camera_frame(metric, camera, params)
    W, H = settings.width, settings.height
    yy, xx = jnp.meshgrid(
        jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32),
        indexing="ij",
    )
    pstate, _, _ = rays_for_pixels(metric, camera, position, es, params,
                                   settings, features,
                                   xx.reshape(-1), yy.reshape(-1),
                                   planar=_planar_enabled(metric, settings))
    popts = dataclasses.replace(
        settings.trace, planar=_planar_enabled(metric, settings)
    )
    pfin = integrate.trace_rays(metric, pstate, params, features=features,
                                opts=popts)
    dead = (pfin.status == integrate.DEAD).reshape(H, W)
    steps = pfin.steps.reshape(H, W)
    return dead, steps


class RefineBudgetController:
    """Cross-frame controller: demand-proportional refinement budgeting.

    The reference sizes its refinement dispatch by an atomic counter —
    exactly the frame's demand (cl.cl:5294, dispatched
    main.cpp:2478-2510).  Static shapes can't do that per frame, so the
    demand fraction is quantised to a few buckets and the pipeline
    re-specialises via jit recompile when the bucket changes — the same
    dynamic->static program swap the reference uses for metric parameters
    (metric_manager.hpp:172-219).

    Feedback never blocks the pipeline: the demand scalar of frame t starts
    an async device->host copy and is consulted ``latency`` frames later.
    The budget grows immediately when demand rises (quality first:
    over-budget blocks fall back to sphere interpolation) and shrinks only
    after ``down_patience`` consecutive low frames (hysteresis against
    recompile thrash).
    """

    BUCKETS = (1 / 16, 1 / 8, 3 / 16, 1 / 4, 3 / 8, 1 / 2, 3 / 4, 1.0)

    def __init__(self, margin: float = 1.3, latency: int = 2,
                 down_patience: int = 3):
        self._pending: list = []
        self._margin = margin
        self._latency = latency
        self._down_patience = down_patience
        self._down = 0
        self._current: float | None = None
        # Previous frame's quarter termination statuses + the stream key
        # they were rendered under.  When the key is unchanged (same camera/
        # params/features objects — a static frame stream), the prepass is
        # skipped entirely: last frame's quarter-grid dead map (at 8x finer
        # resolution than the 16x prepass) supplies the kill mask, eroded by
        # the same 5-neighbour test the reference applies to its prepass
        # cells (cl.cl:3213-3232).
        self.qterm: Array | None = None
        self.stream_key: tuple | None = None

    def fraction(self, cap: float) -> float:
        """The refine budget to use for the next frame (<= cap)."""
        if self._current is None:
            return cap
        return min(self._current, cap)

    def observe(self, demand_scalar) -> None:
        """Feed the measured demand fraction (a device scalar) of the frame
        just issued; consumes matured entries without blocking on fresh
        ones."""
        try:
            demand_scalar.copy_to_host_async()
        except AttributeError:
            pass  # non-jax input (tests)
        self._pending.append(demand_scalar)
        while len(self._pending) > self._latency:
            self._update(float(np.asarray(self._pending.pop(0))))

    def _update(self, demand: float) -> None:
        want = demand * self._margin
        target = next((b for b in self.BUCKETS if b >= want), 1.0)
        if self._current is None or target > self._current:
            self._current = target
            self._down = 0
        elif target < self._current:
            self._down += 1
            if self._down >= self._down_patience:
                self._current = target
                self._down = 0
        else:
            self._down = 0


def _adaptive_trace(metric: Metric, camera: cam.Camera, params,
                    settings: RenderSettings, features: Features,
                    controller: RefineBudgetController | None = None):
    """The adaptive pipeline's trace half: prepass + quarter trace +
    budgeted refinement selection + refine trace.

    Returns ``(qr, should, sel, dest, rstate, rku, riquat, k)`` — the
    operands of a finish stage (:func:`_finish_jit` for full-res render
    data, :func:`_finish_shade_jit` for traced-only RGB).
    """
    W, H = settings.width, settings.height
    assert W % 2 == 0 and H % 2 == 0, "adaptive sampling needs even dims"
    Wh, Hh = W // 2, H // 2
    nq = Wh * Hh

    # Steady-state prepass reuse: identical (camera, params, features)
    # objects mean last frame's quarter dead map is exact — skip the
    # prepass trace and derive the kill mask from feedback instead.
    key = _stream_key(camera, params, features)
    # Reuse replaces the prepass, so it is gated on the same config bit —
    # metrics without use_prepass never early-kill (reference parity).
    reuse = (metric.config.use_prepass and controller is not None
             and controller.qterm is not None
             and controller.stream_key == key)
    dead = None
    if metric.config.use_prepass and not reuse:
        pw = max(W // settings.prepass_scale, 4)
        ph = max(H // settings.prepass_scale, 4)
        psettings = dataclasses.replace(settings, width=pw, height=ph,
                                        adaptive_sampling=False)
        dead, _ = _prepass_dead_map(metric, camera, params, psettings,
                                    features)

    prev_term = controller.qterm if reuse else None
    state, ku, iquat = _quarter_setup_jit(
        metric, camera, params, settings, features, dead, prev_term)
    state = _trace_jit(metric, state, params, settings, features)

    frac = settings.refine_budget
    if controller is not None:
        frac = controller.fraction(settings.refine_budget)
    if frac >= 1.0:
        k = nq
    else:
        k = max(min(nq, 1024), (int(nq * frac) // 8) * 8)
    (qr, should, demand, sel, dest, rstate, rku,
     riquat) = _refine_setup_jit(metric, camera, params, settings, features,
                                 state, ku, iquat, k)
    if controller is not None:
        controller.observe(demand)
        controller.qterm = qr.terminated
        controller.stream_key = key
    rstate = _trace_jit(metric, rstate, params, settings, features)
    return qr, should, sel, dest, rstate, rku, riquat, k


def render_data_adaptive(metric: Metric, camera: cam.Camera, params,
                         settings: RenderSettings, features: Features,
                         controller: RefineBudgetController | None = None,
                         ) -> RenderData:
    """Quarter-density trace + error-driven refinement + optional prepass.

    The reference's atomic variable-length refinement list (cl.cl:5294)
    becomes a budgeted top-k block batch (``refine_budget``; 1.0 = every
    block, masked), optionally demand-sized across frames by a
    :class:`RefineBudgetController`.  The frame is exactly 5-6 XLA programs
    chained from the host — prepass, quarter setup, quarter trace, refine
    setup, refine trace, finish — with all jnp glue inside them (every
    un-jitted glue op would be its own tiny program).
    """
    qr, should, sel, dest, rstate, rku, riquat, k = _adaptive_trace(
        metric, camera, params, settings, features, controller)
    return _finish_jit(metric, rstate, rku, riquat, params, features,
                       qr, should, sel, dest, settings, k)


def render_frame_adaptive(metric: Metric, camera: cam.Camera, params,
                          backgrounds: bg.Background,
                          settings: RenderSettings, features: Features,
                          controller: RefineBudgetController | None = None,
                          ) -> Array:
    """Adaptive frame with traced-only shading: the quarter grid and the k
    refined blocks' rays are shaded directly off their render data; blocks
    that passed the angular-error test get bilinear RGB interpolation from
    the quarter corners instead of per-pixel background gathers.

    The reference interpolates render data and shades every pixel
    (cl.cl:5223-5344, 5453-5687) because its texture units make shading
    nearly free; here every shaded pixel is 1-2 gathers from device
    memory, so the gathers run only where a ray was actually traced
    (~nq + 3k pixels instead of 4nq).
    """
    qr, should, sel, dest, rstate, rku, riquat, k = _adaptive_trace(
        metric, camera, params, settings, features, controller)
    return _finish_shade_jit(metric, rstate, rku, riquat, params, features,
                             qr, should, sel, dest, backgrounds, settings, k)


def _qcoords(settings: RenderSettings):
    """Flat pixel coordinates of the quarter (even) pixels."""
    Wh, Hh = settings.width // 2, settings.height // 2
    yy, xx = jnp.meshgrid(
        2.0 * jnp.arange(Hh, dtype=jnp.float32),
        2.0 * jnp.arange(Wh, dtype=jnp.float32),
        indexing="ij",
    )
    return xx.reshape(-1), yy.reshape(-1)


def _stream_key(camera, params, features) -> tuple:
    """Cheap identity key for a frame stream: array leaves compare by object
    id (comparing values would fetch them from the device), scalars by
    value.  A frame loop that reuses its camera/params
    objects (bench.py, the CLI) gets steady-state reuse; one that rebuilds
    them every frame just re-runs the prepass — conservative, never wrong."""
    leaves, treedef = jax.tree.flatten((camera, params, features))
    return treedef, tuple(
        x if isinstance(x, (int, float, bool, str, type(None))) else id(x)
        for x in leaves
    )


@functools.partial(jax.jit, static_argnames=("metric", "settings"))
def _quarter_setup_jit(metric: Metric, camera: cam.Camera, params,
                       settings: RenderSettings, features: Features,
                       dead: Array | None, prev_qterm: Array | None = None):
    """Quarter-pass ray init fused with the prepass kill probe.

    ``prev_qterm``: the previous frame's quarter termination statuses,
    supplied ONLY for an identical frame (same camera/params/features):
    the kill mask comes from last frame's dead map — exact at steady state,
    eroded by the reference's 5-neighbour margin — and the prepass trace is
    skipped entirely."""
    W, H = settings.width, settings.height
    qcx, qcy = _qcoords(settings)
    kill = None
    if dead is not None:
        kill = _prepass_kill(dead, W, H, W // 2, H // 2)
    if prev_qterm is not None:
        dg = (prev_qterm == integrate.DEAD).reshape(H // 2, W // 2)
        d5 = (_shift2d(dg, 0, -1, False) & dg & _shift2d(dg, 0, 1, False)
              & _shift2d(dg, -1, 0, False) & _shift2d(dg, 1, 0, False))
        kill = d5.reshape(-1)
    return _init_rays(metric, camera, params, settings, features, qcx, qcy,
                      kill)


_REFINE_OFFSETS = ((1, 0), (0, 1), (1, 1))


@functools.partial(jax.jit, static_argnames=("metric", "settings", "k"))
def _refine_setup_jit(metric: Metric, camera: cam.Camera, params,
                      settings: RenderSettings, features: Features,
                      qstate, qku, qiquat, k: int):
    """Quarter render-data + top-k block selection + refine-ray init, fused
    into one program (handle_adaptive_sampling's decision half,
    cl.cl:5240-5294)."""
    Wh, Hh = settings.width // 2, settings.height // 2
    qr = compute_render_data(metric, qstate, qku, params, features,
                             inv_quat=qiquat)
    qg = RenderData(*(f.reshape((Hh, Wh) + f.shape[1:]) for f in qr))

    should, sel, dest = _select_refine_blocks(qg, settings, k)
    # Demand fraction for the budget controller — computed here so it costs
    # no extra program dispatch.
    demand = jnp.mean(should.astype(jnp.float32))
    sflat = should.reshape(-1)[sel]
    qcx, qcy = _qcoords(settings)
    scx, scy = qcx[sel], qcy[sel]
    rcx = jnp.concatenate([scx + ox for ox, oy in _REFINE_OFFSETS])
    rcy = jnp.concatenate([scy + oy for ox, oy in _REFINE_OFFSETS])
    rkill = ~jnp.concatenate([sflat] * 3)

    rstate, rku, riquat = _init_rays(metric, camera, params, settings,
                                     features, rcx, rcy, rkill)
    return qr, should, demand, sel, dest, rstate, rku, riquat


@functools.partial(jax.jit, static_argnames=("metric", "settings", "k"))
def _finish_jit(metric: Metric, rstate, rku, riquat, params,
                features: Features, qr: RenderData, should: Array,
                sel: Array, dest: Array, settings: RenderSettings,
                k: int) -> RenderData:
    """Refine render-data + scatter-back + assembly, fused into one program.

    The k traced blocks return to the (Hh, Wh) grid with ONE (k, 24) row
    scatter: all RenderData fields pack into f32 columns (statuses/steps are
    small ints, exact in f32), and the three offset parts share the block
    ids, so 21 per-field gathers over nq rows collapse to one k-row scatter
    (k < 0.4 nq: scattering the traced rows costs ~2.7x fewer rows than
    gathering every block's)."""
    Wh, Hh = settings.width // 2, settings.height // 2
    nq = Wh * Hh
    rr = compute_render_data(metric, rstate, rku, params, features,
                             inv_quat=riquat)

    packed = jnp.concatenate([
        rr.tex_coord,                                   # 0, 1
        rr.z_shift[:, None],                            # 2
        rr.side.astype(jnp.float32)[:, None],           # 3
        rr.terminated.astype(jnp.float32)[:, None],     # 4
        rr.angles,                                      # 5, 6
        rr.steps.astype(jnp.float32)[:, None],          # 7
    ], axis=-1)                                         # (3k, 8)

    ok = dest < k

    def grid(x):
        return x.reshape((Hh, Wh) + x.shape[1:])

    wide = jnp.zeros((nq, 24), jnp.float32).at[sel].set(
        jnp.concatenate(
            [packed[0:k], packed[k:2 * k], packed[2 * k:3 * k]], axis=1
        ),
        indices_are_sorted=False, unique_indices=True,
    )

    def part(i):
        g = wide[:, i * 8:(i + 1) * 8]
        return RenderData(
            tex_coord=grid(g[:, 0:2]),
            z_shift=grid(g[:, 2]),
            side=grid(g[:, 3].astype(jnp.int32)),
            terminated=grid(g[:, 4].astype(jnp.int32)),
            angles=grid(g[:, 5:7]),
            steps=grid(g[:, 7].astype(jnp.int32)),
        )

    qg = RenderData(*(grid(f) for f in qr))
    # Blocks over budget fall back to interpolation.
    traced_ok = should & ok.reshape(Hh, Wh)
    return _adaptive_assemble(qg, part(0), part(1), part(2), traced_ok,
                              settings)


def _shade_set(rdata_tex, rdata_side, rdata_z, rdata_term, dx, dy,
               backgrounds: bg.Background, settings: RenderSettings,
               segments: tuple) -> Array:
    """Shade one flat traced-ray set: EWA sample + redshift + black mask.
    ``dx``/``dy``: (N, 2) screen-space uv derivatives in FULL-RES pixel
    units (already bias-scaled)."""
    live = rdata_term == integrate.ESCAPED
    rgb = bg.sample_anisotropic_flat(
        backgrounds, rdata_tex, rdata_side, dx, dy,
        max_probes=settings.anisotropy, trilinear=settings.trilinear,
        probe_bilinear=settings.probe_bilinear, live=live,
        probe_segments=segments,
    )
    if settings.redshift:
        rgb = colour.apply_redshift(rgb, rdata_z,
                                    dominant_colour=settings.dominant_colour,
                                    old=settings.old_redshift,
                                    spectral=settings.spectral_redshift)
    return jnp.where(live[:, None], rgb, 0.0)


def _refine_segments(settings: RenderSettings) -> tuple:
    """Probe schedule for the refine shade set: explicit override, or the
    image-wide schedule with 4x fractions (refined blocks concentrate where
    tex derivatives are large, so their probe demand is several times the
    image-wide rate; 4x measured close to the true refine-set demand on the
    flagship Kerr frame)."""
    if settings.refine_probe_segments:
        return settings.refine_probe_segments
    acc = 0.0
    out = []
    for frac, iters in settings.probe_segments:
        f = min(4.0 * float(frac), 1.0 - acc)
        if f <= 0.0:
            break
        out.append((f, iters))
        acc += f
    return tuple(out)


_BIAS_FRAC = 1.3  # sample_anisotropic's default derivative bias


@functools.partial(jax.jit, static_argnames=("metric", "settings", "k"))
def _finish_shade_jit(metric: Metric, rstate, rku, riquat, params,
                      features: Features, qr: RenderData, should: Array,
                      sel: Array, dest: Array, backgrounds: bg.Background,
                      settings: RenderSettings, k: int):
    """Traced-only finish: refine render-data + quarter/refine shading +
    RGB scatter-back + full-res RGB assembly, fused into one program.

    Shading needs screen-space uv derivatives for the EWA ellipse
    (cl.cl:5524-5556).  The quarter grid takes half its quarter-neighbour
    circular diff (adjacent quarter pixels are 2 full-res pixels apart —
    the same value the full-res path derives at a quarter corner from its
    interpolated midpoint neighbour).  A refined block [q r0; r1 r2] has
    all four of its rays' tex coords available, so each refine ray takes
    intra-block forward differences — 1-pixel steps, no cross-block data.
    """
    Wh, Hh = settings.width // 2, settings.height // 2
    nq = Wh * Hh
    rr = compute_render_data(metric, rstate, rku, params, features,
                             inv_quat=riquat)

    # --- quarter shade ---
    qtex = qr.tex_coord.reshape(Hh, Wh, 2)
    nbr_r = jnp.concatenate([qtex[:, 1:], qtex[:, -2:-1]], axis=1)
    nbr_d = jnp.concatenate([qtex[1:], qtex[-2:-1]], axis=0)
    scale = 0.5 / _BIAS_FRAC
    dxq = (bg._circular_diff(qtex, nbr_r) * scale).reshape(nq, 2)
    dyq = (bg._circular_diff(qtex, nbr_d) * scale).reshape(nq, 2)
    rgb_q = _shade_set(qr.tex_coord, qr.side, qr.z_shift, qr.terminated,
                       dxq, dyq, backgrounds, settings,
                       settings.probe_segments)

    # --- refine shade (3k rays: offsets (1,0), (0,1), (1,1)) ---
    tq = qr.tex_coord[sel]                       # (k, 2) block corners
    t0, t1, t2 = (rr.tex_coord[0:k], rr.tex_coord[k:2 * k],
                  rr.tex_coord[2 * k:3 * k])
    cd = bg._circular_diff
    dxr = jnp.concatenate([cd(tq, t0), cd(t1, t2), cd(t1, t2)]) / _BIAS_FRAC
    dyr = jnp.concatenate([cd(t0, t2), cd(tq, t1), cd(t0, t2)]) / _BIAS_FRAC
    rgb_r = _shade_set(rr.tex_coord, rr.side, rr.z_shift, rr.terminated,
                       dxr, dyr, backgrounds, settings,
                       _refine_segments(settings))

    # --- scatter the k traced blocks' RGB back to the quarter grid ---
    # ONE (k, 9) row scatter (cf. _finish_jit): 3 offsets x RGB.
    ok = dest < k
    packed = jnp.concatenate([
        rgb_r[0:k], rgb_r[k:2 * k], rgb_r[2 * k:3 * k],
    ], axis=1)
    wide = jnp.zeros((nq, 9), jnp.float32).at[sel].set(
        packed, indices_are_sorted=False, unique_indices=True,
    )

    # --- assembly: traced RGB where refined, RGB interpolation elsewhere ---
    qrgb = rgb_q.reshape(Hh, Wh, 3)
    qesc = (qr.terminated == integrate.ESCAPED).reshape(Hh, Wh, 1)
    traced_ok = (should & ok.reshape(Hh, Wh))[..., None]

    def interp(dy, dx):
        # Midpoint RGB; the centre's terminated flag decides black
        # (cl.cl:5111-5133 carries the centre's flag for interpolated data).
        nb = jnp.roll(qrgb, (-dy, -dx), axis=(0, 1))
        return jnp.where(qesc, 0.5 * (qrgb + nb), 0.0)

    def part(i):
        return wide[:, 3 * i:3 * i + 3].reshape(Hh, Wh, 3)

    cell_r = jnp.where(traced_ok, part(0), interp(0, 1))
    cell_d = jnp.where(traced_ok, part(1), interp(1, 0))
    cell_dr = jnp.where(traced_ok, part(2), interp(1, 1))

    # Interleave via stack+reshape (see _adaptive_assemble).
    top = jnp.stack([qrgb, cell_r], axis=2)
    bot = jnp.stack([cell_d, cell_dr], axis=2)
    rows = jnp.stack([top, bot], axis=1)          # (Hh, 2, Wh, 2, 3)
    return rows.reshape(Hh * 2, Wh * 2, 3)


def _refine_error_terms(qg: RenderData, settings: RenderSettings):
    """Shared refinement-decision terms (cl.cl:5240-5285): the angular
    error ratio (rel_err / threshold, >= 1 means refine) and the
    must-refine mask (terminated mismatch or image border)."""
    Hh, Wh = qg.terminated.shape
    W = settings.width

    def shift(x, dy, dx):
        return jnp.roll(x, (-dy, -dx), axis=(0, 1))

    x_err = _angle_between(shift(qg.angles, 0, -1), shift(qg.angles, 0, 1))
    y_err = _angle_between(shift(qg.angles, 1, 0), shift(qg.angles, -1, 0))
    # (2*ax + 2*ay)/4/2*pi, reference operator precedence preserved.
    rel_err = (2.0 * x_err + 2.0 * y_err) / 8.0 * jnp.pi

    fov_rad = settings.fov_degrees * 2.0 * jnp.pi / 360.0
    per_pixel = fov_rad / W
    err_ratio = rel_err / (per_pixel * settings.adaptive_threshold)

    t = qg.terminated
    mism = (
        (t != shift(t, 0, -1))
        | (t != shift(t, 0, 1))
        | (t != shift(t, -1, 0))
        | (t != shift(t, 1, 0))
        | (t != shift(t, 1, 1))
    )
    border = jnp.zeros((Hh, Wh), dtype=bool)
    border = border.at[0, :].set(True).at[-1, :].set(True)
    border = border.at[:, 0].set(True).at[:, -1].set(True)
    return err_ratio, mism | border


@functools.partial(jax.jit, static_argnames=("settings",))
def _adaptive_should_sample(qg: RenderData, settings: RenderSettings) -> Array:
    """Per-quarter-block refinement decision (cl.cl:5240-5285)."""
    err_ratio, must = _refine_error_terms(qg, settings)
    return (err_ratio >= 1.0) | must


@functools.partial(jax.jit, static_argnames=("settings", "k", "seam_rows"))
def _select_refine_blocks(qg: RenderData, settings: RenderSettings, k: int,
                          seam_rows: tuple = ()):
    """Top-k refinement blocks by error priority, O(N) bucket partition.

    The reference builds an unbounded refinement list with atomic_add
    (cl.cl:5294); a static batch needs a bound, so blocks are bucketed —
    must-refine (terminated mismatch/border) first, then by descending
    angular error — and the k highest win.  Returns ``(should, sel, dest)``:
    ``sel`` the selected flat block ids, ``dest`` the inverse permutation
    (``concat(parts, filler)[dest]`` scatters k results back to N blocks,
    gather-only), with ``dest < k`` marking selected blocks.

    ``seam_rows``: grid rows that are NOT image-adjacent to their grid
    neighbour (mirrored half-bands, parallel/mesh) — forced must-refine
    exactly like band boundaries, so interpolation never crosses a seam.
    """
    err_ratio, must = _refine_error_terms(qg, settings)
    if seam_rows:
        # Seam blocks MUST be traced (interpolating across a seam blends
        # non-image-adjacent rows into visible banding), but they compete
        # in the same must bucket as borders/mismatch for the top-k.
        # Statically require k to cover the deterministic must floor
        # (seam rows + border rows/cols); dynamic mismatch blocks on top
        # of that are bounded by the same terminated-edge geometry the
        # contiguous-band path already budgets for.
        Hh_g, Wh_g = qg.terminated.shape
        must_floor = (len(seam_rows) + 2) * Wh_g + 2 * max(Hh_g - 2, 0)
        if k < must_floor:
            raise ValueError(
                f"refine budget k={k} cannot cover the {must_floor} "
                f"statically-forced must-refine blocks (seam rows "
                f"{seam_rows} + borders) — raise refine_budget or drop "
                f"mirror mode"
            )
    for r in seam_rows:
        must = must.at[r, :].set(True)
    should = (err_ratio >= 1.0) | must

    # Buckets: 0 = must-refine; 1..14 descending error (log2 steps);
    # 15 = below threshold.
    logr = jnp.log2(jnp.maximum(err_ratio, 1e-20))
    by_err = jnp.clip(14.0 - jnp.floor(logr * 2.0), 1.0, 14.0).astype(
        jnp.int32
    )
    bucket = jnp.where(should, by_err, 15)
    bucket = jnp.where(must, 0, bucket)

    from ..ops import packing

    perm, dest = packing.bucket_sort_perm(bucket.reshape(-1), 16)
    return should, perm[:k], dest


@functools.partial(jax.jit, static_argnames=("settings",))
def _adaptive_assemble(qg: RenderData, r0: RenderData, r1: RenderData,
                       r2: RenderData, should: Array,
                       settings: RenderSettings) -> RenderData:
    """Merge traced/interpolated cells into full-resolution RenderData."""
    W, H = settings.width, settings.height

    def shiftall(x, dy, dx):
        return jax.tree.map(lambda a: jnp.roll(a, (-dy, -dx), axis=(0, 1)), x)

    right = shiftall(qg, 0, 1)
    down = shiftall(qg, 1, 0)
    down_right = shiftall(qg, 1, 1)

    # One angle->vector conversion of the quarter grid, shifted for the
    # three neighbours (the per-neighbour trig was half the finish stage).
    vq = _ang_to_vec(qg.angles)

    def shv(dy, dx):
        return jnp.roll(vq, (-dy, -dx), axis=(0, 1))

    interp_r = _interp_rdata(qg, right, vq, shv(0, 1))
    interp_d = _interp_rdata(qg, down, vq, shv(1, 0))
    interp_dr = _interp_rdata(qg, down_right, vq, shv(1, 1))

    def pick(traced, interp):
        return jax.tree.map(
            lambda t, i: jnp.where(
                should.reshape(should.shape + (1,) * (t.ndim - 2)), t, i
            ),
            traced, interp,
        )

    cell_r = pick(r0, interp_r)
    cell_d = pick(r1, interp_d)
    cell_dr = pick(r2, interp_dr)

    def assemble(q, r, d, dr):
        # Interleave via stack+reshape (out[2i+a, 2j+b] = cell[a][b][i, j])
        # instead of four strided scatters.
        top = jnp.stack([q, r], axis=2)      # (Hh, Wh, 2, ...)
        bot = jnp.stack([d, dr], axis=2)
        rows = jnp.stack([top, bot], axis=1)  # (Hh, 2, Wh, 2, ...)
        return rows.reshape((H * W,) + q.shape[2:])

    return RenderData(
        *(assemble(q, r, d, dr)
          for q, r, d, dr in zip(qg, cell_r, cell_d, cell_dr))
    )


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def shade(rdata: RenderData, backgrounds: bg.Background,
          settings: RenderSettings) -> Array:
    """``render`` kernel (cl.cl:5453-5846): anisotropic background sampling +
    relativistic redshift.  Returns (H, W, 3) linear-light RGB in [0, 1]."""
    W, H = settings.width, settings.height
    tex = rdata.tex_coord.reshape(H, W, 2)
    side = rdata.side.reshape(H, W)
    z_shift = rdata.z_shift.reshape(H, W)
    terminated = rdata.terminated.reshape(H, W)

    rgb = bg.sample_anisotropic(
        backgrounds, tex, side, max_probes=settings.anisotropy,
        trilinear=settings.trilinear, probe_bilinear=settings.probe_bilinear,
        live=terminated == integrate.ESCAPED,
        probe_segments=settings.probe_segments,
    )

    if settings.redshift:
        rgb = colour.apply_redshift(rgb, z_shift,
                                    dominant_colour=settings.dominant_colour,
                                    old=settings.old_redshift,
                                    spectral=settings.spectral_redshift)

    # terminated != 1 paints black (cl.cl:5470-5474).
    mask = (terminated == integrate.ESCAPED)[..., None]
    return jnp.where(mask, rgb, 0.0)


# ---------------------------------------------------------------------------
# Whole-frame entry point
# ---------------------------------------------------------------------------

def render_frame(metric: Metric, camera: cam.Camera, params,
                 backgrounds: bg.Background, settings: RenderSettings,
                 features: Features | None = None,
                 controller: RefineBudgetController | None = None) -> Array:
    """Trace and shade a full frame.  Returns (H, W, 3) linear RGB.

    The adaptive path is orchestrated from the host as a handful of separate
    XLA programs (prepass / quarter / refine / shade): the refine budget
    ``k`` is a static shape chosen between them, and dispatch is async.
    ``controller``: optional :class:`RefineBudgetController` for
    demand-sized refinement across a frame stream.
    """
    if features is None:
        features = Features.for_metric(metric)
    if settings.adaptive_sampling:
        if settings.shade_traced_only:
            return render_frame_adaptive(metric, camera, params, backgrounds,
                                         settings, features,
                                         controller=controller)
        rdata = render_data_adaptive(metric, camera, params, settings,
                                     features, controller=controller)
        return _shade_jit(rdata, backgrounds, settings)
    return _render_frame_jit(metric, camera, params, backgrounds, settings,
                             features)


@functools.partial(
    jax.jit, static_argnames=("metric", "settings")
)
def _render_frame_jit(metric: Metric, camera: cam.Camera, params,
                      backgrounds: bg.Background, settings: RenderSettings,
                      features: Features) -> Array:
    state, ku, iquat = init_camera_rays(metric, camera, params, settings,
                                        features)
    topts = dataclasses.replace(
        settings.trace, planar=_planar_enabled(metric, settings)
    )
    final = integrate.trace_rays(
        metric, state, params, features=features, opts=topts
    )
    rdata = compute_render_data(metric, final, ku, params, features,
                                inv_quat=iquat)
    return shade(rdata, backgrounds, settings)


_shade_jit = functools.partial(jax.jit, static_argnames=("settings",))(shade)


def grad_safe_final(metric: Metric, launch: RayState, final: RayState,
                    params, features: Features, step_cap: int = 512):
    """Differentiation-safe final state + its consumed-pixel mask.

    Two reverse-mode hazards are excluded from the gradient domain:

    * Rays that stop at the horizon/terminator end where the metric
      itself is singular (Kerr BL ``D -> 0`` makes ``g_rr`` infinite):
      evaluating render data there carries inf primals, and
      inf * zero-cotangent = NaN poisons the whole batch's parameter
      gradient even though those pixels are masked out of any loss.
    * Rays winding many photon-sphere orbits (``steps > step_cap``):
      their tangents grow like e^(lambda n) (~e^(2 pi) per orbit — the
      photon-ring Lyapunov exponent), overflow fp32 inside the backward
      sweep, and turn the summed parameter gradient into NaN.  These
      pixels form a thin annulus at the shadow edge whose gradient is
      chaos-dominated noise anyway; the boundary signal survives in the
      moderately-wound pixels.  (Measured: 128^2 Kerr at 1024 steps NaNs
      without the cap; every ray <= 512 steps is finite.)

    Replaces every non-consumed lane's endpoint with its LAUNCH state (a
    regular point) and returns ``(final_sane, consumed)`` — loss paths
    must mask pixels by ``consumed``.  Forward rendering does NOT use
    this: the near-horizon pixels' z_shift (infinite redshift -> black)
    and the photon-ring pixels are part of the image.
    """
    polar_r = jnp.abs(metric.to_polar(final.position.T, params)[1])
    consumed = (
        (final.status == integrate.ESCAPED)
        & (polar_r >= 0.5 * features.universe_size)
        & (final.steps <= step_cap)
    )

    def pick(a, b):
        m = consumed.reshape((-1,) + (1,) * (a.ndim - 1))
        return jnp.where(m, a, b)

    sane = final._replace(
        position=pick(final.position, launch.position),
        velocity=pick(final.velocity, launch.velocity),
        acceleration=pick(final.acceleration, launch.acceleration),
    )
    return sane, consumed


def trace_frame(metric: Metric, camera: cam.Camera, params,
                settings: RenderSettings,
                features: Features | None = None):
    """Trace only (no shading) — returns (final RayState, ku_uobsu)."""
    if features is None:
        features = Features.for_metric(metric)
    return _trace_frame_jit(metric, camera, params, settings, features)


@functools.partial(jax.jit, static_argnames=("metric", "settings"))
def _trace_frame_jit(metric: Metric, camera: cam.Camera, params,
                     settings: RenderSettings, features: Features):
    # trace_frame consumers read raw final positions — keep the physical
    # (unrotated) frame by disabling planar here.
    nsettings = dataclasses.replace(settings, planar=False)
    state, ku, _ = init_camera_rays(metric, camera, params, nsettings,
                                    features)
    final = integrate.trace_rays(
        metric, state, params, features=features, opts=settings.trace
    )
    return final, ku
