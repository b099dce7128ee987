"""The geodesic integrator: adaptive-step velocity Verlet over ray batches.

Behavioural twin of the reference's hot loop ``do_generic_rays``
(cl.cl:3954-4247) and ``step_verlet`` (cl.cl:3273-3346), re-expressed as
whole-batch array code:

* The reference runs one work-item per ray with a data-dependent ``while``
  and ``i--`` step-rejection retries.  Here every ray in a batch advances
  through a *fixed-bound* loop under masks: a rejected trial simply does not
  commit its state (no retry counter), a terminated ray stops committing and
  idles until the batch's ``while_loop`` exits.
* Layout: state is component-first (4, N), metrics (4, 4, N), so every
  operation is elementwise over the ray axis.
* Per-ray early exit becomes batch-level early exit: the ``lax.while_loop``
  stops as soon as every ray in the batch has terminated, so each iteration
  pays for the batch's slowest ray.
* Differentiability: ``trace_rays(..., method="scan")`` runs a fixed-length
  ``lax.scan`` with rematerialisation every ``remat_every`` steps so pixels
  can be differentiated w.r.t. metric params / camera pose — a capability the
  reference does not have.

Status codes: 0 = active, 1 = terminated-at-surface (samples the background;
reference ``terminated == 1``), 2 = dead (black pixel: coordinate blowup,
singularity hit, NaN — the reference's bare ``return`` paths).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..metrics.base import Metric
from . import geometry

Array = jax.Array

ACTIVE = 0
ESCAPED = 1
DEAD = 2

# do_generic_rays loop limit (cl.cl:4016: 4096 * 4).
MAX_STEPS_DEFAULT = 16384

# acceleration_to_precision's float-precision workaround constant
# "I_HATE_COMPUTERS" (cl.cl:3398: 256*256).
_PRECISION_SCALE = 65536.0
_MAX_TIMESTEP = 100000.0


class Features(NamedTuple):
    """Runtime-tunable engine features (the reference's dynamic_feature_config,
    main.cpp:1123-1158).  All traced — changing one does not recompile."""

    universe_size: Array | float = 20.0
    max_acceleration_change: Array | float = 0.01
    max_precision_radius: Array | float = 10.0
    min_step: Array | float = 1e-6
    ambient_precision: Array | float = 0.2
    subambient_precision: Array | float = 0.5

    @classmethod
    def for_metric(cls, metric, **overrides) -> "Features":
        """Features seeded from the metric's config — the reference loads
        ``metric_cfg.max_acceleration_change`` into the feature registry on
        metric switch."""
        kw = dict(max_acceleration_change=metric.config.max_acceleration_change)
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class TraceOptions:
    """Static trace options — part of the jit specialisation key, mirroring
    the reference's compile-time ``-D`` feature defines."""

    max_steps: int = MAX_STEPS_DEFAULT
    reparameterisation: bool = False
    # "verlet" (reference default) | "euler" (step_euler cl.cl:3352-3377;
    # schedule-driven steps, no adaptive error control).
    integrator: str = "verlet"
    # "while" (XLA whole-batch early exit), "scan" (differentiable, remat).
    method: str = "while"
    # Constant-theta planar mode (GENERIC_CONSTANT_THETA): rays were rotated
    # into the equatorial plane at init; pin theta and drop its dynamics.
    # Only valid for spherically symmetric metrics with plane-rotated rays.
    planar: bool = False
    remat_every: int = 128  # checkpoint window for method="scan"


class RayState(NamedTuple):
    """Structure-of-arrays ray state (reference ``struct lightray``
    cl.cl:813-824, minus bookkeeping that lives in the pipeline).

    Public layout: position/velocity/acceleration (N, 4); scalars (N,).
    (The integrator transposes to component-first internally.)
    """

    position: Array
    velocity: Array
    acceleration: Array
    next_ds: Array
    running_dlambda_dnew: Array
    status: Array  # int32
    steps: Array  # int32 committed steps


class _StateT(NamedTuple):
    """Internal transposed state: vectors (4, N)."""

    position: Array
    velocity: Array
    acceleration: Array
    next_ds: Array
    running_dlambda_dnew: Array
    status: Array
    steps: Array


def _transpose_in(s: RayState) -> _StateT:
    return _StateT(
        s.position.T, s.velocity.T, s.acceleration.T,
        s.next_ds, s.running_dlambda_dnew, s.status, s.steps,
    )


def _transpose_out(s: _StateT) -> RayState:
    return RayState(
        s.position.T, s.velocity.T, s.acceleration.T,
        s.next_ds, s.running_dlambda_dnew, s.status, s.steps,
    )


def linear_val(value, min_val, max_val, at_min, at_max):
    """cl.cl:806-811 — clamped linear remap.

    The divide is by the scalar span, hoisted out of the vector lane work
    (constant-folds entirely when the bounds are Python floats)."""
    inv_span = 1.0 / (max_val - min_val)
    mixd = jnp.clip((value - min_val) * inv_span, 0.0, 1.0)
    return at_min + (at_max - at_min) * mixd


def acceleration_to_precision(acc: Array, max_acceleration, w_v,
                              udiv=None) -> tuple[Array, Array]:
    """cl.cl:3400-3429 — error estimate and ideal next step from acceleration.

    ``acc`` is component-first (4, N).  Returns ``(diff, next_ds)`` of (N,).
    ``udiv``: pass ``max(weights)`` as a Python scalar when the weights are
    compile-time constants — the fallback ``jnp.max`` is a reduction to a
    scalar inside the step loop.
    """
    if udiv is None:
        udiv = jnp.max(w_v)
    wa = acc * w_v.reshape((4,) + (1,) * (acc.ndim - 1))
    # The clamp keeps sqrt off exact zero: in exactly-flat regions
    # (Alcubierre outside the bubble) acc == 0 and d/dx sqrt(x)|_0 = inf
    # turns every reverse-mode gradient into NaN (inf * 0).  Forward values
    # are unchanged (the diff floor below dominates 1e-15).
    err_scale = jnp.sqrt(jnp.maximum(jnp.sum(wa * wa, axis=0), 1e-30)) \
        * (0.01 / udiv)
    err = max_acceleration
    diff = err_scale * _PRECISION_SCALE
    floor = err * (_PRECISION_SCALE / (_MAX_TIMESTEP * _MAX_TIMESTEP))
    diff = jnp.maximum(diff, floor)
    # sqrt(e/d) = sqrt(e) * rsqrt(d): the scalar sqrt hoists off the rays
    # and the vector divide becomes one rsqrt (diff > 0 by the floor above).
    next_ds = jnp.sqrt(err * _PRECISION_SCALE) * jax.lax.rsqrt(diff)
    return diff, next_ds


def metric_acceleration(metric: Metric, pos, vel, params, deps=None):
    """Geodesic acceleration dispatch: the rank-1 Kerr-Schild fast path
    when the metric declares a decomposition (Metric.rank1), else the
    sparsity-pruned generic contraction."""
    if deps is None:
        deps = metric.depends_on
    if metric.rank1 is not None:
        return geometry.acceleration_batched_rank1(
            metric.rank1, pos, vel, params)
    return geometry.acceleration_batched(metric.fn, pos, vel, params,
                                         deps=deps, nz=metric.nonzeros())


def verlet_step(metric: Metric, position, velocity, acceleration, ds, params,
                reparameterisation: bool, deps=None):
    """cl.cl:3273-3346 — velocity Verlet with optional affine
    reparameterisation (K = 1/max|v'|).  All vectors component-first (4, N).
    """
    if deps is None:
        deps = metric.depends_on
    ds_ = ds[None, :] if position.ndim == 2 else ds
    next_position = position + velocity * ds_ + 0.5 * acceleration * ds_ * ds_
    intermediate_velocity = velocity + acceleration * ds_
    next_acceleration = metric_acceleration(
        metric, next_position, intermediate_velocity, params, deps=deps)
    next_velocity = velocity + 0.5 * (acceleration + next_acceleration) * ds_

    if reparameterisation:
        max_divisor = jnp.max(jnp.abs(next_velocity), axis=0)
        K = 1.0 / max_divisor
        return (
            next_position,
            next_velocity * K[None, :],
            next_acceleration * (K * K)[None, :],
            K,
        )
    K = jnp.ones(ds.shape, dtype=position.dtype)
    return next_position, next_velocity, next_acceleration, K


def initial_next_ds(metric: Metric, features: Features, acc: Array) -> Array:
    """Seed the adaptive step size from the launch acceleration (the tail
    of ``geodesic_to_render_ray`` cl.cl:3000-3065).  Component-first batch
    transparent."""
    if metric.config.adaptive_precision:
        w_v = geometry.select4(metric.precision_weights(), acc)
        _, next_ds = acceleration_to_precision(
            acc, features.max_acceleration_change, w_v,
            udiv=float(max(metric.precision_weights())),
        )
        return next_ds
    return jnp.full(acc.shape[1:], 1e-5, dtype=acc.dtype)


def init_ray_state(metric: Metric, position: Array, velocity: Array, params,
                   features: Features, fix_null_velocity: bool = True) -> RayState:
    """Build the initial RayState from (N, 4) positions/velocities
    (``geodesic_to_render_ray`` cl.cl:3000-3065: null-fix the velocity,
    compute the initial acceleration, seed the adaptive step)."""
    pos = position.T
    vel = velocity.T
    n = pos.shape[1]

    if fix_null_velocity:
        gab = metric.fn(pos, params)
        if gab.ndim == 2:  # constant metric — add a broadcast batch axis
            gab = gab[..., None]
        vel = geometry.fix_null_batched(gab, vel)

    acc = metric_acceleration(metric, pos, vel, params)
    next_ds = initial_next_ds(metric, features, acc)

    return RayState(
        position=pos.T,
        velocity=vel.T,
        acceleration=acc.T,
        next_ds=next_ds,
        running_dlambda_dnew=jnp.ones((n,), dtype=pos.dtype),
        status=jnp.zeros((n,), dtype=jnp.int32),
        steps=jnp.zeros((n,), dtype=jnp.int32),
    )


def make_step_fn(metric: Metric, features: Features, opts: TraceOptions,
                 f_in_x: Array, with_ds: bool = False):
    """One masked integrator iteration over a component-first ray batch.

    Shared by the while and scan drivers and the geodesic recorder.
    With ``with_ds`` the step also returns the committed step sizes
    (0 where nothing committed) — used by the geodesic recorder.
    """
    cfg = metric.config
    w_v_const = metric.precision_weights()
    deps = metric.depends_on
    if opts.planar:
        # theta is pinned; only the theta acceleration component uses d_theta
        # and it is identically zero on the equator of a symmetric metric.
        deps = tuple(d for d in deps if d != 2)

    def step(state: _StateT, params) -> _StateT:
        pos, vel, acc = state.position, state.velocity, state.acceleration
        dtype = pos.dtype
        w_v = geometry.select4(w_v_const, pos)

        active = state.status == ACTIVE

        polar = metric.to_polar(pos, params)
        r_value = metric.origin_distance(polar, params)
        abs_r = jnp.abs(r_value)

        new_min = jnp.asarray(3.0, dtype)
        new_max = features.max_precision_radius

        # Step schedule (cl.cl:4059-4086): adaptive next_ds near the object,
        # clamped by ambient precision; linear growth in the far field.
        ds_sched = linear_val(
            abs_r, new_min, new_max,
            features.ambient_precision, features.subambient_precision,
        )
        adaptive = cfg.adaptive_precision and opts.integrator == "verlet"
        ds = state.next_ds if adaptive else ds_sched
        near = abs_r < new_max
        ds = jnp.where(
            near,
            jnp.minimum(ds, features.ambient_precision),
            0.1 * (abs_r - new_max) + features.ambient_precision,
        )
        # Inactive lanes step with ds = 0: a lane frozen by the finiteness
        # probe would otherwise recompute its non-finite trial (the one
        # that killed it) every remaining iteration — masked in forward,
        # but reverse mode multiplies those inf/NaN primals with the
        # lane's zero cotangents and NaN-poisons the batch gradient.  At
        # h = 0 the trial re-evaluates the frozen (finite) state instead.
        ds = jnp.where(active, ds, jnp.zeros_like(ds))

        # Termination tests on the current position (cl.cl:4088-4130).
        escaped = jnp.abs(polar[1]) >= features.universe_size
        newly_escaped = escaped
        if cfg.singular:
            newly_escaped = newly_escaped | (
                jnp.abs(polar[1]) < cfg.singular_terminator
            )

        dead = jnp.zeros_like(newly_escaped)
        if cfg.has_cylindrical_singularity:
            dead = dead | (pos[1] < cfg.cylindrical_terminator)
        if not cfg.unconditionally_nonsingular:
            # |v/rd| > t  <=>  |v| > t*rd — running_dlambda_dnew is a product
            # of K = 1/max|v'| factors, always > 0, so the divides become
            # multiply-compares (cl.cl:4100-4112 divides; same predicate).
            rd = state.running_dlambda_dnew
            blowup = (jnp.abs(vel[0]) > (1000.0 + f_in_x) * rd) & (
                jnp.abs(acc[0]) > 100.0 * rd
            )
            dead = dead | blowup

        status = state.status
        status = jnp.where(active & newly_escaped, ESCAPED, status)
        status = jnp.where(active & dead & ~newly_escaped, DEAD, status)
        active = status == ACTIVE

        if opts.integrator == "euler":
            # step_euler (cl.cl:3352-3377): acceleration at the current
            # event, then a semi-implicit update.
            lacc = metric_acceleration(metric, pos, vel, params, deps=deps)
            nvel = vel + lacc * ds[None, :]
            npos = pos + nvel * ds[None, :]
            nacc = lacc
            K = jnp.ones(ds.shape, dtype=pos.dtype)
        else:
            # Trial Verlet step (cl.cl:4144-4178).
            npos, nvel, nacc, K = verlet_step(
                metric, pos, vel, acc, ds, params, opts.reparameterisation,
                deps=deps,
            )
        if opts.planar:
            # IS_CONSTANT_THETA pins (cl.cl:3990-3995).  An iota-select, not
            # .at[2].set: an indexed update would lower to a scatter.
            is_theta = geometry.basis_vec4(2, npos) > 0
            half_pi = jnp.asarray(jnp.pi / 2, dtype=npos.dtype)
            npos = jnp.where(is_theta, half_pi, npos)
            nvel = jnp.where(is_theta, 0.0, nvel)
            nacc = jnp.where(is_theta, 0.0, nacc)

        # Degenerate bail-out (IS_DEGENERATE, cl.cl:4234-4237) — a single
        # isfinite on the TRIAL state's component sum (NaN/Inf propagate
        # through +).  Tested BEFORE the commit (the reference tests after;
        # same pixels die) so a dying ray keeps its last finite state AND
        # a finite next_ds: carried state then never holds NaN/Inf, which
        # the reverse-mode path needs — a committed NaN would feed every
        # later step's primals and poison the backward sweep through
        # zero-cotangent NaN products that where() cannot block.
        probe = (npos[0] + npos[1] + npos[2] + npos[3]
                 + nvel[0] + nvel[1] + nvel[2] + nvel[3]
                 + nacc[0] + nacc[1] + nacc[2] + nacc[3])
        bad = ~jnp.isfinite(probe)
        status = jnp.where(active & bad, DEAD, status)
        active = status == ACTIVE

        commit = active
        next_ds = state.next_ds
        if adaptive:
            err = features.max_acceleration_change
            diff, ideal_ds = acceleration_to_precision(
                nacc, err, w_v, udiv=float(max(w_v_const))
            )
            # calculate_ds_error (cl.cl:3431-3456).  Div-free forms (ds > 0):
            # ds*clip(ideal/ds, .3, 2) == clip(ideal, .3*ds, 2*ds);
            # cand < ds/1.95 <=> 1.95*cand < ds;
            # diff/SCALE > e <=> diff > e*SCALE.
            cand = 0.99 * jnp.clip(ideal_ds, 0.3 * ds, 2.0 * ds)
            cand = jnp.maximum(cand, features.min_step)
            skip = 1.95 * cand < ds
            kill = jnp.zeros_like(skip)
            if cfg.detect_singularities:
                kill = (cand <= features.min_step) & (
                    diff > err * (10000.0 * _PRECISION_SCALE)
                )
            # Error control applies only in the near zone (cl.cl:4156).
            skip = skip & near
            kill = kill & near
            status = jnp.where(active & kill, DEAD, status)
            commit = active & ~kill & ~skip
            next_ds = jnp.where(active, cand, next_ds)

        cm = commit[None, :]
        pos = jnp.where(cm, npos, pos)
        vel = jnp.where(cm, nvel, vel)
        acc = jnp.where(cm, nacc, acc)
        rdl = jnp.where(commit, state.running_dlambda_dnew * K,
                        state.running_dlambda_dnew)

        out = _StateT(
            position=pos,
            velocity=vel,
            acceleration=acc,
            next_ds=next_ds,
            running_dlambda_dnew=rdl,
            status=status,
            steps=state.steps + commit.astype(jnp.int32),
        )
        if with_ds:
            return out, jnp.where(commit, ds, 0.0)
        return out

    return step


def trace_rays(metric: Metric, state: RayState, params,
               features: Features = Features(),
               opts: TraceOptions = TraceOptions()) -> RayState:
    """March every ray to termination or the step limit.

    ``opts.method``:
      * ``"while"`` — ``lax.while_loop`` with batch-level early exit; the
        fast inference path (not reverse-differentiable).
      * ``"scan"``  — fixed ``opts.max_steps`` iterations as a nested
        ``lax.scan`` with ``jax.checkpoint`` every ``opts.remat_every`` steps;
        reverse-differentiable w.r.t. ``params`` and the initial state.
    """
    st = _transpose_in(state)
    # Blow-up kill baseline: the launch-time |v_t| (cl.cl:3990).
    step = make_step_fn(metric, features, opts, jnp.abs(st.velocity[0]))

    if opts.method == "while":
        def cond(carry):
            i, s = carry
            return (i < opts.max_steps) & jnp.any(s.status == ACTIVE)

        def body(carry):
            i, s = carry
            return i + 1, step(s, params)

        _, final = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
        return _transpose_out(final)

    if opts.method == "scan":
        inner_n = min(opts.remat_every, opts.max_steps)
        outer_n = -(-opts.max_steps // inner_n)

        @jax.checkpoint
        def outer_body(s, _):
            def inner_body(s2, _):
                return step(s2, params), None

            s, _ = jax.lax.scan(inner_body, s, None, length=inner_n)
            return s, None

        final, _ = jax.lax.scan(outer_body, st, None, length=outer_n)
        return _transpose_out(final)

    raise ValueError(f"unknown trace method {opts.method!r}")


def trace_rays_recorded(metric: Metric, state: RayState, params,
                        features: Features = Features(),
                        opts: TraceOptions = TraceOptions(),
                        n_slots: int = 16, steps_per_slot: int = 64):
    """Trace while recording the ray paths every ``steps_per_slot``
    iterations — the triangle-mode path recording of ``do_generic_rays``
    (cl.cl:4181-4232, ``ray_skip`` feature).

    Returns ``(final RayState, path (n_slots+1, N, 4))`` where slot 0 is the
    launch position and slot j is the position after ``j*steps_per_slot``
    iterations (terminated rays repeat their final position, which makes
    their later segments degenerate and harmless).
    """
    st = _transpose_in(state)
    f_in_x = jnp.abs(st.velocity[0])
    step = make_step_fn(metric, features, opts, f_in_x)

    def outer(s, _):
        def inner(s2, _):
            return step(s2, params), None

        s, _ = jax.lax.scan(inner, s, None, length=steps_per_slot)
        return s, s.position

    final, path = jax.lax.scan(outer, st, None, length=n_slots)
    path = jnp.concatenate([st.position[None], path])  # (S+1, 4, N)
    return _transpose_out(final), jnp.moveaxis(path, 1, 2)
