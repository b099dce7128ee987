"""Metric definition framework.

The reference defines metrics as JavaScript files evaluated with symbolic dual
numbers (js_interop.cpp:848-901) paired with JSON configs supporting
inheritance (metric.hpp:330-435, content_manager.cpp:70-112).  Here a metric is
a plain Python function ``g(x, params) -> (4, 4)`` plus a static, hashable
``MetricConfig`` — the config is a legal ``jax.jit`` static argument, so
switching metrics or toggling config bits re-specialises the compiled kernels
exactly like the reference's two-program recompile path (metric_manager.hpp).

Tunable parameters (the reference's ``$cfg.x`` sliders, js_interop.cpp:762-846)
are a dict of traced scalars: changing one re-runs nothing (dynamic program);
marking it static is a jit re-specialisation (the baked program).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import jax
import jax.numpy as jnp

from ..coordinates import transforms as _tr

Array = jax.Array

COORDINATE_SYSTEMS = ("X_Y_THETA_PHI", "CARTESIAN", "CYLINDRICAL", "OTHER")


@dataclasses.dataclass(frozen=True)
class MetricConfig:
    """Static per-metric configuration.

    Field-for-field mirror of the reference's ``metric_config``
    (metric.hpp:330-435); every JSON key in ``scripts/*.json`` maps here.
    """

    name: str = ""
    description: str = ""
    use_prepass: bool = False
    max_acceleration_change: float = 1e-7

    singular: bool = False
    traversable_event_horizon: bool = False
    singular_terminator: float = 1.0

    adaptive_precision: bool = True
    detect_singularities: bool = False
    follow_geodesics_forward: bool = False

    has_cylindrical_singularity: bool = False
    cylindrical_terminator: float = 0.005

    coordinate_system: str = "X_Y_THETA_PHI"

    to_polar: str = ""
    from_polar: str = ""
    origin_distance: str = ""
    coordinate_periodicity: str = ""

    unconditionally_nonsingular: bool = False

    def replace(self, **kw) -> "MetricConfig":
        return dataclasses.replace(self, **kw)


# Base config presets mirroring scripts/{polar,cartesian,cylindrical,
# ingoing_ef,...}_base.json; metric configs inherit from these exactly as
# ``inherit_settings`` does in content_manager.cpp:70-112.
BASE_CONFIGS: dict[str, dict] = {
    "polar_base": dict(
        coordinate_system="X_Y_THETA_PHI",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="polar_to_polar",
        from_polar="polar_to_polar",
        coordinate_periodicity="polar_periodicity",
        origin_distance="at_origin",
    ),
    "cartesian_base": dict(
        coordinate_system="CARTESIAN",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="cartesian_to_polar",
        from_polar="polar_to_cartesian",
        origin_distance="at_origin",
    ),
    "cartesian_skew_base": dict(
        coordinate_system="CARTESIAN",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="cartesian_skew_to_polar",
        from_polar="polar_to_cartesian_skew",
        origin_distance="at_origin",
    ),
    "cylindrical_base": dict(
        coordinate_system="CYLINDRICAL",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="cylindrical_to_polar",
        from_polar="polar_to_cylindrical",
        coordinate_periodicity="cylindrical_periodicity",
        origin_distance="at_origin",
    ),
    "ingoing_ef_base": dict(
        coordinate_system="X_Y_THETA_PHI",
        traversable_event_horizon=True,
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-6,
        to_polar="ingoing_ef_to_polar",
        from_polar="polar_to_ingoing_ef",
        coordinate_periodicity="polar_periodicity",
        origin_distance="at_origin",
    ),
    "ingoing_ef_variable_base": dict(
        coordinate_system="X_Y_THETA_PHI",
        traversable_event_horizon=True,
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-6,
        to_polar="ingoing_ef_variable_to_polar",
        from_polar="polar_to_ingoing_ef_variable",
        coordinate_periodicity="polar_periodicity",
        origin_distance="at_origin",
    ),
    "skewed_polar_base": dict(
        coordinate_system="X_Y_THETA_PHI",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="skewed_polar_to_polar",
        from_polar="polar_to_skewed_polar",
        coordinate_periodicity="polar_periodicity",
        origin_distance="at_origin",
    ),
}


def make_config(inherit: str | None = None, **overrides) -> MetricConfig:
    """Build a MetricConfig, optionally inheriting a base preset."""
    fields = {}
    if inherit:
        fields.update(BASE_CONFIGS[inherit])
    fields.update(overrides)
    return MetricConfig(**fields)


# ---------------------------------------------------------------------------
# Origin-distance functions (scripts/origins/*.js)
# ---------------------------------------------------------------------------

def at_origin(polar: Array, params) -> Array:
    """scripts/origins/at_origin.js — distance is just r."""
    return polar[1]


def alcubierre_origin(polar: Array, params) -> Array:
    """scripts/origins/alcubierre_origin.js — distance to the moving warp
    bubble at x = v*t.  Componentwise, so batch-transparent."""
    t, r, theta, phi = polar[0], polar[1], polar[2], polar[3]
    st = jnp.sin(theta)
    cx = r * st * jnp.cos(phi)
    cy = r * st * jnp.sin(phi)
    cz = r * jnp.cos(theta)
    x_pos = cx - params["velocity"] * t
    return jnp.sqrt(x_pos * x_pos + cy * cy + cz * cz)


ORIGINS = {
    "at_origin": at_origin,
    "alcubierre_origin": alcubierre_origin,
    "": at_origin,
}


@dataclasses.dataclass(frozen=True, eq=False)
class Metric:
    """A spacetime: metric tensor function + static config + param defaults.

    ``eq=False`` keeps identity hashing so a Metric is a valid ``jax.jit``
    static argument (its ``defaults`` dict would otherwise break hashing);
    metrics are registry singletons, so identity equality is correct.

    ``fn(x, params)`` returns the full symmetric (4, 4) metric at event ``x``.
    ``diagonal`` / ``spherically_symmetric`` are performance hints replacing
    the reference's symbolic diagonal-reduction (``debiggen`` metric.hpp:665)
    and sin^2-theta pattern matching (``is_polar_spherically_symmetric``
    metric.hpp:557-622) — explicit bits beat expression-tree matching.
    """

    name: str
    fn: Callable
    config: MetricConfig
    defaults: Mapping[str, float] = dataclasses.field(default_factory=dict)
    diagonal: bool = False
    spherically_symmetric: bool = False
    # Coordinates g actually depends on: JVP sweeps and Christoffel terms for
    # the others are dropped at trace time (the analogue of the reference's
    # symbolic zero pruning).  Validated by tests/test_metrics_catalogue.
    depends_on: tuple = (0, 1, 2, 3)
    # Structurally nonzero upper-triangle entries (i <= j), or None = dense.
    # The integrator's 4x4 inverse and Christoffel contraction drop terms
    # for absent entries at trace time — for Kerr BL (diag + t-phi) the
    # pruned cofactor expansion collapses to the 2x2-block closed form.
    # Explicit declaration, like depends_on (the reference detects the same
    # sparsity symbolically: debiggen metric.hpp:665-708); validated against
    # numeric probes by tests/test_metrics_catalogue.
    structure: frozenset | None = None
    # Kerr-Schild decomposition ``(x, params) -> (f, l)`` with
    # g = eta + f l ox l and l eta-null: enables the rank-1
    # Sherman-Morrison acceleration fast path
    # (ops.geometry.acceleration_batched_rank1) in the integrator.  Must
    # satisfy fn(x, p) == minkowski_plus(*rank1(x, p)) (validated by
    # tests/test_metrics_catalogue.py).
    rank1: Callable | None = None

    # -- parameter handling --------------------------------------------------
    def params(self, **overrides) -> dict:
        p = {k: jnp.float32(v) for k, v in self.defaults.items()}
        for k, v in overrides.items():
            if k not in p:
                raise KeyError(f"{self.name} has no parameter {k!r}")
            p[k] = jnp.float32(v)
        return p

    # -- geometry ------------------------------------------------------------
    def g(self, x: Array, params) -> Array:
        return self.fn(x, params)

    def nonzeros(self) -> frozenset | None:
        """Structurally nonzero (i <= j) metric entries, or None = dense."""
        if self.structure is not None:
            return self.structure
        if self.diagonal:
            return frozenset((i, i) for i in range(4))
        return None

    # -- coordinates ---------------------------------------------------------
    def to_polar(self, x: Array, params) -> Array:
        """generic -> (t, r, theta, phi) (reference ``generic_to_spherical``)."""
        return _tr.get_transform(self.config.to_polar)(x, params)

    def from_polar(self, x: Array, params) -> Array:
        """(t, r, theta, phi) -> generic (reference ``spherical_to_generic``)."""
        return _tr.get_transform(self.config.from_polar)(x, params)

    def to_polar_velocity(self, x: Array, v: Array, params) -> Array:
        return _tr.velocity_transform(
            _tr.get_transform(self.config.to_polar), x, v, params
        )

    def from_polar_velocity(self, x: Array, v: Array, params) -> Array:
        return _tr.velocity_transform(
            _tr.get_transform(self.config.from_polar), x, v, params
        )

    def origin_distance(self, polar: Array, params) -> Array:
        """Distance function driving the ambient step schedule
        (``get_distance_to_object`` cl.cl:3379-3390)."""
        return ORIGINS[self.config.origin_distance](polar, params)

    def periods(self, params) -> Array:
        """Per-coordinate periodicity (0 = aperiodic)."""
        return _tr.get_periodicity(self.config.coordinate_periodicity)(params)

    def precision_weights(self) -> tuple[float, float, float, float]:
        """The reference's W_V1..4 per-coordinate error weights
        (metric.hpp:849-869)."""
        cs = self.config.coordinate_system
        if cs == "X_Y_THETA_PHI":
            if self.spherically_symmetric:
                return (1.0, 1.0, 8.0, 8.0)
            return (1.0, 1.0, 8.0, 32.0)
        if cs == "CYLINDRICAL":
            return (1.0, 1.0, 8.0, 1.0)
        return (1.0, 1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

REGISTRY: dict[str, Metric] = {}


def register(metric: Metric) -> Metric:
    REGISTRY[metric.name] = metric
    return metric


def get_metric(name: str) -> Metric:
    return REGISTRY[name]


def list_metrics() -> list[str]:
    return sorted(REGISTRY)


def diag_metric(d0, d1, d2, d3) -> Array:
    """Assemble a diagonal 4x4 metric from its components.

    Batch-transparent: scalar components give (4, 4); components of shape
    ``B`` give (4, 4, *B) — the component-first layout the hot path uses
    (rays on the trailing axis).
    """
    return sym_metric({(0, 0): d0, (1, 1): d1, (2, 2): d2, (3, 3): d3})


def sym_metric(entries: Mapping[tuple[int, int], Array]) -> Array:
    """Assemble a symmetric 4x4 metric from an upper-triangle entry dict.

    Batch-transparent like :func:`diag_metric`.
    """
    vals = [jnp.asarray(v, dtype=jnp.float32) for v in entries.values()]
    vals = jnp.broadcast_arrays(*vals) if len(vals) > 1 else vals
    z = jnp.zeros_like(vals[0])
    grid = [[z] * 4 for _ in range(4)]
    for (i, j), v in zip(entries.keys(), vals):
        grid[i][j] = v
        if i != j:
            grid[j][i] = v
    return jnp.stack([jnp.stack(row) for row in grid])


def minkowski_plus(f, lv) -> Array:
    """eta_ab + f l_a l_b — the Kerr-Schild form, batch-transparent
    (lv of shape (4,) or (4, *B)).  eta is built from iota so the expression
    carries no captured array constant."""
    import jax

    g = f * lv[:, None] * lv[None, :]
    # Iotas at the FULL broadcast rank (no (4, 4) -> (4, 4, 1, 1) reshape).
    shape = (4, 4) + (1,) * (g.ndim - 2)
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    eta = jnp.where(
        i == j, jnp.where(i == 0, -1.0, 1.0), 0.0
    ).astype(g.dtype)
    return g + eta
