"""Spherically-symmetric / diagonal metric catalogue.

Each function is the jnp re-statement of the corresponding reference script in
``scripts/*.js`` (cited per metric).  Signature: ``g(x, params) -> (4, 4)``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import geometry

from .base import Metric, diag_metric, make_config, register, sym_metric


def minkowski_fn(x, params):
    """scripts/minkowski.js — flat spacetime, cartesian (t, x, y, z)."""
    return diag_metric(-1.0, 1.0, 1.0, 1.0)


minkowski = register(
    Metric(
        name="minkowski",
        fn=minkowski_fn,
        config=make_config(
            "cartesian_base",
            name="minkowski",
            adaptive_precision=False,
            detect_singularities=False,
            description="Totally flat, ordinary spacetime",
        ),
        diagonal=True,
        depends_on=(),
    )
)


def minkowski_skew_fn(x, params):
    """scripts/minkowski_skew.js — flat spacetime with coordinates (x, t, y, z)."""
    return diag_metric(1.0, -1.0, 1.0, 1.0)


minkowski_skew = register(
    Metric(
        name="minkowski_skew",
        fn=minkowski_skew_fn,
        config=make_config(
            "cartesian_skew_base",
            name="minkowski_skew",
            adaptive_precision=False,
            detect_singularities=False,
        ),
        diagonal=True,
        depends_on=(),
    )
)


def schwarzschild_fn(x, params):
    """scripts/schwarzschild.js / schwarzschild_accurate.js — standard polar
    Schwarzschild with rs as a parameter."""
    rs = params["rs"]
    r, theta = x[1], x[2]
    st = jnp.sin(theta)
    return diag_metric(
        -(1.0 - rs / r),
        1.0 / (1.0 - rs / r),
        r * r,
        r * r * st * st,
    )


schwarzschild_fast = register(
    Metric(
        name="schwarzschild_fast",
        fn=schwarzschild_fn,
        config=make_config(
            "polar_base",
            name="schwarzschild_fast",
            adaptive_precision=False,
            singular=True,
            detect_singularities=False,
            singular_terminator=1.05,
            description="An uncharged, non spinning black hole (rs=1 optimised)",
        ),
        defaults={"rs": 1.0},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)

schwarzschild = register(
    Metric(
        name="schwarzschild",
        fn=schwarzschild_fn,
        config=make_config(
            "polar_base",
            name="schwarzschild",
            description="An uncharged, non spinning black hole",
        ),
        defaults={"rs": 1.0},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def schwarzschild_skewed_fn(x, params):
    """scripts/skewed_schwarzschild.js — coordinates (r, t, theta, phi)."""
    r, theta = x[0], x[2]
    rs = 1.0
    st = jnp.sin(theta)
    return diag_metric(
        1.0 / (1.0 - rs / r),
        -(1.0 - rs / r),
        r * r,
        r * r * st * st,
    )


schwarzschild_skewed = register(
    Metric(
        name="schwarzschild_skewed",
        fn=schwarzschild_skewed_fn,
        config=make_config("skewed_polar_base", name="schwarzschild_skewed"),
        diagonal=True,
        depends_on=(0, 2),
    )
)


def schwarzschild_ingoing_ef_fn(x, params):
    """scripts/schwarzschild_ingoing_ef.js — ingoing Eddington-Finkelstein
    (v, r, theta, phi); the horizon is traversable."""
    rs = params["rs"]
    r, theta = x[1], x[2]
    st = jnp.sin(theta)
    return sym_metric(
        {
            (0, 0): -(1.0 - rs / r),
            (0, 1): 1.0,
            (2, 2): r * r,
            (3, 3): r * r * st * st,
        }
    )


schwarzschild_ingoing_ef = register(
    Metric(
        name="schwarzschild_ingoing_ef",
        # Trace-time structure (sym_metric keys); prunes the
        # in-kernel inverse/contraction like the Kerr family.
        structure=frozenset({(0, 0), (0, 1), (2, 2), (3, 3)}),
        fn=schwarzschild_ingoing_ef_fn,
        config=make_config(
            "ingoing_ef_base",
            name="schwarzschild_ingoing_ef",
            description="Schwarzschild in ingoing EF coordinates",
        ),
        defaults={"rs": 1.0},
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def schwarzschild_ef_hawking_fn(x, params):
    """scripts/schwarzschild_ingoing_ef_hawking.js (arXiv:2103.08340) — an
    evaporating black hole: rs shrinks as (lifetime - v)^(1/3)."""
    rs_base = params["rs_base"]
    lifetime = params["lifetime"]
    v, r, theta = x[0], x[1], x[2]
    M0 = rs_base / 2.0
    k_squiggle = M0 * M0 * M0 / lifetime
    # Cube roots via geometry.pow_pos (exp/log form, exactly 0 at 0).
    k_dash = 2.0 * geometry.pow_pos(k_squiggle, 1.0 / 3.0)
    negative_branch = k_dash * geometry.pow_pos(
        jnp.maximum(lifetime - v, 0.0), 1.0 / 3.0)
    rs_v = jnp.where(v <= lifetime, negative_branch, 0.0)
    st = jnp.sin(theta)
    return sym_metric(
        {
            (0, 0): -(1.0 - rs_v / r),
            (0, 1): 1.0,
            (2, 2): r * r,
            (3, 3): r * r * st * st,
        }
    )


schwarzschild_ingoing_ef_hawking = register(
    Metric(
        name="schwarzschild_ingoing_ef_hawking",
        # Trace-time structure (sym_metric keys); prunes the
        # in-kernel inverse/contraction like the Kerr family.
        structure=frozenset({(0, 0), (0, 1), (2, 2), (3, 3)}),
        fn=schwarzschild_ef_hawking_fn,
        config=make_config(
            "ingoing_ef_variable_base",
            name="schwarzschild_ingoing_ef_hawking",
            description="A black hole emitting hawking radiation",
        ),
        defaults={"rs_base": 1.0, "lifetime": 1000.0},
        spherically_symmetric=True,
        depends_on=(0, 1, 2),
    )
)


def de_sitter_fn(x, params):
    """scripts/de_sitter.js — expanding universe, positive Lambda."""
    cosmo = params["cosmological_constant"]
    r, theta = x[1], x[2]
    st = jnp.sin(theta)
    f = 1.0 - cosmo * r * r / 3.0
    return diag_metric(-f, 1.0 / f, r * r, r * r * st * st)


de_sitter = register(
    Metric(
        name="de_sitter",
        fn=de_sitter_fn,
        config=make_config(
            "polar_base",
            name="de_sitter",
            adaptive_precision=False,
            detect_singularities=False,
        ),
        defaults={"cosmological_constant": 0.01},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def wormhole_fn(x, params):
    """scripts/wormhole.js — Morris-Thorne wormhole (arXiv:0904.4184);
    p runs through the throat, negative on the far side."""
    n = params["n"]
    p, theta = x[1], x[2]
    st = jnp.sin(theta)
    b = p * p + n * n
    return diag_metric(-1.0, 1.0, b, b * st * st)


wormhole = register(
    Metric(
        name="wormhole (morris-thorne)",
        fn=wormhole_fn,
        config=make_config(
            "polar_base",
            name="wormhole (morris-thorne)",
            adaptive_precision=False,
            detect_singularities=False,
        ),
        defaults={"n": 1.0},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def configurable_wormhole_fn(x, params):
    """scripts/configurable_wormhole.js — Kip Thorne's interstellar wormhole
    (arXiv:1502.03809)."""
    M, p, a = params["M"], params["p"], params["a"]
    l, theta = x[1], x[2]
    st = jnp.sin(theta)
    xx = 2.0 * (jnp.abs(l) - a) / (jnp.pi * M)
    r = jnp.where(
        jnp.abs(l) <= a,
        p,
        p + M * (xx * geometry.arctan(xx) - 0.5 * jnp.log1p(xx * xx)),
    )
    return diag_metric(-1.0, 1.0, r * r, r * r * st * st)


configurable_wormhole = register(
    Metric(
        name="configurable_wormhole",
        fn=configurable_wormhole_fn,
        config=make_config(
            "polar_base",
            name="configurable_wormhole",
            adaptive_precision=True,
            detect_singularities=False,
            max_acceleration_change=1e-5,
        ),
        defaults={"M": 0.01, "p": 1.0, "a": 0.001},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def ellis_drainhole_fn(x, params):
    """scripts/ellis_drainhole.js — the earliest traversable wormhole."""
    m, n = params["m"], params["n"]
    r, theta = x[1], x[2]
    st = jnp.sin(theta)
    alpha = jnp.sqrt(n * n - m * m)
    pseudophi = (n / alpha) * (jnp.pi / 2 - geometry.arctan2(r - m, alpha))
    Fp = -jnp.sqrt(1.0 - jnp.exp(-(2.0 * m / n) * pseudophi))
    Rp2 = ((r - m) * (r - m) + alpha * alpha) / (1.0 - Fp * Fp)
    return sym_metric(
        {
            (0, 0): -(1.0 - Fp * Fp),
            (0, 1): Fp,
            (1, 1): 1.0,
            (2, 2): Rp2,
            (3, 3): Rp2 * st * st,
        }
    )


ellis_drainhole = register(
    Metric(
        name="ellis_drainhole",
        # Trace-time structure (sym_metric keys); prunes the
        # in-kernel inverse/contraction like the Kerr family.
        structure=frozenset({(0, 0), (0, 1), (1, 1), (2, 2), (3, 3)}),
        fn=ellis_drainhole_fn,
        config=make_config(
            "polar_base",
            name="ellis_drainhole",
            adaptive_precision=False,
            detect_singularities=False,
        ),
        defaults={"m": 0.5, "n": 1.0},
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def cosmic_string_bh_fn(x, params):
    """scripts/cosmic_string_bh.js — Schwarzschild with a conical deficit."""
    rs, B = params["rs"], params["B"]
    r, theta = x[1], x[2]
    st = jnp.sin(theta)
    return diag_metric(
        -(1.0 - rs / r),
        1.0 / (1.0 - rs / r),
        r * r,
        r * r * B * B * st * st,
    )


black_hole_cosmic_string = register(
    Metric(
        name="black_hole_cosmic_string",
        fn=cosmic_string_bh_fn,
        config=make_config(
            "polar_base",
            name="black_hole_cosmic_string",
            max_acceleration_change=1e-6,
        ),
        defaults={"rs": 1.0, "B": 0.3},
        diagonal=True,
        depends_on=(1, 2),
    )
)


def janis_newman_winicour_fn(x, params):
    """scripts/janis_newman_winicour.js (arXiv:1408.6041)."""
    r0, mu = params["r0"], params["mu"]
    r, theta = x[1], x[2]
    st = jnp.sin(theta)
    num = 2.0 * r - r0 * (mu - 1.0)
    den = 2.0 * r + r0 * (mu + 1.0)
    Ar = (num / den) ** (1.0 / mu)
    Br = 0.25 * den ** (1.0 / mu + 1.0) / num ** (1.0 / mu - 1.0)
    return diag_metric(-Ar, 1.0 / Ar, Br, Br * st * st)


janis_newman_winicour = register(
    Metric(
        name="janis_newman_winicour",
        fn=janis_newman_winicour_fn,
        config=make_config(
            "polar_base",
            name="janis_newman_winicour",
            detect_singularities=False,
            max_acceleration_change=1e-6,
        ),
        defaults={"r0": 1.0, "mu": 4.0},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def ernst_fn(x, params):
    """scripts/ernst.js — black hole in a magnetic field."""
    B, rs = params["B"], params["rs"]
    r, theta = x[1], x[2]
    st = jnp.sin(theta)
    lam = 1.0 + B * B * r * r * st * st
    lam2 = lam * lam
    f = 1.0 - rs / r
    return diag_metric(-lam2 * f, lam2 / f, lam2 * r * r, r * r * st * st / lam2)


ernst = register(
    Metric(
        name="ernst",
        fn=ernst_fn,
        config=make_config(
            "polar_base",
            name="ernst",
            max_acceleration_change=1e-6,
        ),
        defaults={"B": 0.0000025, "rs": 1.0},
        diagonal=True,
        depends_on=(1, 2),
    )
)


def symmetric_warp_drive_fn(x, params):
    """scripts/symmetric_warp_drive.js (arXiv:2010.11031) — warp without
    negative energy; only correct for radial geodesics (per the reference)."""
    t, r = x[0], x[1]
    theta = jnp.pi / 2  # the script pins theta (reference line 5)
    rg = 1.0
    rk = rg
    a20 = 1.0 - rg / r
    a0 = jnp.sqrt(a20)
    a2 = a20 + t / theta
    st = jnp.sin(theta)
    yrr0 = 1.0 / (1.0 - rg / r)
    gamma_0 = r ** 4 * st * st / (1.0 - rg / r)
    littlea = rk * theta / a0
    littleb = rk * theta - jnp.sqrt(gamma_0)
    Urt = (littlea * (a20 + t / theta) ** 1.5 - littleb) / (
        littlea * a0 * a0 * a0 - littleb
    )
    return diag_metric(
        -a2, Urt * yrr0, Urt * r * r, Urt * r * r * st * st
    )


symmetric_warp_drive = register(
    Metric(
        name="symmetric_warp_drive",
        fn=symmetric_warp_drive_fn,
        config=make_config(
            "polar_base",
            name="symmetric_warp_drive",
            singular=True,
            singular_terminator=1.001,
            max_acceleration_change=1e-6,
        ),
        defaults={},
        diagonal=True,
        depends_on=(0, 1),
    )
)
