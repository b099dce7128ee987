"""Example content-pack metric: Reissner-Nordstrom (charged, non-spinning).

Drop-in user extension -- load with:
    python -m geodesic_raytracing.cli --content examples/pack \
        --metric reissner_nordstrom --pitch -90 --out rn.png
"""

import jax.numpy as jnp

from geodesic_raytracing.metrics.base import diag_metric

DEFAULTS = {"rs": 1.0, "rq": 0.4}
DIAGONAL = True
SPHERICALLY_SYMMETRIC = True
DEPENDS_ON = (1, 2)


def metric(x, params):
    rs, rq = params["rs"], params["rq"]
    r, theta = x[1], x[2]
    st = jnp.sin(theta)
    f = 1.0 - rs / r + (rq * rq) / (r * r)
    return diag_metric(-f, 1.0 / f, r * r, r * r * st * st)
