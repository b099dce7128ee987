"""GPU lowering guard: every catalogue metric's production trace must lower
for CUDA.

The CPU suite has no GPU to compile for, but XLA can still lower a program
for the ``cuda`` platform here: a primitive or shape the GPU route refuses
fails this lowering on the CPU instead of on the card.
"""

import jax
import jax.numpy as jnp
import pytest

from geodesic_raytracing.metrics import REGISTRY, get_metric
from geodesic_raytracing.ops import integrate


def _lower_for_cuda(fn, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_step_fn_is_mosaic_legal(name):
    """The production ``while`` trace of ``name`` (planar for spherically
    symmetric metrics, as the pipeline runs it) lowers for CUDA."""
    metric = get_metric(name)
    features = integrate.Features.for_metric(metric)
    planar = bool(getattr(metric, "spherically_symmetric", False))
    opts = integrate.TraceOptions(max_steps=16384, method="while",
                                  planar=planar)
    params = metric.params()
    n = 128
    state = integrate.RayState(
        position=jnp.full((n, 4), 3.0),
        velocity=jnp.ones((n, 4)),
        acceleration=jnp.zeros((n, 4)),
        next_ds=jnp.full((n,), 0.01),
        running_dlambda_dnew=jnp.ones((n,)),
        status=jnp.zeros((n,), jnp.int32),
        steps=jnp.zeros((n,), jnp.int32),
    )
    lowered = _lower_for_cuda(
        lambda s: integrate.trace_rays(metric, s, params, features=features,
                                       opts=opts), state)
    assert "while" in lowered.as_text()


def test_pow_pos_matches_pow():
    """geometry.pow_pos (the exp/log form) must match ** on positive bases
    and give exactly 0 at base 0."""
    import numpy as np

    from geodesic_raytracing.ops import geometry

    z = jnp.asarray([0.0, 1e-6, 0.5, 1.0, 7.3, 1234.5], jnp.float32)
    for e in (1.0 / 3.0, 0.25, 1.4):
        got = np.asarray(geometry.pow_pos(z, e))
        want = np.asarray(z) ** e
        np.testing.assert_allclose(got[1:], want[1:], rtol=2e-6)
        assert got[0] == 0.0
