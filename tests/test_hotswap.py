"""Hot-swap program pair + static parameter baking (reference
metric_manager.hpp two-program scheme)."""

import time

import jax
import jax.numpy as jnp
import numpy as np

from geodesic_raytracing import metrics
from geodesic_raytracing.runtime.hotswap import HotSwapProgram, bake


def test_bake_matches_dynamic():
    m = metrics.get_metric("kerr_boyer")
    x = jnp.array([0.1, 5.0, 1.1, 0.3])
    params = m.params(a=-0.7)
    baked = bake(m, params)
    np.testing.assert_allclose(
        np.asarray(m.g(x, params)), np.asarray(baked.g(x, {})), rtol=1e-6
    )


def test_hotswap_dispatch():
    m = metrics.get_metric("schwarzschild")
    x = jnp.array([0.0, 6.0, 1.2, 0.4])

    calls = {"dynamic": 0, "static": 0}

    def dynamic(params, xx):
        calls["dynamic"] += 1
        return m.g(xx, params)

    def build_static(params):
        baked = bake(m, params)
        fn = jax.jit(lambda xx: baked.g(xx, {}))
        fn(x).block_until_ready()  # warm-up: ready before swap-in

        def wrapped(xx):
            calls["static"] += 1
            return fn(xx)

        return wrapped

    prog = HotSwapProgram(dynamic, build_static)
    params = m.params(rs=1.3)

    r1 = prog(params, x)  # no static yet -> dynamic
    assert calls["dynamic"] == 1

    prog.request_static(params)
    prog.wait(30.0)
    assert prog.static_ready

    r2 = prog(params, x)  # static ready & matching -> static
    assert calls["static"] == 1
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), rtol=1e-6)

    # Changed params -> falls back to dynamic until rebuilt.
    prog(m.params(rs=2.0), x)
    assert calls["dynamic"] == 2
