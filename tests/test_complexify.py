"""Unit tests for ops.complexify.realify (complex -> (re, im) pairs).

The metric-level validation lives in test_metrics_catalogue.py (realified
double-Kerr family vs complex originals); these are primitive-level checks
for the symbolic-zero imaginary convention, including the regression where
a REAL-valued base raised to a COMPLEX exponent reached `arctan2(None, x)`
(round-4 advisor finding: only _cpow/log/_csqrt materialised the symbolic
zero, the complex-exponent pow branch did not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geodesic_raytracing.ops.complexify import realify


def _assert_close(fn, args, rtol=2e-5, atol=2e-6):
    want = fn(*args)
    got = realify(fn)(*args)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


X = jnp.array([0.3, 1.7, 2.9], jnp.float32)
Y = jnp.array([-0.4, 0.8, 2.2], jnp.float32)


def test_pow_real_base_complex_exponent():
    # z**w where the base is a real->complex promotion: its imaginary part
    # is tracked as a symbolic zero, which the pow rule must materialise.
    def fn(x, y):
        z = jax.lax.complex(x, jnp.zeros_like(x))
        w = jax.lax.complex(y, 0.5 * y)
        return jnp.real(z ** w), jnp.imag(z ** w)

    _assert_close(fn, (X, Y))


def test_pow_zero_imag_constant_base_complex_exponent():
    # Same hazard via a complex CONSTANT with exactly-zero imag (realify
    # prunes those to symbolic zeros at jaxpr-entry too).
    def fn(y):
        z = jnp.asarray(2.0 + 0.0j, jnp.complex64)
        w = jax.lax.complex(y, -0.25 * y)
        return jnp.abs(z ** w)

    _assert_close(fn, (Y,))


def test_pow_complex_base_complex_exponent():
    def fn(x, y):
        z = jax.lax.complex(x, y)
        w = jax.lax.complex(0.3 * y, 0.2 * x)
        return jnp.real(z ** w), jnp.imag(z ** w)

    _assert_close(fn, (X, Y))


def test_pow_complex_base_real_exponent():
    def fn(x, y):
        z = jax.lax.complex(x, y)
        return jnp.abs(z ** 1.7)

    _assert_close(fn, (X, Y))


def test_symbolic_zero_survives_add_mul_select():
    # Chains that keep imag symbolically zero must still match numpy.
    def fn(x, y):
        z = jax.lax.complex(x, jnp.zeros_like(x))
        u = z * z + z * 3.0 - 1.0
        v = jnp.where(x > 1.0, u, -u)
        return jnp.real(v), jnp.imag(v)

    _assert_close(fn, (X, Y))


def test_sqrt_log_of_real_promotion():
    def fn(x):
        z = jax.lax.complex(-x, jnp.zeros_like(x))  # negative real axis
        s = jnp.sqrt(z)
        l = jnp.log(z + 4.0j * jnp.ones_like(z))
        return jnp.real(s), jnp.imag(s), jnp.real(l), jnp.imag(l)

    _assert_close(fn, (X,))


def test_grad_through_realified_pow():
    def fn(x, y):
        z = jax.lax.complex(x, jnp.zeros_like(x))
        w = jax.lax.complex(y, 0.5 * y)
        return jnp.sum(jnp.real(z ** w))

    gx_want, gy_want = jax.grad(fn, argnums=(0, 1))(X, Y)
    gx_got, gy_got = jax.grad(realify(fn), argnums=(0, 1))(X, Y)
    np.testing.assert_allclose(np.asarray(gx_got), np.asarray(gx_want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gy_got), np.asarray(gy_want),
                               rtol=1e-4, atol=1e-5)
