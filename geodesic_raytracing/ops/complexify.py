"""Complex -> real-pair jaxpr transform.

The double-Kerr family's Ernst potentials are written in complex
arithmetic (the reference evaluates them with ``dual_complex`` dual
numbers, js_interop.cpp:129-149).  :func:`realify` re-evaluates a traced
function with every complex value carried as an explicit ``(re, im)``
pair of f32 arrays — principal-branch ``sqrt`` via the algebraic
half-angle form, ``pow`` via the polar form on
:func:`ops.geometry.arctan2`.  The output graph contains only real
primitives and keeps jax autodiff (the pair ops are ordinary jnp
arithmetic); it also prunes imaginary chains that are identically zero.

Usage: ``Metric(fn=realify(double_kerr_fn), ...)`` — values match the
complex original to fp32 rounding (validated metric-by-metric in
tests/test_metrics_catalogue.py's structure/evaluation checks and
tests/test_complexify.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.extend.core import Literal

from . import geometry

Array = jax.Array

# Structural primitives applied componentwise to (re, im) pairs.
_STRUCTURAL = {
    "broadcast_in_dim", "reshape", "squeeze", "expand_dims", "transpose",
    "slice", "rev", "copy",
}


def _is_complex_dtype(dt) -> bool:
    return dt is not None and jnp.issubdtype(dt, jnp.complexfloating)


def _pair(v):
    """Promote a real value to a (re, im) pair.

    ``im is None`` means EXACTLY zero, tracked symbolically: real values
    entering complex arithmetic (coordinates, parameters — most of the
    Ernst-potential inputs) would otherwise drag dense zero-imag arrays
    through every downstream op, and XLA cannot fold ``x * 0`` away for
    floats (inf/NaN semantics).  Pruning at trace time here is the same
    convention the hand-written metrics use for structural zeros
    (geometry.sym_metric); measured on the double_kerr step jaxpr it
    removes ~1/3 of the multiplies."""
    if isinstance(v, tuple):
        return v
    return (v, None)


def _mat(i, like):
    """Materialise a symbolic-zero imag as a real array (for consumers
    that need one, e.g. the custom-JVP sqrt/abs kernels)."""
    return jnp.zeros_like(like) if i is None else i


def _zadd(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _zsub(a, b):
    if b is None:
        return a
    if a is None:
        return -b
    return a - b


def _zneg(a):
    return None if a is None else -a


def _zmul(a, b):
    if a is None or b is None:
        return None
    return a * b


def _cmul(a, b):
    ar, ai = a
    br, bi = b
    return (_zsub(ar * br, _zmul(ai, bi)),
            _zadd(_zmul(ar, bi), _zmul(ai, br)))


def _cdiv(a, b):
    ar, ai = a
    br, bi = b
    # geometry.recip: the JVP sweeps over the realified graph stay
    # div-free (same convention as the hand-written metrics).
    if bi is None:
        inv = geometry.recip(br)
        return (ar * inv, _zmul(ai, inv))
    d = br * br + bi * bi
    inv = geometry.recip(d)
    return (_zadd(ar * br, _zmul(ai, bi)) * inv,
            _zsub(_zmul(ai, br), ar * bi) * inv)


@jax.custom_jvp
def _cabs2(ar, ai):
    return jnp.sqrt(ar * ar + ai * ai)


@_cabs2.defjvp
def _cabs2_jvp(primals, tangents):
    ar, ai = primals
    dar, dai = tangents
    m = _cabs2(ar, ai)
    return m, (ar * dar + ai * dai) * geometry.recip(jnp.maximum(m, 1e-37))


def _cabs(a):
    ar, ai = a
    if ai is None:
        return jnp.abs(ar)
    return _cabs2(ar, ai)


@jax.custom_jvp
def _csqrt2(ar, ai):
    """Principal branch: sqrt(-1+0j) = +1j, matching numpy.

    The half-angle primal is NOT differentiated directly: at ai == 0,
    ar > 0 (csqrt of a positive real — ubiquitous) the im = sqrt(0) factor
    makes its raw JVP inf * 0 = NaN even though csqrt is smooth there.
    The custom rule is the exact complex derivative dw = dz / (2 w)."""
    m = jnp.sqrt(ar * ar + ai * ai)
    re = jnp.sqrt(jnp.maximum(0.5 * (m + ar), 0.0))
    im = jnp.sqrt(jnp.maximum(0.5 * (m - ar), 0.0))
    return re, jnp.where(ai < 0, -im, im)


@_csqrt2.defjvp
def _csqrt2_jvp(primals, tangents):
    ar, ai = primals
    dar, dai = tangents
    wr, wi = _csqrt2(ar, ai)
    inv = 0.5 * geometry.recip(jnp.maximum(wr * wr + wi * wi, 1e-37))
    return (wr, wi), ((dar * wr + dai * wi) * inv,
                      (dai * wr - dar * wi) * inv)


def _csqrt(a):
    ar, ai = a
    # A symbolic-zero imag still needs the complex branch (ar may be
    # negative); materialise it for the custom-JVP kernel, whose rule
    # handles the ai == 0 smoothness hazard.
    return _csqrt2(ar, _mat(ai, ar))


def _cint_pow(a, n: int):
    if n < 0:
        a = _cdiv(_pair(jnp.ones_like(a[0])), a)
        n = -n
    out = None
    base = a
    while n:
        if n & 1:
            out = base if out is None else _cmul(out, base)
        base = _cmul(base, base)
        n >>= 1
    if out is None:
        return _pair(jnp.ones_like(a[0]))
    return out


def _cpow(a, c):
    """z**c for REAL exponent c via the polar form."""
    ar, ai = a
    m = _cabs(a)
    theta = geometry.arctan2(_mat(ai, ar), ar)
    mc = jnp.power(jnp.maximum(m, 1e-37), c)
    return (mc * jnp.cos(c * theta), mc * jnp.sin(c * theta))


def _read(env, consts_env, v):
    if isinstance(v, Literal):
        val = v.val
        if _is_complex_dtype(getattr(np.asarray(val), "dtype", None)):
            val = np.asarray(val)
            if np.all(val.imag == 0):
                return (jnp.asarray(val.real, jnp.float32), None)
            return (jnp.asarray(val.real, jnp.float32),
                    jnp.asarray(val.imag, jnp.float32))
        return jnp.asarray(val)
    return env[v]


def _eval_jaxpr(jaxpr, consts, args):
    env: dict = {}

    def write(v, val):
        env[v] = val

    for v, c in zip(jaxpr.constvars, consts):
        if _is_complex_dtype(getattr(c, "dtype", None)):
            c = np.asarray(c)
            if np.all(c.imag == 0):
                write(v, (jnp.asarray(c.real, jnp.float32), None))
            else:
                write(v, (jnp.asarray(c.real, jnp.float32),
                          jnp.asarray(c.imag, jnp.float32)))
        else:
            write(v, c)
    for v, a in zip(jaxpr.invars, args):
        write(v, a)

    for eq in jaxpr.eqns:
        name = eq.primitive.name
        ins = [_read(env, None, v) for v in eq.invars]
        out_cx = any(
            _is_complex_dtype(getattr(v.aval, "dtype", None))
            for v in eq.outvars
        )
        any_pair = any(isinstance(x, tuple) for x in ins)

        # Sub-jaxpr calls (jit/custom_jvp wrappers) — recurse so complex
        # inside them realifies too; custom-JVP identities are dropped
        # (the realified graph differentiates as plain jnp arithmetic).
        if name in ("pjit", "jit", "closed_call", "core_call"):
            sub = eq.params["jaxpr"]
            outs = _eval_jaxpr(sub.jaxpr, sub.consts, ins)
            for v, o in zip(eq.outvars, outs):
                write(v, o)
            continue
        if name == "custom_jvp_call":
            sub = eq.params["call_jaxpr"]
            outs = _eval_jaxpr(sub.jaxpr, sub.consts, ins)
            for v, o in zip(eq.outvars, outs):
                write(v, o)
            continue
        if name == "custom_vjp_call":
            sub = eq.params["call_jaxpr"]
            outs = _eval_jaxpr(sub.jaxpr, sub.consts, ins)
            for v, o in zip(eq.outvars, outs):
                write(v, o)
            continue

        if not any_pair and not out_cx:
            outs = eq.primitive.bind(*ins, **eq.params)
            outs = outs if eq.primitive.multiple_results else [outs]
            for v, o in zip(eq.outvars, outs):
                write(v, o)
            continue

        # --- complex rules ---------------------------------------------
        if name == "convert_element_type":
            new_dtype = eq.params["new_dtype"]
            x = ins[0]
            if _is_complex_dtype(new_dtype):
                out = x if isinstance(x, tuple) \
                    else _pair(x.astype(jnp.float32))
            elif isinstance(x, tuple):
                out = x[0].astype(new_dtype)  # drop imag (numpy semantics)
            else:
                out = x.astype(new_dtype)
            write(eq.outvars[0], out)
        elif name == "complex":
            write(eq.outvars[0], (ins[0], ins[1]))
        elif name == "real":
            write(eq.outvars[0], _pair(ins[0])[0])
        elif name == "imag":
            r, i = _pair(ins[0])
            write(eq.outvars[0], _mat(i, r))
        elif name == "conj":
            r, i = _pair(ins[0])
            write(eq.outvars[0], (r, _zneg(i)))
        elif name == "neg":
            r, i = _pair(ins[0])
            write(eq.outvars[0], (-r, _zneg(i)))
        elif name in ("add", "add_any"):
            a, b = _pair(ins[0]), _pair(ins[1])
            write(eq.outvars[0], (a[0] + b[0], _zadd(a[1], b[1])))
        elif name == "sub":
            a, b = _pair(ins[0]), _pair(ins[1])
            write(eq.outvars[0], (a[0] - b[0], _zsub(a[1], b[1])))
        elif name == "mul":
            write(eq.outvars[0], _cmul(_pair(ins[0]), _pair(ins[1])))
        elif name == "div":
            write(eq.outvars[0], _cdiv(_pair(ins[0]), _pair(ins[1])))
        elif name == "abs":
            write(eq.outvars[0], _cabs(_pair(ins[0])))
        elif name == "sqrt":
            write(eq.outvars[0], _csqrt(_pair(ins[0])))
        elif name == "integer_pow":
            write(eq.outvars[0], _cint_pow(_pair(ins[0]), eq.params["y"]))
        elif name == "pow":
            if isinstance(ins[1], tuple):
                # z**w = exp(w * log z) — jax promotes even real python
                # exponents to complex when the base is.
                z = _pair(ins[0])
                # _mat: the base's imag may be a symbolic zero (None) —
                # e.g. a real-valued base raised to a complex exponent.
                logz = (jnp.log(jnp.maximum(_cabs(z), 1e-37)),
                        geometry.arctan2(_mat(z[1], z[0]), z[0]))
                wlog = _cmul(ins[1], logz)
                er = jnp.exp(wlog[0])
                write(eq.outvars[0],
                      (er * jnp.cos(wlog[1]), er * jnp.sin(wlog[1])))
            else:
                write(eq.outvars[0], _cpow(_pair(ins[0]), ins[1]))
        elif name == "exp":
            r, i = _pair(ins[0])
            er = jnp.exp(r)
            if i is None:
                write(eq.outvars[0], (er, None))
            else:
                write(eq.outvars[0], (er * jnp.cos(i), er * jnp.sin(i)))
        elif name == "log":
            a = _pair(ins[0])
            write(eq.outvars[0],
                  (jnp.log(jnp.maximum(_cabs(a), 1e-37)),
                   geometry.arctan2(_mat(a[1], a[0]), a[0])))
        elif name == "select_n":
            pred = ins[0]
            cases = [_pair(x) for x in ins[1:]]
            if all(c[1] is None for c in cases):
                im = None
            else:
                im = jax.lax.select_n(
                    pred, *[_mat(c[1], c[0]) for c in cases])
            write(eq.outvars[0],
                  (jax.lax.select_n(pred, *[c[0] for c in cases]), im))
        elif name == "concatenate":
            pairs = [_pair(x) for x in ins]
            if all(p[1] is None for p in pairs):
                im = None
            else:
                im = jax.lax.concatenate(
                    [_mat(p[1], p[0]) for p in pairs],
                    eq.params["dimension"])
            write(eq.outvars[0],
                  (jax.lax.concatenate([p[0] for p in pairs],
                                       eq.params["dimension"]), im))
        elif name in _STRUCTURAL:
            r, i = _pair(ins[0])
            write(eq.outvars[0],
                  (eq.primitive.bind(r, **_real_params(eq.params)),
                   None if i is None
                   else eq.primitive.bind(i, **_real_params(eq.params))))
        else:
            raise NotImplementedError(
                f"realify: no rule for complex primitive {name!r}"
            )

    return [_read(env, None, v) for v in jaxpr.outvars]


def _real_params(params):
    """Structural-op params, with any complex dtype swapped for f32."""
    out = dict(params)
    for k, v in out.items():
        if _is_complex_dtype(v) if not isinstance(v, (list, tuple)) else False:
            out[k] = jnp.float32
    return out


def realify(fn):
    """Wrap ``fn`` so complex intermediates evaluate as real (re, im) pairs.

    ``fn`` must take and return real pytrees (complex only INSIDE) — true
    for metric functions (g is real).  The wrapper re-traces per call,
    which under ``jit`` costs only trace time.
    """

    def wrapped(*args):
        flat, tree = jax.tree.flatten(args)

        def ffn(*fargs):
            return fn(*jax.tree.unflatten(tree, fargs))

        closed = jax.make_jaxpr(ffn)(*flat)
        out_flat = _eval_jaxpr(closed.jaxpr, closed.consts, list(flat))
        for o in out_flat:
            if isinstance(o, tuple):
                raise TypeError("realify: function returned a complex value")
        out_tree = jax.tree.structure(
            jax.eval_shape(ffn, *flat)
        )
        return jax.tree.unflatten(out_tree, out_flat)

    return wrapped
