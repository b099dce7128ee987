"""Per-step operation counts of the integrator, per metric.

For each metric it counts the operations of (a) the batched geodesic
acceleration and (b) one raw integrator step (``make_step_fn``: the
acceleration plus the step controller, termination tests and commit) —
the per-ray-step op count a roofline for the trace divides by.

It also answers the double_kerr floor question (VERDICT r4 item 7): is the
remaining cost after realify-with-symbolic-zeros irreducible, or are shared
Ernst subexpressions being recomputed across the four metric-component
chains?

The reference ``$pin``s shared subexpressions into named temporaries
(js_interop.cpp:352-380, equation_context.hpp:16-43).  In this framework
the metric function is traced ONCE (Python-level sharing lands in the
jaxpr once) and the JVP partial sweeps are where duplicates can arise
(each sweep re-traces the primal chain).  XLA's CSE is the designed
``$pin`` replacement — this script produces the evidence:

  * jaxpr op histogram of the batched geodesic acceleration (pre-XLA:
    includes any cross-sweep duplicate primal chains), and
  * the optimised-HLO op counts after XLA CSE/fusion (what actually
    executes).

If HLO mul count << jaxpr mul count, CSE is already deduplicating the
sweeps and the remaining op count is the true cost of the Ernst
potentials.  Compare against kerr_boyer for scale.

Usage: python scripts/dk_opcount.py [metric ...]
"""

from __future__ import annotations

import re
import sys
from collections import Counter

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from geodesic_raytracing import metrics
from geodesic_raytracing.ops import integrate

INTERESTING = ("mul", "add", "sub", "div", "integer_pow", "sqrt", "rsqrt",
               "exp", "log", "sin", "cos", "tanh")


def jaxpr_hist(closed) -> Counter:
    hist: Counter = Counter()

    def walk(jx):
        for eq in jx.eqns:
            hist[eq.primitive.name] += 1
            for v in eq.params.values():
                if hasattr(v, "jaxpr"):
                    walk(v.jaxpr)
    walk(closed.jaxpr)
    return hist


def jaxpr_cse_duplicates(closed) -> tuple[Counter, int]:
    """Value-number the (flat) jaxpr: count equations whose
    (primitive, params, operand value-numbers) already occurred — the
    duplicates a ``$pin``-style CSE would remove.  Sub-jaxprs (pjit
    wrappers) are treated as opaque (counted but not inlined)."""
    ids: dict = {}
    nextid = [0]

    def vid(v):
        from jax.extend.core import Literal

        if isinstance(v, Literal):
            return ("lit", repr(v.val))
        if v not in ids:
            ids[v] = nextid[0]
            nextid[0] += 1
        return ids[v]

    seen: dict = {}
    dups: Counter = Counter()
    total_dup = 0
    for eq in closed.jaxpr.eqns:
        key = (eq.primitive.name,
               tuple(sorted((k, repr(v)) for k, v in eq.params.items())),
               tuple(vid(v) for v in eq.invars))
        if key in seen and not eq.primitive.multiple_results:
            dups[eq.primitive.name] += 1
            total_dup += 1
            ids[eq.outvars[0]] = seen[key]
        else:
            rep = vid(eq.outvars[0]) if not eq.primitive.multiple_results \
                else tuple(vid(o) for o in eq.outvars)
            seen[key] = rep
    return dups, total_dup


def hlo_hist(compiled_text: str) -> Counter:
    """Count retained HLO ops: every instruction line reads
    ``%name = <type> opname(...)`` where <type> is a single token or a
    parenthesised tuple."""
    hist: Counter = Counter()
    for mt in re.finditer(r"= (?:\([^)]*\)|\S+) ([a-z][a-z-]*)\(",
                          compiled_text):
        hist[mt.group(1)] += 1
    return hist


def analyze(name: str):
    m = metrics.get_metric(name)
    params = m.params()
    N = 256
    rng = np.random.default_rng(0)
    pos = jnp.asarray(
        np.array([0.0, 6.0, 1.2, 0.3])[:, None]
        + 0.1 * rng.standard_normal((4, N)), jnp.float32)
    vel = jnp.asarray(
        np.array([1.0, -0.5, 0.01, 0.02])[:, None]
        + 0.01 * rng.standard_normal((4, N)), jnp.float32)

    def f(pos, vel):
        return integrate.metric_acceleration(m, pos, vel, params)

    planar = bool(m.spherically_symmetric)
    step = integrate.make_step_fn(
        m, integrate.Features.for_metric(m),
        integrate.TraceOptions(planar=planar), jnp.abs(vel[0]))
    state = integrate._StateT(
        position=pos, velocity=vel, acceleration=f(pos, vel),
        next_ds=jnp.full((N,), 0.01), running_dlambda_dnew=jnp.ones((N,)),
        status=jnp.zeros((N,), jnp.int32), steps=jnp.zeros((N,), jnp.int32))

    print(f"\n== {name} ==")
    out = {}
    for label, fn, args in (("accel", f, (pos, vel)),
                            ("step", lambda s: step(s, params), (state,))):
        closed = jax.make_jaxpr(fn)(*args)
        jh = jaxpr_hist(closed)
        dups, total_dup = jaxpr_cse_duplicates(closed)
        hh = hlo_hist(jax.jit(fn).lower(*args).compile().as_text())
        print(f"  {label} jaxpr:", "  ".join(
            f"{k}={jh.get(k, 0)}" for k in INTERESTING),
            f" total={sum(jh.values())}")
        print(f"  {label} jaxpr CSE-removable duplicates: {total_dup} "
              f"({dict(dups.most_common(6))})")
        print(f"  {label} hlo:  ", "  ".join(
            f"{k}={hh.get('multiply' if k == 'mul' else k, 0)}"
            for k in ("mul", "add", "subtract", "divide", "sqrt", "rsqrt",
                      "exponential", "log", "tanh")),
            f" total={sum(hh.values())}")
        out[label] = (jh, hh)
    return out["accel"]


def main(argv):
    jax.config.update("jax_platforms", "cpu")
    names = argv[1:] or ["kerr_boyer", "double_kerr", "double_kerr_alt",
                         "ernst"]
    rows = {}
    for n in names:
        rows[n] = analyze(n)
    base = "kerr_boyer"
    if base in rows and "double_kerr" in rows:
        bm = rows[base][1].get("multiply", 1)
        dm = rows["double_kerr"][1].get("multiply", 0)
        print(f"\nHLO multiply ratio double_kerr / kerr_boyer: "
              f"{dm}/{bm} = {dm / max(bm, 1):.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
