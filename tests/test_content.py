"""Content-pack loader: discovery, config inheritance, broken-pack
tolerance (reference content_manager.cpp)."""

import json
import textwrap

import jax.numpy as jnp
import numpy as np

from geodesic_raytracing.content import load_config, load_pack


def make_pack(tmp_path):
    (tmp_path / "my_hole.py").write_text(textwrap.dedent("""
        import jax.numpy as jnp
        from geodesic_raytracing.metrics.base import diag_metric

        DEFAULTS = {"rs": 2.0}
        DIAGONAL = True
        SPHERICALLY_SYMMETRIC = True
        DEPENDS_ON = (1, 2)

        def metric(x, params):
            rs = params["rs"]
            r, theta = x[1], x[2]
            st = jnp.sin(theta)
            f = 1.0 - rs / r
            return diag_metric(-f, 1.0 / f, r * r, r * r * st * st)
    """))
    (tmp_path / "my_hole.json").write_text(json.dumps({
        "name": "my_hole",
        "inherit_settings": "local_base",
        "max_acceleration_change": 1e-5,
    }))
    (tmp_path / "local_base.json").write_text(json.dumps({
        "inherit_settings": "polar_base",
        "singular": True,
        "singular_terminator": 2.1,
    }))
    (tmp_path / "broken.py").write_text("def metric(x, params): raise 1\n"
                                        "syntax error here")
    (tmp_path / "sorting.json").write_text(json.dumps(
        ["my_hole.py", "broken.py"]
    ))
    return tmp_path


def test_load_pack(tmp_path):
    pack = load_pack(make_pack(tmp_path), register=False)
    assert "my_hole" in pack.metrics
    assert "broken" in pack.broken
    m = pack.metrics["my_hole"]
    # Inheritance chain: local_base -> polar_base, with leaf override.
    assert m.config.singular is True
    assert m.config.singular_terminator == 2.1
    assert m.config.max_acceleration_change == 1e-5
    assert m.config.to_polar == "polar_to_polar"  # from polar_base
    assert m.defaults == {"rs": 2.0}
    assert m.depends_on == (1, 2)
    assert pack.order == ["my_hole"]

    g = m.g(jnp.array([0.0, 8.0, 1.2, 0.3]), m.params())
    np.testing.assert_allclose(float(g[0, 0]), -(1 - 2.0 / 8.0), rtol=1e-6)


def test_pack_metric_traces(tmp_path):
    """A pack metric runs through the real integrator end to end."""
    from geodesic_raytracing.ops.integrate import (
        Features, TraceOptions, init_ray_state, trace_rays,
    )

    pack = load_pack(make_pack(tmp_path), register=False)
    m = pack.metrics["my_hole"]
    pos = jnp.asarray(np.tile([0.0, 14.0, np.pi / 2, 0.0], (4, 1)),
                      dtype=jnp.float32)
    ang = np.linspace(0.3, 0.8, 4)
    vel = jnp.asarray(
        np.stack([np.ones(4), -np.cos(ang), np.zeros(4),
                  np.sin(ang) / 14.0], -1), dtype=jnp.float32)
    feats = Features.for_metric(m)
    st = init_ray_state(m, pos, vel, params=m.params(), features=feats)
    fin = trace_rays(m, st, m.params(), features=feats,
                     opts=TraceOptions(max_steps=4096))
    assert set(np.asarray(fin.status)) <= {1, 2}
