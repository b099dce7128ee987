"""CPU-side checks of what the GPU path relies on: the stdlib PNG codec,
the compile-cache location, chip_smoke.py's device guard and result line,
full-precision float32 contractions in the CUDA lowering, and a single XLA
trace with no fallback in the entry points."""

import inspect
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geodesic_raytracing.utils import compile_cache, png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
import chip_smoke  # noqa: E402
import make_goldens  # noqa: E402


@pytest.mark.parametrize("key", make_goldens.FAST)
def test_png_decodes_goldens_like_imageio(key):
    iio = pytest.importorskip("imageio.v3")
    path = make_goldens.golden_path(key)
    got = png.read(path)
    want = iio.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (6, 4, 4)])
def test_png_write_read_round_trip(tmp_path, shape):
    rng = np.random.default_rng(len(shape))
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    png.write(path, arr)
    np.testing.assert_array_equal(png.read(path), arr)


def test_compile_cache_honours_env_var():
    env = {compile_cache.ENV_VAR: "/some/cache/dir"}
    assert compile_cache.cache_dir(env) == "/some/cache/dir"


def test_compile_cache_default_is_fixed_in_checkout():
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir({}) == want
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: ""}) == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_device_phase_refuses_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_phase(jax)


def test_chip_smoke_result_line_keys():
    line = chip_smoke.result_line(jax.devices()[:1])
    assert "\n" not in line
    out = json.loads(line)
    assert out == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": 1,
    }}


def test_contractions_lower_for_cuda_at_highest_precision():
    """Every float32 dot on the ray-setup and render-data path asks for
    HIGHEST precision when lowered for CUDA (default precision may run in
    TF32 there)."""
    from geodesic_raytracing import camera as cam
    from geodesic_raytracing import metrics
    from geodesic_raytracing.ops import geometry
    from geodesic_raytracing.ops.integrate import Features
    from geodesic_raytracing.render import pipeline as pl

    m = metrics.get_metric("kerr_boyer")
    p = m.params()
    settings = pl.RenderSettings(width=8, height=8)
    camera = cam.Camera.default().rotate(pitch=-np.pi / 2)

    def f(x, v, cx, cy):
        gab = m.fn(x, p)
        es = cam.observer_tetrad(m, x, p, basis_speed3=jnp.array(
            [0.1, 0.0, 0.0]), orient=True)
        state, ku, _ = pl.rays_for_pixels(m, camera, x, es, p, settings,
                                          Features.for_metric(m), cx, cy)
        rd = pl.compute_render_data(m, state, ku, p)
        return (geometry.acceleration_at(m.fn, x, v, p),
                geometry.fix_null(gab, v), geometry.dot_g(gab, v, v),
                geometry.raise_(gab, v), rd.z_shift)

    x = jnp.array([0.0, 7.0, 1.5, 0.3])
    v = jnp.array([1.0, -1.0, 0.01, 0.02])
    c = jnp.arange(4, dtype=jnp.float32)
    text = jax.jit(f).trace(x, v, c, c).lower(
        lowering_platforms=("cuda",)).as_text()
    dots = [line for line in text.splitlines() if "dot_general" in line]
    assert dots
    loose = [d for d in dots if "precision = [HIGHEST, HIGHEST]" not in d]
    assert not loose, loose[:3]


def test_production_trace_is_the_xla_while_driver():
    from geodesic_raytracing.bench_config import flagship_config
    from geodesic_raytracing.ops.integrate import TraceOptions

    *_, settings, _ = flagship_config(64, 36)
    assert settings.trace.method == "while"
    assert settings.adaptive_sampling
    fields = {f.name for f in TraceOptions.__dataclass_fields__.values()}
    assert fields == {"max_steps", "reparameterisation", "integrator",
                      "method", "planar", "remat_every"}


def test_trace_rays_has_no_silent_method_swap():
    from geodesic_raytracing import metrics
    from geodesic_raytracing.ops import integrate

    m = metrics.get_metric("schwarzschild")
    n = 4
    state = integrate.RayState(
        jnp.full((n, 4), 3.0), jnp.ones((n, 4)), jnp.zeros((n, 4)),
        jnp.full((n,), 0.01), jnp.ones((n,)), jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,), jnp.int32))
    with pytest.raises(ValueError, match="unknown trace method"):
        integrate.trace_rays(m, state, m.params(),
                             opts=integrate.TraceOptions(method="pallas"))


@pytest.mark.parametrize("module", ["bench", "cli"])
def test_entry_points_pick_one_trace_without_fallback(module):
    """bench.py and the CLI pick the XLA trace on every backend: no branch
    on the backend, and no exception handler that could carry on with
    another configuration."""
    if module == "bench":
        import bench as mod
    else:
        from geodesic_raytracing import cli as mod
    src = inspect.getsource(mod)
    assert "default_backend" not in src
    assert "except" not in src
    assert "pallas" not in src
    if module == "cli":
        import argparse

        captured = {}
        real_parse = argparse.ArgumentParser.parse_args

        def grab(self, args=None, namespace=None):
            captured["parser"] = self
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = real_parse
        action = next(a for a in captured["parser"]._actions
                      if a.dest == "trace_method")
        assert action.default == "while"
        assert tuple(action.choices) == ("while", "scan")
