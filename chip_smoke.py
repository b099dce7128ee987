"""On-card check of the renderer's main path, run on one NVIDIA GPU.

Drives the system through the entry points a user calls, at full size, and
checks each result against the plain reference:

  device     JAX runs on a GPU; card name and power limit from nvidia-smi
  render     the flagship 1080p adaptive Kerr frame (bench_config), timed
  reference  the same frame through the plain path (no adaptive sampling,
             XLA ``while``, float32, highest matmul precision)
  goldens    the FAST golden scenes at 128^2 against the checked-in PNGs
  fit        3 steps of the joint (rs, a) Kerr fit at 512^2, 2048 steps

With ``--four-cards`` it runs only the device check and the two paths that
exist across cards: ``sharded_adaptive_frame`` at 1080p on a 4-card mesh
against ``render_frame`` on one card, and one train step on the 4-card mesh
against the same step on one card.

Every phase raises on failure.  The last line of standard output is one
JSON object, ``{"ok": true, "device": {...}}``, printed only when every
phase passed.

Usage:
    python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Flagship frame: settle frames let the refine-budget controller pick its
# bucket (a bucket change recompiles the refine chain) before timing.
SETTLE_FRAMES = 4
TIMED_FRAMES = 5
# Adaptive traced-only shading vs the plain frame: the limits
# tests/test_adaptive.py holds such a frame to (per-pixel max abs diff).
ADAPTIVE_MEDIAN_MAX = 0.01
ADAPTIVE_MEAN_MAX = 0.06
# The differentiable fit (README "Differentiable fitting").
FIT_SIZE, FIT_MAX_STEPS, FIT_REMAT = 512, 2048, 32
FIT_TRUE = dict(rs=1.10, a=-0.45)
FIT_START = dict(rs=0.95, a=-0.55)
FIT_STEPS, FIT_LR, FIT_LR_DECAY = 3, 0.05, 0.93
# One train step on 4 cards vs 1: the shard sums reassociate in float32.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Names a phase on stdout and times it; exceptions propagate."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        say(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        say(f"== {self.name}: {status} in {dt:.1f} s")
        return False


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_phase(jax, n_cards: int = 1) -> list:
    """The devices to use; raises unless JAX runs on enough GPUs."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"JAX found no GPU (default backend {backend!r}); this check "
            "never runs on another backend")
    devices = jax.devices()
    if len(devices) < n_cards:
        raise RuntimeError(f"need {n_cards} GPUs, JAX sees {len(devices)}")
    say(f"device_kind {devices[0].device_kind!r}, count {len(devices)}")
    return devices[:n_cards]


def result_line(devices) -> str:
    """The final line: the contract's keys and nothing else."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


def render_phase(jax, card: str, width: int = 1920, height: int = 1080):
    from geodesic_raytracing.bench_config import flagship_config
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render import pipeline as pl

    metric, params, camera, settings, features = flagship_config(width,
                                                                 height)
    backgrounds = bg.checker_background()
    controller = pl.RefineBudgetController()

    def frame():
        return jax.block_until_ready(pl.render_frame(
            metric, camera, params, backgrounds, settings, features,
            controller=controller))

    t0 = time.perf_counter()
    img = frame()
    say(f"compile frame: {time.perf_counter() - t0:.1f} s")
    for i in range(SETTLE_FRAMES):
        t0 = time.perf_counter()
        img = frame()
        say(f"settle frame {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    times = []
    for _ in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        img = frame()
        times.append(time.perf_counter() - t0)
    img = np.asarray(img)
    if img.shape != (height, width, 3):
        raise AssertionError(f"frame shape {img.shape}")
    if not np.isfinite(img).all():
        raise AssertionError("non-finite pixels in the flagship frame")
    med = float(np.median(times))
    say("timed frames (ms): " + " ".join(f"{t * 1e3:.1f}" for t in times))
    say(f"flagship {width}x{height} kerr_boyer adaptive: median "
        f"{med * 1e3:.1f} ms/frame, {width * height / med / 1e6:.3f} "
        f"Mrays/s over {len(times)} frames, refine bucket "
        f"{controller.fraction(1.0)} [{card}]")
    return img, (metric, params, camera, settings, features, backgrounds)


def reference_phase(jax, img: np.ndarray, frame_cfg) -> None:
    from geodesic_raytracing.render import pipeline as pl

    metric, params, camera, settings, features, backgrounds = frame_cfg
    plain = dataclasses.replace(settings, adaptive_sampling=False)
    assert plain.trace.method == "while"
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.block_until_ready(pl.render_frame(
            metric, camera, params, backgrounds, plain, features)))
    say(f"plain reference frame (incl. compile): "
        f"{time.perf_counter() - t0:.1f} s")
    if not np.isfinite(ref).all():
        raise AssertionError("non-finite pixels in the reference frame")
    d = np.abs(img - ref).max(axis=-1)
    med, mean = float(np.median(d)), float(d.mean())
    say(f"adaptive vs plain: median {med:.6f} (< {ADAPTIVE_MEDIAN_MAX}), "
        f"mean {mean:.6f} (< {ADAPTIVE_MEAN_MAX}), share d>0.1 "
        f"{float((d > 0.1).mean()):.6f}")
    if not (med < ADAPTIVE_MEDIAN_MAX and mean < ADAPTIVE_MEAN_MAX):
        raise AssertionError("adaptive frame disagrees with the plain frame")


def goldens_phase() -> None:
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import make_goldens

    from geodesic_raytracing.utils import png

    failed = []
    for key in make_goldens.FAST:
        t0 = time.perf_counter()
        arr = make_goldens.render_scene(key, make_goldens.scene_spec(key))
        rmse, bad = make_goldens.compare(
            png.read(make_goldens.golden_path(key)), arr)
        ok = make_goldens.passes(rmse, bad)
        say(f"golden {key:24s} rmse {rmse:.4f} (< {make_goldens.RMSE_MAX})"
            f"  bad {bad:.5f} (< {make_goldens.BAD_FRAC_MAX})  "
            f"{'ok' if ok else 'FAIL'}  {time.perf_counter() - t0:.1f} s")
        if not ok:
            failed.append(key)
    if failed:
        raise AssertionError(f"goldens outside the parity gate: {failed}")


def _fit_setup(size: int = FIT_SIZE, max_steps: int = FIT_MAX_STEPS,
               remat: int = FIT_REMAT):
    import jax.numpy as jnp

    from geodesic_raytracing import metrics
    from geodesic_raytracing.camera import Camera
    from geodesic_raytracing.fit import _render_target
    from geodesic_raytracing.ops.integrate import Features, TraceOptions
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render.pipeline import RenderSettings

    metric = metrics.get_metric("kerr_boyer")
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(256, 512)
    settings = RenderSettings(
        width=size, height=size,
        trace=TraceOptions(max_steps=max_steps, method="scan",
                           remat_every=remat))
    features = Features.for_metric(metric)
    target = _render_target(metric, camera, metric.params(**FIT_TRUE),
                            backgrounds, settings, features)
    # float32 arrays from the start: the step returns them, and a weakly
    # typed first call would compile the step twice.
    params = {k: jnp.float32(v)
              for k, v in metric.params(**FIT_START).items()}
    return metric, camera, backgrounds, settings, features, target, params


def fit_phase(jax, card: str, **sizes) -> None:
    import jax.numpy as jnp

    from geodesic_raytracing.parallel.mesh import (
        make_train_step,
        ray_mesh,
    )

    (metric, camera, backgrounds, settings, features, target,
     params) = _fit_setup(**sizes)
    step = make_train_step(metric, ray_mesh(jax.devices()[:1]), settings,
                           features)
    losses, times = [], []
    for i in range(FIT_STEPS):
        t0 = time.perf_counter()
        params, loss = step(params, camera, target, backgrounds,
                            jnp.float32(FIT_LR * FIT_LR_DECAY ** i))
        loss = float(loss)
        times.append(time.perf_counter() - t0)
        vals = {k: float(v) for k, v in params.items()}
        say(f"fit step {i}: {times[-1]:.3f} s  loss {loss:.6f}  {vals}")
        losses.append(loss)
        if not (np.isfinite(loss) and all(np.isfinite(list(vals.values())))):
            raise AssertionError(f"non-finite fit step {i}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"fit loss does not decrease: {losses}")
    size = settings.width
    say(f"fit {size}^2/{settings.trace.max_steps} remat "
        f"{settings.trace.remat_every}: {np.mean(times[1:]):.3f} s/step "
        f"(steps 1-{FIT_STEPS - 1}; step 0 incl. compile {times[0]:.1f} s)"
        f" [{card}]")


def four_card_frame_phase(jax, devices, card: str, width: int = 1920,
                          height: int = 1080) -> None:
    from geodesic_raytracing.bench_config import flagship_config
    from geodesic_raytracing.parallel.mesh import (
        ray_mesh,
        sharded_adaptive_frame,
    )
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render import pipeline as pl

    metric, params, camera, settings, features = flagship_config(width,
                                                                 height)
    # The flagship frame with its two rankings turned off: the refine
    # budget's top-k and the EWA probe tiers (only the top share of pixels
    # by probe demand runs the probe walk) rank per band in the sharded
    # frame but across the whole frame on one card, so under them interior
    # pixels legitimately differ.  Every block may refine and every pixel
    # runs its full probe walk.
    full = ((1.0, settings.anisotropy),)
    settings = dataclasses.replace(settings, refine_budget=1.0,
                                   probe_segments=full,
                                   refine_probe_segments=full)
    backgrounds = bg.checker_background()
    mesh = ray_mesh(devices)
    t0 = time.perf_counter()
    with jax.default_device(devices[0]):
        single = np.asarray(jax.block_until_ready(pl.render_frame(
            metric, camera, params, backgrounds, settings, features)))
    say(f"one-card frame (incl. compile): {time.perf_counter() - t0:.1f} s")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sharded = jax.block_until_ready(sharded_adaptive_frame(
            metric, mesh, camera, params, backgrounds, settings, features))
        times.append(time.perf_counter() - t0)
    sharded = np.asarray(sharded)
    say(f"{len(devices)}-card sharded frame: first (incl. compile) "
        f"{times[0]:.1f} s, then " + " ".join(
            f"{t * 1e3:.1f}" for t in times[1:]) + f" ms [{card}]")
    if sharded.shape != single.shape or not np.isfinite(sharded).all():
        raise AssertionError(f"sharded frame {sharded.shape} not finite "
                             "or misshapen")
    # Band-interior gate (__graft_entry__.dryrun_multichip): rows away from
    # band boundaries match the one-card frame; the 2 full-res rows at
    # each band edge fall under the must-refine border rule.
    d = np.abs(single - sharded).max(axis=-1)
    n = len(devices)
    rows_per_band = height // n
    interior = np.ones(height, bool)
    for band in range(n):
        interior[band * rows_per_band:band * rows_per_band + 2] = False
        interior[(band + 1) * rows_per_band - 2:
                 (band + 1) * rows_per_band] = False
    bad_interior = float((d[interior] > 0.05).mean())
    bad_all = float((d > 0.1).mean())
    say(f"sharded vs one card: interior share d>0.05 {bad_interior:.6f} "
        f"(< 0.02), share d>0.1 {bad_all:.6f} (< 0.15)")
    if not (bad_interior < 0.02 and bad_all < 0.15):
        raise AssertionError("sharded frame diverges from the one-card frame")


def four_card_train_phase(jax, devices, **sizes) -> None:
    from geodesic_raytracing.parallel.mesh import (
        make_train_step,
        ray_mesh,
    )

    (metric, camera, backgrounds, settings, features, target,
     params) = _fit_setup(**sizes)
    results = {}
    for n in (1, len(devices)):
        step = make_train_step(metric, ray_mesh(devices[:n]), settings,
                               features)
        t0 = time.perf_counter()
        loss, grads = jax.block_until_ready(
            step.loss_and_grad(params, camera, target, backgrounds))
        results[n] = (float(loss), {k: float(v) for k, v in grads.items()})
        say(f"train step on {n} card(s): loss {results[n][0]:.7f} grads "
            f"{results[n][1]} ({time.perf_counter() - t0:.1f} s incl. "
            "compile)")
    (l1, g1), (ln, gn) = results[1], results[len(devices)]
    if not (l1 > 0 and any(v != 0 for v in g1.values())):
        raise AssertionError("vacuous comparison: zero loss or gradients")
    if not np.isclose(ln, l1, rtol=TRAIN_LOSS_RTOL, atol=0.0):
        raise AssertionError(f"loss {ln} vs {l1}")
    for k in g1:
        if not np.isclose(gn[k], g1[k], rtol=TRAIN_GRAD_RTOL,
                          atol=TRAIN_GRAD_RTOL * max(abs(v) for v in
                                                     g1.values())):
            raise AssertionError(f"grad {k}: {gn[k]} vs {g1[k]}")
    say(f"loss and gradients agree (rtol {TRAIN_LOSS_RTOL} / "
        f"{TRAIN_GRAD_RTOL})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded frame and train step")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from geodesic_raytracing.utils import compile_cache

    say(f"compile cache: {compile_cache.enable()}")
    import jax

    with Phase("device"):
        devices = device_phase(jax, 4 if args.four_cards else 1)
        card = card_line()
        say(f"card: {card}")
    if args.four_cards:
        with Phase("four_card_frame"):
            four_card_frame_phase(jax, devices, card)
        with Phase("four_card_train"):
            four_card_train_phase(jax, devices)
    else:
        with Phase("render"):
            img, frame_cfg = render_phase(jax, card)
        with Phase("reference"):
            reference_phase(jax, img, frame_cfg)
        with Phase("goldens"):
            goldens_phase()
        with Phase("fit"):
            fit_phase(jax, card)
    say(card)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
