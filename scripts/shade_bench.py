"""Microbench of EWA shade variants at 1080p (a dominant frame stage).

Variants:
  prod        production sample_anisotropic (quad-gather bilinear base +
              nearest-texel probes)
  base        centre sample only (max_probes=1) — the floor
  quad_bilin  bilinear tap via ONE (4,)-row gather of the quad atlas
  four_singles bilinear tap via FOUR single-word gathers (the old scheme)
  point       nearest-texel tap, one single-word gather

Usage: python scripts/shade_bench.py [--cpu] [--frames N]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def sync(x):
    import jax

    leaf = jax.tree.leaves(x)[0]
    return np.asarray(leaf.reshape(-1)[:1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import functools

    import jax.numpy as jnp

    from geodesic_raytracing.render import background as bg

    H, W = 1080, 1920
    backgrounds = bg.checker_background()

    # Synthetic but realistic render-data: tex from a lensing-like warp so
    # uv derivatives vary; a band of high anisotropy near the "ring".
    yy, xx = np.meshgrid(np.linspace(0, 1, H, dtype=np.float32),
                         np.linspace(0, 1, W, dtype=np.float32), indexing="ij")
    r = np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2) + 1e-3
    warp = 1.0 + 0.2 / r  # strong stretching near centre
    tex = np.stack([np.mod(xx * warp, 1.0), np.mod(yy * warp, 1.0)], axis=-1)
    tex = jnp.asarray(tex)
    side = jnp.ones((H, W), jnp.int32)
    uv = tex.reshape(-1, 2)
    sidef = side.reshape(-1)
    lvl = jnp.zeros((H * W,), jnp.int32)

    @functools.partial(jax.jit, static_argnames=("mp",))
    def prod(tex, side, mp=4):
        return bg.sample_anisotropic(backgrounds, tex, side, max_probes=mp,
                                     trilinear=False)

    @jax.jit
    def quad_bilin(uv, sidef, lvl):
        return bg._bilinear_level(backgrounds, sidef, uv, lvl)

    @jax.jit
    def four_singles(uv, sidef, lvl):
        b = backgrounds
        wi = jnp.int32(b.level_w[0])
        hi = jnp.int32(b.level_h[0])
        x0f = uv[:, 0] * wi.astype(jnp.float32) - 0.5
        y0f = uv[:, 1] * hi.astype(jnp.float32) - 0.5
        xi, yi = jnp.floor(x0f), jnp.floor(y0f)
        fx, fy = (x0f - xi)[:, None], (y0f - yi)[:, None]
        x0 = xi.astype(jnp.int32) & (wi - 1)
        x1 = (x0 + 1) & (wi - 1)
        y0 = yi.astype(jnp.int32) & (hi - 1)
        y1 = (y0 + 1) & (hi - 1)

        def g(yy2, xx2):
            return bg._decode_rgb10(
                b.packed[bg._texel_index(b, sidef, yy2, xx2)])

        c00, c01, c10, c11 = g(y0, x0), g(y0, x1), g(y1, x0), g(y1, x1)
        top = c00 * (1 - fx) + c01 * fx
        bot = c10 * (1 - fx) + c11 * fx
        return top * (1 - fy) + bot * fy

    @jax.jit
    def point(uv, sidef, lvl):
        return bg._point_level(backgrounds, sidef, uv, lvl)

    variants = {
        "prod": lambda: prod(tex, side),
        "base": lambda: prod(tex, side, mp=1),
        "quad_bilin": lambda: quad_bilin(uv, sidef, lvl),
        "four_singles": lambda: four_singles(uv, sidef, lvl),
        "point": lambda: point(uv, sidef, lvl),
    }

    for name, fn in variants.items():
        ts = []
        for _ in range(args.frames + 1):
            sync(fn())
            t0 = time.perf_counter()
            sync(fn())
            ts.append(time.perf_counter() - t0)
        print(f"{name:13s} {float(np.median(ts[1:])):7.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
