"""Skysphere backgrounds: mip pyramid + anisotropic (EWA) equirect sampling.

The reference builds a CPU-side mip pyramid into a CL image array because of
driver holes (graphics_settings.cpp:152-212) and hand-rolls trilinear
mipmapping + Heckbert-ellipse anisotropic filtering in the render kernel
(cl.cl:5421-5687).  Here the array program has no texture units, so the
same hand-rolled filtering becomes gathers over a mip *atlas*: all levels packed
side-by-side in one array so a traced mip level stays a dynamic index, not a
dynamic shape.

Two backgrounds are carried for two-sided universes (wormholes; side selects
which, graphics_settings.cpp:214-243).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

MIP_LEVELS = 10  # reference uses 10 (graphics_settings.cpp:165)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("packed", "quad"),
    meta_fields=("level_w", "level_h", "level_x"),
)
@dataclasses.dataclass(frozen=True)
class Background:
    """Mip atlas for both universe sides, packed one texel per 32-bit word.

    ``packed``: (2 * H * 2W,) uint32, rgb10 linear (10 bits/channel) — the
    flat row-major packing of the (2, H, 2W) atlas.  Level l of side s
    occupies columns ``offs[l]:offs[l]+(W>>l)`` of rows ``:H>>l``.  One
    32-bit word per texel because this path has no texture units: every
    sample is a gather from device memory, a word per texel keeps the
    gathered bytes small, and 10-bit linear matches the reference's 8-bit
    sRGB CL images for quality.

    ``quad``: (2 * H * 2W, 4) uint32 — for every atlas texel, its 2x2
    wrap-correct neighbourhood [c00, c01, c10, c11] as four consecutive
    words.  A bilinear tap is then ONE (4,)-row gather instead of four
    single-word gathers, at 4x the memory.  Wrap is baked per mip level at
    build time, which also makes the u = 1 equirect seam exact.

    ``level_w, level_h, level_x``: per-level sizes and x offsets — STATIC
    tuples of Python ints (pytree aux data), so level geometry is baked into
    the compiled program: the per-pixel level->size mapping lowers to shifts
    (pow2) or literal select chains instead of table gathers, and wrap
    addressing lowers to a bitwise AND instead of an integer mod by a
    dynamic divisor (integer division is slow).  Changing the
    background resolution recompiles, matching the reference rebuilding its
    CL image array (graphics_settings.cpp:152-212).
    """

    packed: Array
    quad: Array
    level_w: tuple
    level_h: tuple
    level_x: tuple

    @property
    def atlas_h(self) -> int:
        return self.level_h[0]

    @property
    def atlas_w(self) -> int:
        return 2 * self.level_w[0]

    @property
    def levels(self) -> int:
        return len(self.level_w)

    @property
    def pow2(self) -> bool:
        """True when every level size is a power of two AND levels halve
        exactly — wrap becomes AND, level tables become shifts."""
        w0, h0 = self.level_w[0], self.level_h[0]
        if w0 & (w0 - 1) or h0 & (h0 - 1):
            return False
        return all(
            self.level_w[l] == max(w0 >> l, 1)
            and self.level_h[l] == max(h0 >> l, 1)
            and self.level_x[l] == 2 * w0 - max((2 * w0) >> l, 2)
            for l in range(self.levels)
        )


def build_background(image: np.ndarray, image2: np.ndarray | None = None,
                     levels: int = MIP_LEVELS) -> Background:
    """Build the mip atlas from (H, W, 3) float32 linear images
    (``load_mipped_image`` graphics_settings.cpp:152-212).  The box-filter
    chain runs in the native runtime library when available."""
    from .. import runtime

    image = np.asarray(image, dtype=np.float32)
    if image2 is None:
        image2 = image
    image2 = np.asarray(image2, dtype=np.float32)
    assert image.shape == image2.shape, "both sides must share dimensions"

    H, W, _ = image.shape
    levels = min(levels, int(np.log2(min(H, W))) + 1)

    a1, lw, lh, lx = runtime.build_mips(image, max_levels=levels)
    a2, _, _, _ = runtime.build_mips(image2, max_levels=levels)
    atlas = np.stack([a1, a2])

    q = (np.clip(atlas, 0.0, 1.0) * 1023.0 + 0.5).astype(np.uint32)
    packed = (q[..., 0] << 20) | (q[..., 1] << 10) | q[..., 2]

    # Per-texel 2x2 neighbourhoods with per-level wrap (see Background.quad).
    quad = np.zeros(packed.shape + (4,), dtype=np.uint32)
    for l in range(len(lw)):
        w, h, xo = int(lw[l]), int(lh[l]), int(lx[l])
        blk = packed[:, :h, xo:xo + w]
        right = np.roll(blk, -1, axis=2)
        down = np.roll(blk, -1, axis=1)
        quad[:, :h, xo:xo + w, 0] = blk
        quad[:, :h, xo:xo + w, 1] = right
        quad[:, :h, xo:xo + w, 2] = down
        quad[:, :h, xo:xo + w, 3] = np.roll(right, -1, axis=1)

    return Background(
        packed=jnp.asarray(packed.reshape(-1)),
        quad=jnp.asarray(quad.reshape(-1, 4)),
        level_w=tuple(int(v) for v in lw),
        level_h=tuple(int(v) for v in lh),
        level_x=tuple(int(v) for v in lx),
    )


def checker_background(height: int = 1024, width: int = 2048,
                       squares: int = 24) -> Background:
    """Procedural latitude/longitude checker — the test/bench skysphere."""
    v, u = np.meshgrid(
        np.arange(height) / height, np.arange(width) / width, indexing="ij"
    )
    cu = np.floor(u * squares).astype(int)
    cv = np.floor(v * squares / 2).astype(int)
    check = ((cu + cv) % 2).astype(np.float32)
    img = np.stack(
        [0.15 + 0.7 * check, 0.25 + 0.5 * check, 0.6 - 0.3 * check], axis=-1
    )
    # Tint the second side so wormhole far sides are identifiable.
    img2 = img[..., ::-1].copy()
    return build_background(img, img2)


def load_background(path: str, path2: str | None = None) -> Background:
    """Load equirect image file(s) (PNG/JPG), convert sRGB -> linear."""
    from . import colour

    def load(p):
        if p.lower().endswith(".png"):
            from ..utils import png

            arr = png.read(p)
        else:
            try:
                import imageio.v3 as iio
            except ImportError:
                try:
                    from PIL import Image
                except ImportError:
                    raise ImportError(
                        f"reading {p!r} needs imageio or Pillow, and neither "
                        "is installed; convert the skybox to an 8-bit PNG, "
                        "which the built-in reader handles") from None
                arr = np.asarray(Image.open(p))
            else:
                arr = iio.imread(p)
        arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        arr = arr[..., :3]
        return np.asarray(colour.srgb_to_lin(arr))

    img = load(path)
    img2 = load(path2) if path2 else None
    return build_background(img, img2)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _level_tables(bgr: Background, level: Array):
    """Per-pixel (w, h, xoff) for a traced mip level WITHOUT gathers.

    pow2 pyramids (the common case) lower to pure shifts; otherwise a
    select chain over literal level slots.  Either way no table gathers —
    ``level_w[level]`` as a fancy-index is a full gather row per pixel per
    table, on top of the actual atlas texel gathers."""
    if bgr.pow2:
        w0, h0 = bgr.level_w[0], bgr.level_h[0]
        wi = jnp.int32(w0) >> level
        hi = jnp.int32(h0) >> level
        xo = jnp.int32(2 * w0) - (jnp.int32(2 * w0) >> level)
        return wi, hi, xo
    wi = jnp.zeros(level.shape, jnp.int32)
    hi = jnp.zeros(level.shape, jnp.int32)
    xo = jnp.zeros(level.shape, jnp.int32)
    for l in range(bgr.levels):
        sel = level == l
        wi = jnp.where(sel, bgr.level_w[l], wi)
        hi = jnp.where(sel, bgr.level_h[l], hi)
        xo = jnp.where(sel, bgr.level_x[l], xo)
    return wi, hi, xo


def _decode_rgb10(w: Array) -> Array:
    """uint32 rgb10 texel -> (..., 3) float32 linear."""
    return jnp.stack(
        [((w >> 20) & 0x3FF).astype(jnp.float32),
         ((w >> 10) & 0x3FF).astype(jnp.float32),
         (w & 0x3FF).astype(jnp.float32)],
        axis=-1,
    ) * (1.0 / 1023.0)


def _texel_index(bgr: Background, side: Array, yy: Array, xx: Array) -> Array:
    """Flat index into ``packed`` — ONE word per texel, one 1-D gather.

    Reference read_mipmap: side >= 1 samples the PRIMARY background
    (cl.cl:5450 `side >= 1 ? v1 : v2`); plane 0 is primary."""
    atlas_idx = jnp.where(side >= 1, 0, 1)
    return (atlas_idx * bgr.atlas_h + yy) * bgr.atlas_w + xx


def _bilinear_level(bgr: Background, side: Array, uv: Array, level: Array) -> Array:
    """Bilinear wrap-sample one mip level (CLK_ADDRESS_REPEAT + FILTER_LINEAR,
    cl.cl:5846 ``read_mipmap``).  All args per-pixel arrays; uv (..., 2)."""
    level = jnp.clip(level, 0, bgr.levels - 1)
    wi, hi, xoff = _level_tables(bgr, level)
    w = wi.astype(jnp.float32)
    h = hi.astype(jnp.float32)
    x0f = uv[..., 0] * w - 0.5
    y0f = uv[..., 1] * h - 0.5
    xi = jnp.floor(x0f)
    yi = jnp.floor(y0f)
    fx = (x0f - xi)[..., None]
    fy = (y0f - yi)[..., None]

    if bgr.pow2:
        # Wrap = bitwise AND (sizes are powers of two; AND handles the
        # negative -1 row from the -0.5 texel shift as well) — integer mod
        # by a traced divisor is a slow integer division.
        x0 = xi.astype(jnp.int32) & (wi - 1)
        y0 = yi.astype(jnp.int32) & (hi - 1)
    else:
        x0 = jnp.mod(xi.astype(jnp.int32), wi)
        y0 = jnp.mod(yi.astype(jnp.int32), hi)

    # ONE (4,)-row gather per tap: the quad atlas stores each texel's
    # wrap-correct 2x2 neighbourhood as four consecutive words.
    q = bgr.quad[_texel_index(bgr, side, y0, xoff + x0)]
    c00 = _decode_rgb10(q[..., 0])
    c01 = _decode_rgb10(q[..., 1])
    c10 = _decode_rgb10(q[..., 2])
    c11 = _decode_rgb10(q[..., 3])
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _point_level(bgr: Background, side: Array, uv: Array, level: Array) -> Array:
    """Nearest-texel wrap-sample of one mip level — 1 gather instead of 4.

    Used for the EWA probe walk: each probe is one of several
    gaussian-weighted samples, so the average supplies the smoothing the
    per-probe bilinear filter would (the shade stage is gather-bound; this
    quarters its probe cost)."""
    level = jnp.clip(level, 0, bgr.levels - 1)
    wi, hi, xoff = _level_tables(bgr, level)
    xi = jnp.floor(uv[..., 0] * wi.astype(jnp.float32)).astype(jnp.int32)
    yi = jnp.floor(uv[..., 1] * hi.astype(jnp.float32)).astype(jnp.int32)
    if bgr.pow2:
        x0 = xi & (wi - 1)
        y0 = yi & (hi - 1)
    else:
        x0 = jnp.mod(xi, wi)
        y0 = jnp.mod(yi, hi)
    return _decode_rgb10(bgr.packed[_texel_index(bgr, side, y0, xoff + x0)])


def read_mipmap(bgr: Background, side: Array, uv: Array, lod: Array,
                trilinear: bool = True, point: bool = False) -> Array:
    """Trilinear: blend the two straddling mip levels (cl.cl:5846-5875).
    With ``trilinear=False`` samples the nearest level only — half the
    gathers; ``point=True`` additionally drops the bilinear filter (one
    gather per sample) for gather-bound shading."""
    lod = jnp.clip(lod, 0.0, bgr.levels - 1.0)
    if point:
        return _point_level(bgr, side, uv, jnp.round(lod).astype(jnp.int32))
    if not trilinear:
        return _bilinear_level(bgr, side, uv,
                               jnp.round(lod).astype(jnp.int32))
    lo = jnp.floor(lod).astype(jnp.int32)
    hi = jnp.ceil(lod).astype(jnp.int32)
    frac = (lod - jnp.floor(lod))[..., None]
    v_lo = _bilinear_level(bgr, side, uv, lo)
    v_hi = _bilinear_level(bgr, side, uv, hi)
    return v_lo * (1 - frac) + v_hi * frac


def _circular_diff(a: Array, b: Array) -> Array:
    """Shortest wrap-around uv difference (reference ``circular_diff2``)."""
    d = b - a
    return d - jnp.round(d)


def sample_anisotropic(bgr: Background, tex: Array, side: Array,
                       max_probes: int = 16, bias_frac: float = 1.3,
                       trilinear: bool = True,
                       probe_bilinear: bool = False,
                       live: Array | None = None,
                       probe_segments: tuple = (),
                       base_point: bool = False) -> Array:
    """EWA-style anisotropic filtering over the equirect map
    (cl.cl:5524-5687): screen-space uv derivatives from neighbouring pixels'
    texture coords, Heckbert ellipse axes, up to ``max_probes`` gaussian-
    weighted probes along the major axis.

    ``tex``: (H, W, 2); ``side``: (H, W) int32.  Returns (H, W, 3).
    ``live`` (optional bool (H, W)): pixels that will actually be displayed.
    Non-live pixels (the black shadow; painted over by the caller) drop out
    of the probe budget — their tex derivatives explode across the shadow
    edge and would otherwise crowd out real anisotropic pixels.

    ``probe_segments``: optional static schedule ``((frac, iters), ...)`` —
    pixels are already rank-ordered by descending probe count, so the sorted
    prefix is cut into segments: the first ``frac``-of-all-pixels run
    ``iters`` probe iterations, the next segment fewer, and so on.  A
    pixel whose ellipse wants more probes than its segment grants is
    re-clamped through the standard EWA budget rule (minor axis grows →
    overblur, never alias) — exactly what ``max_probes`` itself does.  The
    probe loop is gather-bound and masked lanes still pay their gather, so
    a dense loop costs ``k * max_probes`` gathers while the measured probe
    distribution is heavily skewed towards 1-2; segments cut that ~2x at
    equal anisotropy budget.  Empty = one segment: the top third of pixels
    at the full ``max_probes``.
    """
    tl = tex
    tr = jnp.concatenate([tex[:, 1:], tex[:, -2:-1]], axis=1)
    bl = jnp.concatenate([tex[1:], tex[-2:-1]], axis=0)
    # Edge pixels flip their neighbour direction (cl.cl:5525-5556); the
    # circular diff makes the sign irrelevant for the ellipse, so clamping
    # to the inner neighbour suffices.

    dx_vtc = _circular_diff(tl, tr) / bias_frac
    dy_vtc = _circular_diff(tl, bl) / bias_frac

    n_pix = int(np.prod(tex.shape[:-1]))
    out = sample_anisotropic_flat(
        bgr, tex.reshape(n_pix, 2), side.reshape(n_pix),
        dx_vtc.reshape(n_pix, 2), dy_vtc.reshape(n_pix, 2),
        max_probes=max_probes, trilinear=trilinear,
        probe_bilinear=probe_bilinear,
        live=None if live is None else live.reshape(n_pix),
        probe_segments=probe_segments, base_point=base_point,
    )
    return out.reshape(tex.shape[:-1] + (3,))


def sample_anisotropic_flat(bgr: Background, tex: Array, side: Array,
                            dx_vtc: Array, dy_vtc: Array,
                            max_probes: int = 16,
                            trilinear: bool = True,
                            probe_bilinear: bool = False,
                            live: Array | None = None,
                            probe_segments: tuple = (),
                            base_point: bool = False) -> Array:
    """EWA filtering over a FLAT pixel set with caller-supplied screen-space
    uv derivatives (already bias-scaled) — the traced-only shade path feeds
    quarter-grid and refine-ray sets whose neighbours are not screen-adjacent
    rows of one image.  ``tex``/``dx_vtc``/``dy_vtc``: (N, 2); ``side``:
    (N,).  Returns (N, 3).  See :func:`sample_anisotropic` for semantics.
    """
    w0 = float(bgr.level_w[0])
    h0 = float(bgr.level_h[0])
    du_dx = dx_vtc[..., 0] * w0
    du_dy = dy_vtc[..., 0] * w0
    dv_dx = dx_vtc[..., 1] * h0
    dv_dy = dy_vtc[..., 1] * h0

    # Heckbert ellipse (cl.cl:5577-5601).
    Ann = dv_dx * dv_dx + dv_dy * dv_dy + 1.0
    Bnn = -2.0 * (du_dx * dv_dx + du_dy * dv_dy)
    Cnn = du_dx * du_dx + du_dy * du_dy + 1.0
    # Degenerate ellipses (parallel derivatives at the poles) drive F -> 0
    # and then inf - inf = NaN downstream; clamp (the reference exhibits the
    # same pole artifacts, but NaN pixels must not escape here).
    F = jnp.maximum(Ann * Cnn - Bnn * Bnn / 4.0, 1e-10)
    A = Ann / F
    B = Bnn / F
    C = Cnn / F
    root = jnp.sqrt((A - C) * (A - C) + B * B)
    a_prime = (A + C - root) / 2.0
    c_prime = (A + C + root) / 2.0
    major = jax.lax.rsqrt(jnp.maximum(a_prime, 1e-20))
    minor = jax.lax.rsqrt(jnp.maximum(c_prime, 1e-20))
    theta = jnp.arctan2(B, (A - C) / 2.0)

    major = jnp.maximum(jnp.maximum(major, 1.0), minor)
    minor0 = jnp.maximum(minor, 1.0)

    f_probes = 2.0 * (major / minor0) - 1.0
    i_probes0 = jnp.floor(f_probes + 0.5).astype(jnp.int32)
    i_probes0 = jnp.minimum(i_probes0, max_probes)
    if live is not None:
        i_probes0 = jnp.where(live, i_probes0, 1)

    max_lod = bgr.levels - 1.0

    def probe_geom(ip):
        """The EWA probe-budget rule (cl.cl:5608-5634) for a given per-pixel
        probe count: clamping below the ellipse's wanted count grows the
        minor axis (overblur, never alias); a minor above the top mip level
        collapses to one probe."""
        ipf32 = ip.astype(jnp.float32)
        mnr = jnp.where(ipf32 < f_probes, 2.0 * major / (ipf32 + 1.0), minor0)
        lod = jnp.log2(jnp.maximum(mnr, 1e-20))
        over = lod > max_lod
        lod = jnp.where(over, max_lod, lod)
        ip = jnp.where(over, 1, ip)
        ip = jnp.maximum(ip, 1)
        return ip, mnr, lod

    i_probes, minor, lod = probe_geom(i_probes0)
    alpha = 2.0

    # Two passes: every pixel takes its centre sample; only the
    # highest-anisotropy third of pixels (sorted) runs the masked probe
    # loop — most pixels need one probe, and the dense loop would pay
    # max_probes gathers for all of them.
    # Pixels outside the probe budget fall back to an isotropic blur at the
    # ellipse's *major* radius (overblur rather than alias).
    lod_major = jnp.clip(jnp.log2(jnp.maximum(major, 1e-20)), 0.0,
                         bgr.levels - 1.0)
    base_lod = jnp.where(i_probes > 1, lod_major, lod)
    base = read_mipmap(bgr, side, tex, base_lod, trilinear=trilinear,
                       point=base_point)
    if max_probes <= 1:
        return base

    n_pix = int(np.prod(tex.shape[:-1]))

    # Static segment bounds over the sorted prefix: (start, end, iters).
    segs = tuple(probe_segments) or ((1.0 / 3.0, max_probes),)
    bounds = []
    prev = 0
    acc = 0.0
    for frac, iters in segs:
        acc += float(frac)
        end = min(n_pix, max(int(n_pix * acc), prev))
        if end > prev:
            bounds.append((prev, end, max(int(iters), 2)))
        prev = end
    k_min = min(n_pix, 1024)  # small-image floor
    if prev < k_min:
        start = bounds[-1][0] if bounds and bounds[-1][1] == prev else prev
        iters = bounds[-1][2] if bounds else max_probes
        if bounds and bounds[-1][1] == prev:
            bounds[-1] = (start, k_min, iters)
        else:
            bounds.append((prev, k_min, iters))
    k = bounds[-1][1]

    def flat(x):
        return x.reshape((n_pix,) + x.shape[tex.ndim - 1:])

    ip_f = flat(i_probes)
    # Group pixels by descending probe count with an O(N) counting partition
    # (ops.packing) instead of argsort — a bitonic sort over 2M keys costs
    # more than the whole probe loop.  i_probes is already in
    # [1, max_probes], so (max_probes - i_probes) is an exact bucket key and
    # the first k entries of the partition are exactly argsort(-i_probes)[:k]
    # up to tie order (irrelevant: ties get identical treatment).
    from ..ops import packing

    order, dest = packing.bucket_sort_perm(max_probes - ip_f, max_probes)
    order = order[:k]

    if any(iters < max_probes for _, _, iters in bounds) or len(bounds) > 1:
        # Per-pixel probe budget from the rank in the sorted order; pixels
        # wanting more than their segment grants re-clamp through
        # probe_geom (overblur).  Rank thresholds are static, so this is
        # pure elementwise work.  The re-clamp must also run for a SINGLE
        # segment whose iteration count is below max_probes — otherwise the
        # walk geometry (start_n, du/dv) assumes more probes than the loop
        # executes and samples only the negative half of the major axis.
        budget = jnp.ones((n_pix,), jnp.int32)
        for start, end, iters in reversed(bounds):
            budget = jnp.where(dest < end, iters, budget)
        ip_eff = jnp.minimum(
            i_probes, budget.reshape(i_probes.shape)
        )
        i_probes, minor, lod = probe_geom(ip_eff)

    # Probe walk along the major axis (cl.cl:5636-5687), fixed-bound with
    # masking: probe cnt contributes iff cnt < i_probes.
    line_length = 2.0 * (major - minor)
    np_f = jnp.maximum(i_probes.astype(jnp.float32) - 1.0, 1.0)
    du = jnp.cos(theta) * line_length / np_f
    dv = jnp.sin(theta) * line_length / np_f

    # ONE (k, 8) row gather instead of per-field gathers: gathers cost per
    # row AND saturate ~1 GB/s on wide rows, so derivable fields are
    # recomputed from the gathered minimum instead of carried — sU/sV are
    # du/dv times a static scale, start_n is a two-op function of
    # i_probes, and major only appears as (du^2+dv^2)/major^2 (carried as
    # the single ``q``).  side/i_probes are small ints — exact as f32.
    q_ell = (du * du + dv * dv) / (major * major)
    fields = jnp.concatenate([
        flat(tex),                                     # 0, 1
        flat(side).astype(jnp.float32)[:, None],       # 2
        flat(lod)[:, None],                            # 3
        flat(du)[:, None], flat(dv)[:, None],          # 4, 5
        flat(q_ell)[:, None],                          # 6
        flat(i_probes).astype(jnp.float32)[:, None],   # 7
    ], axis=-1)[order]
    texf = fields[:, 0:2]
    sidef = fields[:, 2].astype(jnp.int32)
    lodf = fields[:, 3]
    duf, dvf = fields[:, 4], fields[:, 5]
    sUf, sVf = duf * (1.0 / w0), dvf * (1.0 / h0)
    qf = fields[:, 6]
    ipf = fields[:, 7].astype(jnp.int32)
    oddf = (ipf % 2) == 1
    startf = jnp.where(oddf, -(ipf - 1), -ipf - 1)

    # Each segment runs only as many probe iterations as its budget grants
    # (its rows' i_probes are <= that by construction), so the gather count
    # follows the skewed probe distribution instead of k * max_probes.
    parts = []
    for start, end, iters in bounds:
        sl = slice(start, end)
        total = jnp.zeros((end - start, 3), dtype=jnp.float32)
        weight = jnp.zeros((end - start,), dtype=jnp.float32)
        for cnt in range(iters):
            nn = startf[sl] + 2 * cnt
            active = cnt < ipf[sl]
            d2 = (nn.astype(jnp.float32) ** 2 / 4.0) * qf[sl]
            rel_w = jnp.where(active, jnp.exp(-alpha * d2), 0.0)
            cu = texf[sl, 0] + (nn.astype(jnp.float32) / 2.0) * sUf[sl]
            cv = texf[sl, 1] + (nn.astype(jnp.float32) / 2.0) * sVf[sl]
            uv = jnp.stack([jnp.mod(cu, 1.0), jnp.mod(cv, 1.0)], axis=-1)
            val = read_mipmap(bgr, sidef[sl], uv, lodf[sl],
                              trilinear=trilinear,
                              point=not probe_bilinear)
            total = total + rel_w[:, None] * val
            weight = weight + rel_w
        parts.append(total / jnp.maximum(weight, 1e-20)[:, None])

    multi = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
    out = flat(base)
    k = order.shape[0]
    # Rows that keep their base value (ip == 1) redirect their scatter to
    # DISTINCT dummy rows past the image instead of being merged through an
    # ``out[order]`` gather — scatters/gathers cost per row, so the
    # masked-merge gather was an extra k rows (and same-row redirects would
    # bank-serialise, hence one dummy row each).
    safe = jnp.where(ipf > 1, order, n_pix + jnp.arange(k, dtype=order.dtype))
    out = jnp.concatenate([out, jnp.zeros((k, 3), out.dtype)], axis=0)
    out = out.at[safe].set(multi)[:n_pix]
    out = jnp.where(jnp.isfinite(out), out, 0.0)
    return out.reshape(tex.shape[:-1] + (3,))
