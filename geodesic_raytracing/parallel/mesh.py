"""Multi-device scaling: ray-tile data parallelism over a device mesh.

The reference is single-process single-GPU (SURVEY §2.4); its parallel axis is
"one work-item per pixel".  This design (BASELINE.json north star) shards the
*image plane* as ray tiles across the devices of a host:

* rays are embarrassingly parallel -> 1-D ``Mesh`` over a ``"rays"`` axis,
  ``shard_map`` with ``P("rays")`` on ray arrays, params/backgrounds
  replicated;
* the differentiable path all-reduces metric-parameter gradients
  (``psum`` inside ``shard_map``, which XLA hands to the collective library)
  — the only collective this workload needs;
* image assembly is the out-spec gather; no per-step traffic crosses devices.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import camera as cam
from ..metrics.base import Metric
from ..ops import integrate
from ..ops.geometry import HIGHEST
from ..ops.integrate import Features, TraceOptions
from ..render import background as bg
from ..render import pipeline

Array = jax.Array


def ray_mesh(devices: Sequence[jax.Device] | None = None,
             axis: str = "rays") -> Mesh:
    """1-D device mesh over the ray-tile axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def sharded_trace(metric: Metric, mesh: Mesh, state: integrate.RayState,
                  params, features: Features, opts: TraceOptions):
    """Trace a ray batch with rays sharded over the mesh.

    Pads the batch to a multiple of the mesh size; the returned state keeps
    the padded length (callers slice back).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    n = state.position.shape[0]
    n_pad = _pad_to(n, n_dev)

    if n_pad != n:
        pad = n_pad - n

        def padder(x):
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, widths)

        state = jax.tree.map(padder, state)
        # Padded rays start DEAD so they never integrate.
        state = state._replace(
            status=state.status.at[n:].set(integrate.DEAD)
        )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(axis), state), P()),
        out_specs=jax.tree.map(lambda _: P(axis), state),
        check_vma=False,
    )
    def run(shard, p):
        return integrate.trace_rays(metric, shard, p, features=features,
                                    opts=opts)

    return run(state, params)


def sharded_render_frame(metric: Metric, mesh: Mesh, camera: cam.Camera,
                         params, backgrounds: bg.Background,
                         settings: pipeline.RenderSettings,
                         features: Features | None = None) -> Array:
    """Full frame render with the trace stage sharded over the mesh.

    Ray init and shading are cheap elementwise/gather stages left to XLA's
    default sharding propagation; the integrator loop (~all of the work)
    runs under shard_map.
    """
    if features is None:
        features = Features.for_metric(metric)
    import dataclasses as _dc

    state, ku, _ = pipeline.init_camera_rays(
        metric, camera, params, _dc.replace(settings, planar=False), features
    )
    n = state.position.shape[0]
    final = sharded_trace(metric, mesh, state, params, features,
                          settings.trace)
    final = jax.tree.map(lambda x: x[:n], final)
    rdata = pipeline.compute_render_data(metric, final, ku, params, features)
    return pipeline.shade(rdata, backgrounds, settings)


def _adaptive_band_stages(metric: Metric, settings, features, Hb: int,
                          Wh: int, k: int, band_settings, opts,
                          Hh: int, mirror: bool, balance_cpb: int = 0):
    """Band-local stage functions for the production adaptive pipeline.

    Each stage covers one band of ``Hb`` quarter rows, identified by the
    leading band-index argument ``b``.  ``sharded_adaptive_frame`` wires
    ``b = axis_index`` inside ``shard_map``; ``banded_adaptive_frame``
    passes it explicitly to run the SAME programs sequentially on one
    device — keeping the two paths behaviourally identical by construction.

    ``mirror``: band b covers the top half-chunk ``[b*Hb/2, (b+1)*Hb/2)``
    PLUS its mirrored bottom chunk — centred scenes (the hole in the
    middle rows) cost-balance across bands.  The half-chunk seam rows fall under the same must-refine rule as band
    boundaries, so nothing interpolates across non-adjacent rows.

    ``balance_cpb``: dynamic cost-balanced bands — band b covers
    ``balance_cpb`` row chunks chosen PER FRAME from the prepass cost map
    (``_cost_band_layout``); each stage takes the band's traced row
    indices as an extra trailing argument.  Chunk-boundary rows in the
    band grid sit at static positions (multiples of ``Hb/balance_cpb``)
    and fall under the seam must-refine rule — the row CONTENT is traced,
    the seam GEOMETRY is static, so one compiled program serves every
    frame's assignment.  Mutually exclusive with ``mirror``.
    """
    Hb2 = Hb // 2
    if balance_cpb:
        assert not mirror
        Hc = Hb // balance_cpb
        seam = tuple(r for c in range(1, balance_cpb)
                     for r in (c * Hc - 1, c * Hc))
    else:
        seam = (Hb2 - 1, Hb2) if mirror else ()

    def band_rows(b, rows=None):
        if balance_cpb:
            return rows.reshape(Hb)
        r = jnp.arange(Hb, dtype=jnp.int32)
        if mirror:
            return jnp.where(r < Hb2, b * Hb2 + r,
                             Hh - (b + 1) * Hb2 + (r - Hb2))
        return b * Hb + r

    def band_coords(b, rows=None):
        yy = 2.0 * band_rows(b, rows).astype(jnp.float32)
        qcy = jnp.repeat(yy, Wh)
        qcx = jnp.tile(2.0 * jnp.arange(Wh, dtype=jnp.float32), Hb)
        return qcx, qcy

    def quarter_stage(b, camera, params, kill, rows=None):
        qcx, qcy = band_coords(b, rows)
        state, ku, iquat = pipeline._init_rays(
            metric, camera, params, settings, features, qcx, qcy, kill)
        qfin = integrate.trace_rays(metric, state, params, features=features,
                                    opts=opts)
        return pipeline.compute_render_data(metric, qfin, ku, params,
                                            features, inv_quat=iquat)

    def refine_stage(b, camera, params, qr, rows=None):
        qcx, qcy = band_coords(b, rows)
        qg = pipeline.RenderData(
            *(f.reshape((Hb, Wh) + f.shape[1:]) for f in qr))
        should, sel, dest = pipeline._select_refine_blocks(qg, settings, k,
                                                          seam_rows=seam)
        sflat = should.reshape(-1)[sel]
        scx, scy = qcx[sel], qcy[sel]
        rcx = jnp.concatenate(
            [scx + ox for ox, oy in pipeline._REFINE_OFFSETS])
        rcy = jnp.concatenate(
            [scy + oy for ox, oy in pipeline._REFINE_OFFSETS])
        rkill = ~jnp.concatenate([sflat] * 3)
        rstate, rku, riquat = pipeline._init_rays(
            metric, camera, params, settings, features, rcx, rcy, rkill)
        rfin = integrate.trace_rays(metric, rstate, params, features=features,
                                    opts=opts)
        return rfin, rku, riquat, should, sel, dest

    def finish_stage(params, rfin, rku, riquat, qr, should, sel, dest,
                     backgrounds):
        return pipeline._finish_shade_jit(
            metric, rfin, rku, riquat, params, features, qr, should, sel,
            dest, backgrounds, band_settings, k)

    return quarter_stage, refine_stage, finish_stage


@functools.partial(jax.jit,
                   static_argnames=("Hh", "Wh", "n_bands", "cpb"))
def _cost_band_layout(kill_full, cost_full, Hh: int, Wh: int,
                      n_bands: int, cpb: int):
    """Per-frame cost-balanced chunk-to-band assignment.

    An OPT-IN: its extra seam must-refine rows and per-frame layout
    program cost work that contiguous bands do not pay, so it is meant for
    scenes whose prepass cost map is genuinely row-skewed.

    Splits the ``Hh`` quarter rows into ``n_bands * cpb`` contiguous
    chunks, prices each chunk by the prepass step-cost map (already on
    device — no host round trip), and assigns chunks to bands by greedy
    LPT under a fixed per-band capacity of ``cpb`` chunks — every band
    gets EXACTLY ``Hh / n_bands`` rows, so all downstream shapes stay
    static and one compiled program serves every frame's assignment.

    Returns ``(kill_perm, row_map, inv_fullres)``: the prepass kill map
    permuted to band-major order (so the existing static per-band
    slicing / P(axis) sharding applies unchanged), the per-band quarter-
    row indices ``(n_bands, Hh/n_bands)``, and the full-res row gather
    that stitches the band-major output image back to image order.
    """
    C = n_bands * cpb
    Hc = Hh // C
    chunk_cost = cost_full.reshape(C, Hc * Wh).sum(axis=1)
    order = jnp.argsort(-chunk_cost)

    def body(i, carry):
        load, count, assign = carry
        c = order[i]
        # Least-loaded band that still has chunk capacity.
        masked = jnp.where(count < cpb, load, jnp.inf)
        b = jnp.argmin(masked).astype(jnp.int32)
        return (load.at[b].add(chunk_cost[c]),
                count.at[b].add(1),
                assign.at[c].set(b))

    _, _, assign = jax.lax.fori_loop(
        0, C, body,
        (jnp.zeros((n_bands,), jnp.float32),
         jnp.zeros((n_bands,), jnp.int32),
         jnp.zeros((C,), jnp.int32)))
    # Band-major chunk list, ascending chunk id within each band (argsort
    # is stable, so equal band keys keep image order — image-adjacent
    # chunks in one band stay adjacent).
    band_chunks = jnp.argsort(assign * C + jnp.arange(C)).reshape(
        n_bands, cpb).astype(jnp.int32)
    row_map = (band_chunks[:, :, None] * Hc
               + jnp.arange(Hc, dtype=jnp.int32)).reshape(n_bands, cpb * Hc)
    rows_flat = row_map.reshape(-1)
    kill_perm = kill_full.reshape(Hh, Wh)[rows_flat].reshape(-1)
    # Banded full-res rows 2i, 2i+1 show image rows 2*rows_flat[i](+1).
    full_order = jnp.stack([2 * rows_flat, 2 * rows_flat + 1],
                           axis=1).reshape(-1)
    inv_fullres = jnp.argsort(full_order).astype(jnp.int32)
    return kill_perm, row_map, inv_fullres


def _band_setup(metric: Metric, camera: cam.Camera, params, settings,
                features, n_bands: int, mirror: bool | None = None,
                balance: int | None = None):
    """Shared per-frame setup for the band-decomposed adaptive pipeline:
    band geometry, per-band refine budget, trace options, and the
    once-per-frame global prepass maps (or flat defaults)."""
    import dataclasses as _dc

    W, H = settings.width, settings.height
    Wh, Hh = W // 2, H // 2
    assert Hh % n_bands == 0, (
        f"band count ({n_bands}) must divide quarter rows ({Hh})"
    )
    Hb = Hh // n_bands
    nqb = Wh * Hb
    frac = settings.refine_budget
    if frac >= 1.0:
        k = nqb
    else:
        k = max(min(nqb, 1024), (int(nqb * frac) // 8) * 8)
    band_settings = _dc.replace(settings, height=2 * Hb)
    planar = pipeline._planar_enabled(metric, settings)
    opts = _dc.replace(settings.trace, planar=planar)

    # Global prepass (1/256 of the frame's rays), run once per frame; its
    # kill map is split into per-band quarter rows by the caller, its cost
    # map prices the cost-balanced layout.
    kill_full = cost_full = None
    if metric.config.use_prepass:
        pw = max(W // settings.prepass_scale, 4)
        ph = max(H // settings.prepass_scale, 4)
        psettings = _dc.replace(settings, width=pw, height=ph,
                                adaptive_sampling=False)
        dead, psteps = pipeline._prepass_dead_map(
            metric, camera, params, psettings, features)
        # (Hh*Wh,) row-major: splitting on axis 0 yields exactly the
        # per-band quarter rows.
        kill_full = pipeline._prepass_kill(dead, W, H, Wh, Hh)
        cost_full = pipeline._prepass_cost(psteps, W, H, Wh, Hh)
    if kill_full is None:
        kill_full = jnp.zeros((Hh * Wh,), bool)
        cost_full = jnp.zeros((Hh * Wh,), jnp.float32)

    # Mirrored half-bands (see _adaptive_band_stages): available but OFF
    # by default — they add seam must-refine rows and per-frame
    # permute/stitch programs, and the flagship cost field is not
    # top-bottom symmetric.  Scenes with genuinely symmetric cost can opt
    # in.
    if mirror and (n_bands <= 1 or Hb % 2):
        # An EXPLICIT mirror request that cannot be honoured must not be
        # silently downgraded (the cache key would record contiguous-band
        # semantics under a mirror call).  mirror=None auto-off stays quiet.
        raise ValueError(
            f"mirror=True requires n_bands > 1 and an even band height "
            f"(n_bands={n_bands}, Hb={Hb})"
        )
    mirror = bool(mirror)
    if balance:
        if mirror:
            raise ValueError("balance and mirror are mutually exclusive")
        if n_bands > 1:
            if Hb % balance:
                raise ValueError(
                    f"balance={balance} chunks/band must divide the band "
                    f"height ({Hb} quarter rows)")
            kill_full, row_map, inv_fullres = _cost_band_layout(
                kill_full, cost_full, Hh, Wh, n_bands, balance)
            return (Wh, Hb, k, band_settings, opts, kill_full, Hh, mirror,
                    inv_fullres, row_map)
        balance = None  # 1 band: nothing to balance
    inv_fullres = None
    if mirror:
        Hb2 = Hb // 2
        order = np.concatenate([
            np.concatenate([
                np.arange(b * Hb2, (b + 1) * Hb2),
                np.arange(Hh - (b + 1) * Hb2, Hh - b * Hb2),
            ]) for b in range(n_bands)
        ])
        # The prepass maps are consumed band-row-major: pre-permute them.
        kill_full = kill_full.reshape(Hh, Wh)[order].reshape(-1)
        # Full-res row map for stitching the band-major output image back
        # to image order: banded row 2*i(+1) shows image row 2*order[i](+1).
        full_order = np.stack([2 * order, 2 * order + 1], axis=1).reshape(-1)
        inv_fullres = jnp.asarray(np.argsort(full_order), jnp.int32)
    return (Wh, Hb, k, band_settings, opts, kill_full, Hh, mirror,
            inv_fullres, None)


def sharded_adaptive_frame(metric: Metric, mesh: Mesh, camera: cam.Camera,
                           params, backgrounds: bg.Background,
                           settings: pipeline.RenderSettings,
                           features: Features | None = None,
                           mirror: bool | None = None,
                           balance: int | None = None) -> Array:
    """The PRODUCTION adaptive pipeline (prepass + quarter trace + budgeted
    refinement + traced-only shading) sharded over quarter-row bands.

    Sharding design (BASELINE.json north star: rays/s scaling efficiency):

    * The image plane is cut into ``n_dev`` horizontal bands of quarter
      rows; every per-ray stage (ray init, trace, render data, shading)
      is band-local — zero per-step communication, exactly the
      embarrassingly-parallel structure of the reference's one-work-item-
      per-pixel dispatch (SURVEY §2.4).
    * The 16x prepass is computed ONCE per frame as its own global
      program (it is 1/256 of the frame's rays) and its kill map is
      scattered into bands by the ``P(axis)`` in_specs of the quarter
      stage.  Computing it globally — rather than per band —
      removes the only cross-band neighbour dependency (the 5-cell kill
      test straddles band boundaries).
    * The refinement decision's cross-block neighbour tests run per band;
      band-boundary rows fall under the same must-refine rule as image
      borders (pipeline._refine_error_terms), so a band boundary only ever
      ADDS traced blocks (~0.2% extra rays per boundary) — never
      interpolates across data it cannot see.
    * The refinement budget is split evenly across bands (k/n_dev per
      band): the reference sizes its dispatch by a global atomic counter
      (cl.cl:5294); a global top-k would need an all-gather of every
      block's error.  Under the controller's demand margin the even split
      only bites when refinement demand is heavily band-skewed, and then
      over-budget blocks fall back to interpolation (quality, not
      correctness).

    The collective cost of a frame is exactly: parameter/camera broadcast
    in, image all-gather out (the out_spec) — no per-step traffic crosses
    devices.

    Structure: the frame runs as a host-chained sequence of per-stage
    ``shard_map`` programs (replicated prepass, then quarter trace /
    refine trace / finish+shade with band-local shards carried between
    programs) — mirroring the single-device pipeline's program splits.
    The old monolithic band program (3 while-loop trace stages + the fused
    shade in ONE XLA module) took 400+ s to compile even for a 1-device
    CPU mesh (vs ~20 s as separate programs — a superlinear XLA pass).
    Dispatch is async, so the extra program boundaries cost little.
    """
    if features is None:
        features = Features.for_metric(metric)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    (Wh, Hb, k, band_settings, opts, kill_full, Hh, mirror, inv_fullres,
     row_map) = _band_setup(metric, camera, params, settings,
                                         features, n_dev, mirror, balance)
    dyn = row_map is not None
    q_band, r_band, f_band = _adaptive_band_stages(
        metric, settings, features, Hb, Wh, k, band_settings, opts, Hh,
        mirror, balance_cpb=(balance or 0) if dyn else 0)

    def quarter_stage(camera, params, kill, *rows):
        return q_band(jax.lax.axis_index(axis), camera, params, kill, *rows)

    def refine_stage(camera, params, qr, *rows):
        return r_band(jax.lax.axis_index(axis), camera, params, qr, *rows)

    finish_stage = f_band

    # One cached (shard_map + jit) program per stage per configuration —
    # a fresh wrapper per frame would re-trace every call.  Keyed by
    # id(metric) (the closures capture the Metric object, so two distinct
    # instances under one name must NOT share a program) and bounded: the
    # interactive path swaps metrics freely and the programs pin compiled
    # executables.
    ckey = (id(metric), metric.name, mesh, settings, k, mirror,
            balance if dyn else None, tuple(float(v) for v in features))
    progs = _ADAPTIVE_PROGRAMS.get(ckey)
    if progs is None:
        if len(_ADAPTIVE_PROGRAMS) >= _ADAPTIVE_PROGRAMS_CAP:
            _ADAPTIVE_PROGRAMS.pop(next(iter(_ADAPTIVE_PROGRAMS)))

        def smap(fn, in_specs):
            # out_specs P(axis) is a PREFIX spec: every output leaf is
            # band-local (sharded along its leading axis).
            return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                                     out_specs=P(axis), check_vma=False))

        rows_spec = (P(axis),) if dyn else ()
        progs = (
            smap(quarter_stage, (P(), P(), P(axis)) + rows_spec),
            smap(refine_stage, (P(), P(), P(axis)) + rows_spec),
            smap(finish_stage,
                 (P(),) + (P(axis),) * 7 + (P(),)),
        )
        _ADAPTIVE_PROGRAMS[ckey] = progs
    q_prog, r_prog, f_prog = progs

    rows_arg = (row_map,) if dyn else ()
    qr = q_prog(camera, params, kill_full, *rows_arg)
    rfin, rku, riquat, should, sel, dest = r_prog(camera, params, qr,
                                                  *rows_arg)
    img = f_prog(params, rfin, rku, riquat, qr, should, sel, dest,
                 backgrounds)
    if inv_fullres is not None:
        # Band-major rows -> image rows (mirror / cost-balanced layouts).
        img = img[inv_fullres]
    return img


def banded_adaptive_frame(metric: Metric, camera: cam.Camera, params,
                          backgrounds: bg.Background,
                          settings: pipeline.RenderSettings,
                          n_bands: int,
                          features: Features | None = None,
                          band_sync=None,
                          mirror: bool | None = None,
                          balance: int | None = None) -> Array:
    """The production adaptive pipeline run as ``n_bands`` sequential
    band-local program chains on ONE device — the exact band decomposition
    ``sharded_adaptive_frame`` distributes over a mesh (the stage code is
    shared; ``row0`` is passed as a traced argument instead of derived from
    ``axis_index``, so one compiled program serves every band).

    Purpose: measure the *banding tax* on a single device — the
    band-boundary must-refine rows, the k/n_bands refine-budget split, and
    the smaller per-launch ray batches.  With load-balanced bands, N-device
    scaling efficiency is bounded by ``T(1 band) / (N * T(slowest band))``;
    ``scripts/band_tax_bench.py`` records both the per-band times (via
    ``band_sync``, called with each band's image to force it) and the total.

    Ref: the reference's per-pixel dispatch has no analogue of this
    decomposition (single-GPU, SURVEY §2.4); this is the band-sharded
    scaling design's single-device half (BASELINE.json north star).
    """
    if features is None:
        features = Features.for_metric(metric)
    (Wh, Hb, k, band_settings, opts, kill_full, Hh, mirror, inv_fullres,
     row_map) = _band_setup(metric, camera, params, settings,
                                         features, n_bands, mirror, balance)
    dyn = row_map is not None
    nqb = Wh * Hb

    ckey = ("banded", id(metric), metric.name, n_bands, settings, k, mirror,
            balance if dyn else None, tuple(float(v) for v in features))
    progs = _ADAPTIVE_PROGRAMS.get(ckey)
    if progs is None:
        if len(_ADAPTIVE_PROGRAMS) >= _ADAPTIVE_PROGRAMS_CAP:
            _ADAPTIVE_PROGRAMS.pop(next(iter(_ADAPTIVE_PROGRAMS)))
        q_band, r_band, f_band = _adaptive_band_stages(
            metric, settings, features, Hb, Wh, k, band_settings, opts, Hh,
            mirror, balance_cpb=(balance or 0) if dyn else 0)
        progs = (jax.jit(q_band), jax.jit(r_band), jax.jit(f_band))
        _ADAPTIVE_PROGRAMS[ckey] = progs
    q_prog, r_prog, f_prog = progs

    imgs = []
    for b in range(n_bands):
        bi = jnp.int32(b)
        kb = jax.lax.slice_in_dim(kill_full, b * nqb, (b + 1) * nqb)
        rows_arg = (row_map[b],) if dyn else ()
        qr = q_prog(bi, camera, params, kb, *rows_arg)
        rfin, rku, riquat, should, sel, dest = r_prog(
            bi, camera, params, qr, *rows_arg)
        img = f_prog(params, rfin, rku, riquat, qr, should, sel, dest,
                     backgrounds)
        if band_sync is not None:
            band_sync(b, img)
        imgs.append(img)
    img = jnp.concatenate(imgs, axis=0)
    if inv_fullres is not None:
        img = img[inv_fullres]
    return img


# Stage-program cache for sharded_adaptive_frame / banded_adaptive_frame,
# keyed by (id(metric), metric name, mesh-or-band-count, settings, refine k,
# features values); FIFO-bounded so long interactive sessions can't pin
# unbounded programs.
_ADAPTIVE_PROGRAMS: dict = {}
_ADAPTIVE_PROGRAMS_CAP = 32


def make_train_step(metric: Metric, mesh: Mesh,
                    settings: pipeline.RenderSettings,
                    features: Features | None = None,
                    grad_step_cap: int = 512,
                    grad_hard_cap: int | None = None,
                    soft_decay_bits: float = 1.0):
    """Build a jitted DP training step: fit metric parameters to a target
    image by gradient descent through the (remat-scan) integrator.

    Per-device: trace + shade the local ray shard, local L2 loss, local
    parameter gradient.  Cross-device: a single ``psum`` for loss
    and gradients, overlapped with the backward sweep by XLA.  This is the
    differentiable-rendering capability the reference lacks (SURVEY §7.7-7.8).

    Lyapunov window: reverse-mode tangents of photon-ring rays grow
    ~e^(2 pi) per orbit and overflow fp32.  Instead of excluding every ray
    past a hard step cap from the gradient (which silences the shadow
    edge — the most informative pixels for rs/a), the loss DOWNWEIGHTS
    pixels smoothly beyond ``grad_step_cap``:
    ``w = 2^(-soft_decay_bits * (steps - cap))`` with stop-gradient
    weights from the probe trace.  The decay default (1.0 bit/step) is
    calibrated against the measured worst-lane backward growth (~1 bit/
    step on deep photon-ring lanes at 128^2/1024; 0.25 bits/step NaNs
    after one optimiser update).  The backward sweep is linear in the
    seed cotangents, so the scaling keeps every intermediate cotangent in
    fp32 range while boundary pixels (a few steps past the cap) keep
    near-full weight.  Because the weights are constants of the loss, the
    autodiff gradient equals the finite-difference gradient of the SAME
    weighted loss (validated in tests/test_gradients.py).  Rays past
    ``grad_hard_cap`` (default 2x the soft cap) are still pre-killed.

    Returns ``step(params, camera, target_image, backgrounds, lr)``
    -> ``(new_params, loss)``.
    """
    if features is None:
        features = Features.for_metric(metric)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    import dataclasses as _dc

    if grad_hard_cap is None:
        # Keep lanes only up to the fp32 weight-underflow boundary: a lane
        # more than ~149/decay steps past the soft cap has loss weight
        # 2^-149 == 0 EXACTLY in IEEE fp32 (smallest subnormal is 2^-149;
        # 128 bits would only be exact under flush-to-zero, which not
        # every backend applies), yet its deep photon-ring Jacobian
        # can overflow fp32 mid-backward and inject inf*0 = NaN into the
        # batch gradient.  Measured at 256^2/2048 Kerr
        # (scripts/fit_nan_probe.py): hard cap 896 NaNs both parameter
        # gradients; 768 and 640 are finite with BIT-IDENTICAL loss and
        # gradient (the excluded lanes carried zero weight).  The tighter
        # window also shortens the differentiable scan.
        margin = int(np.ceil(149.0 / max(float(soft_decay_bits), 1e-6)))
        grad_hard_cap = min(2 * grad_step_cap, grad_step_cap + margin,
                            settings.trace.max_steps)
    grad_hard_cap = min(grad_hard_cap, settings.trace.max_steps)

    opts = settings.trace
    if opts.method != "scan":
        # The differentiable path needs the fixed-length remat scan.
        opts = _dc.replace(opts, method="scan")
    # The probe pre-kills every lane past grad_hard_cap COMMITTED steps, so
    # the differentiable scan only needs to cover the cap plus rejected-
    # trial slack (step rejections are ~0.2% of iterations; 1.25x is ample)
    # — at the old fixed length the scan ran max_steps iterations for rays
    # that all finish within the cap.
    remat = max(1, min(opts.remat_every, opts.max_steps))
    scan_steps = min(opts.max_steps,
                     -(-int(grad_hard_cap * 1.25) // remat) * remat)
    opts = _dc.replace(opts, max_steps=scan_steps)
    # The probe only classifies lanes (no gradients flow): run it with the
    # early-exiting while driver at the FULL step budget instead of the
    # fixed-length scan.
    probe_opts = _dc.replace(settings.trace, method="while")

    W, H = settings.width, settings.height
    n_rays = W * H
    assert n_rays % n_dev == 0, (
        f"image pixels ({n_rays}) must divide the mesh ({n_dev} devices)"
    )

    def local_loss(params, camera, dirs, target_slice, backgrounds,
                   probe_params):
        # Rebuild the (tiny, replicated) camera tetrad locally; trace the
        # ray shard; shade; L2 against the target shard.
        # ``probe_params``: parameters for the mask/weight probe — normally
        # ``params`` itself; finite-difference validation passes the
        # unperturbed point so the probe's discrete masks stay constant
        # (autodiff treats them as constants via stop_gradient).
        sign = pipeline._trace_sign(metric, settings)

        def launch(p):
            position = pipeline.camera_to_generic(metric, camera, p)
            es = cam.observer_tetrad(
                metric, position, p, basis_speed3=camera.basis_speed,
                orient=True,
            )
            velocity = (
                dirs[:, 0:1] * es[1][None, :]
                + dirs[:, 1:2] * es[2][None, :]
                + dirs[:, 2:3] * es[3][None, :]
                + sign * es[0][None, :]
            )
            positions = jnp.broadcast_to(position, velocity.shape)
            state = integrate.init_ray_state(metric, positions, velocity, p,
                                             features)
            return position, es, state

        position, es, state = launch(params)
        # Two-pass differentiation: a stop-gradient probe trace finds the
        # lanes whose trajectories poison reverse mode — rays that die
        # (their one divergent trial evaluation feeds inf primals into the
        # vjp even under zero cotangents) and rays winding past the
        # Lyapunov step cap (tangents grow ~e^(2 pi) per photon-sphere
        # orbit and overflow fp32).  Those lanes enter the differentiable
        # scan pre-killed: they idle at their (regular) launch state and
        # never evaluate the hazardous steps at all.  Costs one extra
        # forward pass.
        sg = jax.lax.stop_gradient
        pp = sg(probe_params)
        _, _, pstate = launch(pp)
        probe = integrate.trace_rays(
            metric, jax.tree.map(sg, pstate), pp, features=features,
            opts=probe_opts,
        )
        polar_r = jnp.abs(metric.to_polar(sg(probe.position.T), pp)[1])
        keep = (
            (probe.status == integrate.ESCAPED)
            & (polar_r >= 0.5 * features.universe_size)
            & (probe.steps <= grad_hard_cap)
        )
        # Soft Lyapunov window (see make_train_step docstring): constant
        # per-pixel weights decaying past the soft cap keep shadow-edge
        # gradients finite in fp32 without a hard exclusion.
        extra = jnp.maximum(
            probe.steps.astype(jnp.float32) - float(grad_step_cap), 0.0)
        lyap_w = jnp.where(keep, jnp.exp2(-soft_decay_bits * extra), 0.0)
        state = state._replace(
            status=jnp.where(keep, state.status, integrate.DEAD)
        )
        final = integrate.trace_rays(metric, state, params, features=features,
                                     opts=opts)
        # Horizon-terminated endpoints sit where the metric is singular;
        # their render-data evaluation NaN-poisons reverse mode (see
        # pipeline.grad_safe_final) — substitute launch states and keep
        # only the consumed (probe-kept) pixels.  The mask comes from the
        # PROBE (identical to the diff trace at the evaluation point, both
        # run the same step math) so every discrete decision lives in one
        # stop-gradient pass.
        consumed = keep

        def pick(a, b):
            mm = consumed.reshape((-1,) + (1,) * (a.ndim - 1))
            return jnp.where(mm, a, b)

        final = final._replace(
            position=pick(final.position, state.position),
            velocity=pick(final.velocity, state.velocity),
            acceleration=pick(final.acceleration, state.acceleration),
        )
        gab = metric.fn(position, params)
        ku = jnp.matmul(state.velocity,
                        jnp.matmul(gab, es[0], precision=HIGHEST),
                        precision=HIGHEST)
        rdata = pipeline.compute_render_data(metric, final, ku, params,
                                             features)
        # Sample a blurred mip level: flat checker regions give zero/edge
        # gradients that stall the fit; the blur makes the pixel loss a
        # smooth function of the texture coordinates.
        rgb = bg.read_mipmap(
            backgrounds, rdata.side, rdata.tex_coord,
            jnp.full(rdata.side.shape, 3.0),
        )
        rgb = jnp.where(consumed[..., None], rgb, 0.0)
        w = jnp.where(consumed, lyap_w, 0.0)[..., None]
        return jnp.sum(w * (rgb - target_slice) ** 2) / n_rays

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis, None), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def loss_and_grad(params, camera, dirs, target, backgrounds,
                      probe_params):
        loss, grads = jax.value_and_grad(local_loss)(
            params, camera, dirs, target, backgrounds, probe_params
        )
        loss = jax.lax.psum(loss, axis)
        grads = jax.tree.map(lambda g: jax.lax.psum(g, axis), grads)
        return loss, grads

    @jax.jit
    def _step(params, camera, target_image, backgrounds, lr):
        dirs = cam.pixel_directions(W, H, camera.quat, settings.fov_degrees)
        dirs = dirs.reshape(-1, 3)
        target = target_image.reshape(-1, 3)
        loss, grads = loss_and_grad(params, camera, dirs, target, backgrounds,
                                    params)
        # Clip by global norm — the L2 landscape has cliffs at horizon
        # crossings and NaN-guard plateaus; raw SGD overshoots.
        gnorm = jnp.sqrt(
            sum(jnp.sum(g * g) for g in jax.tree.leaves(grads)) + 1e-20
        )
        scale = jnp.minimum(1.0, 1.0 / gnorm)
        new_params = jax.tree.map(
            lambda p, g: p - lr * scale * g, params, grads
        )
        return new_params, loss

    # The step returns parameters replicated over the mesh; placing the
    # caller's parameters the same way keeps the second call from
    # compiling the step again for a different input sharding.
    replicated = NamedSharding(mesh, P())

    def step(params, camera, target_image, backgrounds, lr):
        return _step(jax.device_put(params, replicated), camera,
                     target_image, backgrounds, lr)

    @jax.jit
    def loss_and_grad_full(params, camera, target_image, backgrounds,
                           probe_params=None):
        """(loss, grads) without the update — exposed for finite-difference
        validation of the (Lyapunov-weighted) loss.  Pass ``probe_params``
        (the unperturbed point) to freeze the probe's discrete masks under
        a parameter perturbation."""
        dirs = cam.pixel_directions(W, H, camera.quat, settings.fov_degrees)
        dirs = dirs.reshape(-1, 3)
        target = target_image.reshape(-1, 3)
        if probe_params is None:
            probe_params = params
        return loss_and_grad(params, camera, dirs, target, backgrounds,
                             probe_params)

    step.loss_and_grad = loss_and_grad_full
    return step
