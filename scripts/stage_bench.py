"""Sync-isolated timings of the PRODUCTION XLA programs making up the
adaptive 1080p Kerr frame (the bench.py configuration), plus divergence
diagnostics for the two whole-batch trace launches.

Usage:
    python scripts/stage_bench.py [--cpu] [--frames N]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def sync(x):
    import jax

    return jax.block_until_ready(x)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--budget", type=float, default=None,
                    help="refine budget fraction (default: the settled "
                         "production bucket, 3/16)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from geodesic_raytracing.bench_config import flagship_config
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render import pipeline as pl

    W, H = args.width, args.height
    metric, params, camera, settings, features = flagship_config(W, H)
    backgrounds = bg.checker_background()
    Wh, Hh = W // 2, H // 2
    nq = Wh * Hh

    # ----- the exact production program chain ----------------------------
    pw = max(W // settings.prepass_scale, 4)
    ph = max(H // settings.prepass_scale, 4)
    psettings = dataclasses.replace(settings, width=pw, height=ph,
                                    adaptive_sampling=False)

    def stage_prepass():
        return pl._prepass_dead_map(metric, camera, params, psettings,
                                    features)

    dead, psteps = stage_prepass()

    def stage_qsetup():
        return pl._quarter_setup_jit(metric, camera, params, settings,
                                     features, dead)

    qstate0, ku, iquat = stage_qsetup()

    def stage_qtrace():
        return pl._trace_jit(metric, qstate0, params, settings, features)

    qstate = stage_qtrace()

    # Profile at the budget the production RefineBudgetController settles
    # on for this frame (3/16; bench.py measures the settled steady state).
    budget = args.budget if args.budget is not None else 3 / 16
    if budget >= 1.0:
        k = nq
    else:
        k = max(min(nq, 1024), (int(nq * budget) // 8) * 8)

    def stage_rsetup():
        return pl._refine_setup_jit(metric, camera, params, settings,
                                    features, qstate, ku, iquat, k)

    (qr, should, _demand, sel, dest, rstate0, rku,
     riquat) = stage_rsetup()

    def stage_rtrace():
        return pl._trace_jit(metric, rstate0, params, settings, features)

    rstate = stage_rtrace()

    def stage_finish():
        return pl._finish_jit(metric, rstate, rku, riquat, params, features,
                              qr, should, sel, dest, settings, k)

    rdata = stage_finish()

    def stage_shade():
        return pl._shade_jit(rdata, backgrounds, settings)

    def stage_fshade():
        # Traced-only finish: refine rdata + quarter/refine shade + RGB
        # assembly in one program (replaces finish+shade in production).
        return pl._finish_shade_jit(metric, rstate, rku, riquat, params,
                                    features, qr, should, sel, dest,
                                    backgrounds, settings, k)

    img = stage_shade()
    assert np.isfinite(np.asarray(img[::128, ::128])).all()

    stages = {
        "prepass": stage_prepass,
        "qsetup": stage_qsetup,
        "qtrace": stage_qtrace,
        "rsetup": stage_rsetup,
        "rtrace": stage_rtrace,
        "finish": stage_finish,
        "shade": stage_shade,
        "fshade": stage_fshade,
    }
    total = 0.0
    for name, fn in stages.items():
        ts = []
        for _ in range(args.frames):
            sync(fn())  # drain anything pending
            t0 = time.perf_counter()
            sync(fn())
            ts.append(time.perf_counter() - t0)
        t = float(np.median(ts))
        total += t
        print(f"{name:10s} {t:7.3f} s")
    print(f"{'TOTAL':10s} {total:7.3f} s  "
          f"({W * H / total / 1e6:.2f} Mrays/s sync-isolated)")

    # ----- probe-demand diagnostics (tunes probe_segments tiers) --------
    def probe_demand(tag, tex, dx, dy, live):
        w0, h0 = float(backgrounds.level_w[0]), float(backgrounds.level_h[0])
        dx, dy = np.asarray(dx), np.asarray(dy)
        du_dx, dv_dx = dx[..., 0] * w0, dx[..., 1] * h0
        du_dy, dv_dy = dy[..., 0] * w0, dy[..., 1] * h0
        Ann = dv_dx * dv_dx + dv_dy * dv_dy + 1.0
        Bnn = -2.0 * (du_dx * dv_dx + du_dy * dv_dy)
        Cnn = du_dx * du_dx + du_dy * du_dy + 1.0
        F = np.maximum(Ann * Cnn - Bnn * Bnn / 4.0, 1e-10)
        A, B, C = Ann / F, Bnn / F, Cnn / F
        root = np.sqrt((A - C) ** 2 + B * B)
        major = 1.0 / np.sqrt(np.maximum((A + C - root) / 2, 1e-20))
        minor = 1.0 / np.sqrt(np.maximum((A + C + root) / 2, 1e-20))
        major = np.maximum(np.maximum(major, 1.0), minor)
        minor = np.maximum(minor, 1.0)
        want = np.floor(2.0 * major / minor - 0.5).astype(int)
        want = np.where(np.asarray(live), want, 1)
        n = want.size
        print(f"{tag:10s} n {n}  " + "  ".join(
            f">={t}: {(want >= t).mean():.3f}" for t in (2, 3, 5, 8)))

    from geodesic_raytracing.ops import integrate as integ

    qtex = np.asarray(qr.tex_coord).reshape(Hh, Wh, 2)
    cd = lambda a, b: (b - a) - np.round(b - a)  # noqa: E731
    nbr_r = np.concatenate([qtex[:, 1:], qtex[:, -2:-1]], axis=1)
    nbr_d = np.concatenate([qtex[1:], qtex[-2:-1]], axis=0)
    qlive = (np.asarray(qr.terminated) == integ.ESCAPED).reshape(Hh, Wh)
    probe_demand("q-set", qtex, cd(qtex, nbr_r) * (0.5 / 1.3),
                 cd(qtex, nbr_d) * (0.5 / 1.3), qlive)
    rr = pl.compute_render_data(metric, rstate, rku, params, features,
                                inv_quat=riquat)
    tq = np.asarray(qr.tex_coord)[np.asarray(sel)]
    rtex = np.asarray(rr.tex_coord)
    t0, t1, t2 = rtex[0:k], rtex[k:2 * k], rtex[2 * k:3 * k]
    dxr = np.concatenate([cd(tq, t0), cd(t1, t2), cd(t1, t2)]) / 1.3
    dyr = np.concatenate([cd(t0, t2), cd(tq, t1), cd(t0, t2)]) / 1.3
    rlive = np.asarray(rr.terminated) == integ.ESCAPED
    probe_demand("r-set", rtex, dxr, dyr, rlive)

    # ----- divergence diagnostics ---------------------------------------
    # The whole-batch while loop runs until the batch's slowest ray is done:
    # executed ray-iterations ~ max(steps) * n against the committed steps.
    def divergence(tag, steps):
        steps = np.asarray(steps)
        executed = float(steps.max()) * steps.size
        committed = float(steps.sum())
        print(f"{tag:10s} n {steps.size}  committed {committed/1e6:8.1f} "
              f"Msteps   executed >= {executed/1e6:8.1f}   waste x"
              f"{executed/max(committed, 1):.2f}")

    divergence("quarter", qstate.steps)
    divergence("refine", rstate.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
