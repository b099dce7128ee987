"""Production shade-quality gate (VERDICT r3 item 6).

The shipping shade path compounds three economies over the reference's
full-quality behaviour (cl.cl:5453-5687 shades EVERY pixel from
interpolated render data with up-to-anisotropy bilinear probes and
trilinear mips):

  * traced-only shading — RGB-bilinear interpolation on smooth blocks,
  * demand-matched probe tiers (sorted prefix, nearest-texel probes),
  * nearest-mip base taps (``trilinear=False``).

Each was validated in isolation on synthetic harnesses
(scripts/shade_quality.py); this test pins their COMPOUND effect
end-to-end at render scale against the full-quality shade of the very
same traced rays, so a future economy cannot silently stack on top of
the existing ones.  Thresholds carry the measured margins (CPU
renders); they are quality numbers, not fp
tolerances — a legitimate new economy that moves them must re-record
its own margin.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from conftest import tier

from geodesic_raytracing import metrics
from geodesic_raytracing.bench_config import (
    PRODUCTION_PROBE_SEGMENTS,
    PRODUCTION_REFINE_SEGMENTS,
)
from geodesic_raytracing.camera import Camera
from geodesic_raytracing.ops.integrate import TraceOptions
from geodesic_raytracing.render import background as bg
from geodesic_raytracing.render import pipeline as pl

# (metric, RMSE limit 0-255, bad-pixel-fraction limit at |diff| > 16),
# per tier — the softening scales with texture frequency RELATIVE to the
# 2-px interpolated blocks, so the small fast-tier frame (96^2 against
# the same checker) legitimately reads several times higher than
# production resolution.  Limits ~1.4x the measured value so a compounded
# economy trips the gate while resolution-independent noise does not.
CASES = [
    # name, (fast rmse, fast bad), (full rmse, full bad)
    # measured r4: fast 18.3/0.244, 16.8/0.239, 19.2/0.309;
    #              full 10.6/0.093, 11.1/0.097, 14.0/0.157
    ("kerr_boyer", (25.0, 0.33), (15.0, 0.13)),
    ("schwarzschild", (23.0, 0.33), (15.0, 0.14)),
    ("ellis_drainhole", (26.0, 0.42), (19.0, 0.21)),
]


def _renders(name: str):
    import jax

    # Full-suite runs segfault inside this test's first compile with
    # several hundred live executables resident (reproducible at ~95%
    # through the suite, twice, including on a freshly-populated
    # per-host compile cache; every subset without the long prefix
    # passes).  Dropping the in-process caches before compiling avoids
    # the crash; the persistent on-disk cache makes the reload cheap.
    jax.clear_caches()
    size = tier(96, 256)
    m = metrics.get_metric(name)
    cam = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background()
    production = pl.RenderSettings(
        width=size, height=size,
        anisotropy=8,
        probe_segments=PRODUCTION_PROBE_SEGMENTS,
        refine_probe_segments=PRODUCTION_REFINE_SEGMENTS,
        trilinear=False,
        shade_traced_only=True,
        adaptive_sampling=True,
        trace=TraceOptions(max_steps=tier(2048, 8192), method="while"),
    )
    # Reference behaviour on the SAME adaptive trace and the SAME mip/
    # probe economy: full-res shading from interpolated render data
    # (cl.cl:5111-5133 + 5453) instead of traced-only RGB interpolation.
    # Only shade_traced_only flips, so the gate isolates exactly the
    # economy VERDICT r3 weak #5 names; the probe-tier and mip economies
    # are separately gated against ground truth by scripts/
    # shade_quality.py's harness (intentional trades like nearest-mip
    # shift every texel slightly and would otherwise drown this signal).
    full = dataclasses.replace(production, shade_traced_only=False)
    img_p = np.asarray(pl.render_frame(m, cam, m.params(), backgrounds,
                                       production))
    img_f = np.asarray(pl.render_frame(m, cam, m.params(), backgrounds,
                                       full))
    return img_p, img_f


@pytest.mark.parametrize("name,fast_lims,full_lims", CASES)
def test_production_shade_quality(name, fast_lims, full_lims):
    rmse_lim, bad_lim = tier(fast_lims, full_lims)
    img_p, img_f = _renders(name)
    assert np.isfinite(img_p).all() and np.isfinite(img_f).all()
    d = np.abs(img_p.astype(np.float64) - img_f.astype(np.float64)) * 255.0
    rmse = float(np.sqrt((d ** 2).mean()))
    bad = float((d.max(axis=-1) > 16.0).mean())
    assert rmse < rmse_lim and bad < bad_lim, (
        f"{name}: production shade vs full-quality shade RMSE {rmse:.2f} "
        f"(limit {rmse_lim}), bad-frac {bad:.4f} (limit {bad_lim}) — a "
        "shade economy has compounded past the recorded margin"
    )


# TOTAL-economy anchor (VERDICT r4 weak #4): the shipping config against
# the FULL-quality reference-behaviour shade — every pixel shaded from
# assembled render data with trilinear mips, bilinear-filtered probes and
# a 7-probe EWA walk for ALL pixels (graphics_settings.hpp:8-47 quality
# ceiling).  Unlike test_production_shade_quality (which isolates
# traced-only vs full-res on the SAME probe/mip economy), this pins the
# SUM of every intentional trade (traced-only + nearest-mip + point
# probes + demand tiers) to ground truth, so two independently-gated
# economies cannot drift compounded.  256^2 only (the softening is
# resolution-relative; production 1080p sits far below these numbers) —
# SUITE_FULL tier, ~4 min.
# Measured 2026-08-21 (this code): kerr 13.76/0.146, schwarzschild
# 13.12/0.136, ellis 16.18/0.206.  Limits ~1.4x measured.
TOTAL_CASES = [
    ("kerr_boyer", 19.5, 0.21),
    ("schwarzschild", 18.5, 0.19),
    ("ellis_drainhole", 23.0, 0.29),
]


@pytest.mark.skipif(not __import__("conftest").SUITE_FULL,
                    reason="SUITE_FULL-only: 256^2 ground-truth renders")
@pytest.mark.parametrize("name,rmse_lim,bad_lim", TOTAL_CASES)
def test_total_shade_quality_vs_ground_truth(name, rmse_lim, bad_lim):
    import jax

    jax.clear_caches()
    size = 256
    m = metrics.get_metric(name)
    cam = Camera.default().rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background()
    production = pl.RenderSettings(
        width=size, height=size, anisotropy=8,
        probe_segments=PRODUCTION_PROBE_SEGMENTS,
        refine_probe_segments=PRODUCTION_REFINE_SEGMENTS,
        trilinear=False, shade_traced_only=True, adaptive_sampling=True,
        trace=TraceOptions(max_steps=8192, method="while"),
    )
    full = dataclasses.replace(
        production, shade_traced_only=False, trilinear=True,
        probe_bilinear=True, probe_segments=((1.0, 7),),
        refine_probe_segments=((1.0, 7),))
    img_p = np.asarray(pl.render_frame(m, cam, m.params(), backgrounds,
                                       production))
    img_f = np.asarray(pl.render_frame(m, cam, m.params(), backgrounds,
                                       full))
    assert np.isfinite(img_p).all() and np.isfinite(img_f).all()
    d = np.abs(img_p.astype(np.float64) - img_f.astype(np.float64)) * 255.0
    rmse = float(np.sqrt((d ** 2).mean()))
    bad = float((d.max(axis=-1) > 16.0).mean())
    assert rmse < rmse_lim and bad < bad_lim, (
        f"{name}: TOTAL shade economy vs ground truth RMSE {rmse:.2f} "
        f"(limit {rmse_lim}), bad-frac {bad:.4f} (limit {bad_lim}) — the "
        "compounded economies drifted; re-measure and re-justify"
    )
