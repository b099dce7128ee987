"""The flagship benchmark configuration (1080p Kerr Boyer-Lindquist),
shared by ``bench.py``, ``chip_smoke.py`` and the measurement scripts in
``scripts/`` — production tuning lives HERE only (a stale copy in one
script silently benches the wrong config).

Reference bench analogue: ``RelativityWorkshop.exe -bench kerr_boyer``
(main.cpp:970-986) with the defaults of graphics_settings.hpp:8-47.
"""

from __future__ import annotations

import numpy as np

# Demand-matched EWA probe schedules — see the comment in flagship_config.
# Round 3 (VERDICT r2 item 7): the 3-probe mid tier was measured
# inefficient — widening the 7-probe tier to the top 11% and dropping the
# mid tier entirely is BOTH cheaper and better on the synthetic-warp
# quality harness (rows/px 1.93 -> 1.87, RMSE_hot 0.0363 -> 0.0325-0.0346;
# sweep in scripts/shade_quality.py's harness: ((.09,7)) loses quality,
# ((.13,7))/((.11,9)) cost more with no gain, 2-tier variants cost 2.08).
PRODUCTION_PROBE_SEGMENTS = ((0.11, 7),)
# The refine shade set (traced-only shading) concentrates at terminator
# edges: measured want-probe demand on the flagship frame is 38% >= 8
# probes, 49% >= 2 (scripts/stage_bench.py r-set line), vs 7.2%/35% for the
# image-wide distribution the quarter tiers serve.
PRODUCTION_REFINE_SEGMENTS = ((0.38, 7), (0.11, 3))


def flagship_config(width: int = 1920, height: int = 1080):
    """Returns ``(metric, params, camera, settings, features)`` for the
    production 1080p Kerr bench frame."""
    from . import metrics
    from .camera import Camera
    from .ops.integrate import Features, TraceOptions
    from .render.pipeline import RenderSettings

    metric = metrics.get_metric("kerr_boyer")
    params = metric.params()
    camera = Camera.default().rotate(pitch=-np.pi / 2)
    settings = RenderSettings(
        width=width,
        height=height,
        # Reference default anisotropy (graphics_settings.hpp:34), served by
        # a demand-matched probe schedule: measured Kerr-frame probe demand
        # is 7.2% of pixels >= 8 probes, 18% >= 3, 35% >= 2, so the sorted
        # prefix tiers cost fewer gathers than a flat 4-probe budget while
        # resolving the full anisotropy where it matters.  Counts are ODD
        # (the reference's probe walk — cl.cl:5646-5657, mirrored here —
        # starts even counts at -ip-1, sampling only the negative half of
        # the major axis, so an even tier wastes its gathers), and the
        # marginal 2-probe tier is dropped: scripts/shade_quality.py
        # measures 2-point probing WORSE than the isotropic major-axis
        # fallback (RMSE_hot 0.0437 -> 0.0363 while 2.46 -> 1.93 gather
        # rows/px vs the old (.072,8)(.11,4)(.17,2) schedule).
        anisotropy=8,
        probe_segments=PRODUCTION_PROBE_SEGMENTS,
        refine_probe_segments=PRODUCTION_REFINE_SEGMENTS,
        trilinear=False,
        adaptive_sampling=True,  # reference default (main.cpp:1152)
        # The XLA while driver up to the reference's 16,384-step ray limit
        # (cl.cl:4016).
        trace=TraceOptions(max_steps=16384, method="while"),
    )
    return metric, params, camera, settings, Features.for_metric(metric)

