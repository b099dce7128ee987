"""Cross-coordinate consistency: the same physical spacetime rendered in
different charts must produce the same image (SURVEY §4 validation anchors —
a check the reference itself has no automation for).

Schwarzschild (polar) vs ingoing Eddington-Finkelstein, and Kerr in
Boyer-Lindquist vs Kerr-Schild cartesian."""

import dataclasses

import numpy as np
import pytest

from geodesic_raytracing import metrics
from geodesic_raytracing.camera import Camera
from geodesic_raytracing.ops import integrate
from geodesic_raytracing.ops.integrate import Features, TraceOptions
from geodesic_raytracing.render import pipeline as pl


def rdata_for(name, size=48):
    m = metrics.get_metric(name)
    cam = Camera.default().rotate(pitch=-np.pi / 2)
    settings = pl.RenderSettings(width=size, height=size,
                                 trace=TraceOptions(max_steps=8192))
    feats = Features.for_metric(m)
    st, ku, iq = pl.init_camera_rays(m, cam, m.params(), settings, feats)
    topts = dataclasses.replace(settings.trace,
                                planar=pl._planar_enabled(m, settings))
    fin = integrate.trace_rays(m, st, m.params(), features=feats, opts=topts)
    return pl.compute_render_data(m, fin, ku, m.params(), feats, inv_quat=iq)


def angular_difference(a1, a2):
    def vec(a):
        th, ph = a[:, 0], a[:, 1]
        return np.stack(
            [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)],
            axis=-1,
        )

    d = np.clip((vec(a1) * vec(a2)).sum(-1), -1, 1)
    return np.degrees(np.arccos(d))


@pytest.mark.parametrize(
    "pair,med_deg,p90_deg",
    [
        # Same chart family: sub-half-degree agreement.
        (("schwarzschild", "schwarzschild_ingoing_ef"), 0.5, 5.0),
        # BL vs Kerr-Schild cross cartesian/polar charts: Boyer-Lindquist is
        # stiff near the ergosphere, so the fp32 tolerance band is wider
        # (SURVEY hard-part (c)).
        (("kerr_boyer", "kerr_schild"), 2.0, 10.0),
    ],
)
def test_charts_agree(pair, med_deg, p90_deg):
    ra = rdata_for(pair[0])
    rb = rdata_for(pair[1])
    ta = np.asarray(ra.terminated)
    tb = np.asarray(rb.terminated)

    # Shadow/escape classification agrees almost everywhere.
    escape_a = ta == 1
    escape_b = tb == 1
    assert (escape_a != escape_b).mean() < 0.02, pair

    both = escape_a & escape_b
    ang = angular_difference(np.asarray(ra.angles)[both],
                             np.asarray(rb.angles)[both])
    assert np.median(ang) < med_deg, (pair, np.median(ang))
    assert np.percentile(ang, 90) < p90_deg, (pair, np.percentile(ang, 90))
