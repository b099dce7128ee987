"""Golden-image regression: full CPU renders must stay close to the checked-in
references (catch visual regressions across refactors)."""

import numpy as np
import pytest

import imageio.v3 as iio

from geodesic_raytracing import metrics
from geodesic_raytracing.camera import Camera
from geodesic_raytracing.ops.integrate import TraceOptions
from geodesic_raytracing.render import background as bg
from geodesic_raytracing.render import colour
from geodesic_raytracing.render.pipeline import RenderSettings, render_frame

CONFIGS = {
    "schwarzschild": dict(max_steps=8192),
    "kerr_boyer": dict(max_steps=8192),
    "wormhole (morris-thorne)": dict(max_steps=4096),
    "alcubierre": dict(max_steps=4096),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden(name):
    m = metrics.get_metric(name)
    cam = Camera.default().rotate(pitch=-np.pi / 2)
    b = bg.checker_background(256, 512)
    s = RenderSettings(width=96, height=96, anisotropy=4,
                       trace=TraceOptions(**CONFIGS[name]))
    img = render_frame(m, cam, m.params(), b, s)
    arr = (np.clip(np.asarray(colour.lin_to_srgb(img)), 0, 1) * 255).astype(
        np.uint8
    )
    fn = "tests/golden/%s.png" % (
        name.replace(" ", "_").replace("(", "").replace(")", "")
    )
    golden = iio.imread(fn).astype(int)
    d = np.abs(golden - arr.astype(int))
    # Tolerances allow fp reassociation across compiler versions but catch
    # real regressions (shadow shape, lensing, NaN speckle).
    assert d.mean() < 2.0, d.mean()
    assert (d > 32).mean() < 0.01, (d > 32).mean()
    assert np.isfinite(np.asarray(img)).all()
