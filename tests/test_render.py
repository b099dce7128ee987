"""Render-stage units: equirect mapping, mip sampling, EWA, redshift."""

import jax
import jax.numpy as jnp
import numpy as np

from geodesic_raytracing.render import background as bg
from geodesic_raytracing.render import colour
from geodesic_raytracing.render.pipeline import angle_to_tex


def test_angle_to_tex_ranges():
    th = jnp.linspace(0.01, np.pi - 0.01, 7)
    ph = jnp.linspace(-3 * np.pi, 3 * np.pi, 7)
    a = jnp.stack(jnp.meshgrid(th, ph, indexing="ij"), -1).reshape(-1, 2)
    uv = np.asarray(angle_to_tex(a))
    assert (uv >= 0).all() and (uv <= 1).all()
    # theta over the pole folds phi by pi (cl.cl:5087-5092)
    folded = np.asarray(angle_to_tex(jnp.array([[np.pi + 0.3, 0.0]])))
    direct = np.asarray(angle_to_tex(jnp.array([[np.pi - (np.pi - 0.3),
                                                 np.pi]])))
    np.testing.assert_allclose(folded, direct, atol=1e-5)


def test_mip_level0_matches_image():
    img = np.zeros((64, 128, 3), np.float32)
    img[10, 20] = [1.0, 0.5, 0.25]
    b = bg.build_background(img)
    # sample the texel centre of (20, 10) at level 0
    uv = jnp.array([[(20 + 0.5) / 128, (10 + 0.5) / 64]])
    side = jnp.array([0])
    out = np.asarray(bg.read_mipmap(b, side, uv, jnp.array([0.0])))
    np.testing.assert_allclose(out[0], [1.0, 0.5, 0.25], atol=1e-3)  # rgb10 atlas quantisation


def test_two_sided_background():
    img = np.zeros((32, 64, 3), np.float32)
    img[..., 0] = 1.0  # side 0 red... (build flips: side index selects)
    img2 = np.zeros((32, 64, 3), np.float32)
    img2[..., 2] = 1.0
    b = bg.build_background(img, img2)
    uv = jnp.array([[0.5, 0.5]])
    # side >= 1 samples the PRIMARY background (cl.cl:5450); side 0 = the
    # far-side universe.
    primary = np.asarray(bg.read_mipmap(b, jnp.array([1]), uv,
                                        jnp.array([0.0])))
    far = np.asarray(bg.read_mipmap(b, jnp.array([0]), uv, jnp.array([0.0])))
    np.testing.assert_allclose(primary[0], [1, 0, 0], atol=1e-3)
    np.testing.assert_allclose(far[0], [0, 0, 1], atol=1e-3)


def test_pow2_and_mod_paths_agree():
    """The pow2 shift/AND addressing fast path must sample identically to
    the generic mod path (exercised via a non-pow2 atlas of the same
    content upsampled -- here directly by comparing a pow2 background
    against per-texel numpy wrap-bilinear)."""
    rng = np.random.default_rng(3)
    img = rng.random((32, 64, 3)).astype(np.float32)
    b = bg.build_background(img)
    assert b.pow2

    uv = jnp.asarray(rng.random((37, 2)), dtype=jnp.float32)
    side = jnp.ones((37,), jnp.int32)
    got = np.asarray(bg.read_mipmap(b, side, uv, jnp.zeros(37),
                                    trilinear=False))

    # numpy reference: wrap bilinear on level 0
    h, w = 32, 64
    x = np.asarray(uv[:, 0]) * w - 0.5
    y = np.asarray(uv[:, 1]) * h - 0.5
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    c00 = img[y0 % h, x0 % w]
    c01 = img[y0 % h, (x0 + 1) % w]
    c10 = img[(y0 + 1) % h, x0 % w]
    c11 = img[(y0 + 1) % h, (x0 + 1) % w]
    want = (c00 * (1 - fx) + c01 * fx) * (1 - fy) \
        + (c10 * (1 - fx) + c11 * fx) * fy
    np.testing.assert_allclose(got, want, atol=1e-3)  # rgb10 quantisation


def test_non_pow2_background_falls_back():
    """Non-pow2 images take the mod addressing path and still wrap-sample
    correctly at every level."""
    rng = np.random.default_rng(4)
    img = rng.random((48, 100, 3)).astype(np.float32)
    b = bg.build_background(img)
    assert not b.pow2

    uv = jnp.asarray(rng.random((50, 2)) * 2.0 - 0.5, dtype=jnp.float32)
    uv = jnp.mod(uv, 1.0)
    side = jnp.ones((50,), jnp.int32)
    for lod in (0.0, 1.0, 2.5):
        out = np.asarray(bg.read_mipmap(b, side, uv,
                                        jnp.full(50, lod)))
        assert np.isfinite(out).all()
        assert (out >= 0).all() and (out <= 1).all()
    # level-0 exactness at a texel centre
    got = np.asarray(bg.read_mipmap(
        b, jnp.array([1]), jnp.array([[(7 + 0.5) / 100, (5 + 0.5) / 48]]),
        jnp.array([0.0])))
    np.testing.assert_allclose(got[0], img[5, 7], atol=1e-3)  # rgb10 atlas quantisation


def test_ewa_uniform_field_invariant():
    """EWA over a constant-colour sky must return that colour regardless of
    the anisotropy of the mapping."""
    img = np.full((64, 128, 3), 0.4, np.float32)
    b = bg.build_background(img)
    H, W = 16, 16
    rng = np.random.default_rng(0)
    tex = jnp.asarray(rng.random((H, W, 2)), dtype=jnp.float32)
    side = jnp.ones((H, W), jnp.int32)
    out = np.asarray(bg.sample_anisotropic(b, tex, side, max_probes=8))
    np.testing.assert_allclose(out, 0.4, atol=1e-3)  # rgb10 atlas quantisation


def test_redshift_extremes():
    rgb = jnp.array([[0.5, 0.5, 0.5]])
    # Large blueshift (z -> -1) brightens towards blue; large redshift dims.
    red = np.asarray(colour.apply_redshift(rgb, jnp.array([5.0])))
    blue = np.asarray(colour.apply_redshift(rgb, jnp.array([-0.9])))
    none = np.asarray(colour.apply_redshift(rgb, jnp.array([0.0])))
    np.testing.assert_allclose(none, np.asarray(rgb), atol=1e-3)
    # redshifted: dimmer overall, red-dominant
    assert red.sum() < none.sum()
    assert red[0, 0] >= red[0, 2]
    # blueshifted: blue-dominant
    assert blue[0, 2] >= blue[0, 0]


def test_old_redshift_skips_energy_redistribution():
    """use_old_redshift (cl.cl:5397-5406): the old path must not push the
    clamped blueshift overflow back into red+green; redshift (z > 0) is
    unaffected."""
    rgb = jnp.array([[0.6, 0.6, 0.6]])
    z_blue = jnp.array([-0.9])
    new = np.asarray(colour.redshift_colour(rgb, z_blue))
    old = np.asarray(colour.redshift_colour(rgb, z_blue, old=True))
    # Redistribution adds energy to r/g; the old path leaves them lower.
    assert old[0, 0] < new[0, 0] and old[0, 1] < new[0, 1]
    np.testing.assert_allclose(old[0, 2], new[0, 2], atol=1e-6)
    z_red = jnp.array([2.0])
    np.testing.assert_allclose(
        np.asarray(colour.redshift_colour(rgb, z_red, old=True)),
        np.asarray(colour.redshift_colour(rgb, z_red)), atol=1e-6,
    )


def test_dominant_wavelength_orders_primaries():
    wl_r = float(colour.dominant_wavelength(jnp.array([[0.9, 0.05, 0.05]]))[0])
    wl_g = float(colour.dominant_wavelength(jnp.array([[0.05, 0.9, 0.05]]))[0])
    wl_b = float(colour.dominant_wavelength(jnp.array([[0.05, 0.05, 0.9]]))[0])
    assert wl_r > wl_g > wl_b
    assert 600 < wl_r < 625
    assert 540 < wl_g < 560
    assert 455 < wl_b < 475


def test_srgb_roundtrip():
    x = jnp.linspace(0.0, 1.0, 64)
    y = colour.srgb_to_lin(colour.lin_to_srgb(x))
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-5)


def _checker_tex(H, W, seed=3):
    rng = np.random.default_rng(seed)
    # Mix smooth and wildly anisotropic uv fields.
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    tex = np.stack([xx + 0.02 * rng.random((H, W)),
                    0.5 * yy + 0.3 * rng.random((H, W))], axis=-1)
    return jnp.asarray(np.mod(tex, 1.0), dtype=jnp.float32)


def test_probe_segments_single_segment_matches_legacy():
    """probe_segments=((1/3, P),) must reproduce the default path exactly
    (same coverage, same iteration count)."""
    img = np.random.default_rng(0).random((64, 128, 3)).astype(np.float32)
    b = bg.build_background(img)
    H, W = 48, 64
    tex = _checker_tex(H, W)
    side = jnp.ones((H, W), jnp.int32)
    ref = np.asarray(bg.sample_anisotropic(b, tex, side, max_probes=8))
    got = np.asarray(bg.sample_anisotropic(
        b, tex, side, max_probes=8, probe_segments=((1.0 / 3.0, 8),)))
    np.testing.assert_array_equal(got, ref)


def test_probe_segments_full_coverage_matches_legacy_small_image():
    """When n_pix <= 1024 the legacy path covers every pixel, so a single
    full-coverage segment is identical."""
    img = np.random.default_rng(1).random((64, 128, 3)).astype(np.float32)
    b = bg.build_background(img)
    H, W = 24, 32  # 768 <= 1024
    tex = _checker_tex(H, W, seed=5)
    side = jnp.zeros((H, W), jnp.int32)
    ref = np.asarray(bg.sample_anisotropic(b, tex, side, max_probes=4))
    got = np.asarray(bg.sample_anisotropic(
        b, tex, side, max_probes=4, probe_segments=((1.0, 4),)))
    np.testing.assert_array_equal(got, ref)


def test_probe_segments_uniform_field_invariant():
    """A tiered schedule must preserve the constant-sky invariant."""
    img = np.full((64, 128, 3), 0.4, np.float32)
    b = bg.build_background(img)
    H, W = 40, 52
    rng = np.random.default_rng(0)
    tex = jnp.asarray(rng.random((H, W, 2)), dtype=jnp.float32)
    side = jnp.ones((H, W), jnp.int32)
    out = np.asarray(bg.sample_anisotropic(
        b, tex, side, max_probes=8,
        probe_segments=((1.0 / 24, 8), (1.0 / 12, 4), (5.0 / 24, 2))))
    np.testing.assert_allclose(out, 0.4, atol=1e-3)


def test_probe_segments_budget_overblurs_not_aliases():
    """Truncated pixels re-clamp through the EWA budget rule: output stays
    finite, in range, and close to the untruncated result on smooth data."""
    img = np.random.default_rng(2).random((64, 128, 3)).astype(np.float32)
    b = bg.build_background(img)
    H, W = 64, 64  # 4096 pixels: segments are real prefixes
    tex = _checker_tex(H, W, seed=9)
    side = jnp.ones((H, W), jnp.int32)
    dense = np.asarray(bg.sample_anisotropic(b, tex, side, max_probes=8))
    seg = np.asarray(bg.sample_anisotropic(
        b, tex, side, max_probes=8,
        probe_segments=((1.0 / 24, 8), (1.0 / 12, 4), (5.0 / 24, 2))))
    assert np.isfinite(seg).all()
    assert (seg >= 0).all() and (seg <= 1.0).all()
    # The truncated pixels blur more but must stay within the local value
    # range — compare distribution-level agreement.
    assert abs(seg.mean() - dense.mean()) < 0.02


def test_probe_segments_single_segment_budget_reclamps():
    """A single segment with iters < max_probes must re-clamp the walk
    geometry exactly like the equivalent two-segment split (regression:
    the re-clamp was gated on len(segments) > 1, sampling only the
    negative half of the major axis)."""
    img = np.random.default_rng(4).random((64, 128, 3)).astype(np.float32)
    b = bg.build_background(img)
    H, W = 64, 64
    tex = _checker_tex(H, W, seed=11)
    side = jnp.ones((H, W), jnp.int32)
    one = np.asarray(bg.sample_anisotropic(
        b, tex, side, max_probes=8, probe_segments=((1.0 / 3.0, 4),)))
    two = np.asarray(bg.sample_anisotropic(
        b, tex, side, max_probes=8,
        probe_segments=((1.0 / 6.0, 4), (1.0 / 6.0, 4))))
    np.testing.assert_array_equal(one, two)


# ---------------------------------------------------------------------------
# CIE 1931 horseshoe (chromaticity.hpp:17-572)
# ---------------------------------------------------------------------------

def test_cie_table_matches_reference_constants():
    """Spot-check the embedded table against the reference's constants
    (chromaticity.hpp rows 360, 555, 830)."""
    from geodesic_raytracing.render import cie1931_data as cie

    assert cie.WL_START == 360.0 and cie.WL_END == 830.0
    assert len(cie.XY_1NM) == 471
    np.testing.assert_allclose(cie.XY_1NM[0], (0.175560, 0.005294), atol=1e-6)
    np.testing.assert_allclose(cie.XY_1NM[830 - 360],
                               (0.734690, 0.265310), atol=1e-6)
    # every entry is a valid chromaticity (x + y <= 1, both >= 0)
    xy = np.asarray(cie.XY_1NM)
    assert (xy >= 0).all() and (xy.sum(axis=1) <= 1.0 + 1e-6).all()


def test_srgb_to_wavelength_primaries():
    """The sRGB primaries' dominant wavelengths must land on the anchors the
    reference hard-codes for them (612/549/464 nm, cl.cl:5730-5732)."""
    prim = jnp.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
    wl = np.asarray(colour.srgb_to_wavelength(prim))
    assert abs(wl[0] - 612.0) < 3.0, wl
    assert abs(wl[1] - 549.0) < 3.0, wl
    assert abs(wl[2] - 464.0) < 3.0, wl
    # Locus round-trip at low excitation purity (dominant wavelength is
    # purity-invariant; full-purity locus points are outside sRGB gamut, so
    # mix 20% locus with equal-energy white to stay in-gamut).
    for target in (460.0, 520.0, 600.0):
        xy = 1 / 3 + 0.2 * (np.asarray(colour.wavelength_to_xy(
            jnp.array(target))) - 1 / 3)
        Y = 0.4
        xyz = jnp.array([[xy[0] / xy[1] * Y, Y,
                          (1 - xy[0] - xy[1]) / xy[1] * Y]])
        lin = jnp.maximum(colour.xyz_to_linear_rgb(xyz), 0.0)
        back = float(colour.dominant_wavelength_cie(lin)[0])
        assert abs(back - target) < 2.0, (target, back)


def test_spectral_redshift_shifts_wavelength():
    """z > 0 must move a green pixel's dominant wavelength redward by the
    1 + z factor; z = 0 must preserve hue; output always finite in [0,1]."""
    green = jnp.array([[0.05, 0.8, 0.05]])
    wl0 = float(colour.dominant_wavelength_cie(green)[0])
    out0 = colour.spectral_redshift(green, jnp.array([0.0]))
    assert abs(float(colour.dominant_wavelength_cie(out0)[0]) - wl0) < 4.0
    out_r = colour.spectral_redshift(green, jnp.array([0.12]))
    wl_r = float(colour.dominant_wavelength_cie(out_r)[0])
    assert abs(wl_r - wl0 * 1.12) < 6.0, (wl0, wl_r)
    for z in (-0.5, 0.0, 0.5, 5.0):
        out = np.asarray(colour.spectral_redshift(green, jnp.array([z])))
        assert np.isfinite(out).all() and (out >= 0).all() and (out <= 1).all()
    # Achromatic pixels pass through (wavelength undefined at the white pt).
    grey = jnp.array([[0.5, 0.5, 0.5]])
    np.testing.assert_allclose(
        np.asarray(colour.spectral_redshift(grey, jnp.array([0.3]))),
        np.asarray(grey), atol=1e-5)
