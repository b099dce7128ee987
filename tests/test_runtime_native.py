"""Native runtime library: mips, OBJ loading, async PNG writer."""

import numpy as np
import pytest

from geodesic_raytracing import runtime


def test_native_builds():
    lib = runtime.get_lib()
    assert lib is not None, f"native build failed: {runtime._build_error}"


def test_build_mips_matches_numpy():
    rng = np.random.default_rng(0)
    img = rng.random((64, 128, 3)).astype(np.float32)
    atlas, lw, lh, lx = runtime.build_mips(img, max_levels=5)
    assert lw[0] == 128 and lh[0] == 64 and lx[0] == 0
    np.testing.assert_allclose(atlas[:64, :128], img)
    # level 1 = 2x2 box
    expect = img.reshape(32, 2, 64, 2, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(atlas[:32, 128:192], expect, rtol=1e-6)
    assert len(lw) == 5


def test_obj_loader(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vn 0 0 1\n"
        "f 1//1 2//1 3//1 4//1\n"  # quad -> 2 triangles
        "f -4 -3 -2\n"  # negative indices
    )
    pos, idx = runtime.load_obj(str(obj))
    assert pos.shape == (4, 3)
    assert idx.shape == (3, 3)
    np.testing.assert_array_equal(idx[0], [0, 1, 2])
    np.testing.assert_array_equal(idx[1], [0, 2, 3])
    np.testing.assert_array_equal(idx[2], [0, 1, 2])


def test_async_writer_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    out = tmp_path / "frame.png"
    with runtime.AsyncFrameWriter(threads=2) as wr:
        wr.submit(str(out), img)
        # close() drains the queue
    assert out.exists()
    import imageio.v3 as iio

    back = iio.imread(out)
    np.testing.assert_array_equal(back, img)


def test_async_writer_many(tmp_path):
    imgs = [(np.full((16, 16, 3), i, dtype=np.uint8)) for i in range(20)]
    with runtime.AsyncFrameWriter(threads=4) as wr:
        for i, img in enumerate(imgs):
            wr.submit(str(tmp_path / f"f{i:03}.png"), img)
    assert wr.failures == 0
    assert len(list(tmp_path.glob("f*.png"))) == 20
