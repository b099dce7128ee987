"""Checkpoint save/load roundtrip (guards the np.savez suffix trap)."""

import numpy as np

from geodesic_raytracing.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)


def test_roundtrip(tmp_path):
    d = tmp_path / "ck"
    save_checkpoint(d, 7, {"rs": np.float32(1.25), "a": np.float32(-0.5)},
                    opt_state={"m": np.ones(3)}, extra={"note": "x"})
    step, params, opt, extra = load_checkpoint(d)
    assert step == 7
    np.testing.assert_allclose(params["rs"], 1.25)
    np.testing.assert_allclose(params["a"], -0.5)
    np.testing.assert_allclose(opt["m"], np.ones(3))
    assert extra == {"note": "x"}
    # overwrite is atomic and re-readable
    save_checkpoint(d, 8, {"rs": np.float32(2.0)})
    step2, params2, _, _ = load_checkpoint(d)
    assert step2 == 8 and float(params2["rs"]) == 2.0
    # no leftover temp junk
    assert sorted(p.name for p in d.iterdir()) == ["arrays.npz", "meta.json"]


def test_missing_returns_none(tmp_path):
    assert load_checkpoint(tmp_path / "nope") is None
