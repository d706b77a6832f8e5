"""The port's synthetic dataset builders (`utils/testing.py`, numpy only)
write the arrays of the JAX package's for the same arguments and seed."""

import numpy as np
import pytest

from uplift_upsample_tpu.utils import testing as jax_testing
from uplift_upsample_torch.utils import testing


def _tree(path):
    with np.load(path, allow_pickle=True) as data:
        return {k: data[k].item() for k in data.files}


def _assert_same(a, b, where="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


PAIRS = {
    "synthetic_h36m": lambda mod, d: mod.make_synthetic_h36m_npz(
        str(d / "3d.npz"), str(d / "2d.npz"), seed=5),
    "quirks_h36m": lambda mod, d: mod.make_quirks_h36m_npz(
        str(d / "3d.npz"), str(d / "2d.npz")),
    "learnable_h36m": lambda mod, d: mod.make_learnable_h36m_npz(
        str(d / "3d.npz"), str(d / "2d.npz"), subjects=("S1", "S9", "S11"),
        action_frames=(("Walking", 300), ("Photo", 240)), seed=3),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_h36m_builders_match_jax(name, tmp_path):
    (tmp_path / "ours").mkdir()
    (tmp_path / "ref").mkdir()
    ours = PAIRS[name](testing, tmp_path / "ours")
    ref = PAIRS[name](jax_testing, tmp_path / "ref")
    for a, b in zip(ours, ref):
        _assert_same(_tree(a), _tree(b))


def test_amass_builder_matches_jax(tmp_path):
    ours = testing.make_synthetic_amass_dir(str(tmp_path / "ours"), seed=4)
    ref = jax_testing.make_synthetic_amass_dir(str(tmp_path / "ref"), seed=4)
    for name in ("CMU.npz", "SFU.npz"):
        _assert_same(_tree(f"{ours}/{name}"), _tree(f"{ref}/{name}"))
