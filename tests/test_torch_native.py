"""The port's C++ window gather (`data/native.py`, `csrc/gather_windows.cc`)
against the JAX package's native gather and the numpy version, and the
port's batchers, which run it, against the JAX package's. On the CPU: the
gather is host code, built here with g++ as on the card's machine.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from uplift_upsample_tpu.data import fast_batcher as jfb
from uplift_upsample_tpu.data import generator as jgen
from uplift_upsample_tpu.data import native as jnative
from uplift_upsample_tpu.data.mocap import AMASSDataset as JaxAMASSDataset
from uplift_upsample_torch.data import fast_batcher, generator, native
from uplift_upsample_torch.data.keypoint_order import H36MOrder17P
from uplift_upsample_torch.data.loading import (filter_and_subsample_dataset,
                                                load_dataset_and_2d_poses)
from uplift_upsample_torch.data.mocap import AMASSDataset

SYNTH_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "synth")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, b=48, n=27, k=17, c=2, t=900):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(t, k, c)).astype(np.float32)
    idx = rng.integers(0, t, size=(b, n))
    zero = rng.random((b, n)) < 0.25
    flip = (rng.random(b) < 0.5).astype(np.uint8)
    perm = np.asarray(H36MOrder17P.flip_lr_indices(), np.int32)
    return src, idx, zero, flip, perm


MIB = 2 ** 20


@pytest.mark.parametrize("nbytes,torch_threads,expected", [
    (0, 8, 1), (104_448, 8, 1),             # the eval's central 3D rows
    (4_943_872, 8, 4), (7_415_808, 8, 4),   # the train batch, 2D and 3D
    (24_440_832, 8, 8), (24_440_832, 3, 3),  # the eval's 2D windows
    (100 * MIB, 1, 1), (MIB, 8, 2)])
def test_default_threads(monkeypatch, nbytes, torch_threads, expected):
    """1.65 sqrt(MiB) rounded, within [1, torch's thread count]."""
    monkeypatch.setattr(native.torch, "get_num_threads", lambda: torch_threads)
    assert native.default_threads(nbytes) == expected


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("zero_fill,flip", [(False, False), (True, False), (False, True),
                                            (True, True)])
@pytest.mark.parametrize("threads", [1, 4])
def test_gather_matches_jax_native_and_plain(c, zero_fill, flip, threads):
    """Byte-equal to the JAX package's native gather; equal in value to the
    numpy version, whose only other bits are -0.0 for +0.0 in channel 0 of
    the zero-filled rows of flipped windows."""
    assert jnative.native_available()  # the JAX binding's committed library
    src, idx, zero, do_flip, perm = _inputs(c, c=c)
    args = (src, idx, zero if zero_fill else None, do_flip if flip else None,
            perm if flip else None)
    got = native.gather_windows(*args, n_threads=threads)
    ref = jnative.gather_windows(*args, n_threads=threads)
    assert got.dtype == np.float32 and got.shape == (48, 27, 17, c)
    assert got.tobytes() == ref.tobytes()
    plain = native.gather_windows_plain(*args)
    np.testing.assert_array_equal(got, plain)
    sign = np.signbit(got) != np.signbit(plain)
    expect = np.zeros_like(sign)
    if zero_fill and flip:
        expect[..., 0] = (zero & do_flip[:, None].astype(bool))[..., None]
        assert expect.any()
    np.testing.assert_array_equal(sign, expect)


def test_gather_rejects_bad_input():
    src, idx, zero, flip, perm = _inputs(0)
    with pytest.raises(IndexError):
        native.gather_windows(src, idx + len(src))
    with pytest.raises(IndexError):
        native.gather_windows(src, idx - len(src))
    with pytest.raises(ValueError, match="zero_mask"):
        native.gather_windows(src, idx, zero[:, 1:])
    with pytest.raises(ValueError, match="flip_perm"):
        native.gather_windows(src, idx, None, flip, perm[:5])


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source g++ rejects raises with g++'s message: no numpy fallback."""
    bad = tmp_path / "gather_windows.cc"
    bad.write_text("extern \"C\" void gather_windows_f32( { }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.build(tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_two_processes_build_at_once(tmp_path):
    """Two processes building into one fresh directory at once both succeed
    and leave one library and no temporary file."""
    code = ("import sys; from pathlib import Path; "
            "from uplift_upsample_torch.data import native; "
            "print(native.build(Path(sys.argv[1])))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    built = {o.strip() for o, _ in outs}
    assert len(built) == 1 and os.path.exists(built.pop())
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".so"]


# the JAX package's batcher cases (tests/test_fast_batcher.py) plus one with
# zero padding and in-batch flips together
H36M_CASES = {
    "train_inbatch": dict(seq_len=9, subsample=2, stride=5, padding_type="copy",
                          flip_augment=True, in_batch_augment=True,
                          mask_stride=[5, 10, 20], stride_mask_align_global=False,
                          rand_shift_stride_mask=True, shuffle=True, seed=3),
    "eval_global": dict(seq_len=9, subsample=1, stride=5, padding_type="copy",
                        flip_augment=False, in_batch_augment=False,
                        mask_stride=5, stride_mask_align_global=True,
                        rand_shift_stride_mask=False, shuffle=False, seed=0),
    "zeros_flip": dict(seq_len=11, subsample=1, stride=2, padding_type="zeros",
                       flip_augment=True, in_batch_augment=True,
                       mask_stride=[4, 8], stride_mask_align_global=False,
                       rand_shift_stride_mask=True, shuffle=True, seed=1),
}


def _assert_batches_bytes(ours, ref, n_batches):
    for count in range(n_batches):
        a, b = next(ours), next(ref)
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (count, i)
            assert x.tobytes() == y.tobytes(), f"batch {count} column {i}"


@pytest.mark.parametrize("central", [False, True])
@pytest.mark.parametrize("name", list(H36M_CASES))
def test_h36m_batcher_bytes_match_jax(name, central):
    dataset, keypoints = load_dataset_and_2d_poses(
        os.path.join(SYNTH_DIR, "data_3d_h36m.npz"),
        os.path.join(SYNTH_DIR, "data_2d_h36m_synth.npz"), verbose=False)
    cams, p3d, p2d, _, subj, act, frates = filter_and_subsample_dataset(
        dataset=dataset, poses_2d=keypoints, subjects=["S1", "S5"], action_filter="*",
        downsample=1, image_base_path=None, verbose=False)

    def batches(gen_mod, fb_mod):
        gen = gen_mod.H36mSequenceGenerator(
            p3d, p2d, camera_params=cams, subjects=subj, actions=act, frame_rates=frates,
            split="t", flip_lr_indices=H36MOrder17P.flip_lr_indices(), verbose=False,
            **H36M_CASES[name])
        return fb_mod.FastH36mBatcher(gen, batch_size=32, central_3d_only=central).batches()

    _assert_batches_bytes(batches(generator, fast_batcher), batches(jgen, jfb), 12)


@pytest.mark.parametrize("in_batch", [False, True])
def test_amass_batcher_bytes_match_jax(in_batch):
    case = dict(seq_len=9, subsample=2, stride=5, padding_type="copy", flip_augment=True,
                in_batch_augment=in_batch, mask_stride=[5, 10, 20],
                stride_mask_align_global=False, rand_shift_stride_mask=True, shuffle=True,
                seed=0)

    def batches(gen_mod, fb_mod, dataset_cls):
        amass = dataset_cls(path=os.path.join(SYNTH_DIR, "amass"), h36m_path=None,
                            split="train_debug")
        gen = gen_mod.AMASSSequenceGenerator(
            amass_dataset=amass, flip_lr_indices=H36MOrder17P.flip_lr_indices(),
            verbose=False, **case)
        return fb_mod.FastAMASSBatcher(gen, batch_size=32).batches()

    _assert_batches_bytes(batches(generator, fast_batcher, AMASSDataset),
                          batches(jgen, jfb, JaxAMASSDataset), 12)
