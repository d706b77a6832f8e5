"""The port's host-side eval code against the JAX package's: float64 metrics,
the action-wise protocol, row dedup, the H3.6M loaders (quirks included),
cameras, skeleton and splits.

These modules are numpy copies, so the port must give the JAX functions'
results bit for bit on seeded inputs, and meet the JAX tests' own checks
(tests/test_metrics.py, tests/test_misc_utils.py::test_dedup_rows_exact,
tests/test_loading_quirks.py:36-110).
"""

import os

import numpy as np
import pytest

from uplift_upsample_torch.data import h36m_splits
from uplift_upsample_torch.data.loading import (filter_and_subsample_dataset,
                                                load_dataset_and_2d_poses)
from uplift_upsample_torch.utils import dedup, eval_protocol, metrics


def _gt(pose, valid=None):
    v = np.ones(pose.shape[:-1] + (1,)) if valid is None else valid[..., None]
    return np.concatenate([pose, v], axis=-1)


def _pose_pairs(seed, m=64):
    """Seeded (pred, gt) with some invalid joints and mirrored predictions
    (the Procrustes reflection guard)."""
    rng = np.random.default_rng(seed)
    gt3d = rng.normal(size=(m, 17, 3))
    pred = rng.normal(size=(m, 17, 3)) * 0.9 + gt3d * 0.3
    pred[::5] = pred[::5] * np.asarray([-1.0, 1.0, 1.0])
    valid = (rng.uniform(size=(m, 17)) > 0.1).astype(np.float64)
    valid[:, 0] = 1.0
    return pred, _gt(gt3d, valid)


@pytest.mark.parametrize("normalize", [True, False])
def test_metrics_match_jax(normalize):
    from uplift_upsample_tpu.utils import metrics as jm

    pred, gt = _pose_pairs(41)
    pairs = [
        (metrics.mpjpe(pred, gt, root_index=6, normalize=normalize),
         jm.mpjpe(pred, gt, root_index=6, normalize=normalize)),
        (metrics.pmpjpe(pred, gt, normalize=normalize),
         jm.pmpjpe(pred, gt, normalize=normalize)),
    ]
    for alignment in ("root", "mean"):
        pairs.append((metrics.nmpjpe(pred, gt, root_index=6, alignment=alignment,
                                     normalize=normalize),
                      jm.nmpjpe(pred, gt, root_index=6, alignment=alignment,
                                normalize=normalize)))
    for got, ref in pairs:
        np.testing.assert_array_equal(got, ref)
    for i in range(4):
        for got, ref in zip(metrics.compute_similarity_transform(gt[i, :, :3], pred[i]),
                            jm.compute_similarity_transform(gt[i, :, :3], pred[i])):
            np.testing.assert_array_equal(got, ref)


def test_metrics_hand_computed():
    """tests/test_metrics.py's hand-computed cases on the port."""
    gt = np.zeros((1, 3, 3))
    gt[0, 1] = [1, 0, 0]
    gt[0, 2] = [0, 2, 0]
    assert np.isclose(metrics.mpjpe((gt[0] + [5.0, -3.0, 2.0])[None], _gt(gt), 0), 0.0)
    pred2 = gt[0].copy()
    pred2[1, 2] += 0.3
    assert np.isclose(metrics.mpjpe(pred2[None], _gt(gt), root_index=0), 0.1)
    # valid flags
    gt2 = np.zeros((1, 2, 3))
    gt2[0, 1] = [1, 0, 0]
    p = gt2[0].copy()
    p[1, 0] = 2.0
    valid = np.array([[1.0, 0.0]])
    assert np.isclose(metrics.mpjpe(p[None], _gt(gt2, valid), root_index=0), 0.0)
    assert metrics.mpjpe(p[None], _gt(gt2, valid), root_index=0, normalize=False)[0, 1] == -1.0
    # optimal scale
    rng = np.random.default_rng(0)
    g = rng.normal(size=(2, 5, 3))
    g -= g[:, [0]]
    assert np.isclose(metrics.nmpjpe(2.0 * g, _gt(g), root_index=0), 0.0, atol=1e-12)
    # rotation + scale + translation
    g = np.random.default_rng(1).normal(size=(1, 6, 3))
    th = 0.7
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    assert metrics.pmpjpe((1.7 * g[0] @ rot.T + [3.0, -1.0, 0.5])[None], _gt(g)) < 1e-9
    # reflection guard: a proper rotation
    x = np.random.default_rng(2).normal(size=(5, 3))
    y = x.copy()
    y[:, 0] *= -1
    assert np.isclose(np.linalg.det(metrics.compute_similarity_transform(x, y)[2]), 1.0,
                      atol=1e-9)


def test_batched_procrustes_matches_loop():
    """The batched Procrustes reproduces the per-example loop, reflections
    included (tests/test_metrics.py:127-147)."""
    pred, gt = _pose_pairs(43)
    batched = metrics._procrustes_align_batched(pred, gt[..., :3])
    for i in range(len(pred)):
        _, ref, _, _, _ = metrics.compute_similarity_transform(
            X=gt[i, :, :3], Y=pred[i], compute_optimal_scale=True)
        np.testing.assert_allclose(batched[i], ref, rtol=1e-10, atol=1e-12)


def test_action_wise_protocol_matches_jax(capsys):
    """h36_action_wise_eval, frame_wise_eval and compute_and_log_metrics on
    seeded data with 3 of 15 actions: the JAX results and printed lines."""
    from uplift_upsample_tpu.utils import eval_protocol as jep

    pred, gt = _pose_pairs(44, m=90)
    actions = np.repeat([0, 3, 12], 30)
    got = eval_protocol.h36_action_wise_eval(pred, gt, actions, root_index=6)
    ref = jep.h36_action_wise_eval(pred, gt, actions, root_index=6)
    assert got == ref and len(got[2]) == 3
    assert all(np.isfinite(v) for v in got[1].values())
    assert (eval_protocol.frame_wise_eval(pred, gt, 6) == jep.frame_wise_eval(pred, gt, 6))
    capsys.readouterr()
    assert eval_protocol.compute_and_log_metrics(pred, gt, actions, 6, True) == ref
    ours = capsys.readouterr().out
    jep.compute_and_log_metrics(pred, gt, actions, 6, True)
    assert ours == capsys.readouterr().out


def test_dedup_rows_exact():
    """Hash dedup is exact vs np.unique(axis=0), collapses masked (±0.0)
    rows into one on the fast path, and matches the JAX dedup."""
    from uplift_upsample_tpu.utils.dedup import dedup_rows as jax_dedup

    rng = np.random.default_rng(0)
    stream = rng.normal(size=(96, 34)).astype(np.float32)
    flat = stream[(np.arange(64)[:, None] + np.arange(27)) % 96].reshape(-1, 34)
    uniq, inv = dedup.dedup_rows(flat)
    assert (uniq[inv] == flat).all() and len(uniq) == len(np.unique(flat, axis=0))
    flat2 = flat.copy()
    flat2[::3] = 0.0
    u2, i2 = dedup.dedup_rows(flat2)
    assert (u2[i2] == flat2).all() and len(u2) == len(np.unique(flat2, axis=0))
    u3, i3 = dedup.dedup_rows(np.ones((50, 16), np.float32))
    assert len(u3) == 1 and (i3 == 0).all()

    flat4 = stream[(np.arange(2048)[:, None] + np.arange(27)) % 96]
    mask = (np.arange(2048) % 2 == 0).astype(np.float32)
    flat4 = (flat4 * mask[:, None, None]).reshape(-1, 34)
    fallback_calls = []
    real_unique = np.unique

    def spy_unique(*args, **kwargs):
        if kwargs.get("axis") is not None:
            fallback_calls.append(kwargs)
        return real_unique(*args, **kwargs)

    dedup.np.unique = spy_unique
    try:
        u4, i4 = dedup.dedup_rows(flat4)
    finally:
        dedup.np.unique = real_unique
    assert len(np.unique(i4[(flat4 == 0).all(axis=1)])) == 1
    assert (u4[i4] == flat4).all() and len(u4) == 97
    assert not fallback_calls, "exact fallback fired — hash collided on -0.0"
    for rows in (flat, flat2, flat4):
        for got, ref in zip(dedup.dedup_rows(rows), jax_dedup(rows)):
            np.testing.assert_array_equal(got, ref)


# -- loaders, on quirks-shaped data (tests/test_loading_quirks.py) -------------

@pytest.fixture(scope="module")
def quirks_npz(tmp_path_factory):
    from uplift_upsample_tpu.utils.testing import make_quirks_h36m_npz

    d = tmp_path_factory.mktemp("quirks")
    return make_quirks_h36m_npz(str(d / "data_3d_h36m.npz"),
                                str(d / "data_2d_h36m_synth.npz"))


@pytest.fixture(scope="module")
def quirks_flat(quirks_npz):
    return load_dataset_and_2d_poses(*quirks_npz, verbose=False)


def test_subject_specific_action_sets(quirks_flat):
    """S11 lacks "Directions": lists stay aligned, counts follow the
    per-subject action sets, 2D is truncated to the mocap length."""
    dataset, keypoints = quirks_flat
    cams, p3d, p2d, _, subj, act, frates = filter_and_subsample_dataset(
        dataset=dataset, poses_2d=keypoints, subjects=["S9", "S11"], action_filter="*",
        downsample=1, image_base_path=None, verbose=False)
    assert len(p2d) == (7 + 6) * 4
    assert len(p3d) == len(p2d) == len(cams) == len(subj) == len(act) == len(frates)
    assert all(a.shape[0] == b.shape[0] for a, b in zip(p3d, p2d))
    names = [h36m_splits.renamed_actions[i] for i in act]
    assert "Photo" in names and "WalkDog" in names and "Directions" in names
    s11 = [i for i, s in enumerate(subj) if h36m_splits.all_subjects[s] == "S11"]
    assert len(s11) == 6 * 4
    assert all(h36m_splits.renamed_actions[act[i]] != "Directions" for i in s11)


def test_action_filter_exact_name_match(quirks_flat):
    """"Walking" must not pull in "WalkDog" (exact base-name comparison)."""
    dataset, keypoints = quirks_flat
    _, _, p2d, _, _, act, _ = filter_and_subsample_dataset(
        dataset=dataset, poses_2d=keypoints, subjects=["S1"], action_filter=["Walking"],
        downsample=1, verbose=False)
    assert {h36m_splits.renamed_actions[i] for i in act} == {"Walking"}
    assert len(p2d) == 2 * 4


def test_frame_name_revert_to_original_action_dirs(quirks_flat, tmp_path):
    """Image paths fall back to the original on-disk action names when the
    canonical-name directory does not exist; one that does is kept."""
    dataset, keypoints = quirks_flat
    base = str(tmp_path / "h36m")
    for action_dir in ("TakingPhoto", "TakingPhoto 1", "WalkingDog", "Walking"):
        for cam in h36m_splits.cameras:
            d = os.path.join(base, "frames", "S1", f"{action_dir}.{cam}")
            os.makedirs(d, exist_ok=True)
            open(os.path.join(d, "img_000000.jpg"), "wb").close()
    _, _, _, frame_names, _, act, _ = filter_and_subsample_dataset(
        dataset=dataset, poses_2d=keypoints, subjects=["S1"], action_filter="*",
        downsample=1, image_base_path=base, verbose=False)
    by_row = {}
    for i, names in enumerate(frame_names):
        by_row.setdefault(h36m_splits.renamed_actions[act[i]], []).append(names)
    photo = by_row["Photo"][0][0]
    assert "TakingPhoto." in photo or "TakingPhoto 1." in photo, photo
    assert "WalkingDog." in by_row["WalkDog"][0][0]
    walking = by_row["Walking"][0][0]
    assert "/Walking." in walking or "/Walking 1." in walking
    assert photo.endswith("img_000000.jpg") and frame_names[0][1].endswith("img_000001.jpg")


def test_loaders_match_jax(quirks_npz, quirks_flat):
    """The loaders' outputs (3D in camera frames, normalized 2D, camera
    vectors, ids, frame rates, frame names) equal the JAX package's; so do
    the camera dicts, the skeleton's joint removal and the split tables."""
    from uplift_upsample_tpu.data import h36m_splits as jsplits
    from uplift_upsample_tpu.data.h36m_cameras import build_camera_dicts as jcams
    from uplift_upsample_tpu.data.loading import (
        filter_and_subsample_dataset as jfilter, load_dataset_and_2d_poses as jload)
    from uplift_upsample_tpu.data.skeleton import Skeleton as JaxSkeleton

    from uplift_upsample_torch.data.h36m_cameras import build_camera_dicts
    from uplift_upsample_torch.data.mocap import h36m_skeleton
    from uplift_upsample_torch.data.skeleton import Skeleton
    from uplift_upsample_torch.utils.time_format import format_time

    kwargs = dict(subjects=["S1", "S9", "S11"], action_filter="*", downsample=2,
                  image_base_path="/nonexistent", verbose=False)
    ours = filter_and_subsample_dataset(*quirks_flat, **kwargs)
    ref = jfilter(*jload(*quirks_npz, verbose=False), **kwargs)
    for a, b in zip(ours, ref):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for ca, cb in zip(build_camera_dicts()["S9"], jcams()["S9"]):
        assert ca.keys() == cb.keys()
        for key in ca:
            np.testing.assert_array_equal(ca[key], cb[key])
    tree = (h36m_skeleton.parents().tolist(), h36m_skeleton.joints_left(),
            h36m_skeleton.joints_right())
    skel, jskel = Skeleton(*tree), JaxSkeleton(*tree)  # fresh: removal mutates
    assert skel.remove_joints([3, 10]) == jskel.remove_joints([3, 10])
    np.testing.assert_array_equal(skel.parents(), jskel.parents())
    assert skel.joints_left() == jskel.joints_left()
    assert [list(c) for c in skel.children()] == [list(c) for c in jskel.children()]
    assert (h36m_splits.subjects_by_split, h36m_splits.renamed_actions) == (
        jsplits.subjects_by_split, jsplits.renamed_actions)
    assert format_time(3725.4) == "1:02:05"
