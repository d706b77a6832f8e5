"""Synthetic dataset builders for tests and smoke runs (numpy only), copied
from the JAX package's `utils/testing.py`: for the same arguments and seed
each writes the same arrays.

Produce tiny `.npz` files in the exact on-disk formats the loaders consume:
  - H36M 3D: {'positions_3d': {subject: {action: (T, 32, 3) float32}}}
  - H36M 2D detections: {'positions_2d': {subject: {action: [(T', 17, 2)] x 4 cams}}}
    in VideoPose3D 17-point order, pixel coordinates
  - AMASS: one npz per sub-dataset:
    {'positions_3d': {subject: {action: {'positions_3d': (T, 17, 3), 'frame_rate': 50.0}}}}
"""

from __future__ import annotations

import os

import numpy as np


def make_synthetic_h36m_npz(path_3d, path_2d,
                            subjects=("S1", "S5", "S6", "S7", "S8", "S9", "S11"),
                            action_frames=(("Walking", 90), ("Walking 1", 61),
                                           ("Photo", 45), ("Sitting", 70)),
                            extra_2d_frames=3, seed=7):
    """Write paired synthetic 3D/2D H36M npz files; returns (path_3d, path_2d)."""
    rng = np.random.default_rng(seed)
    positions_3d, positions_2d = {}, {}
    for subject in subjects:
        positions_3d[subject] = {}
        positions_2d[subject] = {}
        for action, frames in action_frames:
            pose = rng.normal(size=(frames, 32, 3)).astype(np.float32) * 0.2
            pose[..., 2] += 1.0  # keep roughly above ground
            positions_3d[subject][action] = pose
            cams = []
            for _ in range(4):
                kps = rng.uniform(100, 900, size=(frames + extra_2d_frames, 17, 2))
                cams.append(kps.astype(np.float32))
            positions_2d[subject][action] = cams
    np.savez_compressed(path_3d, positions_3d=positions_3d)
    np.savez_compressed(path_2d, positions_2d=positions_2d)
    return path_3d, path_2d


def make_quirks_h36m_npz(path_3d, path_2d, seed=13):
    """H36M npz pair with the quirks real (VideoPose3D-prepared) data has:

    - canonical renamed action keys ("Photo 1", "WalkDog", ... — VideoPose3D's
      prepare_data_h36m.py canonicalizes TakingPhoto→Photo, WalkingDog→WalkDog
      before writing the npz; only on-disk frame DIRECTORIES keep the
      original names, hence the loader's image-path revert fallback),
    - per-subject action sets that differ: S11 lacks "Directions" (the
      corrupted video VideoPose3D discards) — present for every other subject,
    - per-action sequence lengths that differ across subjects,
    - 2D detections longer than the mocap (trailing-frame truncation) for
      some (subject, action) pairs and exactly equal for others.
    """
    rng = np.random.default_rng(seed)
    base_actions = ["Directions", "Walking", "Walking 1", "Photo", "Photo 1",
                    "WalkDog", "SittingDown 2"]
    subjects = ("S1", "S5", "S6", "S7", "S8", "S9", "S11")
    positions_3d, positions_2d = {}, {}
    for si, subject in enumerate(subjects):
        actions = [a for a in base_actions
                   if not (subject == "S11" and a == "Directions")]
        positions_3d[subject] = {}
        positions_2d[subject] = {}
        for ai, action in enumerate(actions):
            frames = 45 + 7 * ((si + ai) % 5)
            pose = rng.normal(size=(frames, 32, 3)).astype(np.float32) * 0.2
            pose[..., 2] += 1.0
            positions_3d[subject][action] = pose
            extra = (si + ai) % 3  # 0 → exactly-equal-length 2D
            cams = [rng.uniform(100, 900, size=(frames + extra, 17, 2)
                                ).astype(np.float32) for _ in range(4)]
            positions_2d[subject][action] = cams
    np.savez_compressed(path_3d, positions_3d=positions_3d)
    np.savez_compressed(path_2d, positions_2d=positions_2d)
    return path_3d, path_2d


def make_synthetic_amass_dir(out_dir, datasets=("CMU", "SFU"), subjects=2, actions=2,
                             frames=80, seed=11):
    """Write synthetic AMASS npz files into `out_dir`; returns the dir."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    for dataset in datasets:
        data = {}
        for s in range(subjects):
            subject = f"subj{s}"
            data[subject] = {}
            for a in range(actions):
                pose = rng.normal(size=(frames, 17, 3)).astype(np.float32) * 0.3
                pose[..., 2] += 1.0
                data[subject][f"act{a}"] = {
                    "positions_3d": pose,
                    "frame_rate": 50.0,
                }
        np.savez_compressed(os.path.join(out_dir, f"{dataset}.npz"), positions_3d=data)
    return out_dir


def make_learnable_h36m_npz(path_3d, path_2d,
                            subjects=("S1", "S5", "S6", "S7", "S8", "S9", "S11"),
                            action_frames=(("Walking", 800), ("Walking 1", 700),
                                           ("Photo", 600), ("Sitting", 700)),
                            extra_2d_frames=2, seed=7):
    """Paired H36M npz files with a LEARNABLE 2D→3D mapping.

    Unlike make_synthetic_h36m_npz (independent random 2D and 3D — only a
    format/pipeline exercise), this builds smooth sinusoid-mixture 3D world
    motion and derives the 2D detections by ACTUALLY PROJECTING the 17-point
    subset through each subject's calibrated Human3.6M camera (world→cam,
    distorted projection, pixel coordinates) — the same camera model the
    loader inverts. Training on this data must therefore reduce val MPJPE
    far below the random-pose baseline, which makes it the fixture for
    convergence smoke runs (e.g. the TRAIN_MATMUL_PRECISION rung
    comparison in the JAX package's tools/rung_convergence.py).
    """
    from ..data.camera_np import (image_coordinates, project_to_2d,
                                  world_to_camera)
    from ..data.h36m_cameras import build_camera_dicts
    from ..data.keypoint_order import H36MOrder17POriginalOrder, H36MOrderFull

    rng = np.random.default_rng(seed)
    cameras = build_camera_dicts()
    to17 = H36MOrderFull.to_17p_order()
    # loading reorders stored-2D rows via to_our_17p_order(); store row
    # orig_j = projection of our-order joint i where reorder[i] = orig_j.
    reorder = np.asarray(H36MOrder17POriginalOrder.to_our_17p_order())

    positions_3d, positions_2d = {}, {}
    for subject in subjects:
        positions_3d[subject] = {}
        positions_2d[subject] = {}
        # Per-subject body: fixed joint offsets around the pelvis (a crude
        # skeleton, constant across actions like a real subject)
        offsets = rng.normal(size=(32, 3)).astype(np.float64) * 0.25
        offsets[:, 2] = np.abs(offsets[:, 2])  # keep joints above the root
        for action, frames in action_frames:
            t = np.arange(frames, dtype=np.float64)[:, None, None]
            # Global trajectory: slow 2D drift within the capture area
            traj = np.stack([
                0.8 * np.sin(2 * np.pi * t[:, 0, 0] / 500.0 + rng.uniform(0, 6)),
                0.8 * np.sin(2 * np.pi * t[:, 0, 0] / 350.0 + rng.uniform(0, 6)),
                0.9 + 0.1 * np.sin(2 * np.pi * t[:, 0, 0] / 200.0),
            ], axis=-1)[:, None, :]  # (T, 1, 3)
            # Articulated motion: 3 sinusoid components per joint, smooth
            pose = np.zeros((frames, 32, 3))
            for _ in range(3):
                amp = rng.normal(size=(1, 32, 3)) * 0.12
                period = rng.uniform(40, 300, size=(1, 32, 1))
                phase = rng.uniform(0, 2 * np.pi, size=(1, 32, 3))
                pose += amp * np.sin(2 * np.pi * t / period + phase)
            pose = (pose + offsets[None] + traj).astype(np.float32)
            positions_3d[subject][action] = pose

            p17w = pose[:, to17].astype(np.float64)  # our 17p order, world
            cams_2d = []
            for cam in cameras[subject]:
                pc = world_to_camera(p17w, R=cam["orientation"],
                                     t=cam["translation"])
                p2n = project_to_2d(pc.astype(np.float32), cam["intrinsic"])
                px = image_coordinates(p2n, w=cam["res_w"], h=cam["res_h"])
                kps = np.empty((frames, 17, 2), np.float32)
                kps[:, reorder] = px.astype(np.float32)
                if extra_2d_frames:
                    kps = np.concatenate(
                        [kps, np.repeat(kps[-1:], extra_2d_frames, axis=0)])
                cams_2d.append(kps)
            positions_2d[subject][action] = cams_2d

    np.savez_compressed(path_3d, positions_3d=positions_3d)
    np.savez_compressed(path_2d, positions_2d=positions_2d)
    return path_3d, path_2d
