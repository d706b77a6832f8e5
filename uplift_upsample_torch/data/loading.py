"""Dataset loading and flattening.

Parity with reference `uplifiting_dataset.py:25-210`, copied from the JAX
package's `data/loading.py` (quirks included):
  - `load_dataset_and_2d_poses`: 3D npz + per-camera world→camera transform,
    2D detections npz truncated to mocap length, reordered to the canonical
    17-point order and normalized to [-1, 1].
  - `filter_and_subsample_dataset`: flattens (subject, action, camera) into
    parallel per-sequence lists (camera 11-vectors, 3D, 2D, frame names,
    subject ids, action ids, frame rates).
"""

from __future__ import annotations

import os

import numpy as np

from . import h36m_splits
from .camera_np import normalize_screen_coordinates, world_to_camera
from .keypoint_order import H36MOrder17POriginalOrder
from .mocap import Human36mDataset, MocapDataset

# Canonical action renames applied when resolving frame-image paths
TRANSLATED_ACTION_NAMES = {"Photo": "TakingPhoto", "WalkDog": "WalkingDog"}


def load_dataset_and_2d_poses(dataset_path, poses_2d_path, dataset_name="h36m", verbose=True):
    """Returns (MocapDataset with per-camera `positions_3d`, normalized 2D dict)."""
    if verbose:
        print(f"Loading 3D dataset from {dataset_path}")
    if dataset_name != "h36m":
        raise KeyError("Invalid dataset")
    dataset = Human36mDataset(dataset_path)

    if verbose:
        print("Converting 3D poses from world to camera frame")
    for subject in list(dataset.subjects()):
        for action in dataset[subject]:
            anim = dataset[subject][action]
            if "positions" in anim:
                anim["positions_3d"] = [
                    world_to_camera(anim["positions"], R=cam["orientation"], t=cam["translation"])
                    for cam in anim["cameras"]
                ]

    if verbose:
        print(f"Loading 2D poses from {poses_2d_path}")
    keypoints = np.load(poses_2d_path, allow_pickle=True)["positions_2d"].item()

    for subject in dataset.subjects():
        assert subject in keypoints, f"Subject {subject} missing from 2D detections"
        for action in dataset[subject]:
            assert action in keypoints[subject], \
                f"Action {action} of subject {subject} missing from 2D detections"
            if "positions_3d" not in dataset[subject][action]:
                continue
            for cam_idx in range(len(keypoints[subject][action])):
                # Some videos contain extra trailing frames; truncate 2D to mocap length
                mocap_length = dataset[subject][action]["positions_3d"][cam_idx].shape[0]
                assert keypoints[subject][action][cam_idx].shape[0] >= mocap_length
                if keypoints[subject][action][cam_idx].shape[0] > mocap_length:
                    keypoints[subject][action][cam_idx] = \
                        keypoints[subject][action][cam_idx][:mocap_length]
            assert len(keypoints[subject][action]) == len(dataset[subject][action]["positions_3d"])

    if verbose:
        print("Normalizing 2D poses to [-1, 1] and converting to 17-point order")
    reorder = H36MOrder17POriginalOrder.to_our_17p_order()
    for subject in keypoints:
        for action in keypoints[subject]:
            for cam_idx, kps in enumerate(keypoints[subject][action]):
                cam = dataset.cameras()[subject][cam_idx]
                kps = kps[:, reorder].copy()
                kps[..., :2] = normalize_screen_coordinates(
                    kps[..., :2], w=cam["res_w"], h=cam["res_h"])
                keypoints[subject][action][cam_idx] = kps

    return dataset, keypoints


def filter_and_subsample_dataset(dataset: MocapDataset, poses_2d, subjects, action_filter,
                                 downsample=1, image_base_path=None, verbose=True):
    """Flatten to parallel per-(subject, action, camera) sequence lists.

    Returns (camera_params, poses_3d, poses_2d, frame_names, subject_ids,
    action_ids, frame_rates); list entries are None when absent.
    """
    if verbose:
        print(f"Filtering subjects: {subjects}")
    action_filter = None if action_filter == "*" else action_filter
    if action_filter is not None and verbose:
        print(f"Filtering actions: {action_filter}")

    out_poses_3d, out_poses_2d = [], []
    out_camera_params, out_frame_names = [], []
    out_subjects, out_actions, out_frame_rates = [], [], []

    subject_dict = {name: i for i, name in enumerate(h36m_splits.all_subjects)}
    action_dict = {name: i for i, name in enumerate(h36m_splits.renamed_actions)}

    for subject in subjects:
        for action in poses_2d[subject].keys():
            action_name = action.split(" ")[0]
            if action_filter is not None and action_name not in action_filter:
                continue

            poses_2d_sequences = poses_2d[subject][action]
            for seq in poses_2d_sequences:
                out_poses_2d.append(seq.copy())
                out_subjects.append(subject_dict[subject])
                out_actions.append(action_dict[action_name])

            if subject in dataset.cameras():
                cams = dataset.cameras()[subject]
                assert len(cams) == len(poses_2d_sequences), "Camera count mismatch"
                for cam in cams:
                    if "intrinsic" in cam:
                        out_camera_params.append(cam["intrinsic"].copy())

            if "positions_3d" in dataset[subject][action]:
                frame_rate = dataset[subject][action].get("frame_rate", 50)
                for seq in dataset[subject][action]["positions_3d"]:
                    out_poses_3d.append(seq.copy())
                    out_frame_rates.append(frame_rate)

            if image_base_path is not None:
                for i in range(len(poses_2d_sequences)):
                    num_frames = poses_2d_sequences[i].shape[0]
                    cam_id = dataset.cameras()[subject][i]["id"]
                    frame_names = h36m_splits.create_image_paths(
                        image_base_path, subject, action, cam_id, range(num_frames))
                    # Revert the canonical renaming when the on-disk name differs
                    for new_name, original in TRANSLATED_ACTION_NAMES.items():
                        if new_name in action and not os.path.exists(frame_names[0]):
                            frame_names = h36m_splits.create_image_paths(
                                image_base_path, subject, action.replace(new_name, original),
                                cam_id, range(num_frames))
                    out_frame_names.append(frame_names)

    out_camera_params = out_camera_params or None
    out_poses_3d = out_poses_3d or None
    out_frame_names = out_frame_names or None
    out_frame_rates = out_frame_rates or None

    if downsample > 1:
        for i in range(len(out_poses_2d)):
            out_poses_2d[i] = out_poses_2d[i][::downsample]
            if out_poses_3d is not None:
                out_poses_3d[i] = out_poses_3d[i][::downsample]
            if out_frame_names is not None:
                out_frame_names[i] = out_frame_names[i][::downsample]

    return (out_camera_params, out_poses_3d, out_poses_2d, out_frame_names,
            out_subjects, out_actions, out_frame_rates)
