"""Mocap dataset containers: the base class, Human3.6M and AMASS.

Parity with reference `mocap_dataset.py:12-45`, `h36m_dataset.py:225-275` and
`amass_dataset.py:39-121`, copied from the JAX package's `data/mocap.py`.
Data files are the VideoPose3D-style `.npz` archives (`positions_3d` dict of
subject→action→array).
"""

from __future__ import annotations

import copy
import os
import re

import numpy as np

from .h36m_cameras import build_camera_dicts
from .keypoint_order import AMASS_REORDER, H36MOrderFull
from .skeleton import Skeleton

# 17-point skeleton in the canonical order (MPII-like)
h36m_skeleton = Skeleton(
    parents=[1, 2, 6, 6, 3, 4, -1, 8, 6, 7, 9, 12, 13, 7, 7, 14, 15],
    joints_left=[3, 4, 5, 14, 15, 16],
    joints_right=[0, 1, 2, 11, 12, 13],
)

# AMASS sub-dataset splits; each entry is a (dataset, subject, action) regex triple
# (reference `amass_dataset.py:39-64`)
amass_splits = {
    "train": [(d, ".*", ".*") for d in [
        "CMU", "DanceDB", "MPILimits", "TotalCapture", "EyesJapanDataset",
        "HUMAN4D", "KIT", "BMLhandball", "BMLmovi", "BMLrub", "EKUT",
        "TCDhandMocap", "ACCAD", "Transitionsmocap"]],
    "val": [(d, ".*", ".*") for d in ["MPIHDM05", "SFU", "MPImosh"]],
    "train_debug": [("CMU", ".*", ".*")],
    "val_debug": [("CMU", ".*", ".*")],
}


class MocapDataset:
    """Base container: `_data[subject][action] = {positions, cameras?, frame_rate}`."""

    def __init__(self, fps, skeleton):
        self._skeleton = skeleton
        self._fps = fps
        self._data = None
        self._cameras = None

    def __getitem__(self, key):
        return self._data[key]

    def subjects(self):
        return self._data.keys()

    def fps(self):
        return self._fps

    def skeleton(self):
        return self._skeleton

    def cameras(self):
        return self._cameras

    def remove_joints(self, joints_to_remove):
        kept = self._skeleton.remove_joints(joints_to_remove)
        for subject in self._data:
            for action in self._data[subject]:
                s = self._data[subject][action]
                if "positions" in s:
                    s["positions"] = s["positions"][:, kept]

    def supports_semi_supervised(self):
        return False


class Human36mDataset(MocapDataset):
    """Loads `data_3d_h36m.npz`, reduces 32→17 joints, attaches calibrated cameras."""

    def __init__(self, path):
        super().__init__(fps=50, skeleton=h36m_skeleton)
        self._cameras = build_camera_dicts()

        data = np.load(path, allow_pickle=True)["positions_3d"].item()
        to17 = H36MOrderFull.to_17p_order()
        self._data = {}
        for subject, actions in data.items():
            self._data[subject] = {}
            for action_name, positions in actions.items():
                self._data[subject][action_name] = {
                    # world-space meters, x=right y=forward z=up
                    "positions": positions[:, to17].copy(),
                    "cameras": self._cameras[subject],
                    "frame_rate": 50,
                }

    def supports_semi_supervised(self):
        return True


class AMASSDataset(MocapDataset):
    """Loads per-sub-dataset AMASS `.npz` files of 17-joint world-space 3D poses.

    Borrows the Human3.6M camera rigs (for random-camera 2D projection during
    pre-training). `_data` is keyed dataset→subject→action.
    """

    def __init__(self, path, h36m_path, split, downsample=1, h36m_cameras=None):
        super().__init__(fps=50, skeleton=h36m_skeleton)
        if h36m_cameras is None:
            self._cameras = build_camera_dicts()
        else:
            self._cameras = copy.deepcopy(h36m_cameras)
        self.split = split
        dataset_filter = amass_splits[split] if isinstance(split, str) else split

        files = [d for d in sorted(os.listdir(path)) if os.path.splitext(d)[1] == ".npz"]
        self._data = {}
        for dataset_file in files:
            dataset = os.path.splitext(dataset_file)[0]
            ds_matches = [p for p in dataset_filter if re.fullmatch(p[0], dataset)]
            if not ds_matches:
                continue
            data = np.load(os.path.join(path, dataset_file), allow_pickle=True)["positions_3d"].item()
            self._data[dataset] = {}
            for subject, actions in data.items():
                subj_matches = [p for p in ds_matches if re.fullmatch(p[1], subject)]
                if not subj_matches:
                    continue
                self._data[dataset][subject] = {}
                for action_name, seq in actions.items():
                    if not [p for p in subj_matches if re.fullmatch(p[2], action_name)]:
                        continue
                    assert seq["frame_rate"] == 50.0
                    positions = seq["positions_3d"].astype(np.float32)[:, AMASS_REORDER]
                    if downsample > 1:
                        positions = positions[::downsample]
                    self._data[dataset][subject][action_name] = {
                        "dataset": dataset,
                        "subject": subject,
                        "action": action_name,
                        "positions": positions.copy(),
                        "frame_rate": int(seq["frame_rate"]),
                    }
