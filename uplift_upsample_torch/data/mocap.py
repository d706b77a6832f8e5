"""Mocap dataset containers: the base class and Human3.6M.

Parity with reference `mocap_dataset.py:12-45` and `h36m_dataset.py:225-275`,
copied from the JAX package's `data/mocap.py:40-99`. Data files are the
VideoPose3D-style `.npz` archives (`positions_3d` dict of
subject→action→array). The AMASS container comes with the AMASS slice.
"""

from __future__ import annotations

import numpy as np

from .h36m_cameras import build_camera_dicts
from .keypoint_order import H36MOrderFull
from .skeleton import Skeleton

# 17-point skeleton in the canonical order (MPII-like)
h36m_skeleton = Skeleton(
    parents=[1, 2, 6, 6, 3, 4, -1, 8, 6, 7, 9, 12, 13, 7, 7, 14, 15],
    joints_left=[3, 4, 5, 14, 15, 16],
    joints_right=[0, 1, 2, 11, 12, 13],
)


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
