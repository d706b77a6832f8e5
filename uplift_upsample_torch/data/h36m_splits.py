"""Human3.6M subject/action split tables (reference `h36m_splits.py:13-101`)."""

from __future__ import annotations

import os

all_subjects = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]

subjects_by_split = {
    "trainval": ["S1", "S5", "S6", "S7", "S8"],
    "test": ["S9", "S11"],
    "train": ["S1", "S5", "S6", "S7"],
    "val": ["S8"],
    "S8": ["S8"],
    "S9": ["S9"],
    "S11": ["S11"],
}

actions = [
    "Directions", "Discussion", "Eating", "Greeting", "Phoning",
    "Posing", "Purchases", "Sitting", "SittingDown", "Smoking",
    "TakingPhoto", "Waiting", "Walking", "WalkingDog", "WalkTogether",
]

# Canonical action vocabulary used for action-wise metrics. Note the renames
# TakingPhoto→Photo and WalkingDog→WalkDog, and the different ordering.
renamed_actions = [
    "Directions", "Discussion", "Eating", "Greeting", "Phoning",
    "Photo", "Posing", "Purchases", "Sitting", "SittingDown",
    "Smoking", "Waiting", "WalkDog", "Walking", "WalkTogether",
]

cameras = ["54138969", "55011271", "58860488", "60457274"]


def create_image_paths(base_path, subject, action, cam_id, frame_nums):
    """0-based frame image paths: <base>/frames/<subject>/<action>.<cam>/img_%06d.jpg"""
    prefix = os.path.join(base_path, "frames", subject, f"{action}.{cam_id}")
    return [os.path.join(prefix, f"img_{k:06d}.jpg") for k in frame_nums]
