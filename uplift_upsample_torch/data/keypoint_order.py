"""Human3.6M joint-order vocabularies.

Four orders are used across the pipeline (reference `keypoint_order.py:13-350`):
the raw 32-point capture order, the 25-point de-duplicated order, the canonical
17-point order used by the model (root = pelvis = 6), and VideoPose3D's
17-point order used by the public 2D-detection files.

Each vocabulary is expressed as a named-index namespace plus derived index
lists (selection into other orders, left/right flip permutation).
"""

from __future__ import annotations


class H36MOrderFull:
    """Raw 32-point Human3.6M order (with duplicated joints)."""

    pelvis, r_hip, r_knee, r_ankle, r_foot, r_toes = 0, 1, 2, 3, 4, 5
    l_hip, l_knee, l_ankle, l_foot, l_toes = 6, 7, 8, 9, 10
    same_as_pelvis, torso, neck, head, head_top, same_as_neck = 11, 12, 13, 14, 15, 16
    l_shoulder, l_elbow, l_wrist, same_as_l_wrist = 17, 18, 19, 20
    l_thumb, l_fingers, same_as_l_fingers, same_as_neck_2 = 21, 22, 23, 24
    r_shoulder, r_elbow, r_wrist, same_as_r_wrist = 25, 26, 27, 28
    r_thumb, r_fingers, same_as_r_fingers = 29, 30, 31

    num_points = 32

    @classmethod
    def to_17p_order(cls):
        """Select the canonical 17 points (in our MPII-like order) from 32."""
        return [cls.r_ankle, cls.r_knee, cls.r_hip,
                cls.l_hip, cls.l_knee, cls.l_ankle,
                cls.pelvis,
                cls.neck, cls.torso,
                cls.head, cls.head_top,
                cls.r_wrist, cls.r_elbow, cls.r_shoulder,
                cls.l_shoulder, cls.l_elbow, cls.l_wrist]


class H36MOrder:
    """25-point Human3.6M order (duplicates removed)."""

    pelvis, r_hip, r_knee, r_ankle, r_foot, r_toes = 0, 1, 2, 3, 4, 5
    l_hip, l_knee, l_ankle, l_foot, l_toes = 6, 7, 8, 9, 10
    torso, neck, head, head_top = 11, 12, 13, 14
    l_shoulder, l_elbow, l_wrist, l_thumb, l_fingers = 15, 16, 17, 18, 19
    r_shoulder, r_elbow, r_wrist, r_thumb, r_fingers = 20, 21, 22, 23, 24

    num_points = 25

    @classmethod
    def flip_lr_indices(cls):
        return [cls.pelvis,
                cls.l_hip, cls.l_knee, cls.l_ankle, cls.l_foot, cls.l_toes,
                cls.r_hip, cls.r_knee, cls.r_ankle, cls.r_foot, cls.r_toes,
                cls.torso, cls.neck, cls.head, cls.head_top,
                cls.r_shoulder, cls.r_elbow, cls.r_wrist, cls.r_thumb, cls.r_fingers,
                cls.l_shoulder, cls.l_elbow, cls.l_wrist, cls.l_thumb, cls.l_fingers]

    @classmethod
    def to_17p_order(cls):
        return [cls.r_ankle, cls.r_knee, cls.r_hip,
                cls.l_hip, cls.l_knee, cls.l_ankle,
                cls.pelvis,
                cls.neck, cls.torso,
                cls.head, cls.head_top,
                cls.r_wrist, cls.r_elbow, cls.r_shoulder,
                cls.l_shoulder, cls.l_elbow, cls.l_wrist]


class H36MOrder17P:
    """Canonical 17-point order used by the model. Root joint = pelvis = 6."""

    r_ankle, r_knee, r_hip = 0, 1, 2
    l_hip, l_knee, l_ankle = 3, 4, 5
    pelvis = 6
    neck, torso, head, head_top = 7, 8, 9, 10
    r_wrist, r_elbow, r_shoulder = 11, 12, 13
    l_shoulder, l_elbow, l_wrist = 14, 15, 16

    num_points = 17
    num_bodyparts = 16

    names = ["rank", "rknee", "rhip", "lhip", "lknee", "lank", "pelv",
             "neck", "torso", "head", "htop", "rwri", "relb", "rsho",
             "lsho", "lelb", "lwrit"]

    @classmethod
    def flip_lr_indices(cls):
        """Permutation mapping each joint to its left/right mirror."""
        return [cls.l_ankle, cls.l_knee, cls.l_hip,
                cls.r_hip, cls.r_knee, cls.r_ankle,
                cls.pelvis,
                cls.neck, cls.torso, cls.head, cls.head_top,
                cls.l_wrist, cls.l_elbow, cls.l_shoulder,
                cls.r_shoulder, cls.r_elbow, cls.r_wrist]

    @classmethod
    def bodypart_indices(cls):
        c = cls
        return [[c.head_top, c.head], [c.head, c.neck],
                [c.neck, c.torso], [c.torso, c.pelvis],
                [c.neck, c.r_shoulder], [c.r_shoulder, c.r_elbow], [c.r_elbow, c.r_wrist],
                [c.neck, c.l_shoulder], [c.l_shoulder, c.l_elbow], [c.l_elbow, c.l_wrist],
                [c.pelvis, c.r_hip], [c.r_hip, c.r_knee], [c.r_knee, c.r_ankle],
                [c.pelvis, c.l_hip], [c.l_hip, c.l_knee], [c.l_knee, c.l_ankle]]


class H36MOrder17POriginalOrder:
    """VideoPose3D-style 17-point order (plain filtering of the 32p order)."""

    pelvis, r_hip, r_knee, r_ankle = 0, 1, 2, 3
    l_hip, l_knee, l_ankle = 4, 5, 6
    torso, neck, head, head_top = 7, 8, 9, 10
    l_shoulder, l_elbow, l_wrist = 11, 12, 13
    r_shoulder, r_elbow, r_wrist = 14, 15, 16

    num_points = 17

    @classmethod
    def to_our_17p_order(cls):
        return [cls.r_ankle, cls.r_knee, cls.r_hip,
                cls.l_hip, cls.l_knee, cls.l_ankle,
                cls.pelvis,
                cls.neck, cls.torso,
                cls.head, cls.head_top,
                cls.r_wrist, cls.r_elbow, cls.r_shoulder,
                cls.l_shoulder, cls.l_elbow, cls.l_wrist]


# AMASS custom joint-regressor order → canonical 17p order
# (reference `amass_dataset.py:23-30`)
AMASS_REORDER = [6, 5, 4, 1, 2, 3, 0, 8, 7, 9, 10, 16, 15, 14, 11, 12, 13]
