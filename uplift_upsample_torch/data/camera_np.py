"""Host-side (numpy) camera math: quaternions, frame transforms, projection.

Behavioral parity with reference `camera.py:15-49` and `quaternion.py:12-31`;
copied from the JAX package's `data/camera_np.py`.
"""

from __future__ import annotations

import numpy as np


def qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4) (w, x, y, z)."""
    assert q.shape[-1] == 4 and v.shape[-1] == 3
    assert q.shape[:-1] == v.shape[:-1]
    qvec = q[..., 1:]
    uv = np.cross(qvec, v, axis=-1)
    uuv = np.cross(qvec, uv, axis=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qinverse(q: np.ndarray) -> np.ndarray:
    """Conjugate of a unit quaternion."""
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)


def normalize_screen_coordinates(x: np.ndarray, w: int, h: int) -> np.ndarray:
    """Map pixel coords so [0, w] → [-1, 1], preserving aspect ratio."""
    assert x.shape[-1] == 2
    return x / w * 2.0 - np.array([1.0, h / w])


def image_coordinates(x: np.ndarray, w: int, h: int) -> np.ndarray:
    """Inverse of :func:`normalize_screen_coordinates`."""
    assert x.shape[-1] == 2
    return (x + np.array([1.0, h / w])) * w / 2.0


def world_to_camera(x: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Transform world-space points into the camera frame (quaternion R, translation t)."""
    rt = qinverse(R)
    return qrot(np.tile(rt, (*x.shape[:-1], 1)), x - t)


def camera_to_world(x: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return qrot(np.tile(R, (*x.shape[:-1], 1)), x) + t


def project_to_2d_linear(x: np.ndarray, f: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Pinhole projection without distortion. x is camera-space (..., 3)."""
    assert x.shape[-1] == 3
    xx = x[..., :2] / x[..., 2:]
    return f * xx + c


def project_to_2d(x: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Full H36M projection with radial (k1..k3) + tangential (p1, p2) distortion.

    `intrinsics` is the 11-vector [res_w, res_h, fx, fy, cx, cy, k1, k2, k3, p1, p2];
    the normalized image point is clamped to [-1, 1] before distortion, matching
    reference `uplifiting_dataset.py:737-761`.
    """
    intr = np.reshape(intrinsics, (1,) * (x.ndim - 1) + (-1,))
    f, c = intr[..., 2:4], intr[..., 4:6]
    k, p = intr[..., 6:9], intr[..., 9:11]

    xx = np.clip(x[..., :2] / x[..., 2:], -1.0, 1.0)
    r2 = np.sum(xx ** 2, axis=-1, keepdims=True)
    radial = 1.0 + np.sum(k * np.concatenate([r2, r2 ** 2, r2 ** 3], axis=-1),
                          axis=-1, keepdims=True)
    tan = np.sum(p * xx, axis=-1, keepdims=True)
    xxx = xx * (radial + tan) + p * r2
    return f * xxx + c
