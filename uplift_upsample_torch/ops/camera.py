"""Camera ops on the device: world→camera transform and 2D projection
(counterpart of the JAX package's ops/camera.py).

The AMASS training step draws a random Human3.6M camera per window on the
host and runs this transform inside the step, on the card, for the whole
batch (the reference does it per element in its tf.data map,
`uplifiting_dataset.py:661-761`). Plain PyTorch: elementwise work on
(B, N, K, 3) poses, no kernel of its own.

Camera encoding (AMASS path): 18-vector = quaternion (4, wxyz) | translation
(3) | intrinsics (11: res_w, res_h, fx, fy, cx, cy, k1, k2, k3, p1, p2).
"""

from __future__ import annotations

import torch


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4), broadcasting."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qinverse(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def world_to_camera(x: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x: (..., 3) world points; R: (4,) or batched (..., 4); t matching (..., 3)."""
    rt = qinverse(R)
    while rt.dim() < x.dim():
        rt = rt[..., None, :]
        t = t[..., None, :]
    return qrot(rt.expand(x.shape[:-1] + (4,)), x - t)


def project_to_2d(x: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """H36M distorted projection of camera-space points x (..., 3).

    `intrinsics` is the 11-vector (possibly batched on leading dims); the
    normalized image point is clamped to [-1, 1] before distortion.
    """
    while intrinsics.dim() < x.dim():
        intrinsics = intrinsics[..., None, :]
    f, c = intrinsics[..., 2:4], intrinsics[..., 4:6]
    k, p = intrinsics[..., 6:9], intrinsics[..., 9:11]

    xx = torch.clamp(x[..., :2] / x[..., 2:], -1.0, 1.0)
    r2 = torch.sum(xx ** 2, dim=-1, keepdim=True)
    radial = 1.0 + torch.sum(k * torch.cat([r2, r2 ** 2, r2 ** 3], dim=-1),
                             dim=-1, keepdim=True)
    tan = torch.sum(p * xx, dim=-1, keepdim=True)
    xxx = xx * (radial + tan) + p * r2
    return f * xxx + c


def project_to_2d_linear(x: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    while intrinsics.dim() < x.dim():
        intrinsics = intrinsics[..., None, :]
    f, c = intrinsics[..., 2:4], intrinsics[..., 4:6]
    xx = torch.clamp(x[..., :2] / x[..., 2:], -1.0, 1.0)
    return f * xx + c


def world_to_cam_and_2d(sequence_3d: torch.Tensor, cam18: torch.Tensor):
    """Batched AMASS input transform.

    sequence_3d: (B, N, K, 3) world-space poses; cam18: (B, 18).
    Returns (camera-space 3D (B, N, K, 3), projected 2D (B, N, K, 2)).
    """
    quat, trans = cam18[..., :4], cam18[..., 4:7]
    intrinsics = cam18[..., 7:18]
    cam3d = world_to_camera(sequence_3d, quat[:, None, :], trans[:, None, :])
    pose2d = project_to_2d(cam3d, intrinsics[:, None, None, :])
    return cam3d, pose2d
