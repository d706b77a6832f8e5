"""3D pose metrics (numpy, float64 on host).

MPJPE / N-MPJPE / PA-MPJPE with per-joint valid flags, matching reference
`metrics.py:13-201`; copied from the JAX package's `utils/metrics.py`. The
metrics stay on the host in float64, as the published numbers are computed.

GT arrays are (B, K, 4) in (x, y, z, valid) format; predictions are (B, K, 3).
With `normalize=False` the per-example per-joint distances are returned, with
-1 marking invalid GT joints.

Implementation note: numpy ops whose inner loop spans only the size-3
coordinate axis (fancy-index root broadcasts, `norm(axis=-1)`,
`sum(axis=(1,2))`) are slow; the contiguous reformulations below
(slice-broadcast `np.subtract(..., out=)`, `einsum` row-dots on (B, K·3)
views) are term-for-term the same sums (bit-equal or last-ulp identical).
"""

from __future__ import annotations

import numpy as np


def _sub_root(a, root_index):
    """a - a[:, root] via slice-broadcast with an explicit out (the
    fancy-index form `a - a[:, [root]]` is ~13× slower on tiny inner dims)."""
    out = np.empty_like(a)
    np.subtract(a, a[:, root_index: root_index + 1, :], out=out)
    return out


def _rownorm(d):
    """||d||₂ over the last (xyz) axis: einsum square-sum + sqrt (identical
    3-term sums to norm(axis=-1), ~7× faster here)."""
    return np.sqrt(np.einsum("mkc,mkc->mk", d, d))


def _rowdot(a, b):
    """Σ over (K, 3) of a·b as one contiguous row dot."""
    m = a.shape[0]
    return np.einsum("mi,mi->m", a.reshape(m, -1), b.reshape(m, -1))


def mpjpe(pred, gt, root_index, normalize=True):
    """Root-aligned mean per-joint position error."""
    gt3d = gt[:, :, :3]
    valid = gt[:, :, 3] > 0
    gt3d = _sub_root(np.ascontiguousarray(gt3d), root_index)
    pred3d = _sub_root(pred, root_index)
    dist = _rownorm(pred3d - gt3d)
    if not normalize:
        return np.where(valid, dist, -1.0)
    return np.sum(np.where(valid, dist, 0.0)) / float(np.sum(valid))


def optimal_scaling(pred3d, target3d, valid_mask):
    """Per-example least-squares scale factor s minimizing ||s*pred - target||²."""
    v = valid_mask[:, :, np.newaxis]
    tm, pm = target3d * v, pred3d * v
    nom = _rowdot(pm, tm)
    denom = _rowdot(pm, pm)
    return pred3d * (nom / denom)[:, np.newaxis, np.newaxis]


def nmpjpe(pred, gt, root_index, alignment="root", normalize=True):
    """Scale-normalized MPJPE with root or mean alignment."""
    gt3d = np.ascontiguousarray(gt[:, :, :3])
    valid = gt[:, :, 3] > 0

    if alignment == "mean":
        normalizer = np.sum(valid, axis=1)
        v = valid[:, :, np.newaxis]
        gt3d = gt3d - (np.sum(gt3d * v, axis=1) / normalizer[:, np.newaxis])[:, np.newaxis, :]
        pred3d = pred - (np.sum(pred * v, axis=1) / normalizer[:, np.newaxis])[:, np.newaxis, :]
    else:
        gt3d = _sub_root(gt3d, root_index)
        pred3d = _sub_root(pred, root_index)

    pred3d = optimal_scaling(pred3d=pred3d, target3d=gt3d, valid_mask=valid)
    dist = _rownorm(pred3d - gt3d)
    if not normalize:
        return np.where(valid, dist, -1.0)
    return np.sum(np.where(valid, dist, 0.0)) / float(np.sum(valid))


def compute_similarity_transform(X, Y, compute_optimal_scale=True):
    """Procrustes alignment of Y onto X (MATLAB `procrustes` semantics).

    Returns (d, Z, T, b, c): squared error, transformed Y, rotation, scale,
    translation.
    """
    muX, muY = X.mean(axis=0), Y.mean(axis=0)
    X0, Y0 = X - muX, Y - muY

    normX = np.sqrt(np.square(X0).sum())
    normY = np.sqrt(np.square(Y0).sum())
    X0, Y0 = X0 / normX, Y0 / normY

    A = X0.T @ Y0
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    V = Vt.T
    T = V @ U.T

    # Reflection guard: force det(T) = +1
    detT = np.linalg.det(T)
    V[:, -1] *= np.sign(detT)
    s[-1] *= np.sign(detT)
    T = V @ U.T

    traceTA = s.sum()
    if compute_optimal_scale:
        b = traceTA * normX / normY
        d = 1 - np.square(traceTA)
        Z = normX * traceTA * (Y0 @ T) + muX
    else:
        b = 1
        d = 1 + np.square(Y0).sum() / np.square(X0).sum() - 2 * traceTA * normY / normX
        Z = normY * (Y0 @ T) + muX
    c = muX - b * (muY @ T)
    return d, Z, T, b, c


def _procrustes_align_batched(pred, gt3d):
    """Batched Procrustes alignment of pred onto gt3d (optimal rotation +
    scale + translation; the math of `compute_similarity_transform` with
    compute_optimal_scale=True, vectorized over the batch via stacked
    3x3 LAPACK SVDs instead of a per-example python loop)."""
    m = pred.shape[0]
    muX = gt3d.mean(axis=1, keepdims=True)
    muY = pred.mean(axis=1, keepdims=True)
    X0, Y0 = gt3d - muX, pred - muY
    normX = np.sqrt(_rowdot(X0, X0))[:, None, None]
    normY = np.sqrt(_rowdot(Y0, Y0))[:, None, None]
    X0, Y0 = X0 / normX, Y0 / normY
    A = X0.transpose(0, 2, 1) @ Y0                      # (M, 3, 3)
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    V = Vt.transpose(0, 2, 1)
    # Reflection guard: force det(T) = +1 (same sign rule as the loop)
    detT = np.linalg.det(V @ U.transpose(0, 2, 1))
    sign = np.sign(detT)
    V = V.copy()
    V[:, :, -1] *= sign[:, None]
    s = s.copy()
    s[:, -1] *= sign
    T = V @ U.transpose(0, 2, 1)
    traceTA = s.sum(axis=1)
    return normX * traceTA[:, None, None] * (Y0 @ T) + muX


def pmpjpe(pred, gt, normalize=True):
    """Procrustes-aligned MPJPE (optimal rotation + scale + translation)."""
    gt3d = np.ascontiguousarray(gt[:, :, :3])
    valid = gt[:, :, 3] > 0

    try:
        aligned = _procrustes_align_batched(pred, gt3d)
    except np.linalg.LinAlgError:
        # Rare non-convergence: fall back to the per-example reference loop
        # (which downgrades only the offending rows).
        aligned = np.empty_like(pred)
        for i, (p, g) in enumerate(zip(pred, gt3d)):
            try:
                _, p_aligned, _, _, _ = compute_similarity_transform(
                    X=g, Y=p, compute_optimal_scale=True)
                aligned[i] = p_aligned
            except np.linalg.LinAlgError:
                print("Warning: SVD did not converge during PAMPJPE")
                aligned[i] = p

    dist = _rownorm(aligned - gt3d)
    if not normalize:
        return np.where(valid, dist, -1.0)
    return np.sum(np.where(valid, dist, 0.0)) / float(np.sum(valid))
