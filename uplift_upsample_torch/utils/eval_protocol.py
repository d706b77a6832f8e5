"""Evaluation protocol: action-wise metrics and keyframe interpolation (numpy,
host side, float64).

Copied from the JAX package's `utils/eval_protocol.py` (parity with reference
`action_wise_eval.py:17-131`). The published "all frames" numbers use
central-frame predictions at every frame, with non-keyframe predictions
replaced by linear interpolation between the surrounding keyframes.
"""

from __future__ import annotations

import sys

import numpy as np

from ..data import h36m_splits
from . import metrics as h36metrics

METRIC_NAMES = ["mpjpe", "nmpjpe", "pampjpe"]


def _frame_metrics(pred_3d, gt_3d, root_index):
    """Per-frame per-joint metric arrays in millimeters (invalid joints = negative)."""
    frame_mpjpe = h36metrics.mpjpe(pred=pred_3d, gt=gt_3d, root_index=root_index,
                                   normalize=False) * 1000.0
    frame_nmpjpe = h36metrics.nmpjpe(pred=pred_3d, gt=gt_3d, root_index=root_index,
                                     alignment="root", normalize=False) * 1000.0
    frame_pampjpe = h36metrics.pmpjpe(pred=pred_3d, gt=gt_3d, normalize=False) * 1000.0
    return frame_mpjpe, frame_nmpjpe, frame_pampjpe


def _average(a):
    return np.mean(a[a >= 0])


def h36_action_wise_eval(pred_3d, gt_3d, actions, root_index):
    """Returns (frame_results, average_results, per_action_results) dicts.

    `average_results` first averages within each of the 15 canonical actions,
    then across actions (the headline H36M protocol). An action with no
    samples is skipped (with a log) instead of NaN-propagating into the mean.
    """
    per_frame = _frame_metrics(pred_3d, gt_3d, root_index)

    per_action_results = {}
    for a_i, action_name in enumerate(h36m_splits.renamed_actions):
        selector = np.where(actions == a_i)
        if selector[0].size == 0:
            print(f'action-wise eval: no samples for "{action_name}", '
                  f"skipping it in the average", file=sys.stderr)
            continue
        per_action_results[action_name] = {
            name: _average(arr[selector]) for name, arr in zip(METRIC_NAMES, per_frame)
        }

    frame_results = {name: _average(arr) for name, arr in zip(METRIC_NAMES, per_frame)}
    average_results = {
        name: np.mean([d[name] for d in per_action_results.values()])
        for name in METRIC_NAMES
    }
    return frame_results, average_results, per_action_results


def frame_wise_eval(pred_3d, gt_3d, root_index):
    per_frame = _frame_metrics(pred_3d, gt_3d, root_index)
    return {name: _average(arr) for name, arr in zip(METRIC_NAMES, per_frame)}


def compute_and_log_metrics(pred3d, gt3d, actions, root_index, action_wise):
    def log(*args):
        print(*args)
        sys.stdout.flush()

    log("Computing metrics:")
    frame_results, average_results, per_action_results = h36_action_wise_eval(
        pred_3d=pred3d, gt_3d=gt3d, actions=actions, root_index=root_index)

    log("Frame-wise evaluation:")
    for name in METRIC_NAMES:
        log(f"{name.upper()}: {frame_results[name]:.3f}")
    log("")

    if action_wise:
        for action_name in sorted(per_action_results.keys()):
            res = per_action_results[action_name]
            log(f'Results for "{action_name}"')
            for name in METRIC_NAMES:
                log(f"{name.upper()}: {res[name]:.3f}")
        log("Total action-wise evaluation results:")
        for name in METRIC_NAMES:
            log(f"{name.upper()}: {average_results[name]:.3f}")

    return frame_results, average_results, per_action_results


def interpolate_between_keyframes(pred3d, frame_indices, keyframe_stride):
    """Linear interpolation of central-frame predictions between keyframes.

    Predictions are dataset-ordered; a non-increasing frame index marks a new
    video sequence. Keyframes are frames whose index is divisible by
    `keyframe_stride` (scalar or per-frame array); non-keyframes between two
    keyframes are linearly interpolated, trailing frames copy the last
    keyframe, frames before a sequence's first keyframe keep the raw
    prediction (a sequence normally starts on a keyframe — globally aligned
    stride masks; the reference would fault here, action_wise_eval.py:99).

    Vectorized (accumulate-based fills) with the reference loop's weights in
    the same expression order, so the output is bit-identical to it.
    """
    frame_indices = np.asarray(frame_indices)
    m = frame_indices.shape[0]
    keyframes = np.equal(np.mod(frame_indices, keyframe_stride), 0)
    if m == 0:
        return np.copy(pred3d), keyframes
    rows = np.arange(m)
    restart = np.zeros(m, dtype=bool)
    restart[1:] = frame_indices[1:] <= frame_indices[:-1]
    seq_id = np.cumsum(restart)

    # Previous keyframe row (inclusive), forward-filled; -1 = none yet.
    prev = np.maximum.accumulate(np.where(keyframes, rows, -1))
    prev_ok = (prev >= 0) & (seq_id[np.maximum(prev, 0)] == seq_id)
    # Next keyframe row (inclusive), backward-filled; m = none ahead.
    nxt_rev = np.minimum.accumulate(np.where(keyframes, rows, m)[::-1])[::-1]
    nxt = np.minimum(nxt_rev, m - 1)
    nxt_ok = (nxt_rev < m) & (seq_id[nxt] == seq_id)

    interp3d = np.copy(pred3d)
    # Middle rows: between two keyframes of the same sequence.
    mid = ~keyframes & prev_ok & nxt_ok
    if np.any(mid):
        p, q, r = prev[mid], nxt_rev[mid], rows[mid]
        w_right = (r - p) / (q - p)
        w = w_right.reshape((-1,) + (1,) * (pred3d.ndim - 1))
        interp3d[mid] = pred3d[p] * (1.0 - w) + pred3d[q] * w
    # Trailing rows: a previous keyframe but no following one — copy it.
    trail = ~keyframes & prev_ok & ~nxt_ok
    if np.any(trail):
        interp3d[trail] = pred3d[prev[trail]]
    # Leading rows (no previous keyframe): keep the raw prediction.
    return interp3d, keyframes
