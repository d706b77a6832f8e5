"""Keyframe interpolation of the evaluation protocol (numpy, host side).

Copied from the JAX package's `utils/eval_protocol.py` (parity with reference
`action_wise_eval.py:76-100`); the metrics part of that module waits for the
eval slice.
"""

from __future__ import annotations

import numpy as np


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
