"""Vectorized batch producers for H36mSequenceGenerator and
AMASSSequenceGenerator (numpy, host side).

Copied from the JAX package's `data/fast_batcher.py`: bit-identical to the
per-item generators (same RNG streams, same outputs), but all RNG decisions
of an epoch are drawn in one vectorized pass and a batch is materialised with
one window gather, the C++ gather of `data/native.py` (as in the JAX package).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .generator import AMASSSequenceGenerator, H36mSequenceGenerator
from .native import gather_windows


def _concatenate_store(videos):
    """Stack variable-length videos into one (T_total, K, C) store + offsets."""
    offsets = np.zeros(len(videos), dtype=np.int64)
    total = 0
    for i, v in enumerate(videos):
        offsets[i] = total
        total += v.shape[0]
    store = np.concatenate([np.asarray(v, dtype=np.float32) for v in videos], axis=0)
    return store, offsets


def _epoch_plan(windower, locs, seq_lengths):
    """Vectorized per-epoch decisions mirroring the per-item loop.

    Returns dict with per-item arrays: indices (M, N) absolute into the
    concatenated store (caller adds offsets), valid (M, N), stride,
    abs_mask_stride, stride_mask (M, N), do_flip, s_i.
    """
    m = locs.shape[0]
    s_i = locs[:, 0].astype(np.int64)
    centers = locs[:, 1].astype(np.int64)
    do_flip = locs[:, 2].astype(np.int64)
    frame_rates = locs[:, 3].astype(np.int64)

    assert np.all(frame_rates % windower.target_frame_rate == 0)
    mult = np.where(frame_rates != windower.target_frame_rate,
                    frame_rates // windower.target_frame_rate, 1)
    stride = windower.stride * mult

    # Mask-stride choice: one draw per item when multiple values configured
    if windower.abs_mask_stride is None:
        abs_mask_stride = stride.copy()
    else:
        values = np.asarray(windower.abs_mask_stride, dtype=np.int64)
        if len(values) == 1:
            abs_mask_stride = np.full(m, values[0], dtype=np.int64)
        else:
            choice = windower.mask_stride_rng.integers(
                low=0, high=len(values), size=m, endpoint=False)
            abs_mask_stride = values[choice]
        abs_mask_stride = abs_mask_stride * mult

    n = windower.seq_len
    mid = n // 2
    video_len = np.asarray(seq_lengths, dtype=np.int64)[s_i]
    positions = centers[:, None] + (np.arange(n) - mid)[None, :] * stride[:, None]
    valid = (positions >= 0) & (positions < video_len[:, None])
    assert valid.any(axis=1).all(), "window entirely outside the video"
    # first/last sampled in-range position per row (edge-pad targets)
    first_pos = np.take_along_axis(positions, np.argmax(valid, axis=1)[:, None], 1)
    last_idx = n - 1 - np.argmax(valid[:, ::-1], axis=1)
    last_pos = np.take_along_axis(positions, last_idx[:, None], 1)
    indices = np.where(positions < 0, first_pos,
                       np.where(positions >= video_len[:, None], last_pos, positions))

    # Stride mask
    seq_idx = (np.arange(n) - mid)[None, :] * stride[:, None]
    if windower.stride_mask_align_global:
        seq_idx = seq_idx + centers[:, None]
    elif windower.rand_shift_stride_mask:
        mask_stride = abs_mask_stride // stride
        max_shift = np.ceil((mask_stride - 1) / 2).astype(np.int64)
        endpoint = (mask_stride % 2 != 0).astype(np.int64)
        rand_shift = windower.stride_shift_rng.integers(
            low=-max_shift, high=max_shift + endpoint, size=m, endpoint=False)
        seq_idx = seq_idx + (rand_shift * stride)[:, None]
    stride_mask = np.equal(seq_idx % abs_mask_stride[:, None], 0)

    return dict(s_i=s_i, centers=centers, do_flip=do_flip, stride=stride,
                abs_mask_stride=abs_mask_stride, indices=indices, valid=valid,
                stride_mask=stride_mask)


def _batches_with_carry(epoch_plan_fn, gather_slice_fn, batch_size: int,
                        rows: Optional[slice] = None):
    """Infinite batch stream over chained epochs, tf.data repeat→batch style:
    batches straddle epoch boundaries, no item is ever dropped.

    `rows`: optional [start, stop) row range of each *global* batch to
    materialize, one rank's shard of a data-parallel feed. All RNG is spent
    at epoch-plan time, so skipping rows at gather time cannot desync the
    streams: rank r's output is exactly `global_batch[rows]`.
    """
    row_start = 0 if rows is None else rows.start
    row_stop = batch_size if rows is None else rows.stop
    pieces = []
    have = 0
    while True:
        plan = epoch_plan_fn()
        m = plan["m"]
        pos = 0
        while pos < m:
            take = min(batch_size - have, m - pos)
            # this plan slice's batch rows [have, have + take) within `rows`
            lo = max(have, row_start)
            hi = min(have + take, row_stop)
            if hi > lo:
                pieces.append(gather_slice_fn(plan, slice(pos + lo - have, pos + hi - have)))
            have += take
            pos += take
            if have == batch_size:
                if len(pieces) == 1:
                    yield pieces[0]
                else:
                    yield tuple(np.concatenate(cols, axis=0) for cols in zip(*pieces))
                pieces, have = [], 0


class FastH36mBatcher:
    """Batched equivalent of H36mSequenceGenerator.

    `batches()` yields an infinite stream of batched tuples matching the
    generator's per-item tuple: (seq3d (B,N,K,3), seq2d (B,N,K,2), mask (B,N),
    cams (B,11), subjects (B,), actions (B,), centers (B,), stride_masks (B,N)).
    Epochs are chained tf.data-style (repeat→batch): batches straddle epoch
    boundaries so RNG stream consumption matches the fully-drained per-item
    generator exactly.
    """

    def __init__(self, generator: H36mSequenceGenerator, batch_size: int,
                 central_3d_only: bool = False):
        self.gen = generator
        self.batch_size = batch_size
        # Eval-feed mode: materialize only the CENTRAL row of each 3D
        # window (seq3d comes back (B, 1, K, 3)) — the eval loop reads just
        # the central-frame ground truth.
        self.central_3d_only = central_3d_only
        self.store3d, self.offsets = _concatenate_store(generator.poses_3d)
        self.store2d, offsets2 = _concatenate_store(generator.poses_2d)
        assert np.array_equal(self.offsets, offsets2)
        self.seq_lengths = [len(v) for v in generator.poses_3d]
        self.cams = np.stack([np.asarray(c, np.float32) for c in generator.camera_params])
        self.subjects = np.asarray(generator.subjects, np.int32)
        self.actions = np.asarray(generator.actions, np.int32)
        self.flip_perm = (None if generator.windower.flip_lr_indices is None
                          else np.asarray(generator.windower.flip_lr_indices, np.int32))

    def __len__(self):
        return len(self.gen)

    def _epoch_plan(self):
        w = self.gen.windower
        locs = w.epoch_locations(self.gen.sequence_locations)
        plan = _epoch_plan(w, locs, self.seq_lengths)
        plan["abs_indices"] = plan["indices"] + self.offsets[plan["s_i"]][:, None]
        if w.in_batch_augment and w.flip_augment:
            # item, flip(item) pairs — duplicate the plan rows, flip the 2nd
            for key in ("s_i", "centers", "valid", "stride_mask", "abs_indices"):
                plan[key] = np.repeat(plan[key], 2, axis=0)
            do_flip = np.zeros(plan["abs_indices"].shape[0], dtype=np.int64)
            do_flip[1::2] = 1
            plan["do_flip"] = do_flip
        plan["zero_fill"] = None if w.pad_edge else ~plan["valid"]
        plan["m"] = plan["abs_indices"].shape[0]
        return plan

    def _gather_slice(self, plan, sl):
        do_flip = plan["do_flip"][sl].astype(np.uint8)
        zf = None if plan["zero_fill"] is None else plan["zero_fill"][sl]
        idx3 = plan["abs_indices"][sl]
        zf3 = zf
        if self.central_3d_only:
            mid = idx3.shape[1] // 2
            idx3 = idx3[:, mid: mid + 1]
            zf3 = None if zf is None else zf[:, mid: mid + 1]
        seq3d = gather_windows(self.store3d, idx3, zf3, do_flip, self.flip_perm)
        seq2d = gather_windows(self.store2d, plan["abs_indices"][sl], zf, do_flip,
                               self.flip_perm)
        cams = self.cams[plan["s_i"][sl]].copy()
        flipped = do_flip.astype(bool)
        cams[flipped, 4] *= -1
        cams[flipped, 9] *= -1
        return (seq3d, seq2d, plan["valid"][sl].astype(np.float32), cams,
                self.subjects[plan["s_i"][sl]], self.actions[plan["s_i"][sl]],
                plan["centers"][sl].astype(np.int64), plan["stride_mask"][sl])

    def batches(self, rows: Optional[slice] = None) -> Iterator[tuple]:
        """The batch stream; `rows` keeps that row range of every batch."""
        return _batches_with_carry(self._epoch_plan, self._gather_slice,
                                   self.batch_size, rows)


class FastAMASSBatcher:
    """Batched equivalent of AMASSSequenceGenerator (world-space 3D + cam18).

    Yields (seq3d_world (B,N,K,3), cam18 (B,18), mask (B,N), subjects (B,),
    actions (B,), centers (B,), stride_masks (B,N)); same epoch-chaining
    semantics as FastH36mBatcher.
    """

    def __init__(self, generator: AMASSSequenceGenerator, batch_size: int):
        self.gen = generator
        self.batch_size = batch_size
        self.store3d, self.offsets = _concatenate_store(generator.sequences)
        self.seq_lengths = [s.shape[0] for s in generator.sequences]
        self.cams = np.stack(generator.cameras)
        self.flip_perm = (None if generator.windower.flip_lr_indices is None
                          else np.asarray(generator.windower.flip_lr_indices, np.int32))

    def __len__(self):
        return len(self.gen)

    def _epoch_plan(self):
        gen = self.gen
        w = gen.windower
        locs = w.epoch_locations(gen.sequence_locations, reset_camera_rng=True)
        plan = _epoch_plan(w, locs, self.seq_lengths)
        plan["abs_indices"] = plan["indices"] + self.offsets[plan["s_i"]][:, None]
        m = plan["abs_indices"].shape[0]
        # Camera draw per item (separate RNG stream, one value per base item)
        plan["cam_choice"] = w.rng.integers(low=0, high=len(self.cams), size=(m, 1))[:, 0]
        if w.in_batch_augment and w.flip_augment:
            for key in ("s_i", "centers", "valid", "stride_mask", "abs_indices",
                        "cam_choice"):
                plan[key] = np.repeat(plan[key], 2, axis=0)
            do_flip = np.zeros(m * 2, dtype=np.int64)
            do_flip[1::2] = 1
            plan["do_flip"] = do_flip
        elif gen.compat_reference_flip_bug:
            # The reference's eager flip branch is dead code; windows yield unflipped
            plan["do_flip"] = np.zeros_like(plan["do_flip"])
        plan["zero_fill"] = None if w.pad_edge else ~plan["valid"]
        plan["m"] = plan["abs_indices"].shape[0]
        return plan

    def _gather_slice(self, plan, sl):
        do_flip = plan["do_flip"][sl].astype(np.uint8)
        zf = None if plan["zero_fill"] is None else plan["zero_fill"][sl]
        seq3d = gather_windows(self.store3d, plan["abs_indices"][sl], zf, do_flip,
                               self.flip_perm)
        n_items = seq3d.shape[0]
        zeros = np.zeros(n_items, dtype=np.int32)
        # AMASS flip does not alter the camera
        return (seq3d, self.cams[plan["cam_choice"][sl]],
                plan["valid"][sl].astype(np.float32), zeros, zeros,
                plan["centers"][sl].astype(np.int64), plan["stride_mask"][sl])

    def batches(self, rows: Optional[slice] = None) -> Iterator[tuple]:
        """The batch stream; `rows` keeps that row range of every batch."""
        return _batches_with_carry(self._epoch_plan, self._gather_slice,
                                   self.batch_size, rows)
