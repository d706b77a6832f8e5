"""Device-resident pose store and batch materialization on the card (the
train feed; counterpart of the JAX package's data/device_feed.py).

The host batchers (fast_batcher.py) materialize whole window batches (~45 MB
at h36m_351, B=512) and ship them to the card every step. The windows are
gathers of a fixed pose store that the card holds whole (the full Human3.6M
training split is ~0.5 GB in fp32), so the store goes up once and each step
ships only the window plan the epoch planner already computes (gather
indices, validity and stride-mask bits, flip flags, camera ids: ~0.4 MB).
`materialize` gathers, flips and zero-fills on the card. All random draws stay
on the host in the same planner as the host batcher
(`fast_batcher._epoch_plan`), so the batches equal the host feed's values
(zero rows here are +0.0 where the host's flipped zero rows hold -0.0).

`make_train_step` / `make_val_step` take such a feed as `device_feed=` and
then take the feed's plan tuples instead of batches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .fast_batcher import FastAMASSBatcher, FastH36mBatcher, _batches_with_carry


def _flip_poses(seq: torch.Tensor, flip_perm: torch.Tensor, do_flip: torch.Tensor):
    """Per-row flip: joint permutation + x negation where do_flip (B,)."""
    f = seq.index_select(2, flip_perm)
    f = torch.cat([-f[..., :1], f[..., 1:]], dim=-1)
    return torch.where(do_flip[:, None, None, None], f, seq)


def _plan_tensors(plan: Tuple[np.ndarray, ...], device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)
                 for a in plan)


def materialize_h36m(store: Dict[str, torch.Tensor], plan, pad_edge: bool):
    """(plan tensors on the card) → the FastH36mBatcher batch tuple, on the card.

    gather → flip → zero-fill, as native/gather_windows.cc.
    """
    idx, valid, s_i, do_flip, centers, stride_mask = plan
    seq3d = store["store3d"][idx]     # (B, N, K, 3)
    seq2d = store["store2d"][idx]     # (B, N, K, 2)
    cams = store["cams"][s_i]         # (B, 11)
    fp = store.get("flip_perm")
    if fp is not None:
        seq3d = _flip_poses(seq3d, fp, do_flip)
        seq2d = _flip_poses(seq2d, fp, do_flip)
        sign = torch.where(do_flip, -1.0, 1.0)
        cams = cams.clone()
        cams[:, 4] *= sign  # cx
        cams[:, 9] *= sign  # tangential p2
    if not pad_edge:
        vm = valid[:, :, None, None]
        seq3d = torch.where(vm, seq3d, 0.0)
        seq2d = torch.where(vm, seq2d, 0.0)
    return (seq3d, seq2d, valid.float(), cams, store["subjects"][s_i],
            store["actions"][s_i], centers, stride_mask)


def materialize_amass(store: Dict[str, torch.Tensor], plan, pad_edge: bool):
    """(plan tensors on the card) → the FastAMASSBatcher batch tuple
    (world-space 3D + 18-vector camera; flip does not alter the camera)."""
    idx, valid, cam_choice, do_flip, centers, stride_mask = plan
    seq3d = store["store3d"][idx]
    fp = store.get("flip_perm")
    if fp is not None:
        seq3d = _flip_poses(seq3d, fp, do_flip)
    if not pad_edge:
        seq3d = torch.where(valid[:, :, None, None], seq3d, 0.0)
    cams = store["cams"][cam_choice]  # (B, 18)
    zeros = torch.zeros(idx.shape[0], dtype=torch.int32, device=idx.device)
    return (seq3d, cams, valid.float(), zeros, zeros, centers, stride_mask)


class _DeviceFeed:
    """Common part: the batcher's planner, plan slices, the store on the card."""

    materialize_fn = None
    choice_key = ""

    def __init__(self, batcher, store: Dict[str, np.ndarray], device):
        self.b = batcher
        self.batch_size = batcher.batch_size
        self.pad_edge = bool(batcher.gen.windower.pad_edge)
        self.device = torch.device(device)
        if batcher.flip_perm is not None:
            store["flip_perm"] = np.asarray(batcher.flip_perm, np.int64)
        self.store = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                      for k, v in store.items()}

    def __len__(self):
        return len(self.b)

    def store_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.store.values())

    def _plan_slice(self, plan, sl):
        return (plan["abs_indices"][sl].astype(np.int64),
                plan["valid"][sl].astype(bool),
                plan[self.choice_key][sl].astype(np.int64),
                plan["do_flip"][sl].astype(bool),
                plan["centers"][sl].astype(np.int64),
                plan["stride_mask"][sl].astype(bool))

    def plan_batches(self, rows: Optional[slice] = None):
        """Infinite per-row plan tuples (numpy), one per batch; `rows` keeps
        that row range of every batch (one rank's shard: every rank holds
        the whole store and plans every batch, as `fast_batcher.py` does)."""
        return _batches_with_carry(self.b._epoch_plan, self._plan_slice, self.batch_size,
                                   rows)

    def materialize(self, plan):
        """A plan tuple (numpy or tensors) → the host batcher's batch tuple,
        built on the card."""
        tensors = _plan_tensors(plan, self.device) if isinstance(plan[0], np.ndarray) \
            else tuple(t.to(self.device) for t in plan)
        return type(self).materialize_fn(self.store, tensors, self.pad_edge)


class H36mDeviceFeed(_DeviceFeed):
    """Wraps a FastH36mBatcher: the same epoch planner and random streams,
    but yields plan tuples (abs_indices, valid, s_i, do_flip, centers,
    stride_mask) instead of windows."""

    materialize_fn = staticmethod(materialize_h36m)
    choice_key = "s_i"

    def __init__(self, batcher: FastH36mBatcher, device):
        super().__init__(batcher, dict(
            store3d=batcher.store3d, store2d=batcher.store2d, cams=batcher.cams,
            subjects=np.asarray(batcher.subjects, np.int32),
            actions=np.asarray(batcher.actions, np.int32)), device)

    def host_ids(self, plan):
        """(subjects, actions) numpy rows of a plan batch: the metrics are
        computed on the host, so they are not fetched back from the card."""
        s_i = np.asarray(plan[2])
        return self.b.subjects[s_i], self.b.actions[s_i]


class AMASSDeviceFeed(_DeviceFeed):
    """AMASS variant of H36mDeviceFeed (cam_choice instead of s_i)."""

    materialize_fn = staticmethod(materialize_amass)
    choice_key = "cam_choice"

    def __init__(self, batcher: FastAMASSBatcher, device):
        super().__init__(batcher, dict(store3d=batcher.store3d, cams=batcher.cams), device)

    def host_ids(self, plan):
        zeros = np.zeros(np.asarray(plan[0]).shape[0], np.int32)
        return zeros, zeros


def make_device_feed(batcher, device="cuda"):
    if isinstance(batcher, FastH36mBatcher):
        return H36mDeviceFeed(batcher, device)
    if isinstance(batcher, FastAMASSBatcher):
        return AMASSDeviceFeed(batcher, device)
    raise TypeError(f"no device feed for {type(batcher).__name__}")
