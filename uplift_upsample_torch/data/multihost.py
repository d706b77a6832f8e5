"""Data-parallel input feed: per-rank batch rows and their gather (counterpart
of the JAX package's data/multihost.py).

Every rank runs the *same* deterministic epoch plan (identical seeds, hence
identical shuffles, mask-stride draws and flips) and materializes only its
row range of each global batch, so the concatenation over ranks in rank
order is bit-identical to the 1-process feed. All RNG is spent at
epoch-plan time (`fast_batcher._epoch_plan`), which is what makes skipping
rows safe.

`gather_rows` takes the place of the JAX package's `globalize_batch` and
`multihost_utils.process_allgather`: it puts the ranks' rows (outputs on the
card, or numpy ids on the host) back into the global batch in rank order.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator, Union

import numpy as np
import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from ..parallel.mesh import DataParallel


def host_row_slice(batch_size: int, rank: int, world: int) -> slice:
    """Rank `rank`'s row range [start, stop) of every global batch."""
    assert batch_size % world == 0, (
        f"global batch {batch_size} must divide over {world} ranks")
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


class HostShardedBatcher:
    """Wrap a Fast*Batcher to produce only this rank's rows of each batch.

    Every rank builds the identical underlying batcher (same data, same
    seeds) and this wrapper slices the global batch deterministically; the
    feed itself needs no communication. `batch_size` is the local batch.
    """

    def __init__(self, batcher, rank: int, world: int):
        self.batcher = batcher
        self.rows = host_row_slice(batcher.batch_size, rank, world)

    def __len__(self):
        return len(self.batcher)

    @property
    def batch_size(self) -> int:
        return self.rows.stop - self.rows.start

    def batches(self) -> Iterator[tuple]:
        return self.batcher.batches(rows=self.rows)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def gather_rows(dp: DataParallel,
                rows: Union[torch.Tensor, np.ndarray]) -> Union[torch.Tensor, np.ndarray]:
    """This rank's rows (equal counts on every rank) → the global batch, the
    ranks' rows in rank order, on every rank: a numpy array on the host, a
    tensor on its own device. With NCCL the gather runs on the card; gloo
    has no all-gather of CUDA tensors, so they go through the host."""
    if isinstance(rows, np.ndarray):
        if rows.dtype == bool:  # sent as bytes
            return gather_rows(dp, rows.astype(np.uint8)).astype(bool)
        return _all_gather(torch.from_numpy(np.ascontiguousarray(rows)), dp.host_group).numpy()
    if rows.device.type == "cuda" and dp.backend != "nccl":
        return _all_gather(rows.cpu(), dp.host_group).to(rows.device)
    return _all_gather(rows, dp.group)
