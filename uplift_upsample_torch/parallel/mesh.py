"""Data parallelism over torch.distributed (counterpart of the JAX package's
parallel/mesh.py).

The JAX package shards each batch over the "dp" axis of a jax.sharding Mesh
and lets XLA insert the gradient psum. Here each rank is a process, one per
card, as `torchrun` starts them:

    torchrun --nproc-per-node N -m uplift_upsample_torch.train ...

Parameters are replicated (`broadcast_params_` from rank 0 after init, load
or resume), each rank takes its rows of every global batch
(`data/multihost.py`), and the gradient is summed over the ranks in one
flattened all-reduce before the optimizer (`all_reduce_sum_`). NCCL on CUDA,
gloo on the CPU. NCCL refuses two ranks on one card; a caller that asks for
gloo may put several ranks on one card, and then the collectives on CUDA
tensors go through the host.

`init_mesh(dp, mp)` lays the ranks out as the JAX package's
`np.array(devices).reshape(dp, mp)`: rank r has dp index r // mp and mp
index r % mp. Its `Mesh` is a `DataParallel` over the rank's dp group (the
gradient all-reduce and the batch rows follow the dp index) that also
carries the mp group as a `sharding.TensorParallel` (`tp`, None when mp is
1: then it is plain data parallelism over every rank).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from .sharding import TensorParallel


@dataclasses.dataclass
class DataParallel:
    """One rank of the data-parallel group.

    `group` is the default process group (NCCL on CUDA, gloo on the CPU or
    when asked for); `host_group` is a gloo group for gathers of host-side
    rows (numpy ids and metrics), the default group itself when that is gloo.
    """
    rank: int
    world: int
    device: torch.device
    backend: str
    group: "dist.ProcessGroup"
    host_group: "dist.ProcessGroup"

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)

    def close(self) -> None:
        dist.destroy_process_group()


@dataclasses.dataclass
class Mesh(DataParallel):
    """One rank of a dp × mp layout (`init_mesh`). As a DataParallel, `rank`
    and `world` are its dp index and the dp size, `group` and `host_group`
    its dp groups. `global_rank` / `global_world` are its place in the
    launch, `tp` its mp group (None when mp is 1), `world_host_group` a gloo
    group over every rank (`barrier` waits for all of them)."""
    global_rank: int = 0
    global_world: int = 1
    tp: Optional[TensorParallel] = None
    world_group: Optional["dist.ProcessGroup"] = None
    world_host_group: Optional["dist.ProcessGroup"] = None

    def barrier(self) -> None:
        dist.barrier(group=self.world_host_group)

    def data_parallel_world(self) -> DataParallel:
        """Data parallelism over every rank of the launch (the JAX dry run's
        1-D dp mesh over all devices)."""
        return DataParallel(rank=self.global_rank, world=self.global_world,
                            device=self.device, backend=self.backend,
                            group=self.world_group, host_group=self.world_host_group)


def launch_world() -> int:
    """The world size of this launch: `torchrun`'s WORLD_SIZE, 1 without it."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def check_data_parallel_devices(config, world: int, entry: str) -> None:
    """DATA_PARALLEL_DEVICES against the launch: -1 (or None) means the
    launch's world size; any other value must equal it."""
    want = getattr(config, "DATA_PARALLEL_DEVICES", -1)
    if want in (-1, None) or int(want) == world:
        return
    raise ValueError(
        f"DATA_PARALLEL_DEVICES={want}, but this launch has {world} rank(s): start one "
        f"process per rank with `torchrun --nproc-per-node {want} -m "
        f"uplift_upsample_torch.{entry} ...`, or set DATA_PARALLEL_DEVICES to -1 (the "
        f"launch's world size)")


@contextlib.contextmanager
def rank0_stdout(dp: Optional[DataParallel]) -> Iterator[None]:
    """Standard output as is on rank 0 (or without dp), discarded on the
    other ranks, whose log lines would repeat rank 0's."""
    if dp is None or dp.rank == 0:
        yield
        return
    with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
        yield


def init_data_parallel(device="cuda", backend: Optional[str] = None,
                       init_method: str = "env://") -> DataParallel:
    """Join the process group of this launch.

    RANK, WORLD_SIZE and LOCAL_RANK are read as `torchrun` sets them (the
    default `init_method` also reads MASTER_ADDR and MASTER_PORT). The
    backend is NCCL for a CUDA device and gloo for the CPU, unless `backend`
    says otherwise. On CUDA the rank takes card LOCAL_RANK (set before NCCL
    starts); NCCL with more ranks on this host than cards raises, while
    gloo puts rank r on card r mod the card count.
    """
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device for a data-parallel rank")
        if backend == "nccl" and max(local_world, local_rank + 1) > cards:
            raise ValueError(
                f"NCCL needs one card per rank: {local_world} ranks on this host, {cards} "
                f"card(s); start at most {cards} ranks per host (only gloo shares a card)")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("NCCL runs on CUDA devices only; the CPU uses gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    group = dist.group.WORLD
    host_group = group if backend == "gloo" else dist.new_group(backend="gloo")
    return DataParallel(rank=rank, world=world, device=device, backend=backend,
                        group=group, host_group=host_group)


def init_mesh(dp: int, mp: int, device="cuda", backend: Optional[str] = None,
              init_method: str = "env://") -> Mesh:
    """Join the launch (`init_data_parallel`) as one rank of a dp × mp
    layout: rank r has dp index r // mp and mp index r % mp. Every rank
    creates every group, in the same order, as torch.distributed requires.
    With mp = 1 the dp group is the default group, as `init_data_parallel`'s."""
    base = init_data_parallel(device, backend=backend, init_method=init_method)
    if dp * mp != base.world:
        base.close()
        raise ValueError(f"a {dp} x {mp} mesh needs {dp * mp} ranks; this launch has "
                         f"{base.world}")
    dp_index, mp_index = divmod(base.rank, mp)
    if mp == 1:
        dp_group, dp_host, tp = base.group, base.host_group, None
    else:
        dp_group = dp_host = mp_group = None
        for j in range(mp):  # the dp groups: one per mp index
            ranks = [i * mp + j for i in range(dp)]
            g = dist.new_group(ranks)
            h = g if base.backend == "gloo" else dist.new_group(ranks, backend="gloo")
            if j == mp_index:
                dp_group, dp_host = g, h
        for i in range(dp):  # the mp groups: one per dp index
            g = dist.new_group([i * mp + j for j in range(mp)])
            if i == dp_index:
                mp_group = g
        tp = TensorParallel(rank=mp_index, size=mp, backend=base.backend, group=mp_group)
    return Mesh(rank=dp_index, world=dp, device=base.device, backend=base.backend,
                group=dp_group, host_group=dp_host, global_rank=base.rank,
                global_world=base.world, tp=tp, world_group=base.group,
                world_host_group=base.host_group)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


@torch.no_grad()
def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def _on_flat_(dp: DataParallel, tensors: Sequence[torch.Tensor], collective) -> None:
    """`collective(buffer)` on one flattened copy of `tensors` (one dtype, one
    device), written back in place; gloo's go through the host from a card."""
    if not tensors:
        return
    flat = _flat(tensors)
    if flat.device.type == "cuda" and dp.backend != "nccl":
        host = flat.cpu()
        collective(host)
        flat.copy_(host)
    else:
        collective(flat)
    _unflat_(flat, tensors)


def all_reduce_sum_(dp: DataParallel, tensors: Sequence[torch.Tensor]) -> None:
    """Sum `tensors` (one dtype, one device) over the ranks, in place: one
    all-reduce of one flattened buffer, not one call per tensor."""
    _on_flat_(dp, tensors, lambda buf: dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                                                       group=dp.group))


def broadcast_params_(dp: DataParallel, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite `tensors` (one dtype, one device) with rank `src`'s, in one
    flattened broadcast."""
    _on_flat_(dp, tensors, lambda buf: dist.broadcast(buf, src=src, group=dp.group))
