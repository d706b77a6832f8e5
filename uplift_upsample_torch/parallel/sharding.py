"""Tensor parallelism over a model-parallel ("mp") group of ranks
(counterpart of the JAX package's parallel/sharding.py).

The JAX package gives each parameter a PartitionSpec over an "mp" mesh axis
and lets GSPMD insert the collectives: q/k/v projections and MLP fc1 split
on the output (head / hidden) dim, proj and fc2 split on the input dim, the
classic Megatron pairing with one all-reduce per branch. Here each mp rank
is a process that holds its contiguous block of every split tensor
(`shard_params_tp`), and the modules call the collectives themselves
(`models/primitives.py`):

  - `copy_to_tp`: identity forward, all-reduce of the gradient backward (the
    input of a branch, replicated over the mp ranks);
  - `reduce_from_tp`: all-reduce forward, identity backward (the branch's
    partial sums; the replicated bias is added after it);
  - `gather_from_tp`: all-gather on the split dim forward, the rank's slice
    backward (the whole-block kernels read whole weights: every mp peer
    computes the same full result, and the backward hands each rank the
    slice of the full gradient that belongs to its shard).

On gloo the collectives of CUDA tensors go through the host, as
`mesh.all_reduce_sum_` does. GSPMD pads a dim that mp does not divide; here
mp must divide the head count and the hidden width of every stack it splits
(ValueError, naming the stack).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

_QKV = ("wq", "wk", "wv")


@dataclasses.dataclass
class TensorParallel:
    """One rank of a model-parallel group: its index `rank` among `size`
    peers, the process group over them and its backend."""
    rank: int
    size: int
    backend: str
    group: Optional["dist.ProcessGroup"]


def active(tp: Optional[TensorParallel]) -> Optional[TensorParallel]:
    """`tp` when it splits anything (size > 1), else None."""
    return tp if tp is not None and tp.size > 1 else None


def param_spec(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The torch dim of state_dict entry `name` that is split over mp, or
    None (replicated): the JAX rules (`sharding.py:16-35`) on the port's
    layouts. nn.Linear weights are (out, in), so a flax kernel's P(None, mp)
    is dim 0 and P(mp, None) dim 1; the strided blocks' Conv1d fc2 weight is
    (C, hidden, 3), so the flax (3, hidden, C) kernel's P(None, mp, None) is
    dim 1."""
    *path, leaf = name.split(".")
    layer = path[-1] if path else ""
    if "attn" in name:
        if layer in _QKV and leaf in ("weight", "bias"):
            return 0
        if layer == "proj" and leaf == "weight":
            return 1
        return None
    if "mlp" in name:
        if layer == "fc1" and leaf in ("weight", "bias"):
            return 0
        if layer == "fc2" and leaf == "weight":
            return 1
    return None


def _stack(name: str) -> str:
    return name.split(".")[0].rsplit("_", 1)[0]  # "temporal_block_2.attn..." → "temporal_block"


def check_divides(mp: int, num_heads: int, hidden: int, stack: str) -> None:
    """Raise ValueError unless mp divides the heads and the hidden width of `stack`."""
    if num_heads % mp or hidden % mp:
        raise ValueError(
            f"mp={mp} does not divide the {stack} stack's {num_heads} heads and hidden width "
            f"{hidden}: tensor parallelism needs both to split evenly (GSPMD would pad)")


def shard_params_tp(state: Mapping[str, torch.Tensor], mp_rank: int,
                    mp_size: int) -> Dict[str, torch.Tensor]:
    """Rank `mp_rank`'s contiguous block of every split tensor of a full
    state_dict (or of any dict keyed like one: moments, EMA); replicated
    tensors as they are."""
    out = {}
    for name, t in state.items():
        dim = param_spec(name, t)
        if dim is None or mp_size == 1:
            out[name] = t
            continue
        if t.shape[dim] % mp_size:
            raise ValueError(f"mp={mp_size} does not divide dim {dim} ({t.shape[dim]}) of "
                             f"{name} in the {_stack(name)} stack")
        width = t.shape[dim] // mp_size
        out[name] = t.narrow(dim, mp_rank * width, width).contiguous()
    return out


def _via_host(tp: TensorParallel, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and tp.backend != "nccl"


def all_reduce_sum(tp: TensorParallel, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the mp group, as a new tensor on t's device."""
    buf = t.detach().to("cpu" if _via_host(tp, t) else t.device, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=tp.group)
    return buf.to(t.device)


def all_gather(tp: TensorParallel, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The mp ranks' blocks of `t` concatenated on `dim`, in rank order."""
    src = t.detach().to("cpu" if _via_host(tp, t) else t.device).contiguous()
    parts = [torch.empty_like(src) for _ in range(tp.size)]
    dist.all_gather(parts, src, group=tp.group)
    return torch.cat(parts, dim=dim).to(t.device)


def gather_params_tp(local_state: Mapping[str, torch.Tensor],
                     tp: Optional[TensorParallel]) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_params_tp` over the mp group: every split tensor
    whole again (on every rank), replicated ones as they are. Through
    `gather_from_tp`, so on parameters under autograd (the whole-block
    kernels' weights in training) the backward hands each rank its slice."""
    if active(tp) is None:
        return dict(local_state)
    out = {}
    for name, t in local_state.items():
        dim = param_spec(name, t)
        out[name] = t if dim is None else gather_from_tp(t, tp, dim)
    return out


def check_model_tp(model, tp: Optional[TensorParallel]) -> Optional[TensorParallel]:
    """`tp` resolved (None unless mp > 1); it must be the group the model
    was built with."""
    tp = active(tp)
    if (tp is None) != (getattr(model, "tp", None) is None):
        raise ValueError("tp must be the tensor-parallel group the model was built with")
    return tp


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(ctx.tp, grad), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_sum(tp, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.width = tp, dim, x.shape[dim]
        return all_gather(tp, x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.width, ctx.width), None, None


def copy_to_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _ReduceFromTP.apply(x, tp)


def gather_from_tp(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    return _GatherFromTP.apply(x, tp, dim)
