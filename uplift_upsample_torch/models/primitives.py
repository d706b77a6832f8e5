"""Transformer primitives (nn.Module).

Numeric parity targets (reference `vision_transformer.py`, strided variants in
`uplift_upsample_transformer.py:53-160`), as in the JAX package:
  - MHA with *separate* q/k/v projections and optional bias; per-head scaling
    1/sqrt(head_dim); additive `mask * -1e9` with 1 = blocked key. With
    `use_pallas` (USE_PALLAS_ATTENTION) it runs the packed attention op
    (`ops/packed_attention.py`, row 11) where the JAX package runs its Pallas
    kernel: S <= 128 and no mask or a (B, 1, 1, S) key mask.
  - Pre-norm blocks with LayerNorm eps 1e-5.
  - MLP: Linear(hidden) → act → inner dropout → Linear(out) → dropout.
  - StridedMlp: pointwise Linear → act → inner dropout → explicit zero-pad →
    Conv1d(k=3, stride=s, VALID) → dropout; this is the temporal downsampler.
  - Dropout (DROP_RATE, ATTENTION_DROP_RATE) at flax's sites: each block's
    MLP output and attention output (proj), the attention weights, and the
    MLP's hidden layer where the JAX block sets `inner_dropout` (temporal
    and strided blocks, not spatial ones). `Dropout` is flax's nn.Dropout,
    drawn on the activation's device from a generator the train step sets;
    the identity under `model.eval()`. Attention-weight dropout sends
    `use_pallas` layers to the split-head path, as the JAX gate does.
  - StridedTransformerBlock's residual path: crop one frame per unpadded end,
    then take every s-th frame (MaxPool1D(pool_size=1, strides=s) semantics).
  - DropPath (stochastic depth) drops whole samples with probability rate and
    scales the kept ones by 1/keep in training (`model.train()`); it is the
    identity under `model.eval()`. A block can instead take its two
    branches' per-sample scales (`droppath=`), as the train step's plain
    stages take the kernels' draws.
  - Products follow the matmul precision context (`precision.py`): the Dense
    layers (`Dense`), the strided conv (`StridedConv1d`) and the attention's
    two products round their operands to bf16 on the "default" rung and run
    as nn.Linear / nn.Conv1d / fp32 matmuls on the others; the packed
    attention op takes the context's rung (row 11's bf16 instances).
  - `dtype` (COMPUTE_DTYPE, SPATIAL_COMPUTE_DTYPE; flax's `dtype=` of the
    JAX modules): None computes in the parameters' dtype at the context's
    rung. torch.bfloat16 casts each Dense's and the conv's input, weights and
    bias to bf16 (a bf16 output: `F.linear` / `F.conv1d` on bf16 tensors, as
    flax's Dense(dtype=bfloat16) on the TPU, whatever the rung); LayerNorm
    takes its statistics in fp32 and returns `dtype`; the attention's logits
    and softmax are fp32, the probabilities rounded to bf16 for P·V and the
    context bf16 (`ops/attention.py`). Parameters stay fp32; in training
    autograd takes the backward of the bf16 products as they run (bf16
    operands, a bf16 gradient cast back to the fp32 parameter).

Tensor parallelism (`tp`, a `parallel.sharding.TensorParallel` with size >
1): MultiHeadAttention, Mlp and StridedMlp hold their mp rank's shard (the
rank's heads, with the head depth unchanged; its block of fc1's outputs and
of fc2's or the conv's inputs), take their input through `copy_to_tp` and
sum the proj / fc2 / conv partials with `reduce_from_tp`, adding the
replicated bias after the reduction: the Megatron pairing that GSPMD runs
for the JAX package's `shard_params_tp`. The state_dict keys stay the same;
the tensors are the shards. With `use_pallas` the packed attention op runs
on the rank's heads (whole heads: no collective) before the split proj.
A dropout site on a split tensor (the attention weights' heads, the MLP's
hidden channels) draws the whole tensor's mask and keeps the rank's block,
so the ranks apply one process's draws.

Sub-module names follow the flax names (norm1, attn.wq, mlp.fc1, ...), so a
flax parameter path maps onto a state_dict key by renaming leaves only
(`utils.weights_h5.params_from_jax`). Activations are (B, S, C), as in the
JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import scaled_dot_product_attention
from ..ops.packed_attention import MAX_SEQ, packed_multihead_attention
from ..parallel.sharding import TensorParallel, active, copy_to_tp, reduce_from_tp
from ..precision import current, rung_conv1d, rung_linear

# flax's truncated_normal(stddev) samples N(0, 1) truncated to [-2, 2] and
# divides by this constant (the std of that truncated law), so the draw has
# std exactly `stddev`.
_TRUNC_STD = 0.87962566103423978


def glorot_uniform_(weight: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator]) -> None:
    """Keras/flax glorot_uniform on any weight layout, given its fans."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-limit, limit, generator=generator)


def pe_init_(t: torch.Tensor, generator: Optional[torch.Generator],
             stddev: float = 0.02) -> None:
    """flax truncated_normal(0.02), used for the PEs and learned tokens."""
    s = stddev / _TRUNC_STD
    nn.init.trunc_normal_(t, mean=0.0, std=s, a=-2.0 * s, b=2.0 * s,
                          generator=generator)


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    return t if t is None or dtype is None else t.to(dtype)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """flax's `y += bias` after the product, in the product's dtype (a second
    rounding on bf16 tensors)."""
    return y if bias is None else y + bias.to(dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax's Dense(dtype=`dtype`), weight (out, in): for bf16 the product of
    bf16 tensors (input and weight cast; fp32 sums, a bf16 output), then the
    bias added in bf16; otherwise at the matmul precision context's rung, x
    cast to `dtype` first."""
    if dtype == torch.bfloat16:
        return _add_bias(F.linear(x.to(dtype), weight.to(dtype)), bias, dtype)
    return rung_linear(_cast(x, dtype), weight, bias)


class Dense(nn.Linear):
    """nn.Linear whose product follows the matmul precision context, or
    runs on `dtype` tensors (`linear`)."""

    dtype: Optional[torch.dtype] = None

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.dtype)


class StridedConv1d(nn.Conv1d):
    """nn.Conv1d (VALID) whose products follow the matmul precision context,
    or run on bf16 tensors at `dtype` bfloat16."""

    dtype: Optional[torch.dtype] = None

    def forward(self, x):
        return conv1d(x, self.weight, self.bias, self.stride[0], self.dtype)


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The VALID conv as `linear` takes its product: on bf16 tensors at bf16,
    the bias added after it."""
    if dtype == torch.bfloat16:
        y = F.conv1d(x.to(dtype), weight.to(dtype), None, stride)
        return y if bias is None else y + bias.to(dtype)[:, None]
    return rung_conv1d(_cast(x, dtype), weight, bias, stride)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm; with `dtype`, flax's LayerNorm(dtype=...): the input
    widened to fp32, its statistics as flax takes them (E[x²] - E[x]², the
    fast variance, clipped at 0), (x - mean) · (rsqrt(var + eps) · scale) +
    bias in fp32, the output in `dtype`."""

    dtype: Optional[torch.dtype] = None

    def forward(self, x):
        if self.dtype is None:
            return super().forward(x)
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


def set_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """`dtype` on every Dense, conv and LayerNorm under `module`."""
    for m in module.modules():
        if isinstance(m, (Dense, StridedConv1d, LayerNorm)):
            m.dtype = dtype


def dense(in_features: int, out_features: int, bias: bool = True,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A Dense with the flax Dense init (glorot-uniform kernel, zero bias)."""
    layer = Dense(in_features, out_features, bias=bias)
    glorot_uniform_(layer.weight, in_features, out_features, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU; on bf16 tensors jax.nn.gelu's bf16 arithmetic,
    0.5·x·erfc(-x·bf16(sqrt(0.5))), each operation rounded to bf16."""
    if x.dtype == torch.bfloat16:
        half = torch.tensor(0.5 ** 0.5, dtype=torch.bfloat16)
        return 0.5 * x * torch.erfc(-x * half)
    return F.gelu(x, approximate="none")


class DropPath(nn.Module):
    """Stochastic depth on the batch dim (counterpart of primitives.drop_path).

    In training, sample i is kept when floor(keep + U[0, 1)) = 1, keep =
    1 - rate, and kept samples are scaled by 1/keep. U is drawn on the CPU
    from `self.generator` (set by the train step; torch's default generator
    when None) and moved to x's device. With `self.rows` = (start, total),
    x holds rows [start, start + B) of a global batch of `total` (one rank's
    shard): U is drawn for the whole batch and those rows kept, so the ranks
    apply the 1-process draws.
    """

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.rows: Optional[Tuple[int, int]] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if self.rows is None:
            u = torch.rand(x.shape[0], generator=self.generator)
        else:
            start, total = self.rows
            u = torch.rand(total, generator=self.generator)[start:start + x.shape[0]]
        mask = torch.floor(keep + u).to(device=x.device, dtype=x.dtype)
        return (x / keep) * mask.reshape((-1,) + (1,) * (x.dim() - 1))


def _mp(tp: Optional[TensorParallel]) -> int:
    return 1 if active(tp) is None else tp.size


class Dropout(nn.Module):
    """flax's nn.Dropout: in training each element is kept when U[0, 1) <
    keep = 1 - rate and the output is where(kept, x / keep, 0) in x's dtype
    (zeros at rate 1); the identity under eval or at rate 0.

    U is drawn on x's device from `self.generator` (set by the train step;
    the device's default generator when None). `rows` = (start, count,
    total): x holds windows [start, start + count) of a batch of `total`
    along dim 0, each window dim 0's rows x.shape[0] / count (frames in
    the spatial stage): U is drawn for the whole batch and those rows kept.
    `part` = (dim, index, parts): x holds block `index` of `parts` equal
    blocks of dim `dim` (a tensor-parallel shard): U is drawn whole and the
    block kept. Both make a rank apply the one-process draws.

    Hooks: `fixed_keep`, a boolean mask of x's shape used instead of a draw;
    `stats`, a list to which each draw appends (kept count, elements).
    """

    def __init__(self, rate: float = 0.0, part: Optional[Tuple[int, int, int]] = None):
        super().__init__()
        self.rate = float(rate)
        self.part = part
        self.generator: Optional[torch.Generator] = None
        self.rows: Optional[Tuple[int, int, int]] = None
        self.fixed_keep: Optional[torch.Tensor] = None
        self.stats: Optional[list] = None

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        """The boolean keep mask of x's shape."""
        shape, index = list(x.shape), [slice(None)] * x.dim()
        if self.rows is not None:
            start, count, total = self.rows
            per = x.shape[0] // count
            shape[0] = total * per
            index[0] = slice(start * per, (start + count) * per)
        if self.part is not None:
            dim, block, parts = self.part
            dim %= x.dim()
            shape[dim] = x.shape[dim] * parts
            index[dim] = slice(block * x.shape[dim], (block + 1) * x.shape[dim])
        u = torch.rand(shape, generator=self.generator, device=x.device)
        return (u < 1.0 - self.rate)[tuple(index)]

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = self.fixed_keep if self.fixed_keep is not None else self.draw(x)
        if self.stats is not None:
            self.stats.append((keep.sum(), keep.numel()))
        return torch.where(keep.to(x.device), x / (1.0 - self.rate), torch.zeros_like(x))


def _scaled(y: torch.Tensor, droppath: nn.Module, scales) -> torch.Tensor:
    """A residual branch under stochastic depth: the block's DropPath, or the
    given per-sample scales."""
    if scales is None:
        return droppath(y)
    return y * scales.to(y.dtype).reshape((-1,) + (1,) * (y.dim() - 1))


def _part(tp: Optional[TensorParallel], dim: int) -> Optional[Tuple[int, int, int]]:
    """A dropout site's `part` on a tensor split over mp along `dim`."""
    tp = active(tp)
    return None if tp is None else (dim, tp.rank, tp.size)


class Mlp(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_features: Optional[int] = None,
                 activation: Callable = gelu_exact, dropout: float = 0.0,
                 inner_dropout: float = 0.0, generator=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        hidden = out_features if hidden_features is None else hidden_features
        self.tp = active(tp)
        self.fc1 = dense(in_features, hidden // _mp(tp), generator=generator)
        self.fc2 = dense(hidden // _mp(tp), out_features, generator=generator)
        self.activation = activation
        self.inner_drop = Dropout(inner_dropout, part=_part(tp, -1))
        self.drop = Dropout(dropout)

    def forward(self, x):
        if self.tp is None:
            return self.drop(self.fc2(self.inner_drop(self.activation(self.fc1(x)))))
        h = self.inner_drop(self.activation(self.fc1(copy_to_tp(x, self.tp))))
        part = linear(h, self.fc2.weight, None, self.fc2.dtype)
        return self.drop(reduce_from_tp(part, self.tp) + self.fc2.bias.to(part.dtype))


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 use_pallas: bool = False, generator=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        assert dim % num_heads == 0
        self.tp = active(tp)
        mp = _mp(tp)
        self.dim = dim // mp                 # the rank's heads × the head depth
        self.num_heads = num_heads // mp
        self.use_pallas = use_pallas
        self.wq = dense(dim, self.dim, bias=qkv_bias, generator=generator)
        self.wk = dense(dim, self.dim, bias=qkv_bias, generator=generator)
        self.wv = dense(dim, self.dim, bias=qkv_bias, generator=generator)
        self.proj = dense(self.dim, dim, generator=generator)
        self.attn_drop = Dropout(attn_drop, part=_part(tp, 1))
        self.proj_drop = Dropout(proj_drop)

    def _proj(self, out):
        if self.tp is None:
            return self.proj_drop(self.proj(out))
        part = linear(out, self.proj.weight, None, self.proj.dtype)
        return self.proj_drop(reduce_from_tp(part, self.tp) + self.proj.bias.to(part.dtype))

    def forward(self, x, mask=None):
        b, s, _ = x.shape
        depth = self.dim // self.num_heads
        if self.tp is not None:
            x = copy_to_tp(x, self.tp)
        # The JAX package's gate (primitives.py:95-98): packed q/k/v, a key
        # mask broadcast from (B, 1, 1, S), S <= 128, and no attention
        # dropout in training. Other cases take the split-head path there too.
        mask_ok = mask is None or (mask.dim() == 4 and mask.shape[1] == 1
                                   and mask.shape[2] == 1)
        packed_ok = self.attn_drop.rate == 0.0 or not self.training
        if self.use_pallas and packed_ok and mask_ok and s <= MAX_SEQ:
            if self.training:
                raise NotImplementedError(
                    "USE_PALLAS_ATTENTION in training without attention dropout: the "
                    "packed attention op has no backward, and the JAX step fails there "
                    "too (its Pallas kernel has no VJP)")
            key_mask = None if mask is None else mask[:, 0, 0, :].expand(b, s)
            # under mp > 1: the rank's whole heads, no collective before proj
            out = packed_multihead_attention(self.wq(x), self.wk(x), self.wv(x),
                                             key_mask, num_heads=self.num_heads,
                                             precision=current())
            return self._proj(out), None

        def split(t):
            return t.reshape(b, s, self.num_heads, depth).transpose(1, 2)

        out, weights = scaled_dot_product_attention(
            split(self.wq(x)), split(self.wk(x)), split(self.wv(x)), mask,
            weights_dropout=self.attn_drop)
        return self._proj(out.transpose(1, 2).reshape(b, s, self.dim)), weights


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then + mlp(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, attn_dropout: float = 0.0, dropout: float = 0.0,
                 inner_dropout: float = 0.0, drop_path_rate: float = 0.0,
                 activation: Callable = gelu_exact, use_pallas: bool = False,
                 generator=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, num_heads=num_heads, qkv_bias=qkv_bias,
                                       attn_drop=attn_dropout, proj_drop=dropout,
                                       use_pallas=use_pallas, generator=generator, tp=tp)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, dim, hidden_features=int(dim * mlp_ratio),
                       activation=activation, dropout=dropout, inner_dropout=inner_dropout,
                       generator=generator, tp=tp)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x, pos_encoding=None, mask=None, droppath=None):
        """droppath: (attention branch, MLP branch) per-sample scales in
        place of the DropPath draws, or None."""
        s_attn, s_mlp = (None, None) if droppath is None else droppath
        if pos_encoding is not None:
            x = x + pos_encoding
        y, attn = self.attn(self.norm1(x), mask=mask)
        x = x + _scaled(y, self.drop_path, s_attn)
        x = x + _scaled(self.mlp(self.norm2(x)), self.drop_path, s_mlp)
        return x, attn


def resolve_padding(padding, kernel_size: int) -> Tuple[int, int]:
    if padding is None:
        return kernel_size // 2, kernel_size // 2
    if isinstance(padding, int):
        return padding, padding
    return int(padding[0]), int(padding[1])


class StridedMlp(nn.Module):
    """FFN whose second layer is a strided temporal convolution."""

    def __init__(self, in_features: int, out_features: int,
                 hidden_features: Optional[int] = None,
                 activation: Callable = gelu_exact, dropout: float = 0.0,
                 inner_dropout: float = 0.0, kernel_size: int = 3,
                 stride: int = 1, padding=None, generator=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        hidden = out_features if hidden_features is None else hidden_features
        self.tp = active(tp)
        local = hidden // _mp(tp)
        self.pad = resolve_padding(padding, kernel_size)
        self.stride = stride
        self.fc1 = dense(in_features, local, generator=generator)
        self.fc2 = StridedConv1d(local, out_features, kernel_size, stride=stride)
        glorot_uniform_(self.fc2.weight, local * kernel_size,
                        out_features * kernel_size, generator)
        nn.init.zeros_(self.fc2.bias)
        self.activation = activation
        self.inner_drop = Dropout(inner_dropout, part=_part(tp, -1))
        self.drop = Dropout(dropout)

    def forward(self, x):  # (B, S, C_in) → (B, S_out, C_out)
        if self.tp is not None:
            x = copy_to_tp(x, self.tp)
        x = self.inner_drop(self.activation(self.fc1(x)))
        x = F.pad(x.transpose(1, 2), self.pad)  # explicit zero pad, then VALID
        if self.tp is None:
            return self.drop(self.fc2(x).transpose(1, 2))
        part = conv1d(x, self.fc2.weight, None, self.stride, self.fc2.dtype)
        return self.drop((reduce_from_tp(part, self.tp)
                          + self.fc2.bias.to(part.dtype)[:, None]).transpose(1, 2))


class StridedTransformerBlock(nn.Module):
    """Transformer block that shrinks sequence length by `stride`.

    The MLP branch is a StridedMlp; the residual path crops one frame at each
    *unpadded* end and then takes every `stride`-th frame.
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, attn_dropout: float = 0.0, dropout: float = 0.0,
                 inner_dropout: float = 0.0, drop_path_rate: float = 0.0,
                 activation: Callable = gelu_exact, kernel_size: int = 3,
                 stride: int = 3, padding=None, use_pallas: bool = False,
                 generator=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.stride = stride
        self.pad = resolve_padding(padding, kernel_size)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, num_heads=num_heads, qkv_bias=qkv_bias,
                                       attn_drop=attn_dropout, proj_drop=dropout,
                                       use_pallas=use_pallas, generator=generator, tp=tp)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = StridedMlp(dim, dim, hidden_features=int(dim * mlp_ratio),
                              activation=activation, dropout=dropout,
                              inner_dropout=inner_dropout, kernel_size=kernel_size,
                              stride=stride, padding=padding,
                              generator=generator, tp=tp)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x, pos_encoding=None, mask=None):
        if pos_encoding is not None:
            x = x + pos_encoding
        y, attn = self.attn(self.norm1(x), mask=mask)
        x = x + self.drop_path(y)
        z = self.drop_path(self.mlp(self.norm2(x)))
        identity = x
        if self.stride > 1:
            if self.pad[0] == 0:
                identity = identity[:, 1:]
            if self.pad[1] == 0:
                identity = identity[:, :-1]
            identity = identity[:, ::self.stride]
        return identity + z, attn
