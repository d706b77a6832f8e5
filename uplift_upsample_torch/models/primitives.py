"""Transformer primitives (nn.Module).

Numeric parity targets (reference `vision_transformer.py`, strided variants in
`uplift_upsample_transformer.py:53-160`), as in the JAX package:
  - MHA with *separate* q/k/v projections and optional bias; per-head scaling
    1/sqrt(head_dim); additive `mask * -1e9` with 1 = blocked key. With
    `use_pallas` (USE_PALLAS_ATTENTION) it runs the packed attention op
    (`ops/packed_attention.py`, row 11) where the JAX package runs its Pallas
    kernel: S <= 128 and no mask or a (B, 1, 1, S) key mask.
  - Pre-norm blocks with LayerNorm eps 1e-5.
  - MLP: Linear(hidden) → act → Linear(out).
  - StridedMlp: pointwise Linear → act → explicit zero-pad →
    Conv1d(k=3, stride=s, VALID); this is the temporal downsampler.
  - StridedTransformerBlock's residual path: crop one frame per unpadded end,
    then take every s-th frame (MaxPool1D(pool_size=1, strides=s) semantics).
  - DropPath (stochastic depth) drops whole samples with probability rate and
    scales the kept ones by 1/keep in training (`model.train()`); it is the
    identity under `model.eval()`.
  - Products follow the matmul precision context (`precision.py`): the Dense
    layers (`Dense`), the strided conv (`StridedConv1d`) and the attention's
    two products round their operands to bf16 on the "default" rung and run
    as nn.Linear / nn.Conv1d / fp32 matmuls on the others. The packed
    attention op has no bf16 rung and raises there (ROADMAP A8).

Tensor parallelism (`tp`, a `parallel.sharding.TensorParallel` with size >
1): MultiHeadAttention, Mlp and StridedMlp hold their mp rank's shard (the
rank's heads, with the head depth unchanged; its block of fc1's outputs and
of fc2's or the conv's inputs), take their input through `copy_to_tp` and
sum the proj / fc2 / conv partials with `reduce_from_tp`, adding the
replicated bias after the reduction: the Megatron pairing that GSPMD runs
for the JAX package's `shard_params_tp`. The state_dict keys stay the same;
the tensors are the shards.

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
from ..precision import BF16, current, rung_conv1d, rung_linear

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


class Dense(nn.Linear):
    """nn.Linear whose product follows the matmul precision context."""

    def forward(self, x):
        return rung_linear(x, self.weight, self.bias)


class StridedConv1d(nn.Conv1d):
    """nn.Conv1d (VALID) whose products follow the matmul precision context."""

    def forward(self, x):
        return rung_conv1d(x, self.weight, self.bias, self.stride[0])


def dense(in_features: int, out_features: int, bias: bool = True,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A Dense with the flax Dense init (glorot-uniform kernel, zero bias)."""
    layer = Dense(in_features, out_features, bias=bias)
    glorot_uniform_(layer.weight, in_features, out_features, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
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


class Mlp(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 hidden_features: Optional[int] = None,
                 activation: Callable = gelu_exact, generator=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        hidden = out_features if hidden_features is None else hidden_features
        self.tp = active(tp)
        self.fc1 = dense(in_features, hidden // _mp(tp), generator=generator)
        self.fc2 = dense(hidden // _mp(tp), out_features, generator=generator)
        self.activation = activation

    def forward(self, x):
        if self.tp is None:
            return self.fc2(self.activation(self.fc1(x)))
        h = self.activation(self.fc1(copy_to_tp(x, self.tp)))
        return reduce_from_tp(rung_linear(h, self.fc2.weight), self.tp) + self.fc2.bias


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 use_pallas: bool = False, generator=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        assert dim % num_heads == 0
        self.tp = active(tp)
        if self.tp is not None and use_pallas:
            raise NotImplementedError(
                "USE_PALLAS_ATTENTION under tensor parallelism (mp > 1) is not ported: "
                "row 11 has no split (ROADMAP A6)")
        mp = _mp(tp)
        self.dim = dim // mp                 # the rank's heads × the head depth
        self.num_heads = num_heads // mp
        self.use_pallas = use_pallas
        self.wq = dense(dim, self.dim, bias=qkv_bias, generator=generator)
        self.wk = dense(dim, self.dim, bias=qkv_bias, generator=generator)
        self.wv = dense(dim, self.dim, bias=qkv_bias, generator=generator)
        self.proj = dense(self.dim, dim, generator=generator)

    def forward(self, x, mask=None):
        b, s, _ = x.shape
        depth = self.dim // self.num_heads
        if self.tp is not None:
            x = copy_to_tp(x, self.tp)
        # The JAX package's gate (primitives.py:95-98): packed q/k/v, a key
        # mask broadcast from (B, 1, 1, S), S <= 128. Other shapes take the
        # split-head path there too.
        mask_ok = mask is None or (mask.dim() == 4 and mask.shape[1] == 1
                                   and mask.shape[2] == 1)
        if self.use_pallas and mask_ok and s <= MAX_SEQ:
            if self.training:
                raise NotImplementedError(
                    "USE_PALLAS_ATTENTION in training is not ported (the packed "
                    "attention op has no backward)")
            if current() == BF16:
                raise NotImplementedError(
                    "USE_PALLAS_ATTENTION on the bf16 rung (matmul precision 'default') "
                    "is not ported: the packed attention op runs fp32 only (ROADMAP A8)")
            key_mask = None if mask is None else mask[:, 0, 0, :].expand(b, s)
            out = packed_multihead_attention(self.wq(x), self.wk(x), self.wv(x),
                                             key_mask, num_heads=self.num_heads)
            return self.proj(out), None

        def split(t):
            return t.reshape(b, s, self.num_heads, depth).transpose(1, 2)

        out, weights = scaled_dot_product_attention(
            split(self.wq(x)), split(self.wk(x)), split(self.wv(x)), mask)
        out = out.transpose(1, 2).reshape(b, s, self.dim)
        if self.tp is None:
            return self.proj(out), weights
        return reduce_from_tp(rung_linear(out, self.proj.weight), self.tp) + self.proj.bias, weights


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then + mlp(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path_rate: float = 0.0,
                 activation: Callable = gelu_exact, use_pallas: bool = False,
                 generator=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, num_heads=num_heads, qkv_bias=qkv_bias,
                                       use_pallas=use_pallas, generator=generator, tp=tp)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, dim, hidden_features=int(dim * mlp_ratio),
                       activation=activation, generator=generator, tp=tp)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x, pos_encoding=None, mask=None):
        if pos_encoding is not None:
            x = x + pos_encoding
        y, attn = self.attn(self.norm1(x), mask=mask)
        x = x + self.drop_path(y)
        x = x + self.drop_path(self.mlp(self.norm2(x)))
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
                 activation: Callable = gelu_exact, kernel_size: int = 3,
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

    def forward(self, x):  # (B, S, C_in) → (B, S_out, C_out)
        if self.tp is not None:
            x = copy_to_tp(x, self.tp)
        x = self.activation(self.fc1(x))
        x = F.pad(x.transpose(1, 2), self.pad)  # explicit zero pad, then VALID
        if self.tp is None:
            return self.fc2(x).transpose(1, 2)
        part = rung_conv1d(x, self.fc2.weight, None, self.stride)
        return (reduce_from_tp(part, self.tp) + self.fc2.bias[:, None]).transpose(1, 2)


class StridedTransformerBlock(nn.Module):
    """Transformer block that shrinks sequence length by `stride`.

    The MLP branch is a StridedMlp; the residual path crops one frame at each
    *unpadded* end and then takes every `stride`-th frame.
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path_rate: float = 0.0,
                 activation: Callable = gelu_exact, kernel_size: int = 3,
                 stride: int = 3, padding=None, use_pallas: bool = False,
                 generator=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.stride = stride
        self.pad = resolve_padding(padding, kernel_size)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, num_heads=num_heads, qkv_bias=qkv_bias,
                                       use_pallas=use_pallas, generator=generator, tp=tp)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = StridedMlp(dim, dim, hidden_features=int(dim * mlp_ratio),
                              activation=activation, kernel_size=kernel_size,
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
