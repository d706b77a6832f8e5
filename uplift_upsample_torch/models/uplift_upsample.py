"""UpliftUpsampleTransformer (nn.Module).

Architecture parity with reference `uplift_upsample_transformer.py:163-421`,
as the JAX package's `models/uplift_upsample.py` implements it:

  input (B, N, 17, 2) masked 2D keypoints [+ (B, N) stride mask]
  → spatial transformer over joints, frame-independent (d=spatial_d_model)
  → LayerNorm(eps 1e-6) → Linear to temporal width (d=temporal_d_model)
  → learned-token substitution at masked frames → + temporal PE
  → temporal transformer over frames (first K blocks optionally blocking
    attention *keys* at masked frames)
  → head1: Linear(3*K) on every frame → "upsampling" output (B, N, 17, 3)
  → strided transformer stack shrinking N → 1
  → head2: Linear(3*K) on the final token → central-frame output (B, 17, 3)

`model.train()` turns on stochastic depth (DropPath) in every block, the
training forward of the JAX model (`uplift_upsample.py:112-268`); the train
step runs the spatial and temporal stacks through their kernels and only the
tail (the `temporal_input` splice) through this module. Output BatchNorm,
dropout, random token masking and `use_pallas` (USE_PALLAS_ATTENTION: the
packed attention op, row 11, in every attention layer) in training are not
ported and raise NotImplementedError. Sub-modules carry the flax names
(`spatial_block_1`, `temporal_pe`, ...), so state_dict keys map one to one
onto the JAX package's parameter paths.

With `tp` (tensor parallelism, mp > 1) every block holds its mp rank's shard
of the attention and MLP weights (`primitives.py`); the embedding, the PEs
and tokens, the LayerNorms, the s2t Dense and the heads are replicated. mp
must divide the heads and the hidden width of every stack (ValueError).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import TensorParallel, active, check_divides
from .primitives import (StridedTransformerBlock, TransformerBlock, dense,
                         gelu_exact, pe_init_)


def strided_sequence_lengths(num_frames: int, strides, paddings) -> list:
    """Per-strided-block input lengths, ending with the final output length."""
    lengths = [num_frames]
    seq_len = num_frames
    for i, s in enumerate(strides):
        p = (1, 1) if paddings is None else paddings[i]
        seq_len = math.ceil((seq_len + p[0] + p[1] - 2) / s)
        lengths.append(seq_len)
    return lengths


class UpliftUpsampleTransformer(nn.Module):
    def __init__(self, full_output: bool = True, num_frames: int = 9,
                 num_keypoints: int = 17, spatial_d_model: int = 16,
                 temporal_d_model: int = 256, spatial_depth: int = 3,
                 temporal_depth: int = 3, strides: Sequence[int] = (3, 3, 3),
                 paddings: Optional[Sequence[Sequence[int]]] = None,
                 num_heads: int = 8, mlp_ratio: float = 2.0,
                 qkv_bias: bool = True,
                 drop_path_rate: Union[float, Sequence[float]] = 0.0,
                 output_bn: bool = False, has_strided_input: bool = False,
                 first_strided_token_attention_layer: int = 0,
                 token_mask_rate: float = 0.0,
                 learnable_masked_token: bool = False,
                 use_pallas: bool = False,
                 generator: Optional[torch.Generator] = None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.tp = tp = active(tp)
        if tp is not None:
            for stack, depth, width in (("spatial", spatial_depth, spatial_d_model),
                                        ("temporal", temporal_depth, temporal_d_model),
                                        ("strided", len(strides), temporal_d_model)):
                if depth > 0:
                    check_divides(tp.size, num_heads, int(width * mlp_ratio), stack)
        self.full_output = full_output
        self.num_frames = num_frames
        self.num_keypoints = num_keypoints
        self.spatial_d_model = spatial_d_model
        self.temporal_d_model = temporal_d_model
        self.spatial_depth = spatial_depth
        self.temporal_depth = temporal_depth
        self.strides = tuple(strides)
        self.paddings = (None if paddings is None
                         else tuple(tuple(int(v) for v in p) for p in paddings))
        self.num_heads = num_heads
        self.output_bn = output_bn
        self.has_strided_input = has_strided_input
        self.first_strided_token_attention_layer = first_strided_token_attention_layer
        self.token_mask_rate = token_mask_rate
        self.learnable_masked_token = learnable_masked_token
        self.use_pallas = use_pallas
        g = generator
        p, cs, ct = num_keypoints, spatial_d_model, temporal_d_model

        def dpr(stage, depth):
            rate = drop_path_rate
            top = rate[stage] if isinstance(rate, (list, tuple)) else rate
            if depth <= 1:
                return [0.0] * depth
            return [top * i / (depth - 1) for i in range(depth)]

        if spatial_depth > 0:
            self.keypoint_embedding = dense(2, cs, generator=g)
            self.spatial_pe = nn.Parameter(torch.empty(p, cs))
            pe_init_(self.spatial_pe, g)
            for i, rate in enumerate(dpr(0, spatial_depth)):
                self.add_module(f"spatial_block_{i + 1}", TransformerBlock(
                    cs, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                    drop_path_rate=rate, activation=gelu_exact,
                    use_pallas=use_pallas, generator=g, tp=tp))
            self.spatial_norm = nn.LayerNorm(cs, eps=1e-6)
            s2t_in = p * cs
        else:
            s2t_in = p * 2
        self.spatial_to_temporal_fc = dense(s2t_in, ct, generator=g)
        if token_mask_rate > 0 and learnable_masked_token:
            self.masked_token = nn.Parameter(torch.empty(ct))
            pe_init_(self.masked_token, g)
        self.temporal_pe = nn.Parameter(torch.empty(num_frames, ct))
        pe_init_(self.temporal_pe, g)
        if has_strided_input:
            self.strided_input_token = nn.Parameter(torch.empty(ct))
            pe_init_(self.strided_input_token, g)
        for i, rate in enumerate(dpr(1, temporal_depth)):
            self.add_module(f"temporal_block_{i + 1}", TransformerBlock(
                ct, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                drop_path_rate=rate, activation=F.relu, use_pallas=use_pallas,
                generator=g, tp=tp))

        out_dim = 3 * num_keypoints
        if full_output and temporal_depth > 0:
            if output_bn:
                self.temporal_norm = nn.BatchNorm1d(ct, eps=1e-5)
            self.temporal_fc = dense(ct, out_dim, generator=g)
        seq_lengths = strided_sequence_lengths(num_frames, self.strides,
                                               self.paddings)
        for i, (s, rate) in enumerate(zip(self.strides,
                                          dpr(2, len(self.strides)))):
            pe = nn.Parameter(torch.empty(seq_lengths[i], ct))
            pe_init_(pe, g)
            self.register_parameter(f"strided_temporal_pe_{i + 1}", pe)
            pad = None if self.paddings is None else self.paddings[i]
            self.add_module(f"strided_temporal_block_{i + 1}",
                            StridedTransformerBlock(
                                ct, num_heads, mlp_ratio=mlp_ratio,
                                qkv_bias=qkv_bias, drop_path_rate=rate,
                                activation=F.relu, kernel_size=3, stride=s,
                                padding=pad, use_pallas=use_pallas, generator=g,
                                tp=tp))
        if output_bn:
            self.strided_temporal_norm = nn.BatchNorm1d(ct, eps=1e-5)
        self.strided_temporal_fc = dense(ct, out_dim, generator=g)

    def block(self, name: str, i: int) -> nn.Module:
        """Block i (1-based) of a stage: "spatial", "temporal" or "strided_temporal"."""
        return getattr(self, f"{name}_block_{i}")

    def forward(self, x, stride_mask=None, *, temporal_input: bool = False,
                strided_entry: int = 0, spatial_input: bool = False,
                s2t_output: bool = False, s2t_input: bool = False):
        """x: (B, N, K, 2) [already masked at non-keyframes when strided input].

        Splices (the JAX model's flags of the same names, uplift_upsample.py:
        78-102), for the eval paths that run a stage outside the module:
          - `spatial_input`: x is the spatial-stack output (B, N, P·C_sp);
          - `s2t_output`: return the s2t Dense output (B, N, C) instead of the
            heads. The prefix is frame-independent, so N may differ from
            num_frames (the shared-spatial step passes N = 1);
          - `s2t_input`: x is that (B, N, C) output; the rest runs;
          - `temporal_input`: x is the temporal-stack output (B, N, C) and only
            the heads and the strided stack run; `strided_entry` leading
            strided blocks have then been applied already (the fused path's
            K3) and head1 is skipped.
        Returns (full_output | None, central (B, K, 3)), or the s2t output.
        """
        p = self.num_keypoints
        if self.training and (self.output_bn or self.token_mask_rate > 0):
            raise NotImplementedError(
                "training with OUTPUT_BN or TOKEN_MASK_RATE > 0 is not ported")
        if temporal_input:
            return self._heads_and_strided(x, stride_mask, strided_entry)
        b, n = x.shape[:2]
        if not (spatial_input or s2t_input):
            assert x.shape[2] == p and (n == self.num_frames or s2t_output), x.shape
        x = x.to(self.temporal_pe.dtype)  # float32, or float64 for a float64 model

        # ---- spatial transformer over joints (frame-independent) ----------
        if spatial_input or s2t_input:
            pass  # x is already the spatial-stack (or s2t) output
        elif self.spatial_depth == 0:
            x = x.reshape(b, n, p * x.shape[-1])
        else:
            x = x.reshape(b * n, p, x.shape[-1])
            x = self.keypoint_embedding(x) + self.spatial_pe
            for i in range(1, self.spatial_depth + 1):
                x, _ = self.block("spatial", i)(x)
            x = self.spatial_norm(x).reshape(b, n, p * self.spatial_d_model)
        if not s2t_input:
            x = self.spatial_to_temporal_fc(x)
        if s2t_output:
            return x

        # ---- temporal transformer over frames -----------------------------
        if self.has_strided_input:
            sm = stride_mask.to(x.dtype)[..., None]
            x = sm * x + (1.0 - sm) * self.strided_input_token
        x = x + self.temporal_pe
        for i in range(1, self.temporal_depth + 1):
            attn_mask = None
            if (self.has_strided_input
                    and i <= self.first_strided_token_attention_layer):
                # Block attention onto masked-frame keys for early layers
                attn_mask = (1.0 - stride_mask.float())[:, None, None, :]
            x, _ = self.block("temporal", i)(x, mask=attn_mask)
        return self._heads_and_strided(x, stride_mask, 0)

    def _bn(self, name, h):
        bn = getattr(self, name)
        shape = h.shape
        return F.batch_norm(h.reshape(-1, shape[-1]), bn.running_mean,
                            bn.running_var, bn.weight, bn.bias, training=False,
                            eps=bn.eps).reshape(shape)

    def _heads_and_strided(self, x, stride_mask, strided_entry: int):
        """head1 + strided stack + head2 (the post-temporal tail)."""
        b, n = x.shape[:2]
        p = self.num_keypoints
        full_output = None
        if self.full_output and self.temporal_depth > 0 and strided_entry == 0:
            h = self._bn("temporal_norm", x) if self.output_bn else x
            full_output = self.temporal_fc(h).reshape(b, n, p, 3)

        if self.strides:
            for i in range(strided_entry, len(self.strides)):
                attn_mask = None
                if (self.temporal_depth == 0 and self.has_strided_input
                        and i < self.first_strided_token_attention_layer):
                    # Deferred upsampling-token attention (no temporal blocks)
                    attn_mask = (1.0 - stride_mask.float())[:, None, None, :]
                x, _ = self.block("strided_temporal", i + 1)(
                    x, pos_encoding=getattr(self, f"strided_temporal_pe_{i + 1}"),
                    mask=attn_mask)
            central = x
        else:
            central = x[:, self.num_frames // 2][:, None, :]
        if self.output_bn:
            central = self._bn("strided_temporal_norm", central)
        central = self.strided_temporal_fc(central).reshape(b, p, 3)
        return full_output, central
