"""Row 11 — packed multi-head attention (counterpart of ops/pallas_attention.py).

`packed_multihead_attention(q, k, v, mask, num_heads=H)` computes
softmax(q kᵀ / sqrt(D) + mask · -1e9) v per head on q, k and v in the packed
(F, S, H·D) layout the projections produce, with an optional (F, S) key mask
(1 = blocked; additive and finite, so a row whose keys are all blocked still
takes a softmax over them). S <= 128, the JAX package's gate. On a CUDA
tensor it launches `csrc/attention.cu` (which replaces
`pallas_attention.packed_multihead_attention`); on a CPU tensor it runs
`packed_attention_plain`, the split-head math in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .attention import scaled_dot_product_attention

COUNTER = "packed_attention"
MAX_SEQ = 128


def packed_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *,
                           num_heads: int) -> torch.Tensor:
    """(F, S, C) q, k, v → (F, S, C) context, through the split-head path."""
    f, s, c = q.shape
    d = c // num_heads

    def split(t):
        return t.reshape(f, s, num_heads, d).transpose(1, 2)

    mask4 = None if mask is None else mask.to(q.dtype)[:, None, None, :]
    out, _ = scaled_dot_product_attention(split(q), split(k), split(v), mask4)
    return out.transpose(1, 2).reshape(f, s, c)


def packed_multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               mask: Optional[torch.Tensor] = None, *,
                               num_heads: int) -> torch.Tensor:
    """(F, S, C) → (F, S, C). CPU tensor: plain version; CUDA tensor: the kernel.

    mask: (F, S), 1/True = blocked key, or None.
    """
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, mask, num_heads=num_heads)
    f, s, c = q.shape
    if c % num_heads != 0 or s > MAX_SEQ:
        raise ValueError(f"packed attention takes S <= {MAX_SEQ} and C divisible by "
                         f"the heads; got S={s}, C={c}, heads={num_heads}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.check_cuda(name, t, shape=(f, s, c), device=q.device)
    key_mask = None
    if mask is not None:
        key_mask = mask.to(torch.float32).contiguous()
        cuda_lib.check_cuda("mask", key_mask, shape=(f, s), device=q.device)
    out = torch.empty_like(q)
    if f == 0:
        return out
    cuda_lib.launch("attention", "packed_attention_f32", COUNTER, q, k, v, key_mask, out,
                    f, s, c, num_heads)
    return out
