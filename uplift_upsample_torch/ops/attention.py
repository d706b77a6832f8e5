"""Scaled dot-product attention (plain PyTorch).

Semantics of the reference (`vision_transformer.py:99-130`): logits scaled by
1/sqrt(head_dim); an optional additive mask with 1 marking *blocked* keys is
applied as `logits += mask * -1e9` before the softmax. The mask is a large
finite number, not -inf: a row whose keys are all blocked still gets a
softmax over them, as in the reference. Both products follow the matmul
precision context (`precision.rung_matmul`): on the bf16 rung q and k are
rounded as they are, the logits scaled after the product, and the
normalised weights rounded for the product with v.

On bf16 q, k and v (COMPUTE_DTYPE bfloat16) it is the JAX function's dtype
handling (`uplift_upsample_tpu/ops/attention.py:36-46`): fp32 logits from
the bf16 operands (exact products, fp32 sums), an fp32 softmax, the weights
rounded to bf16 for P·V with fp32 sums, and the context returned in bf16.

`weights_dropout` (attention dropout in training, a `primitives.Dropout`)
acts on the fp32 weights before P·V, as the flax attention drops them
(`uplift_upsample_tpu/models/primitives.py:109-113`); the dropped weights
are returned.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..precision import round_bf16, rung_matmul


def scaled_dot_product_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, H, Sk, D)
    v: torch.Tensor,  # (B, H, Sk, D)
    mask: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Sq, Sk); 1 = blocked
    weights_dropout: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Returns (output (B, H, Sq, D), attention weights (B, H, Sq, Sk))."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    dtype = q.dtype
    if dtype == torch.bfloat16:
        q, k, v = q.float(), k.float(), v.float()
        # the JAX function's fp32 factor, 1 / sqrt(fp32(D)) in fp32
        scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32))
    logits = rung_matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.to(logits.dtype) * -1e9
    weights = torch.softmax(logits, dim=-1)
    if weights_dropout is not None:
        weights = weights_dropout(weights)
    if dtype == torch.bfloat16:
        return rung_matmul(round_bf16(weights), v).to(dtype), weights
    return rung_matmul(weights, v), weights
