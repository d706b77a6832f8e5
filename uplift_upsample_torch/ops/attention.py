"""Scaled dot-product attention (plain PyTorch).

Semantics of the reference (`vision_transformer.py:99-130`): logits scaled by
1/sqrt(head_dim); an optional additive mask with 1 marking *blocked* keys is
applied as `logits += mask * -1e9` before the softmax. The mask is a large
finite number, not -inf: a row whose keys are all blocked still gets a
softmax over them, as in the reference. Both products follow the matmul
precision context (`precision.rung_matmul`): on the bf16 rung q and k are
rounded as they are, the logits scaled after the product, and the
normalised weights rounded for the product with v.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..precision import rung_matmul


def scaled_dot_product_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, H, Sk, D)
    v: torch.Tensor,  # (B, H, Sk, D)
    mask: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Sq, Sk); 1 = blocked
):
    """Returns (output (B, H, Sq, D), attention weights (B, H, Sq, Sk))."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = rung_matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.to(logits.dtype) * -1e9
    weights = torch.softmax(logits, dim=-1)
    return rung_matmul(weights, v), weights
