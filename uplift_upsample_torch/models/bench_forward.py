"""Fused eval forward: K1 spatial stack → s2t Dense → K2 temporal stack → K3
strided block 1 → the model's tail (counterpart of models/bench_forward.py,
dense path).

Equivalent to `model(x, stride_mask)`'s central output. The s2t Dense, the
masked-token substitution, the temporal PE and the tail (strided blocks 2+
and head2, through the model's `strided_entry=1` splice) are plain PyTorch,
as the JAX package leaves them to XLA. On CUDA tensors the three kernels
run; on CPU tensors their plain versions do.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.spatial import (pack_spatial_params, spatial_stack_apply,
                           stack_spatial_params)
from ..ops.strided import stack_strided_block1_params, strided_block1
from ..ops.temporal import stack_temporal_params, temporal_stack
from .uplift_upsample import UpliftUpsampleTransformer


def can_fuse_strided(model: UpliftUpsampleTransformer) -> bool:
    """Whether strided block 1 runs as K3: a k=3 block with per-side conv
    padding ≤ 1 (every released config: h36m_351/amass (0,0), h36m_81 (1,1))."""
    if not (len(model.strides) > 0 and model.temporal_depth > 0
            and model.paddings is not None):
        return False
    p0, p1 = model.paddings[0]
    return 0 <= p0 <= 1 and 0 <= p1 <= 1


def prepare_fused_params(model: UpliftUpsampleTransformer) -> Dict:
    """The kernels' operands, stacked once from the model's weights."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    ops = dict(
        spatial=stack_spatial_params(state, model.spatial_depth),
        temporal=stack_temporal_params(state, model.temporal_depth),
        strided=(stack_strided_block1_params(state)
                 if can_fuse_strided(model) else None),
    )
    ops["spatial_packed"] = pack_spatial_params(ops["spatial"])
    return ops


@torch.inference_mode()
def bench_forward(model: UpliftUpsampleTransformer, x2d_masked: torch.Tensor,
                  stride_mask: torch.Tensor,
                  fused_params: Optional[Dict] = None) -> torch.Tensor:
    """Central-frame output (B, 17, 3) of the fused eval path.

    x2d_masked: (B, N, 17, 2) already masked at non-keyframes;
    stride_mask: (B, N) with 1/True on frames carrying real input.
    """
    if fused_params is None:
        fused_params = prepare_fused_params(model)
    sp = spatial_stack_apply(fused_params["spatial"], x2d_masked,
                             num_heads=model.num_heads,
                             packed=fused_params["spatial_packed"])  # (B, N, P·C)
    y = model.spatial_to_temporal_fc(sp)  # s2t Dense: plain torch, as in XLA
    return _post_s2t(model, y, stride_mask, fused_params)


def _post_s2t(model: UpliftUpsampleTransformer, y: torch.Tensor,
              stride_mask: torch.Tensor, fused_params: Dict) -> torch.Tensor:
    """Masked-token substitution + temporal PE + K2 + K3 + tail.

    y: (B, N, temporal_d) spatial_to_temporal output (pre-substitution).
    """
    key_mask = None
    if model.has_strided_input:
        sm = stride_mask.to(y.dtype)[..., None]
        y = sm * y + (1.0 - sm) * model.strided_input_token
        key_mask = 1.0 - stride_mask.to(torch.float32)
    y = y + model.temporal_pe
    fmb = (model.first_strided_token_attention_layer
           if model.has_strided_input else 0)
    y = temporal_stack(y, fused_params["temporal"], key_mask,
                       num_heads=model.num_heads, first_masked_blocks=fmb)
    entry = 0
    if fused_params["strided"] is not None:
        y = strided_block1(y, fused_params["strided"], num_heads=model.num_heads,
                           stride=model.strides[0], paddings=model.paddings[0])
        entry = 1
    _, central = model(y, stride_mask, temporal_input=True, strided_entry=entry)
    return central
