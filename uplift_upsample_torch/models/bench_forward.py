"""Fused eval forward: K1 spatial stack → s2t Dense → K2 temporal stack → K3
strided block 1 → the model's tail (counterpart of models/bench_forward.py,
non-tiled path).

Equivalent to `model(x, stride_mask)`'s central output. The s2t Dense, the
masked-token substitution, the temporal PE and the tail (strided blocks 2+
and head2, through the model's `strided_entry=1` splice) are plain PyTorch,
as the JAX package leaves them to XLA; with `use_pallas` the tail's attention
runs the packed attention op (row 11). On CUDA tensors the kernels run; on
CPU tensors their plain versions do.

`bench_forward` takes (B, N) windows, optionally keyframe-sparse
(`max_keyframes`); `shared_spatial_forward` takes the eval protocol's
deduplicated unique frames and gathers their features into windows. Both
may skip the first-block key mask when every window is all-real
(`assume_dense_mask`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.spatial import (pack_spatial_params, spatial_stack, spatial_stack_apply,
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
                  stride_mask: torch.Tensor, fused_params: Optional[Dict] = None,
                  max_keyframes: Optional[int] = None,
                  assume_dense_mask: bool = False) -> torch.Tensor:
    """Central-frame output (B, 17, 3) of the fused eval path.

    x2d_masked: (B, N, 17, 2) already masked at non-keyframes;
    stride_mask: (B, N) with 1/True on frames carrying real input.
    max_keyframes: keyframe-sparse spatial stage. The model replaces every
    masked frame's spatial output by the learned token, so K1 and the s2t
    Dense run only on a gathered (B, max_keyframes) subset of each window's
    frames, real-input frames first. Exact as long as no window has more
    real-input frames than that (the eval loop checks it on the host).
    None → dense (all N frames).
    assume_dense_mask: the caller promises stride_mask is all-ones, so K2
    runs without the first-block key mask (inert for all-real windows).
    """
    if fused_params is None:
        fused_params = prepare_fused_params(model)
    b, n = x2d_masked.shape[:2]
    if (max_keyframes is not None and model.has_strided_input
            and 0 < max_keyframes < n):
        smb = stride_mask.to(torch.bool)
        frame_ids = torch.arange(n, device=x2d_masked.device)[None, :]
        # Keyframe positions ascending, padded (beyond the window's real
        # count) with non-keyframe positions whose features are never read.
        order = torch.argsort(torch.where(smb, frame_ids, n + frame_ids),
                              dim=1)[:, :max_keyframes]              # (B, KF)
        xg = torch.gather(x2d_masked, 1, order[:, :, None, None].expand(
            -1, -1, *x2d_masked.shape[2:]))
        y = model.spatial_to_temporal_fc(_spatial(model, xg, fused_params))
        # inverse gather: frame t ← its keyframe rank (masked frames point at
        # an arbitrary real row; the token substitution replaces them)
        inv = (torch.cumsum(smb.to(torch.int64), dim=1) - 1).clamp(min=0)
        y = torch.gather(y, 1, inv[:, :, None].expand(-1, -1, y.shape[-1]))
    else:
        y = model.spatial_to_temporal_fc(_spatial(model, x2d_masked, fused_params))
    return _post_s2t(model, y, stride_mask, fused_params, assume_dense_mask)


@torch.inference_mode()
def shared_spatial_forward(model: UpliftUpsampleTransformer, unique2d: torch.Tensor,
                           win_idx: torch.Tensor, stride_mask: torch.Tensor,
                           fused_params: Optional[Dict] = None,
                           assume_dense_mask: bool = False) -> torch.Tensor:
    """Fused eval forward with a cross-window SHARED spatial stage.

    In the window-sparse eval protocol consecutive computed windows overlap
    in all but one of their N frames, and the spatial stage plus the s2t
    Dense are frame-independent, so K1 and the Dense run once per unique
    masked frame and the features are gathered into windows; the temporal
    and strided stages are the dense path's.

    unique2d: (U, 17, 2) deduplicated, already-masked frames (all masked
      frames collapse into the one all-zeros row, whose features the token
      substitution discards). Rows beyond the real unique count are padding
      and never indexed.
    win_idx: (B, N) integer — each window token's row in unique2d.
    stride_mask: (B, N) — 1/True on real-input frames.
    """
    if fused_params is None:
        fused_params = prepare_fused_params(model)
    sp = spatial_stack(unique2d.contiguous(), fused_params["spatial"],
                       num_heads=model.num_heads,
                       packed=fused_params["spatial_packed"])      # (U, P·C)
    y_u = model.spatial_to_temporal_fc(sp)                         # (U, C)
    return _post_s2t(model, y_u[win_idx], stride_mask, fused_params, assume_dense_mask)


def _spatial(model, x2d, fused_params):
    return spatial_stack_apply(fused_params["spatial"], x2d, num_heads=model.num_heads,
                               packed=fused_params["spatial_packed"])  # (B, N, P·C)


def _post_s2t(model: UpliftUpsampleTransformer, y: torch.Tensor,
              stride_mask: torch.Tensor, fused_params: Dict,
              assume_dense_mask: bool = False) -> torch.Tensor:
    """Masked-token substitution + temporal PE + K2 + K3 + tail.

    y: (B, N, temporal_d) spatial_to_temporal output (pre-substitution).
    """
    key_mask = None
    if model.has_strided_input:
        sm = stride_mask.to(y.dtype)[..., None]
        y = sm * y + (1.0 - sm) * model.strided_input_token
        if not assume_dense_mask:
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
