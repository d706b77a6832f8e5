"""The evaluation step with flip-TTA (counterpart of eval.py's make_test_step).

The eval CLI, its metrics and dataset loaders come with the next slice; the
serving CLI (`predict.py`) uses this step.
"""

from __future__ import annotations

import numpy as np
import torch


def make_test_step(model, flip_tta: bool, flip_lr_indices, fused: str = "none",
                   tta_batched: bool = True):
    """Forward step with optional flip-TTA.

    `fused` selects the compute path:
      - "full": the kernel path of `models.bench_forward` (K1 spatial stack,
        s2t Dense, K2 temporal stack, K3 strided block 1, plain tail). Central
        prediction only. On CPU tensors the kernels' plain versions run.
      - "none": the plain model.
    "full" needs a spatial and a temporal stack; otherwise the plain model runs.

    `tta_batched`: run flip-TTA as ONE forward on the concatenated
    [unflipped; flipped] batch instead of two forwards (the same math,
    batched).

    Returns fn(keypoints2d (B,N,K,2) unmasked, stride_mask (B,N) bool)
    → (pred_sequence (B,N,K,3) | None, pred_central (B,K,3)).
    """
    device = next(model.parameters()).device
    flip_idx = torch.as_tensor(np.asarray(flip_lr_indices, dtype=np.int64),
                               device=device)

    if fused == "full" and model.spatial_depth > 0 and model.temporal_depth > 0:
        from .models.bench_forward import bench_forward, prepare_fused_params
        fused_params = prepare_fused_params(model)

        def forward(keypoints2d, stride_mask):
            x = keypoints2d
            if model.has_strided_input:
                x = x * stride_mask[:, :, None, None].to(x.dtype)
            return None, bench_forward(model, x, stride_mask, fused_params)
    elif fused in ("full", "none"):
        def forward(keypoints2d, stride_mask):
            x = keypoints2d
            if model.has_strided_input:
                x = x * stride_mask[:, :, None, None].to(x.dtype)
                return model(x, stride_mask)
            return model(x)
    else:
        raise ValueError(f"fused must be 'full' or 'none', got {fused!r}")

    def flip_in(frames):
        """x-negate + L/R joint swap; frames is (..., K, 2)."""
        flipped = torch.cat([-frames[..., :1], frames[..., 1:]], dim=-1)
        return flipped.index_select(-2, flip_idx)

    def unflip_central(f_central):
        return torch.cat([-f_central[..., :1], f_central[..., 1:]],
                         dim=-1)[:, flip_idx]

    def unflip_seq(f_seq):
        return torch.cat([-f_seq[..., :1], f_seq[..., 1:]], dim=-1)[:, :, flip_idx]

    @torch.inference_mode()
    def step(keypoints2d, stride_mask):
        if flip_tta and tta_batched:
            b = keypoints2d.shape[0]
            both = torch.cat([keypoints2d, flip_in(keypoints2d)], dim=0)
            sm2 = torch.cat([stride_mask, stride_mask], dim=0)
            pred_seq2, central2 = forward(both, sm2)
            pred_central = (central2[:b] + unflip_central(central2[b:])) / 2.0
            pred_seq = None
            if pred_seq2 is not None:
                pred_seq = (pred_seq2[:b] + unflip_seq(pred_seq2[b:])) / 2.0
            return pred_seq, pred_central
        pred_seq, pred_central = forward(keypoints2d, stride_mask)
        if flip_tta:
            f_seq, f_central = forward(flip_in(keypoints2d), stride_mask)
            pred_central = (pred_central + unflip_central(f_central)) / 2.0
            if pred_seq is not None:
                pred_seq = (pred_seq + unflip_seq(f_seq)) / 2.0
        return pred_seq, pred_central

    return step
