"""Fused eval forward (counterpart of models/bench_forward.py): K1 spatial
stack → s2t Dense → K2 temporal stack → K3 strided block 1 → the model's tail.

Equivalent to `model(x, stride_mask)`'s central output. The routes are the
JAX package's, each reaching its TPU kernels' counterparts (the kernel table
in PERF.md):
  - the default (`temporal_impl="v3"`, `temporal_attn="full"`): K1, the s2t
    Dense, the masked-token substitution and the temporal PE in plain
    PyTorch, K2, K3, then the tail (strided blocks 2+ and head2, through the
    model's `strided_entry=1` splice). `strided_sel` selects the TPU's
    selection epilogue (row 7): K3 already computes only the selected rows,
    so the launches are the same.
  - `temporal_attn="banded"` (row 6): K2's window attention is per window,
    which is what the TPU's band softmax computes; K3 runs only at paddings
    (0, 0), as the banded epilogue implements only that alignment, and
    otherwise the model's own strided stack runs in the tail.
  - `temporal_impl="v2"` (row 10): K2, no K3 (the v2 kernel has no strided
    epilogue), the whole strided stack in the tail.
  - `fuse_s2t=True` with "banded" and a K3 geometry: the tiled pipeline
    (`_tiled_forward`, rows 4 and 5): K1 on all B·N frames, the s2t
    prologue kernel (`ops/s2t.py`), K2, K3, the tail.
On CUDA tensors the kernels run; on CPU tensors their plain versions do.
With `use_pallas` the tail's attention runs the packed attention op (row 11).

`temporal_wpt` is the TPU temporal kernel's windows per tile: the port's
kernels lay windows out as rows, so it is accepted and changes no launch.

`precision` is the matmul rung (`precision.py`; the TPU's spatial and
temporal precisions, which the JAX eval step sets alike): "high" and
"highest" run the 3xTF32 kernels and the fp32 tail; "default", the one-pass
bf16 rung, runs the bf16 instances of K1, K2, K3 and the s2t kernel (K1's
17-token attention stays fp32, as on the TPU) and the plain products (the
s2t Dense, the tail) under `precision.matmul_precision("default")`, which
rounds their operands too. It needs `prepare_fused_params(model, "default")`
(the weights' bf16 planes), runs unsplit only (mp > 1 raises), and not with
`use_pallas` (row 11 has no bf16 rung: ROADMAP A8).

Under tensor parallelism (the model built with `tp`, mp > 1) the default
route runs K2 and K3 split over the mp ranks on the rank's operands
(`ops/temporal.py`, `ops/strided.py`), K1 on the spatial weights gathered
once when the operands are stacked (every mp peer computes the same
frames), and the tail's split modules. The other routes (banded, v2, tiled;
rows 4-7, 9, 10) raise NotImplementedError under mp > 1.

`bench_forward` takes (B, N) windows, optionally keyframe-sparse
(`max_keyframes`); `shared_spatial_forward` takes the eval protocol's
deduplicated unique frames and gathers their features into windows. Both
may skip the first-block key mask when every window is all-real
(`assume_dense_mask`); the tiled pipeline ignores `max_keyframes` and
`assume_dense_mask`, as the JAX one does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.s2t import s2t_params, s2t_prologue
from ..ops.spatial import (pack_spatial_params, spatial_stack, spatial_stack_apply,
                           stack_spatial_params)
from ..ops.strided import DENSE as STRIDED_DENSE
from ..ops.strided import stack_strided_block1_params, strided_block1
from ..ops.temporal import stack_temporal_params, temporal_stack
from ..ops.temporal import add_bf16_planes
from ..parallel.sharding import gather_params_tp
from ..precision import BF16, check_rung, current, matmul_precision
from .uplift_upsample import UpliftUpsampleTransformer

TEMPORAL_IMPLS = ("v3", "v2")
TEMPORAL_ATTNS = ("full", "banded")


def can_fuse_strided(model: UpliftUpsampleTransformer, temporal_impl: str = "v3",
                     temporal_attn: str = "full") -> bool:
    """Whether strided block 1 runs as K3 (`_can_fuse_strided`): the v3
    route, a k=3 block with per-side conv padding ≤ 1 (every released config:
    h36m_351/amass (0,0), h36m_81 (1,1)); with "banded" attention (0,0) only."""
    if temporal_impl not in TEMPORAL_IMPLS or temporal_attn not in TEMPORAL_ATTNS:
        raise ValueError(f"temporal_impl {temporal_impl!r} / temporal_attn "
                         f"{temporal_attn!r}: expected one of {TEMPORAL_IMPLS} / "
                         f"{TEMPORAL_ATTNS}")
    if not (len(model.strides) > 0 and model.temporal_depth > 0
            and model.paddings is not None and temporal_impl == "v3"):
        return False
    p0, p1 = model.paddings[0]
    if temporal_attn == "banded":
        return (p0, p1) == (0, 0)
    return 0 <= p0 <= 1 and 0 <= p1 <= 1


def check_tp_route(model: UpliftUpsampleTransformer, temporal_impl: str = "v3",
                   temporal_attn: str = "full", fuse_s2t: bool = False) -> None:
    """Under mp > 1 only the default route is split (ROADMAP A6)."""
    if model.tp is not None and (temporal_impl, temporal_attn, fuse_s2t) != ("v3", "full",
                                                                             False):
        raise NotImplementedError(
            f"the bench route temporal_impl={temporal_impl!r}, temporal_attn="
            f"{temporal_attn!r}, fuse_s2t={fuse_s2t} is not split for tensor parallelism "
            f"(mp > 1): only the default route is (ROADMAP A6, rows 4-7, 9, 10)")


def prepare_fused_params(model: UpliftUpsampleTransformer, precision: str = "high") -> Dict:
    """The kernels' operands, stacked once from the model's weights: under
    mp > 1 K2's and K3's from the rank's shards, K1's from the spatial
    weights gathered whole. On the bf16 rung (`precision` "default") also
    the dense weights' bf16 planes (K1 rounds its own as it stages them)."""
    bf16 = check_rung(precision, model.use_pallas, model.tp) == BF16
    state = {k: v.detach() for k, v in model.state_dict().items()}
    whole = gather_params_tp(state, model.tp)
    ops = dict(
        spatial=stack_spatial_params(whole, model.spatial_depth),
        temporal=stack_temporal_params(state, model.temporal_depth),
        strided=(stack_strided_block1_params(state)
                 if can_fuse_strided(model) else None),
        s2t=s2t_params(model, precision),
    )
    if bf16:
        ops["temporal"] = add_bf16_planes(ops["temporal"])
        if ops["strided"] is not None:
            ops["strided"] = add_bf16_planes(ops["strided"], STRIDED_DENSE)
    ops["spatial_packed"] = pack_spatial_params(ops["spatial"])
    return ops


@torch.inference_mode()
def bench_forward(model: UpliftUpsampleTransformer, x2d_masked: torch.Tensor,
                  stride_mask: torch.Tensor, fused_params: Optional[Dict] = None,
                  max_keyframes: Optional[int] = None,
                  assume_dense_mask: bool = False, *, temporal_impl: str = "v3",
                  temporal_wpt: int = 4, temporal_attn: str = "full",
                  fuse_s2t: bool = False, strided_sel: bool = False,
                  precision: Optional[str] = None) -> torch.Tensor:
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
    temporal_impl, temporal_wpt, temporal_attn, fuse_s2t, strided_sel: the
    routes of the module docstring. precision: the matmul rung (module
    docstring); None takes the current `matmul_precision` context's.
    """
    del temporal_wpt, strided_sel  # the same launches on every value
    check_tp_route(model, temporal_impl, temporal_attn, fuse_s2t)
    rung = check_rung(current() if precision is None else precision, model.use_pallas, model.tp)
    if fused_params is None:
        fused_params = prepare_fused_params(model, rung)
    with matmul_precision(rung):
        return _bench_forward(model, x2d_masked, stride_mask, fused_params, max_keyframes,
                              assume_dense_mask, temporal_impl, temporal_attn, fuse_s2t)


def _bench_forward(model, x2d_masked, stride_mask, fused_params, max_keyframes,
                   assume_dense_mask, temporal_impl, temporal_attn, fuse_s2t):
    """`bench_forward` inside its rung's `matmul_precision` context."""
    fuse_strided = can_fuse_strided(model, temporal_impl, temporal_attn)
    if (fuse_s2t and fuse_strided and temporal_attn == "banded"
            and model.spatial_depth > 0):
        return _tiled_forward(model, x2d_masked, stride_mask, fused_params)
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
    return _post_s2t(model, y, stride_mask, fused_params, assume_dense_mask, fuse_strided)


@torch.inference_mode()
def shared_spatial_forward(model: UpliftUpsampleTransformer, unique2d: torch.Tensor,
                           win_idx: torch.Tensor, stride_mask: torch.Tensor,
                           fused_params: Optional[Dict] = None,
                           assume_dense_mask: bool = False, *,
                           temporal_impl: str = "v3", temporal_wpt: int = 4,
                           temporal_attn: str = "full",
                           strided_sel: bool = False,
                           precision: Optional[str] = None) -> torch.Tensor:
    """Fused eval forward with a cross-window SHARED spatial stage.

    In the window-sparse eval protocol consecutive computed windows overlap
    in all but one of their N frames, and the spatial stage plus the s2t
    Dense are frame-independent, so K1 and the Dense run once per unique
    masked frame and the features are gathered into windows; the temporal
    and strided stages are the dense path's, on the routes of the module
    docstring (all but the tiled one, as in the JAX package).

    unique2d: (U, 17, 2) deduplicated, already-masked frames (all masked
      frames collapse into the one all-zeros row, whose features the token
      substitution discards). Rows beyond the real unique count are padding
      and never indexed.
    win_idx: (B, N) integer — each window token's row in unique2d.
    stride_mask: (B, N) — 1/True on real-input frames.
    precision: the matmul rung, as in `bench_forward`.
    """
    del temporal_wpt, strided_sel  # the same launches on every value
    check_tp_route(model, temporal_impl, temporal_attn)
    rung = check_rung(current() if precision is None else precision, model.use_pallas, model.tp)
    if fused_params is None:
        fused_params = prepare_fused_params(model, rung)
    fuse_strided = can_fuse_strided(model, temporal_impl, temporal_attn)
    with matmul_precision(rung):
        sp = spatial_stack(unique2d.contiguous(), fused_params["spatial"],
                           num_heads=model.num_heads,
                           packed=fused_params["spatial_packed"], precision=rung)  # (U, P·C)
        y_u = model.spatial_to_temporal_fc(sp)                     # (U, C)
        return _post_s2t(model, y_u[win_idx], stride_mask, fused_params, assume_dense_mask,
                         fuse_strided)


def _spatial(model, x2d, fused_params):
    """K1 at the current context's rung."""
    return spatial_stack_apply(fused_params["spatial"], x2d, num_heads=model.num_heads,
                               packed=fused_params["spatial_packed"],
                               precision=current())  # (B, N, P·C)


def _tiled_forward(model: UpliftUpsampleTransformer, x2d_masked: torch.Tensor,
                   stride_mask: torch.Tensor, fused_params: Dict) -> torch.Tensor:
    """The tiled pipeline (`_tiled_forward` of the JAX package): K1 on all
    B·N frames (row 4: the TPU kernel's window padding to 72 frames and its
    tile layout are Mosaic alignment devices, so the frames stay rows), the
    s2t prologue kernel, K2 with the key mask, K3 and the tail (row 5 with
    its banded-selection epilogue)."""
    sm = stride_mask if model.has_strided_input else None
    y = s2t_prologue(_spatial(model, x2d_masked, fused_params), fused_params["s2t"], sm,
                     precision=current())
    key_mask = None if sm is None else 1.0 - sm.to(torch.float32)
    return _temporal_and_tail(model, y, stride_mask, key_mask, fused_params, True)


def _post_s2t(model: UpliftUpsampleTransformer, y: torch.Tensor,
              stride_mask: torch.Tensor, fused_params: Dict,
              assume_dense_mask: bool, fuse_strided: bool) -> torch.Tensor:
    """Masked-token substitution + temporal PE, then `_temporal_and_tail`.

    y: (B, N, temporal_d) spatial_to_temporal output (pre-substitution).
    """
    key_mask = None
    if model.has_strided_input:
        sm = stride_mask.to(y.dtype)[..., None]
        y = sm * y + (1.0 - sm) * model.strided_input_token
        if not assume_dense_mask:
            key_mask = 1.0 - stride_mask.to(torch.float32)
    y = y + model.temporal_pe
    return _temporal_and_tail(model, y, stride_mask, key_mask, fused_params, fuse_strided)


def _temporal_and_tail(model, y, stride_mask, key_mask, fused_params,
                       fuse_strided: bool) -> torch.Tensor:
    """K2, then K3 when `fuse_strided`, then the rest of the model, at the
    current context's rung."""
    fmb = (model.first_strided_token_attention_layer
           if model.has_strided_input else 0)
    rung = current()
    y = temporal_stack(y, fused_params["temporal"], key_mask,
                       num_heads=model.num_heads, first_masked_blocks=fmb, tp=model.tp,
                       precision=rung)
    entry = 0
    if fuse_strided:
        y = strided_block1(y, fused_params["strided"], num_heads=model.num_heads,
                           stride=model.strides[0], paddings=model.paddings[0], tp=model.tp,
                           precision=rung)
        entry = 1
    _, central = model(y, stride_mask, temporal_input=True, strided_entry=entry)
    return central
