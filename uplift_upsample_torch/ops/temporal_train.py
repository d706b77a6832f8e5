"""K5 — the temporal stack in training (counterpart of
ops/pallas_temporal_bwd.py `fused_temporal_stack_train`).

`temporal_stack_train(x, ops, key_mask, dp_all, ...)` is differentiable. x is
(B, S, C); `ops` are `temporal.stack_temporal_params`' 12 stacked operands
and their matrices' TF32 halves (`temporal.weight_keys`, split from the same
weights); dp_all (L, 2, B) holds each block's per-window stochastic-depth
scales on its attention and MLP branches. On a CPU tensor it is
`temporal.temporal_stack_plain` with the scales, under autograd. On a CUDA
tensor it is `TemporalStackTrain`:
  - forward (`temporal_train_fwd`): K2's kernels (LayerNorm, GEMM, window
    attention) with the scales in the residual epilogues
    (`gemm_branch_f32`), keeping every intermediate the backward reads;
  - backward (`temporal_train_bwd`): the kernels of `csrc/temporal_bwd.cu`,
    returning dx, the grads of all 12 operands per block and ddp (L, 2, B),
    as `_fts_impl_bwd` does.
Every product runs on the tensor cores in 3xTF32 (`csrc/gemm_tc.cuh`): the
forward's and dX = dY·Wᵀ on TMA + wgmma from W's halves, dW = Xᵀ·dY on
mma.sync, split over the rows; the window attention's backward
(`window_attention_bwd`, also K6's) on mma.sync in `csrc/temporal_bwd.cu`.
Launches count as "temporal_train_fwd" and "temporal_train_bwd".

The bf16 rung (`precision` "default", TRAIN_MATMUL_PRECISION "default" and
"mixed"; `pallas_temporal_bwd.py` at DEFAULT, where every dot comes from
`_dot_maker` and rounds both operands): each entry's bf16 instance, one
TF32 pass on bf16-rounded operands with fp32 sums, reading the weights'
bf16 planes (`temporal.add_weight_operands`: "<w>_bf" for x·W, "<w>_bf_dx"
for dY·Wᵀ) in place of the halves: `gemm_bf16` and `gemm_branch_bf16`
forward; `window_attention_train_bf16`, whose logits round q·1/sqrt(D) (the
training kernel scales q before its dot; the eval's `window_attention_bf16`
rounds q and scales the logits); `gemm_dx_bf16` (dY scaled by the droppath
factor, then rounded), `gemm_dw_bf16` and `window_attention_bwd_bf16`
(dP = round(dO)·round(v), dv = round(P)ᵀ·round(dO), dq = round(dS)·round(k)
then 1/sqrt(D), dk = round(dS)ᵀ·round(q·1/sqrt(D))). LayerNorm, softmax,
relu, biases, the droppath scales, residuals and every sum stay fp32. On a
CPU tensor the plain version at the rung under autograd computes the same
(`precision.Bf16Matmul`, `window_attention_plain(train=True)`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..precision import BF16, check_rung
from . import cuda_lib
from .temporal import (DENSE, gemm, layernorm, temporal_stack_plain, weight_keys,
                       window_attention, window_attention_plain)

COUNTER_FWD = "temporal_train_fwd"
COUNTER_BWD = "temporal_train_bwd"
ORDER = ["ln1_g", "ln1_b", "wqkv", "bqkv", "wp", "bp", "ln2_g", "ln2_b",
         "w1", "b1", "w2", "b2"]
_TARGET_BLOCKS = 264  # split-K dW: one wave of two blocks on each of 132 SMs


def _empty(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


# -- forward --------------------------------------------------------------------

def _branch_gemm(a, w_tc, bias, scale, rows_per_scale, residual, relu=False,
                 precision="high"):
    """(residual + scale · act(a @ w + bias), act(a @ w + bias)) on the card;
    w_tc (2, N, K) the TF32 halves of w (K, N), or on the bf16 rung its bf16
    plane (N, K)."""
    bf16 = check_rung(precision) == BF16
    m, k = a.shape
    n = w_tc.shape[-2]
    cuda_lib.check_cuda("w", w_tc, shape=(n, k) if bf16 else (2, n, k), device=a.device)
    out, branch = _empty((m, n), a), _empty((m, n), a)
    cuda_lib.launch("temporal_bwd", "gemm_branch_bf16" if bf16 else "gemm_branch_f32",
                    COUNTER_FWD, a, w_tc, bias, scale, rows_per_scale, residual, branch, out,
                    m, n, k, int(relu))
    return out, branch


def _check(x: torch.Tensor, ops: Dict, dp_all: torch.Tensor, num_heads: int, precision: str):
    b, n, c = x.shape
    if c % num_heads != 0:
        raise ValueError(f"C={c} does not split into {num_heads} heads")
    blocks = ops["ln1_g"].shape[0]
    cuda_lib.check_cuda("dp_all", dp_all, shape=(blocks, 2, b), device=x.device)
    for name in ORDER + weight_keys(DENSE, precision):
        cuda_lib.check_cuda(name, ops[name], device=x.device)


def window_attention_train(qkv, key_mask, *, windows, n, num_heads, counter,
                           precision="high"):
    """The forward window attention of K5 and K6 on the card: K2's kernel at
    "high" / "highest"; at "default" `window_attention_train_bf16` (q scaled
    by 1/sqrt(D) before its rounding, as the training kernel computes it)."""
    if check_rung(precision) != BF16:
        return window_attention(qkv, key_mask, windows=windows, n=n, num_heads=num_heads,
                                counter=counter)
    rows, c3 = qkv.shape
    cuda_lib.check_cuda("qkv", qkv, shape=(windows * n, c3))
    if key_mask is not None:
        cuda_lib.check_cuda("key_mask", key_mask, shape=(windows, n), device=qkv.device)
    out = _empty((rows, c3 // 3), qkv)
    cuda_lib.launch("temporal_bwd", "window_attention_train_bf16", counter, qkv, key_mask, out,
                    windows, n, c3 // 3, num_heads)
    return out


def temporal_train_fwd(x: torch.Tensor, ops: Dict, key_mask: Optional[torch.Tensor],
                       dp_all: torch.Tensor, *, num_heads: int, first_masked_blocks: int,
                       precision: str = "high") -> Tuple[torch.Tensor, List[Dict]]:
    """(B, S, C) → ((B, S, C), per-block intermediates) on the card, at the
    rung `precision` (module docstring)."""
    b, n, c = x.shape
    _check(x, ops, dp_all, num_heads, precision)
    w = "_bf" if check_rung(precision) == BF16 else "_tc"
    km = None
    if key_mask is not None and first_masked_blocks > 0:
        km = key_mask.to(torch.float32).contiguous()
    h = x.reshape(b * n, c).contiguous()
    cuda_lib.check_cuda("x", h)
    saved = []
    for blk in range(ops["ln1_g"].shape[0]):
        y = layernorm(h, ops["ln1_g"][blk], ops["ln1_b"][blk], 1e-5, counter=COUNTER_FWD)
        qkv = gemm(y, ops["wqkv" + w][blk], ops["bqkv"][blk], counter=COUNTER_FWD,
                   precision=precision)
        ctx = window_attention_train(qkv, km if blk < first_masked_blocks else None,
                                     windows=b, n=n, num_heads=num_heads,
                                     counter=COUNTER_FWD, precision=precision)
        x2, proj = _branch_gemm(ctx, ops["wp" + w][blk], ops["bp"][blk], dp_all[blk, 0], n, h,
                                precision=precision)
        z = layernorm(x2, ops["ln2_g"][blk], ops["ln2_b"][blk], 1e-5, counter=COUNTER_FWD)
        h1 = gemm(z, ops["w1" + w][blk], ops["b1"][blk], relu=True, counter=COUNTER_FWD,
                  precision=precision)
        out, z2 = _branch_gemm(h1, ops["w2" + w][blk], ops["b2"][blk], dp_all[blk, 1], n, x2,
                               precision=precision)
        saved.append(dict(x=h, y=y, qkv=qkv, ctx=ctx, proj=proj, x2=x2, z=z, h1=h1, z2=z2))
        h = out
    return h.reshape(b, n, c), saved


# -- backward -------------------------------------------------------------------

def _sum_rows(part: torch.Tensor, out: torch.Tensor, counter=COUNTER_BWD) -> None:
    rows = part.shape[0]
    cuda_lib.launch("temporal_bwd", "sum_rows_f32", counter, part, out, rows,
                    part.numel() // rows)


def gemm_dx(dy, scale, rows_per_scale, w_tc_dx, mask=None, counter=COUNTER_BWD,
            precision="high"):
    """(dy · scale[row // rows_per_scale]) @ wᵀ, zeroed where mask <= 0; w_tc_dx
    (2, N, K) the TF32 halves of w (N, K) as stored (`tf32_halves(w,
    transpose=False)`), or on the bf16 rung its bf16 plane (N, K) as stored
    (dy · scale rounded to bf16 as the kernel reads it)."""
    bf16 = check_rung(precision) == BF16
    m, k = dy.shape
    n = w_tc_dx.shape[-2]
    if k % 4:
        raise ValueError(f"the tensor-core GEMM loads rows of 16 bytes: K={k} is not a "
                         "multiple of 4")
    cuda_lib.check_cuda("w_dx", w_tc_dx, shape=(n, k) if bf16 else (2, n, k), device=dy.device)
    out = _empty((m, n), dy)
    cuda_lib.launch("temporal_bwd", "gemm_dx_bf16" if bf16 else "gemm_dx_f32", counter, dy,
                    scale, rows_per_scale, w_tc_dx, mask, out, m, n, k)
    return out


def dw_splits(rows: int, m: int, n: int) -> int:
    """Row chunks of a split-K dW product (m, n) over `rows` on `gemm_dw_f32`'s
    128 x 128 tiles: as many as one wave of blocks holds (two per SM), at
    least 256 rows a chunk."""
    tiles = math.ceil(m / 128) * math.ceil(n / 128)
    return max(1, min(64, _TARGET_BLOCKS // tiles, rows // 256))


def gemm_dw(x, dy, scale, rows_per_scale, out, counter=COUNTER_BWD, precision="high"):
    """out (m, n) = xᵀ @ (dy · scale[row // rows_per_scale]), split over rows;
    m and n multiples of 4. On the bf16 rung x and dy · scale rounded."""
    rows, m = x.shape
    n = dy.shape[1]
    if m % 4 or n % 4:
        raise ValueError(f"dW loads rows of 16 bytes: ({m}, {n}) are not multiples of 4")
    splits = dw_splits(rows, m, n)
    part = _empty((splits, m, n), x)
    entry = "gemm_dw_bf16" if check_rung(precision) == BF16 else "gemm_dw_f32"
    cuda_lib.launch("temporal_bwd", entry, counter, x, dy, scale,
                    rows_per_scale, part, m, n, rows, splits)
    _sum_rows(part, out, counter)


def colsum(x, scale, rows_per_scale, out, counter=COUNTER_BWD):
    rows, cols = x.shape
    part = _empty((math.ceil(rows / 256), cols), x)
    cuda_lib.launch("temporal_bwd", "colsum_f32", counter, x, scale, rows_per_scale,
                    part, rows, cols)
    _sum_rows(part, out, counter)


def layernorm_bwd(x, dy, gamma, residual, out_gamma, out_beta, counter=COUNTER_BWD):
    """dx = LN backward of dy at x (eps 1e-5) + residual; γ/β grads into the outs."""
    rows, c = x.shape
    workers = min(1024, math.ceil(rows / 8) * 8)
    dx, part, gb = _empty((rows, c), x), _empty((workers, 2 * c), x), _empty((2 * c,), x)
    cuda_lib.launch("temporal_bwd", "layernorm_bwd_f32", counter, x, dy, gamma,
                    residual, dx, part, rows, c, 1e-5, workers)
    _sum_rows(part, gb, counter)
    out_gamma.copy_(gb[:c])
    out_beta.copy_(gb[c:])
    return dx


def window_attention_bwd_plain(qkv, dctx, key_mask, *, windows, n, num_heads,
                               precision="high"):
    """torch.autograd of `window_attention_plain` (the training kernel's,
    `train=True`, at the rung): d(q|k|v) (windows·n, 3C)."""
    rows, c = dctx.shape
    with torch.enable_grad():
        leaf = qkv.detach().reshape(windows, n, 3 * c).requires_grad_(True)
        out = window_attention_plain(leaf, key_mask, num_heads, precision, train=True)
        (dqkv,) = torch.autograd.grad(out, leaf, dctx.reshape(windows, n, c))
    return dqkv.reshape(rows, 3 * c)


def window_attention_bwd(qkv, dctx, key_mask, *, windows, n, num_heads,
                         counter=COUNTER_BWD, precision="high"):
    """d(q|k|v) (windows·n, 3C) of the training window attention for dctx
    (windows·n, C); key_mask (windows, n), 1 = blocked, or None; n <= 128.
    CPU tensor: the plain version; CUDA tensor: the tensor-core kernel of
    csrc/temporal_bwd.cu (its bf16 instance at "default")."""
    if dctx.device.type == "cpu":
        return window_attention_bwd_plain(qkv, dctx, key_mask, windows=windows, n=n,
                                          num_heads=num_heads, precision=precision)
    rows, c = dctx.shape
    cuda_lib.check_cuda("qkv", qkv, shape=(rows, 3 * c), device=dctx.device)
    dqkv = _empty((rows, 3 * c), dctx)
    entry = ("window_attention_bwd_bf16" if check_rung(precision) == BF16
             else "window_attention_bwd_f32")
    cuda_lib.launch("temporal_bwd", entry, counter, qkv, dctx,
                    key_mask, dqkv, windows, n, c, num_heads)
    return dqkv


def temporal_train_bwd(saved: List[Dict], g: torch.Tensor, ops: Dict,
                       key_mask: Optional[torch.Tensor], dp_all: torch.Tensor, *,
                       num_heads: int, first_masked_blocks: int, precision: str = "high"
                       ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """VJP of `temporal_train_fwd` for g (B, S, C) → (dx, grads by operand
    name, stacked over blocks, ddp (L, 2, B)) on the card, at the rung."""
    b, n, c = g.shape
    w = "_bf_dx" if check_rung(precision) == BF16 else "_tc_dx"
    rung = dict(precision=precision)
    rows = b * n
    km = None
    if key_mask is not None and first_masked_blocks > 0:
        km = key_mask.to(torch.float32).contiguous()
    g = g.reshape(rows, c).contiguous()
    cuda_lib.check_cuda("g", g)
    grads = {name: torch.empty_like(ops[name]) for name in ORDER}
    blocks = len(saved)
    ddp = _empty((blocks, 2, b), g)
    for blk in range(blocks - 1, -1, -1):
        s = saved[blk]
        s1, s2 = dp_all[blk, 0], dp_all[blk, 1]
        # MLP branch: out = x2 + s2 · (relu(z @ w1 + b1) @ w2 + b2)
        cuda_lib.launch("temporal_bwd", "window_dot_f32", COUNTER_BWD, g, s["z2"],
                        ddp[blk, 1], b, n, c)
        gemm_dw(s["h1"], g, s2, n, grads["w2"][blk], **rung)
        colsum(g, s2, n, grads["b2"][blk])
        dh1 = gemm_dx(g, s2, n, ops["w2" + w][blk], mask=s["h1"], **rung)
        gemm_dw(s["z"], dh1, None, 1, grads["w1"][blk], **rung)
        colsum(dh1, None, 1, grads["b1"][blk])
        dz = gemm_dx(dh1, None, 1, ops["w1" + w][blk], **rung)
        dx2 = layernorm_bwd(s["x2"], dz, ops["ln2_g"][blk], g, grads["ln2_g"][blk],
                      grads["ln2_b"][blk])
        # attention branch: x2 = x + s1 · (attention(LN1(x)) @ wp + bp)
        cuda_lib.launch("temporal_bwd", "window_dot_f32", COUNTER_BWD, dx2, s["proj"],
                        ddp[blk, 0], b, n, c)
        gemm_dw(s["ctx"], dx2, s1, n, grads["wp"][blk], **rung)
        colsum(dx2, s1, n, grads["bp"][blk])
        dctx = gemm_dx(dx2, s1, n, ops["wp" + w][blk], **rung)
        dqkv = window_attention_bwd(s["qkv"], dctx, km if blk < first_masked_blocks else None,
                                    windows=b, n=n, num_heads=num_heads, **rung)
        gemm_dw(s["y"], dqkv, None, 1, grads["wqkv"][blk], **rung)
        colsum(dqkv, None, 1, grads["bqkv"][blk])
        dy = gemm_dx(dqkv, None, 1, ops["wqkv" + w][blk], **rung)
        g = layernorm_bwd(s["x"], dy, ops["ln1_g"][blk], dx2, grads["ln1_g"][blk],
                    grads["ln1_b"][blk])
    return g.reshape(b, n, c), grads, ddp


def temporal_stack_bwd_plain(x: torch.Tensor, ops: Dict, key_mask: Optional[torch.Tensor],
                             dp_all: torch.Tensor, g: torch.Tensor, *, num_heads: int,
                             first_masked_blocks: int,
                             relu_masks: Optional[List[torch.Tensor]] = None,
                             precision: str = "high"
                             ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """torch.autograd of `temporal_stack_plain` with scales (the training
    kernel's attention, at the rung): (dx, grads, ddp).

    relu_masks as in `temporal_stack_plain`; `saved_relu_masks(saved)` gives
    the kernel forward's."""
    with torch.enable_grad():
        leaves = {k: ops[k].detach().requires_grad_(True) for k in ORDER}
        xg = x.detach().requires_grad_(True)
        dg = dp_all.detach().requires_grad_(True)
        out = temporal_stack_plain(xg, leaves, key_mask, num_heads=num_heads,
                                   first_masked_blocks=first_masked_blocks, droppath=dg,
                                   relu_masks=relu_masks, precision=precision, train=True)
        grads = torch.autograd.grad(out, [xg, dg, *leaves.values()], g)
    return grads[0], dict(zip(ORDER, grads[2:])), grads[1]


def saved_relu_masks(saved: List[Dict]) -> List[torch.Tensor]:
    """Where each block's MLP relu passed in `temporal_train_fwd`."""
    return [s["h1"] > 0 for s in saved]


class TemporalStackTrain(torch.autograd.Function):
    """K5: apply(x, key_mask, dp_all, num_heads, first_masked_blocks, precision,
    *operands in ORDER, *weights in `weight_keys(DENSE, precision)`); gradients for
    x, dp_all and every operand (none for the halves or planes: the weights
    carry them)."""

    @staticmethod
    def forward(ctx, x, key_mask, dp_all, num_heads, first_masked_blocks, precision, *leaves):
        keys = ORDER + weight_keys(DENSE, precision)
        out, saved = temporal_train_fwd(x, dict(zip(keys, leaves)), key_mask, dp_all,
                                        num_heads=num_heads,
                                        first_masked_blocks=first_masked_blocks,
                                        precision=precision)
        ctx.intermediates = saved
        ctx.num_heads, ctx.fmb, ctx.precision = num_heads, first_masked_blocks, precision
        ctx.save_for_backward(key_mask, dp_all, *leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        key_mask, dp_all, *leaves = ctx.saved_tensors
        keys = ORDER + weight_keys(DENSE, ctx.precision)
        dx, grads, ddp = temporal_train_bwd(ctx.intermediates, g, dict(zip(keys, leaves)),
                                            key_mask, dp_all, num_heads=ctx.num_heads,
                                            first_masked_blocks=ctx.fmb,
                                            precision=ctx.precision)
        ctx.intermediates = None
        return (dx, None, ddp, None, None, None, *[grads[name] for name in ORDER],
                *[None] * (len(keys) - len(ORDER)))


def temporal_stack_train(x: torch.Tensor, ops: Dict, key_mask: Optional[torch.Tensor],
                         dp_all: torch.Tensor, *, num_heads: int,
                         first_masked_blocks: int = 0, precision: str = "high") -> torch.Tensor:
    """Differentiable (B, S, C) → (B, S, C) with per-window stochastic depth,
    at the rung `precision` (module docstring).

    CPU tensor: the plain version under autograd; CUDA tensor: K5.
    key_mask: (B, S), 1 = blocked key, in the first `first_masked_blocks` blocks.
    """
    if x.device.type == "cpu":
        return temporal_stack_plain(x, ops, key_mask, num_heads=num_heads,
                                    first_masked_blocks=first_masked_blocks,
                                    droppath=dp_all, precision=precision, train=True)
    return TemporalStackTrain.apply(x, key_mask, dp_all.float().contiguous(), num_heads,
                                    first_masked_blocks, check_rung(precision),
                                    *[ops[name] for name in ORDER + weight_keys(DENSE, precision)])
