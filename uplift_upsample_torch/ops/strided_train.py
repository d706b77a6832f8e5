"""K6 — strided block 1 in training (counterpart of ops/pallas_strided_bwd.py
`fused_strided_block1_train`).

`strided_block1_train(x, ops, num_heads=..., stride=...)` is differentiable.
x is the temporal stack's output (B, S, C); `ops` are
`strided.stack_strided_block1_params`' operands (with the TF32 halves of
the dense matrices and the conv kernel, `temporal.weight_keys`). It returns
the n_out rows the next strided block reads, (B, n_out, C): the JAX op followed by its
caller's `[:, :(n_out-1)·s0+1:s0]` slice. Strided block 1 has no stochastic
depth (its rate top·i/(depth-1) is 0 at i = 0; the train step asserts it).

On a CPU tensor it is `strided_block1_train_plain` under autograd. On a CUDA
tensor it is `StridedBlock1Train`:
  - forward (`strided_train_fwd`): K3's kernels (LayerNorm with the PE,
    GEMMs, window attention, the conv on the selected rows), keeping every
    intermediate the backward reads;
  - backward (`strided_train_bwd`): K5's backward kernels up to h1 and the
    conv's backward of `csrc/strided_bwd.cu` (`conv_dh1`: each h1 row the
    sum of the taps of g · Wcᵀ that read it, one launch, rows by TMA;
    `conv_dwc`: Tᵀ · g with the taps gathered from h1; both on the tensor
    cores; the crop residual), returning
    dx and the grads of all 13 operands (dpe the fixed-order sum of dx over
    windows), as `_fsb_bwd_rule` does.
The wrappers count one per call: "strided_train_fwd" on the forward's last
launch, "strided_train_bwd" on the backward's last launch.

The bf16 rung (`precision` "default"; `pallas_strided_bwd.py` at DEFAULT):
the forward launches K3's bf16 instances with K5's training attention
(`window_attention_train_bf16`); the backward K5's bf16 instances,
`strided_dh1_bf16` (native bf16: g rounded, Wc's bf16 plane as stored, a
torch.bfloat16 tensor), `strided_dwc_bf16`
(the taps and g rounded) and `sum_rows_bf16` for the PE's gradient (the sum
over windows of the bf16-rounded input gradient: the JAX kernel takes it
with a DEFAULT dot against a one-hot matrix). The JAX conv is three tap
dots summed in fp32; one product over 3·hidden on the same rounded operands
equals it up to sum order. The weights are the bf16 planes
(`temporal.weight_keys`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..precision import BF16, check_rung, mm
from . import cuda_lib
from .strided import (DENSE, conv_scatter_plain, conv_taps_plain, output_length,
                      strided_block1_plain, strided_conv)
from .temporal import check_unfolded, check_weight, gemm, layernorm, operand_dtype, weight_keys
from .temporal_train import (_sum_rows, colsum, dw_splits, gemm_dw, gemm_dx, layernorm_bwd,
                             window_attention_bwd, window_attention_train)

COUNTER_FWD = "strided_train_fwd"
COUNTER_BWD = "strided_train_bwd"
ORDER = ["pe", "ln1_g", "ln1_b", "wqkv", "bqkv", "wp", "bp", "ln2_g", "ln2_b",
         "w1", "b1", "wc", "bc"]


def conv_dh1_plain(g: torch.Tensor, wc: torch.Tensor, h1: torch.Tensor, *, stride: int,
                   paddings, precision: str = "high") -> torch.Tensor:
    """The conv's input gradient through fc1's relu: g (B, n_out, C), wc
    (3·hidden, C), h1 (B, n, hidden) → (B, n, hidden), `conv_scatter_plain` of
    g · wcᵀ (at the rung), zero where h1 <= 0."""
    d = conv_scatter_plain(mm(g, wc.t(), check_rung(precision)), h1.shape[1], stride, paddings)
    return torch.where(h1 > 0, d, 0.0)


def conv_dwc_plain(h1: torch.Tensor, g: torch.Tensor, *, stride: int, paddings,
                   precision: str = "high") -> torch.Tensor:
    """The conv's kernel gradient Tᵀ · g (at the rung), (3·hidden, C),
    T = `conv_taps_plain`(h1)."""
    taps = conv_taps_plain(h1, stride, paddings)
    return mm(taps.reshape(-1, taps.shape[-1]).t(), g.reshape(-1, g.shape[-1]),
              check_rung(precision))


def conv_dh1(g: torch.Tensor, ops: Dict, h1: torch.Tensor, *, stride: int,
             paddings, precision: str = "high") -> torch.Tensor:
    """(B, n_out, C), (B, n, hidden) → dH1 (B, n, hidden). CPU tensor: the
    plain version; CUDA tensor: one launch of `strided_dh1_f32` (each h1 row
    the sum of its taps' g · W_jᵀ on the tensor cores from Wc's halves as
    stored, "wc_tc_dx", the relu mask read and the rows written by TMA), or
    at "default" `strided_dh1_bf16` (native bf16: Wc's bf16 plane
    "wc_bf_dx", a torch.bfloat16 tensor)."""
    if g.device.type == "cpu":
        return conv_dh1_plain(g, ops["wc"], h1, stride=stride, paddings=paddings,
                              precision=precision)
    bf16 = check_rung(precision) == BF16
    b, n_out, c = g.shape
    n, hidden = h1.shape[1:]
    g = g.reshape(b * n_out, c).contiguous()
    cuda_lib.check_cuda("g", g)
    cuda_lib.check_cuda("h1", h1, device=g.device)
    if bf16 and c % 8:
        raise ValueError(f"strided_dh1_bf16 reads Wc's bf16 plane by TMA in rows of C: C={c} "
                         "must be a multiple of 8 (16 bytes)")
    w = ops["wc_bf_dx"] if bf16 else ops["wc_tc_dx"]
    check_weight(w, 3 * hidden, c, bf16, g.device)
    out = torch.empty_like(h1)  # never h1 itself: the relu mask is read as dH1 is written
    cuda_lib.launch("strided_bwd", "strided_dh1_bf16" if bf16 else "strided_dh1_f32", None, g,
                    w, h1, out, b, n, hidden, c, stride, int(paddings[0]), n_out)
    return out


def conv_dwc(h1: torch.Tensor, g: torch.Tensor, out: torch.Tensor, *, stride: int,
             paddings, precision: str = "high") -> torch.Tensor:
    """dWc (3·hidden, C) into `out`. CPU tensor: the plain version; CUDA
    tensor: `strided_dwc_f32` (Tᵀ · g on the tensor cores, T gathered from h1;
    `strided_dwc_bf16` at "default") split over the selected rows as
    `dw_splits` cuts them, the partials summed in a fixed order (`sum_rows_f32`)."""
    if g.device.type == "cpu":
        return out.copy_(conv_dwc_plain(h1, g, stride=stride, paddings=paddings,
                                        precision=precision))
    b, n_out, c = g.shape
    n, hidden = h1.shape[1:]
    g = g.reshape(b * n_out, c).contiguous()
    cuda_lib.check_cuda("g", g)
    cuda_lib.check_cuda("h1", h1, device=g.device)
    cuda_lib.check_cuda("out", out, shape=(3 * hidden, c), device=g.device)
    splits = dw_splits(b * n_out, 3 * hidden, c)
    part = torch.empty((splits, 3 * hidden, c), dtype=torch.float32, device=g.device)
    entry = "strided_dwc_bf16" if check_rung(precision) == BF16 else "strided_dwc_f32"
    cuda_lib.launch("strided_bwd", entry, None, h1, g, part, b, n, hidden, c,
                    stride, int(paddings[0]), n_out, splits)
    _sum_rows(part, out, counter=None)
    return out


def _geometry(x: torch.Tensor, stride: int, paddings) -> Tuple[int, int, int]:
    b, n, c = x.shape
    p0, p1 = int(paddings[0]), int(paddings[1])
    if not (0 <= p0 <= 1 and 0 <= p1 <= 1):
        raise ValueError(f"strided block 1 takes paddings in {{0, 1}}, got {paddings}")
    if output_length(n, stride, (p0, p1)) < 1:
        raise ValueError(f"N={n} is too short for stride {stride}")
    return b, n, c


def strided_train_fwd(x: torch.Tensor, ops: Dict, *, num_heads: int, stride: int,
                      paddings=(0, 0), precision: str = "high") -> Tuple[torch.Tensor, Dict]:
    """(B, S, C) → ((B, n_out, C), intermediates) on the card, at the rung."""
    b, n, c = _geometry(x, stride, paddings)
    if c % num_heads != 0:
        raise ValueError(f"C={c} does not split into {num_heads} heads")
    for name in ORDER + weight_keys(DENSE, precision):
        cuda_lib.check_cuda(name, ops[name], device=x.device, dtype=operand_dtype(name))
    cuda_lib.check_cuda("pe", ops["pe"], shape=(n, c))
    w = "_bf" if check_rung(precision) == BF16 else "_tc"
    rung = dict(precision=precision)
    h = x.reshape(b * n, c).contiguous()
    cuda_lib.check_cuda("x", h)
    xpe, y = layernorm(h, ops["ln1_g"], ops["ln1_b"], 1e-5, pe=ops["pe"], counter=None)
    qkv = gemm(y, ops["wqkv" + w], ops["bqkv"], counter=None, **rung)
    ctx = window_attention_train(qkv, None, windows=b, n=n, num_heads=num_heads, counter=None,
                                 **rung)
    x2 = gemm(ctx, ops["wp" + w], ops["bp"], residual=xpe, counter=None, **rung)
    z = layernorm(x2, ops["ln2_g"], ops["ln2_b"], 1e-5, counter=None)
    h1 = gemm(z, ops["w1" + w], ops["b1"], relu=True, counter=None, **rung)
    out = strided_conv(h1.reshape(b, n, -1), x2.reshape(b, n, c), ops, stride=stride,
                       paddings=paddings, counter=COUNTER_FWD, **rung)
    saved = dict(xpe=xpe, y=y, qkv=qkv, ctx=ctx, x2=x2, z=z, h1=h1)
    return out, saved


def strided_train_bwd(saved: Dict, g: torch.Tensor, ops: Dict, *, num_heads: int,
                      stride: int, paddings=(0, 0), precision: str = "high"
                      ) -> Tuple[torch.Tensor, Dict]:
    """VJP of `strided_train_fwd` for g (B, n_out, C) → (dx (B, S, C), grads
    by operand name) on the card, at the rung."""
    bf16 = check_rung(precision) == BF16
    w = "_bf_dx" if bf16 else "_tc_dx"
    rung = dict(precision=precision)
    b, n_out, c = g.shape
    rows, hidden = saved["h1"].shape
    n = rows // b
    p0 = int(paddings[0])
    if n_out != output_length(n, stride, paddings):
        raise ValueError(f"g has {n_out} rows per window, expected "
                         f"{output_length(n, stride, paddings)}")
    g3 = g.contiguous()
    g = g3.reshape(b * n_out, c)
    cuda_lib.check_cuda("g", g)
    grads = {name: torch.empty_like(ops[name]) for name in ORDER}
    # the conv: out[t] = x2[s0·t + (p0 == 0)] + bc + Σ_j h1[s0·t + j - p0] · W_j
    colsum(g, None, 1, grads["bc"], counter=None)
    h1 = saved["h1"].reshape(b, n, hidden)
    conv_dwc(h1, g3, grads["wc"], stride=stride, paddings=paddings, **rung)
    dpre1 = conv_dh1(g3, ops, h1, stride=stride, paddings=paddings,
                     **rung).reshape(rows, hidden)
    # the MLP's first layer and LN2; then the crop residual joins dx2
    gemm_dw(saved["z"], dpre1, None, 1, grads["w1"], counter=None, **rung)
    colsum(dpre1, None, 1, grads["b1"], counter=None)
    dz = gemm_dx(dpre1, None, 1, ops["w1" + w], counter=None, **rung)
    dx2 = layernorm_bwd(saved["x2"], dz, ops["ln2_g"], None, grads["ln2_g"], grads["ln2_b"],
                        counter=None)
    cuda_lib.launch("strided_bwd", "crop_residual_add_f32", None, g, dx2, b, n, c, stride,
                    1 if p0 == 0 else 0, n_out)
    # attention branch: x2 = (x + pe) + proj(attention(LN1(x + pe)))
    gemm_dw(saved["ctx"], dx2, None, 1, grads["wp"], counter=None, **rung)
    colsum(dx2, None, 1, grads["bp"], counter=None)
    dctx = gemm_dx(dx2, None, 1, ops["wp" + w], counter=None, **rung)
    dqkv = window_attention_bwd(saved["qkv"], dctx, None, windows=b, n=n,
                                num_heads=num_heads, counter=None, **rung)
    gemm_dw(saved["y"], dqkv, None, 1, grads["wqkv"], counter=None, **rung)
    colsum(dqkv, None, 1, grads["bqkv"], counter=None)
    dy = gemm_dx(dqkv, None, 1, ops["wqkv" + w], counter=None, **rung)
    dx = layernorm_bwd(saved["xpe"], dy, ops["ln1_g"], dx2, grads["ln1_g"], grads["ln1_b"],
                       counter=None)
    # dpe: Σ over windows (of dx rounded to bf16 on the bf16 rung)
    part = dx.reshape(b, n * c)
    if bf16:
        cuda_lib.launch("strided_bwd", "sum_rows_bf16", COUNTER_BWD, part, grads["pe"], b,
                        n * c)
    else:
        _sum_rows(part, grads["pe"], counter=COUNTER_BWD)
    return dx.reshape(b, n, c), grads


def saved_relu_mask(saved: Dict) -> torch.Tensor:
    """Where fc1's relu passed in `strided_train_fwd`."""
    return saved["h1"] > 0


def strided_block1_train_plain(x: torch.Tensor, ops: Dict, *, num_heads: int, stride: int,
                               paddings=(0, 0), relu_mask: Optional[torch.Tensor] = None,
                               precision: str = "high") -> torch.Tensor:
    """(B, S, C) → (B, n_out, C) in plain PyTorch (differentiable): the
    training kernel's function at the rung (`strided_block1_plain(train=True)`)."""
    return strided_block1_plain(x, ops, num_heads=num_heads, stride=stride,
                                paddings=tuple(paddings), relu_mask=relu_mask,
                                precision=precision, train=True)


def strided_block1_bwd_plain(x: torch.Tensor, ops: Dict, g: torch.Tensor, *, num_heads: int,
                             stride: int, paddings=(0, 0),
                             relu_mask: Optional[torch.Tensor] = None,
                             precision: str = "high") -> Tuple[torch.Tensor, Dict]:
    """torch.autograd of the plain version at the rung: (dx, grads by operand name)."""
    with torch.enable_grad():
        leaves = {k: ops[k].detach().requires_grad_(True) for k in ORDER}
        xg = x.detach().requires_grad_(True)
        out = strided_block1_train_plain(xg, leaves, num_heads=num_heads, stride=stride,
                                         paddings=paddings, relu_mask=relu_mask,
                                         precision=precision)
        grads = torch.autograd.grad(out, [xg, *leaves.values()], g)
    return grads[0], dict(zip(ORDER, grads[1:]))


class StridedBlock1Train(torch.autograd.Function):
    """K6: apply(x, num_heads, stride, paddings, precision, *operands in ORDER,
    *weights in `weight_keys(DENSE, precision)`); gradients for x and every operand
    (none for the halves or planes)."""

    @staticmethod
    def forward(ctx, x, num_heads, stride, paddings, precision, *leaves):
        keys = ORDER + weight_keys(DENSE, precision)
        out, saved = strided_train_fwd(x, dict(zip(keys, leaves)), num_heads=num_heads,
                                       stride=stride, paddings=paddings, precision=precision)
        ctx.intermediates = saved
        ctx.cfg = dict(num_heads=num_heads, stride=stride, paddings=paddings,
                       precision=precision)
        ctx.save_for_backward(*leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        keys = ORDER + weight_keys(DENSE, ctx.cfg["precision"])
        dx, grads = strided_train_bwd(ctx.intermediates, g,
                                      dict(zip(keys, ctx.saved_tensors)), **ctx.cfg)
        ctx.intermediates = None
        return (dx, None, None, None, None, *[grads[name] for name in ORDER],
                *[None] * (len(keys) - len(ORDER)))


def strided_block1_train(x: torch.Tensor, ops: Dict, *, num_heads: int, stride: int,
                         paddings=(0, 0), precision: str = "high") -> torch.Tensor:
    """Differentiable (B, S, C) → (B, n_out, C) at the rung. CPU tensor: the
    plain version under autograd; CUDA tensor: K6."""
    check_unfolded(ops)
    if x.device.type == "cpu":
        return strided_block1_train_plain(x, ops, num_heads=num_heads, stride=stride,
                                          paddings=paddings, precision=precision)
    paddings = (int(paddings[0]), int(paddings[1]))
    return StridedBlock1Train.apply(x, num_heads, stride, paddings, check_rung(precision),
                                    *[ops[name] for name in ORDER + weight_keys(DENSE, precision)])
