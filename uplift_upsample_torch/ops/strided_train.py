"""K6 — strided block 1 in training (counterpart of ops/pallas_strided_bwd.py
`fused_strided_block1_train`).

`strided_block1_train(x, ops, num_heads=..., stride=...)` is differentiable.
x is the temporal stack's output (B, S, C); `ops` are
`strided.stack_strided_block1_params`' operands (with the TF32 halves of
the dense matrices and the conv kernel, HALVES). It returns the n_out rows
the next strided block reads, (B, n_out, C): the JAX op followed by its
caller's `[:, :(n_out-1)·s0+1:s0]` slice. Strided block 1 has no stochastic
depth (its rate top·i/(depth-1) is 0 at i = 0; the train step asserts it).

On a CPU tensor it is `strided_block1_train_plain` under autograd. On a CUDA
tensor it is `StridedBlock1Train`:
  - forward (`strided_train_fwd`): K3's kernels (LayerNorm with the PE,
    GEMMs, window attention, the conv on the selected rows), keeping every
    intermediate the backward reads;
  - backward (`strided_train_bwd`): K5's backward kernels up to h1 and the
    conv's backward of `csrc/strided_bwd.cu` (`conv_dh1`: g · Wcᵀ scattered
    into the rows the taps read; `conv_dwc`: Tᵀ · g with the taps gathered
    from h1; both on the tensor cores; the crop residual), returning
    dx and the grads of all 13 operands (dpe the fixed-order sum of dx over
    windows), as `_fsb_bwd_rule` does.
The wrappers count one per call: "strided_train_fwd" on the forward's last
launch, "strided_train_bwd" on the backward's last launch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import cuda_lib
from .strided import (DENSE, conv_scatter_plain, conv_taps_plain, output_length,
                      strided_block1_plain, strided_conv)
from .temporal import gemm, layernorm, window_attention
from .temporal_train import (_sum_rows, colsum, dw_splits, gemm_dw, gemm_dx, layernorm_bwd,
                             window_attention_bwd)

COUNTER_FWD = "strided_train_fwd"
COUNTER_BWD = "strided_train_bwd"
ORDER = ["pe", "ln1_g", "ln1_b", "wqkv", "bqkv", "wp", "bp", "ln2_g", "ln2_b",
         "w1", "b1", "wc", "bc"]
HALVES = [f"{name}{kind}" for kind in ("_tc", "_tc_dx") for name in DENSE]


def conv_dh1_plain(g: torch.Tensor, wc: torch.Tensor, h1: torch.Tensor, *, stride: int,
                   paddings) -> torch.Tensor:
    """The conv's input gradient through fc1's relu: g (B, n_out, C), wc
    (3·hidden, C), h1 (B, n, hidden) → (B, n, hidden), `conv_scatter_plain` of
    g · wcᵀ, zero where h1 <= 0."""
    d = conv_scatter_plain(g @ wc.t(), h1.shape[1], stride, paddings)
    return torch.where(h1 > 0, d, 0.0)


def conv_dwc_plain(h1: torch.Tensor, g: torch.Tensor, *, stride: int, paddings) -> torch.Tensor:
    """The conv's kernel gradient Tᵀ · g, (3·hidden, C), T = `conv_taps_plain`(h1)."""
    taps = conv_taps_plain(h1, stride, paddings)
    return taps.reshape(-1, taps.shape[-1]).t() @ g.reshape(-1, g.shape[-1])


def conv_dh1(g: torch.Tensor, ops: Dict, h1: torch.Tensor, *, stride: int,
             paddings) -> torch.Tensor:
    """(B, n_out, C), (B, n, hidden) → dH1 (B, n, hidden). CPU tensor: the
    plain version; CUDA tensor: `strided_dh1_f32` (g · Wcᵀ on the tensor
    cores from Wc's halves as stored, "wc_tc_dx", scattered in the epilogue)."""
    if g.device.type == "cpu":
        return conv_dh1_plain(g, ops["wc"], h1, stride=stride, paddings=paddings)
    b, n_out, c = g.shape
    n, hidden = h1.shape[1:]
    g = g.reshape(b * n_out, c).contiguous()
    cuda_lib.check_cuda("g", g)
    cuda_lib.check_cuda("h1", h1, device=g.device)
    cuda_lib.check_cuda("wc_tc_dx", ops["wc_tc_dx"], shape=(2, 3 * hidden, c), device=g.device)
    out = torch.empty_like(h1)  # never h1 itself: the relu mask is read as dH1 is written
    cuda_lib.launch("strided_bwd", "strided_dh1_f32", None, g, ops["wc_tc_dx"], h1, out, b, n,
                    hidden, c, stride, int(paddings[0]), n_out)
    return out


def conv_dwc(h1: torch.Tensor, g: torch.Tensor, out: torch.Tensor, *, stride: int,
             paddings) -> torch.Tensor:
    """dWc (3·hidden, C) into `out`. CPU tensor: the plain version; CUDA
    tensor: `strided_dwc_f32` (Tᵀ · g on the tensor cores, T gathered from h1)
    split over the selected rows as `dw_splits` cuts them, the partials
    summed in a fixed order (`sum_rows_f32`)."""
    if g.device.type == "cpu":
        return out.copy_(conv_dwc_plain(h1, g, stride=stride, paddings=paddings))
    b, n_out, c = g.shape
    n, hidden = h1.shape[1:]
    g = g.reshape(b * n_out, c).contiguous()
    cuda_lib.check_cuda("g", g)
    cuda_lib.check_cuda("h1", h1, device=g.device)
    cuda_lib.check_cuda("out", out, shape=(3 * hidden, c), device=g.device)
    splits = dw_splits(b * n_out, 3 * hidden, c)
    part = torch.empty((splits, 3 * hidden, c), dtype=torch.float32, device=g.device)
    cuda_lib.launch("strided_bwd", "strided_dwc_f32", None, h1, g, part, b, n, hidden, c,
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
                      paddings=(0, 0)) -> Tuple[torch.Tensor, Dict]:
    """(B, S, C) → ((B, n_out, C), intermediates) on the card."""
    b, n, c = _geometry(x, stride, paddings)
    if c % num_heads != 0:
        raise ValueError(f"C={c} does not split into {num_heads} heads")
    for name in ORDER + HALVES:
        cuda_lib.check_cuda(name, ops[name], device=x.device)
    cuda_lib.check_cuda("pe", ops["pe"], shape=(n, c))
    h = x.reshape(b * n, c).contiguous()
    cuda_lib.check_cuda("x", h)
    xpe, y = layernorm(h, ops["ln1_g"], ops["ln1_b"], 1e-5, pe=ops["pe"], counter=None)
    qkv = gemm(y, ops["wqkv_tc"], ops["bqkv"], counter=None)
    ctx = window_attention(qkv, None, windows=b, n=n, num_heads=num_heads, counter=None)
    x2 = gemm(ctx, ops["wp_tc"], ops["bp"], residual=xpe, counter=None)
    z = layernorm(x2, ops["ln2_g"], ops["ln2_b"], 1e-5, counter=None)
    h1 = gemm(z, ops["w1_tc"], ops["b1"], relu=True, counter=None)
    out = strided_conv(h1.reshape(b, n, -1), x2.reshape(b, n, c), ops, stride=stride,
                       paddings=paddings, counter=COUNTER_FWD)
    saved = dict(xpe=xpe, y=y, qkv=qkv, ctx=ctx, x2=x2, z=z, h1=h1)
    return out, saved


def strided_train_bwd(saved: Dict, g: torch.Tensor, ops: Dict, *, num_heads: int,
                      stride: int, paddings=(0, 0)) -> Tuple[torch.Tensor, Dict]:
    """VJP of `strided_train_fwd` for g (B, n_out, C) → (dx (B, S, C), grads
    by operand name) on the card."""
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
    conv_dwc(h1, g3, grads["wc"], stride=stride, paddings=paddings)
    dpre1 = conv_dh1(g3, ops, h1, stride=stride, paddings=paddings).reshape(rows, hidden)
    # the MLP's first layer and LN2; then the crop residual joins dx2
    gemm_dw(saved["z"], dpre1, None, 1, grads["w1"], counter=None)
    colsum(dpre1, None, 1, grads["b1"], counter=None)
    dz = gemm_dx(dpre1, None, 1, ops["w1_tc_dx"], counter=None)
    dx2 = layernorm_bwd(saved["x2"], dz, ops["ln2_g"], None, grads["ln2_g"], grads["ln2_b"],
                        counter=None)
    cuda_lib.launch("strided_bwd", "crop_residual_add_f32", None, g, dx2, b, n, c, stride,
                    1 if p0 == 0 else 0, n_out)
    # attention branch: x2 = (x + pe) + proj(attention(LN1(x + pe)))
    gemm_dw(saved["ctx"], dx2, None, 1, grads["wp"], counter=None)
    colsum(dx2, None, 1, grads["bp"], counter=None)
    dctx = gemm_dx(dx2, None, 1, ops["wp_tc_dx"], counter=None)
    dqkv = window_attention_bwd(saved["qkv"], dctx, None, windows=b, n=n,
                                num_heads=num_heads, counter=None)
    gemm_dw(saved["y"], dqkv, None, 1, grads["wqkv"], counter=None)
    colsum(dqkv, None, 1, grads["bqkv"], counter=None)
    dy = gemm_dx(dqkv, None, 1, ops["wqkv_tc_dx"], counter=None)
    dx = layernorm_bwd(saved["xpe"], dy, ops["ln1_g"], dx2, grads["ln1_g"], grads["ln1_b"],
                       counter=None)
    _sum_rows(dx.reshape(b, n * c), grads["pe"], counter=COUNTER_BWD)  # dpe: Σ over windows
    return dx.reshape(b, n, c), grads


def saved_relu_mask(saved: Dict) -> torch.Tensor:
    """Where fc1's relu passed in `strided_train_fwd`."""
    return saved["h1"] > 0


def strided_block1_train_plain(x: torch.Tensor, ops: Dict, *, num_heads: int, stride: int,
                               paddings=(0, 0),
                               relu_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, C) → (B, n_out, C) in plain PyTorch (differentiable)."""
    return strided_block1_plain(x, ops, num_heads=num_heads, stride=stride,
                                paddings=tuple(paddings), relu_mask=relu_mask)


def strided_block1_bwd_plain(x: torch.Tensor, ops: Dict, g: torch.Tensor, *, num_heads: int,
                             stride: int, paddings=(0, 0),
                             relu_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, Dict]:
    """torch.autograd of the plain version: (dx, grads by operand name)."""
    with torch.enable_grad():
        leaves = {k: ops[k].detach().requires_grad_(True) for k in ORDER}
        xg = x.detach().requires_grad_(True)
        out = strided_block1_train_plain(xg, leaves, num_heads=num_heads, stride=stride,
                                         paddings=paddings, relu_mask=relu_mask)
        grads = torch.autograd.grad(out, [xg, *leaves.values()], g)
    return grads[0], dict(zip(ORDER, grads[1:]))


class StridedBlock1Train(torch.autograd.Function):
    """K6: apply(x, num_heads, stride, paddings, *operands in ORDER, *halves in
    HALVES); gradients for x and every operand (none for the halves)."""

    @staticmethod
    def forward(ctx, x, num_heads, stride, paddings, *leaves):
        out, saved = strided_train_fwd(x, dict(zip(ORDER + HALVES, leaves)),
                                       num_heads=num_heads, stride=stride, paddings=paddings)
        ctx.intermediates = saved
        ctx.cfg = dict(num_heads=num_heads, stride=stride, paddings=paddings)
        ctx.save_for_backward(*leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        dx, grads = strided_train_bwd(ctx.intermediates, g,
                                      dict(zip(ORDER + HALVES, ctx.saved_tensors)), **ctx.cfg)
        ctx.intermediates = None
        return (dx, None, None, None, *[grads[name] for name in ORDER],
                *[None] * len(HALVES))


def strided_block1_train(x: torch.Tensor, ops: Dict, *, num_heads: int, stride: int,
                         paddings=(0, 0)) -> torch.Tensor:
    """Differentiable (B, S, C) → (B, n_out, C). CPU tensor: the plain
    version under autograd; CUDA tensor: K6."""
    if x.device.type == "cpu":
        return strided_block1_train_plain(x, ops, num_heads=num_heads, stride=stride,
                                          paddings=paddings)
    paddings = (int(paddings[0]), int(paddings[1]))
    return StridedBlock1Train.apply(x, num_heads, stride, paddings,
                                    *[ops[name] for name in ORDER + HALVES])
