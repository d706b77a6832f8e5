"""Matmul precision rungs (counterpart of EVAL_MATMUL_PRECISION,
TRAIN_MATMUL_PRECISION and the TPU's dot precisions,
`uplift_upsample_tpu/config.py:224-270`).

  "default" — the TPU's one-pass bf16 dot: each operand rounded to bf16 (to
              nearest, ties to even), the products summed in fp32, an fp32
              result. LayerNorm, softmax, activations, biases, the token
              substitution, PEs and residuals stay fp32.
  "high"    — the TPU's bf16x3; here fp32-level products (the kernels'
              3xTF32, TF32 off in the plain modules).
  "highest" — fp32. The port runs "high" and "highest" through the same code.

`matmul_precision(rung)` is the counterpart of `jax.default_matmul_precision`:
inside it the plain modules' products (the model's Dense layers, its
strided convs and its attention: `models/primitives.py`, `rung_linear`,
`rung_conv1d`, `rung_matmul`) follow the rung; outside any context they run
fp32 ("highest"). The kernel wrappers take the rung as their `precision=`
argument instead; `mm` is their plain versions' product at an explicit rung.

Under autograd the bf16 rung's product is `Bf16Matmul` (`Bf16Linear`,
`Bf16Conv1d` for the model's Dense layers and conv):
its backward is the TPU's DEFAULT transpose, each backward product on
bf16-rounded operands with fp32 sums, dX = round(g) · round(W)ᵀ and
dW = round(X)ᵀ · round(g). Autograd of `round_bf16(a) @ round_bf16(b)`
would instead round the gradient's result (the cast's backward).

The eval reads EVAL_MATMUL_PRECISION (`check_rung`); the train step reads
TRAIN_MATMUL_PRECISION (`train_rungs`), four rungs mapped onto its stages as
the JAX step maps them (`uplift_upsample_tpu/parallel/train_step.py:213-224`).

A bf16 value is also a TF32 value, so a product of bf16-rounded fp32
operands is exact in fp32 whether or not a library call runs it in TF32:
the rung's library products (the tail's Dense layers and conv, the s2t
Dense) run on the rounded operands with TF32 off, as everywhere else.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

RUNGS = ("default", "high", "highest")
BF16 = "default"  # the one-pass bf16 rung
TRAIN_RUNGS = ("mixed", "default", "high", "highest")

_RUNG: contextvars.ContextVar = contextvars.ContextVar("matmul_precision",
                                                       default="highest")


def check_rung(rung: str, use_pallas: bool = False, tp=None) -> str:
    """`rung`, checked (EVAL_MATMUL_PRECISION): one of RUNGS; the bf16 rung
    neither with USE_PALLAS_ATTENTION (row 11 runs fp32 only: ROADMAP A8)
    nor split over mp > 1 (`tp`, ROADMAP C)."""
    if rung not in RUNGS:
        raise ValueError(f"matmul precision (EVAL_MATMUL_PRECISION) {rung!r}: "
                         f"expected one of {RUNGS}")
    if rung == BF16 and use_pallas:
        raise NotImplementedError(
            "matmul precision 'default' with USE_PALLAS_ATTENTION is not ported: the "
            "packed attention op (row 11) runs fp32 only (ROADMAP A8)")
    if rung == BF16 and tp is not None and tp.size > 1:
        raise NotImplementedError(
            "matmul precision 'default' is not split for tensor parallelism (mp > 1): "
            "ROADMAP C")
    return rung


def current() -> str:
    """The rung of the innermost `matmul_precision` context ("highest" outside one)."""
    return _RUNG.get()


@contextlib.contextmanager
def matmul_precision(rung: str):
    """The plain modules' products follow `rung` inside the block."""
    token = _RUNG.set(check_rung(rung))
    try:
        yield
    finally:
        _RUNG.reset(token)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even) and back to its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    return t if t.shape == shape else t.sum_to_size(shape)


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One product site of the bf16 rung: a @ b on operands already rounded
    to bf16, fp32 sums (`Bf16Matmul` runs every product of its forward and
    backward through it, `Bf16Linear` its backward's)."""
    return a @ b


class Bf16Matmul(torch.autograd.Function):
    """a @ b on bf16-rounded operands, fp32 sums; its backward rounds the
    operands of each product: da = round(g) @ round(b)ᵀ, db = round(a)ᵀ @
    round(g) (a (…, M, K); b (K, N) or batched as a)."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_bf16(a), round_bf16(b)
        ctx.save_for_backward(ra, rb)
        ctx.shapes = (a.shape, b.shape)
        return bf16_product(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        a_shape, b_shape = ctx.shapes
        rg = round_bf16(g)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _sum_to(bf16_product(rg, rb.transpose(-1, -2)), a_shape)
        if ctx.needs_input_grad[1]:
            if rb.dim() == 2:  # one product over every leading row
                db = bf16_product(ra.reshape(-1, ra.shape[-1]).t(), rg.reshape(-1, rg.shape[-1]))
            else:
                db = _sum_to(bf16_product(ra.transpose(-1, -2), rg), b_shape)
        return da, db


class Bf16Linear(torch.autograd.Function):
    """F.linear on bf16-rounded x and weight (out, in), fp32 sums, the bias
    added as F.linear adds it; its backward rounds the operands of each
    product as `Bf16Matmul` does (the bias gradient an fp32 sum)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        rx, rw = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(rx, rw)
        ctx.has_bias = bias is not None
        return F.linear(rx, rw, bias)

    @staticmethod
    def backward(ctx, g):
        rx, rw = ctx.saved_tensors
        rg = round_bf16(g)
        g2 = rg.reshape(-1, rg.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = bf16_product(g2, rw).reshape(rx.shape)
        if ctx.needs_input_grad[1]:
            dw = bf16_product(g2.t(), rx.reshape(-1, rx.shape[-1]))
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.reshape(-1, g.shape[-1]).sum(0)
        return dx, dw, db


class Bf16Conv1d(torch.autograd.Function):
    """F.conv1d (VALID) on bf16-rounded operands, fp32 sums, the bias added
    as F.conv1d adds it; its backward rounds the operands of each product as
    `Bf16Matmul` does."""

    @staticmethod
    def forward(ctx, x, w, bias, stride):
        rx, rw = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(rx, rw)
        ctx.stride, ctx.has_bias = stride, bias is not None
        return F.conv1d(rx, rw, bias, stride)

    @staticmethod
    def backward(ctx, g):
        rx, rw = ctx.saved_tensors
        rg = round_bf16(g)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv1d_input(rx.shape, rw, rg, ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv1d_weight(rx, rw.shape, rg, ctx.stride)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum((0, 2))
        return dx, dw, db, None


def mm(a: torch.Tensor, b: torch.Tensor, rung: str) -> torch.Tensor:
    """a @ b at `rung`: on the bf16 rung both operands rounded first
    (`Bf16Matmul`, whose backward rounds its products' operands too)."""
    if rung == BF16:
        return Bf16Matmul.apply(a, b)
    return a @ b


def rung_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b at the current context's rung."""
    return mm(a, b, current())


def rung_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor = None) -> torch.Tensor:
    """F.linear at the current context's rung (weight (out, in))."""
    if current() != BF16:
        return F.linear(x, weight, bias)
    return Bf16Linear.apply(x, weight, bias)


def rung_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor = None,
                stride: int = 1) -> torch.Tensor:
    """F.conv1d (VALID) at the current context's rung."""
    if current() != BF16:
        return F.conv1d(x, weight, bias, stride)
    return Bf16Conv1d.apply(x, weight, bias, stride)


def train_rungs(rung: str):
    """TRAIN_MATMUL_PRECISION → (spatial, temporal, plain) rungs: the spatial
    kernels (K1's training launch, K4), the temporal ones (K5, K6), and the
    plain products (the s2t Dense, the tail, the stages that run plain).

      "default": bf16 everywhere (the JAX package's shipped rung);
      "mixed": the spatial kernels at "highest" (3xTF32), the rest bf16;
      "high", "highest": fp32-level everywhere.

    The JAX step opens no matmul-precision context, so on the TPU its XLA
    products run one bf16 pass at every rung; the port follows it at
    "default" and "mixed" and keeps them fp32 at "high" and "highest", the
    function the JAX step computes on the CPU (ROADMAP, departures)."""
    if rung not in TRAIN_RUNGS:
        raise ValueError(f"TRAIN_MATMUL_PRECISION {rung!r}: expected one of {TRAIN_RUNGS}")
    return {"default": (BF16, BF16, BF16), "mixed": ("highest", BF16, BF16),
            "high": ("high", "high", "high"), "highest": ("highest", "highest", "highest")}[rung]
