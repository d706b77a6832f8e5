"""Matmul precision rungs (counterpart of EVAL_MATMUL_PRECISION and the TPU's
dot precisions, `uplift_upsample_tpu/config.py:266-270`).

  "default" — the TPU's one-pass bf16 dot: each operand rounded to bf16 (to
              nearest, ties to even), the products summed in fp32, an fp32
              result. LayerNorm, softmax, activations, biases, the token
              substitution, PEs and residuals stay fp32.
  "high"    — the TPU's bf16x3; here fp32-level products (the kernels'
              3xTF32, TF32 off in the plain modules).
  "highest" — fp32. The port runs "high" and "highest" through the same code.

`matmul_precision(rung)` is the counterpart of `jax.default_matmul_precision`:
inside it the plain modules' products (the model's Dense layers, its
strided convs and its attention: `models/primitives.py`, `rung_matmul`)
follow the rung; outside any context they run fp32 ("highest"). The
kernel wrappers take the rung as their `precision=` argument instead; `mm`
is their plain versions' product at an explicit rung.

A bf16 value is also a TF32 value, so a product of bf16-rounded fp32
operands is exact in fp32 whether or not a library call runs it in TF32:
the rung's library products (the tail's Dense layers and conv, the s2t
Dense) run on the rounded operands with TF32 off, as everywhere else.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

RUNGS = ("default", "high", "highest")
BF16 = "default"  # the one-pass bf16 rung

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


def mm(a: torch.Tensor, b: torch.Tensor, rung: str) -> torch.Tensor:
    """a @ b at `rung`: on the bf16 rung both operands rounded first."""
    if rung == BF16:
        return round_bf16(a) @ round_bf16(b)
    return a @ b


def rung_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b at the current context's rung."""
    return mm(a, b, current())

