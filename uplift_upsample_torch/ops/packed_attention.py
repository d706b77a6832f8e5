"""Row 11 — packed multi-head attention (counterpart of ops/pallas_attention.py).

`packed_multihead_attention(q, k, v, mask, num_heads=H)` computes
softmax(q kᵀ / sqrt(D) + mask · -1e9) v per head on q, k and v in the packed
(F, S, H·D) layout the projections produce, with an optional (F, S) key mask
(1 = blocked; additive and finite, so a row whose keys are all blocked still
takes a softmax over them). S <= 128, the JAX package's gate. On a CUDA
tensor it launches `csrc/attention.cu` (which replaces
`pallas_attention.packed_multihead_attention`); on a CPU tensor it runs
`packed_attention_plain`, the split-head math in plain PyTorch.

`precision` is the matmul rung of the TPU kernel's two dots, which carry no
precision of their own and so take the ambient one
(`pallas_attention._head_attention`): on the bf16 rung ("default") the
logits at head depth D <= 8 stay fp32 FMAs with no rounding (the spatial
blocks' D = 4, `:36-41`), beyond 8 they are one bf16 pass on q and k (`:43-44`),
scaled after the product; P·V is one bf16 pass on the normalised
probabilities and on v (`:49-50`); sums and the softmax are fp32.

bf16 tensors (COMPUTE_DTYPE bfloat16) are what the TPU kernel widens to fp32
(`:63-66`), computes at the rung, and writes back in q's dtype (`:118`): the
result is bf16. On the card they launch `csrc/attention_bf16.cu`'s
bf16-operand instances, which load and store bf16; the bf16 rung on fp32
tensors launches its `packed_attention_bf16`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..precision import BF16, check_rung, mm, round_bf16
from . import cuda_lib

COUNTER = "packed_attention"
MAX_SEQ = 128
SMALL_DEPTH = 8  # D at or below which the TPU kernel's logits are fp32 FMAs (`_SMALL_DEPTH`)
DTYPES = (torch.float32, torch.bfloat16)


def packed_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None, *,
                           num_heads: int, precision: str = "high") -> torch.Tensor:
    """(F, S, C) q, k, v → (F, S, C) context at the rung `precision`, in q's
    dtype (bf16 tensors are widened to fp32 first and the context rounded
    back; float64 ones, a reference, stay float64)."""
    rung = check_rung(precision)
    f, s, c = q.shape
    out = mm(_probabilities(q, k, mask, num_heads, rung), _split(v, num_heads), rung)
    return out.transpose(1, 2).reshape(f, s, c).to(q.dtype)


def _split(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(F, S, H·D) → (F, H, S, D), bf16 widened to fp32."""
    f, s, c = t.shape
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.reshape(f, s, num_heads, c // num_heads).transpose(1, 2)


def _probabilities(q, k, mask, num_heads: int, rung: str) -> torch.Tensor:
    """The normalised P, (F, H, S, S), of the plain version at `rung`."""
    d = q.shape[-1] // num_heads
    logits = mm(_split(q, num_heads), _split(k, num_heads).transpose(-1, -2),
                rung if d > SMALL_DEPTH else "highest")
    logits = logits * (1.0 / math.sqrt(d))
    if mask is not None:
        logits = logits + mask.to(logits.dtype)[:, None, None, :] * -1e9
    return torch.softmax(logits, dim=-1)


TIE_REL = 2.0 ** -16  # a P this close (relative) to a bf16 rounding boundary rounds either way


def bf16_flip_allowance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, *,
                        num_heads: int) -> torch.Tensor:
    """(F, S, C) float64: how far flipped roundings of P may move each output
    of the bf16 rung, the tolerance its kernels are held to beyond their
    plain version's own distance to the rung with float64 sums. P is that
    rung's (float64 sums); one whose distance to the nearest midpoint
    between two bf16 values is within TIE_REL of itself is at a tie: fp32
    sums in another order, or the kernels' base-2 softmax, round it either
    way, which moves the output by one bf16 unit of P times |bf16(v)|.
    Zero for an output whose row has no P at a tie."""
    f, s, c = q.shape
    p = _probabilities(q.double(), k.double(), mask, num_heads, BF16)
    ulp = torch.ldexp(torch.ones_like(p), torch.frexp(p).exponent - 8)
    at_tie = ulp * 0.5 - (p - round_bf16(p)).abs() <= TIE_REL * p
    ulp = torch.where(at_tie, ulp, torch.zeros_like(ulp))
    del p, at_tie
    vh = round_bf16(_split(v.double(), num_heads))
    return (ulp @ vh.abs()).transpose(1, 2).reshape(f, s, c)


_ENTRIES = {(torch.float32, False): ("attention", "packed_attention_f32"),
            (torch.float32, True): ("attention_bf16", "packed_attention_bf16"),
            (torch.bfloat16, False): ("attention_bf16", "packed_attention_bf16io"),
            (torch.bfloat16, True): ("attention_bf16", "packed_attention_bf16io_bf16")}


def packed_multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               mask: Optional[torch.Tensor] = None, *,
                               num_heads: int, precision: str = "high") -> torch.Tensor:
    """(F, S, C) → (F, S, C) in q's dtype (float32 or bfloat16). CPU tensor:
    plain version; CUDA tensor: the kernel of the rung and dtype.

    mask: (F, S), 1/True = blocked key, or None.
    """
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, mask, num_heads=num_heads, precision=precision)
    f, s, c = q.shape
    if c % num_heads != 0 or s > MAX_SEQ:
        raise ValueError(f"packed attention takes S <= {MAX_SEQ} and C divisible by "
                         f"the heads; got S={s}, C={c}, heads={num_heads}")
    if q.dtype not in DTYPES:
        raise ValueError(f"packed attention takes {DTYPES} tensors, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.check_cuda(name, t, shape=(f, s, c), device=q.device, dtype=q.dtype)
    key_mask = None
    if mask is not None:
        key_mask = mask.to(torch.float32).contiguous()
        cuda_lib.check_cuda("mask", key_mask, shape=(f, s), device=q.device)
    out = torch.empty_like(q)
    if f == 0:
        return out
    lib, entry = _ENTRIES[(q.dtype, check_rung(precision) == BF16)]
    cuda_lib.launch(lib, entry, COUNTER, q, k, v, key_mask, out, f, s, c, num_heads)
    return out
