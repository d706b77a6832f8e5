"""The s2t prologue: the spatial-to-temporal Dense, the strided-input token
and the temporal PE in one kernel (counterpart of the prologue of
`pallas_temporal_v3.fused_temporal_stack_v3_tiled`, `_make_kernel_v3` with
s2t=True, which the TPU runs inside its tiled temporal kernel).

Per frame of (B, N, K) spatial output:

    out[b, t] = m[b, t] * (sp[b, t] @ W + bias) + (1 - m[b, t]) * token + pe[t]

m the stride mask (1 on frames carrying real input; None: all real). On a
CUDA tensor `s2t_prologue` launches `csrc/s2t.cu`: the GEMM on the tensor
cores in 3xTF32 (`csrc/gemm_tc.cuh`, fp32-level error) on W's TF32 halves
"w_tc", or with `precision` "default" (the TPU's one-pass bf16 rung) the
bf16 instance on W's bf16 plane "w_bf", with the bias, token and PE in its
epilogue; on a CPU tensor it runs `s2t_prologue_plain`, the same function
in plain PyTorch. W's halves and plane are prepared once, by `s2t_params`
(a hand-built ops dict: `add_s2t_operands`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..precision import BF16, check_rung, mm
from . import cuda_lib
from .temporal import bf16_plane, tf32_halves

COUNTER = "s2t_prologue"


def add_s2t_operands(ops: Dict, precision: str = "high") -> Dict:
    """`ops` with W's TF32 halves "w_tc" (2, C, K) and, on the bf16 rung
    (`precision` "default"), its bf16 plane "w_bf" (C, K): what the kernel
    reads, prepared once."""
    out = dict(ops, w_tc=tf32_halves(ops["w"]))
    if check_rung(precision) == BF16:
        out["w_bf"] = bf16_plane(ops["w"])
    return out


def s2t_params(model, precision: str = "high") -> Dict[str, torch.Tensor]:
    """The prologue's operands from a model: w (K, C) in (in, out) layout,
    bias (C,), token (C,) or None without strided input, pe (N, C), and
    `add_s2t_operands`'s for the rung `precision`."""
    fc = model.spatial_to_temporal_fc
    token = model.strided_input_token if model.has_strided_input else None
    ops = dict(w=fc.weight.t(), bias=fc.bias, token=token, pe=model.temporal_pe)
    return add_s2t_operands({k: None if v is None else v.detach().float().contiguous()
                             for k, v in ops.items()}, precision)


def s2t_prologue_plain(sp: torch.Tensor, ops: Dict,
                       stride_mask: Optional[torch.Tensor],
                       precision: str = "high") -> torch.Tensor:
    """(B, N, K) → (B, N, C): the prologue in plain PyTorch, in the model's
    order (Dense at the rung `precision`, token substitution, PE)."""
    y = mm(sp, ops["w"], check_rung(precision)) + ops["bias"]
    if stride_mask is not None:
        m = stride_mask.to(y.dtype)[..., None]
        y = m * y + (1.0 - m) * ops["token"]
    return y + ops["pe"]


def s2t_prologue(sp: torch.Tensor, ops: Dict,
                 stride_mask: Optional[torch.Tensor], precision: str = "high") -> torch.Tensor:
    """(B, N, K) → (B, N, C). CPU tensor: plain version; CUDA tensor: the
    kernel (the bf16 instance with `precision` "default"). stride_mask (B,
    N), or None when every frame is real (then the token is not read)."""
    if stride_mask is not None and ops["token"] is None:
        raise ValueError("a stride mask needs the strided-input token")
    if sp.device.type == "cpu":
        return s2t_prologue_plain(sp, ops, stride_mask, precision)
    bf16 = check_rung(precision) == BF16
    b, n, k = sp.shape
    c = ops["w"].shape[1]
    if k % 4:
        raise ValueError(f"the s2t kernel loads rows of 16 bytes: K={k} is not a multiple of 4")
    name = "w_bf" if bf16 else "w_tc"
    if name not in ops:
        raise ValueError(f"the s2t kernel reads {name}: prepare it with add_s2t_operands")
    x = sp.reshape(b * n, k).contiguous()
    cuda_lib.check_cuda("sp", x)
    cuda_lib.check_cuda(name, ops[name], shape=(c, k) if bf16 else (2, c, k), device=x.device)
    cuda_lib.check_cuda("bias", ops["bias"], shape=(c,), device=x.device)
    cuda_lib.check_cuda("pe", ops["pe"], shape=(n, c), device=x.device)
    mask = token = None
    if stride_mask is not None:
        mask = stride_mask.to(torch.float32).reshape(b * n).contiguous()
        token = ops["token"]
        cuda_lib.check_cuda("stride_mask", mask, device=x.device)
        cuda_lib.check_cuda("token", token, shape=(c,), device=x.device)
    out = torch.empty((b * n, c), dtype=torch.float32, device=x.device)
    cuda_lib.launch("s2t", "s2t_prologue_bf16" if bf16 else "s2t_prologue_f32", COUNTER, x,
                    ops[name], ops["bias"], mask, token, ops["pe"], out, b * n, c, k, n)
    return out.reshape(b, n, c)
