"""K4 — the spatial stack's backward (counterpart of ops/pallas_spatial_bwd.py).

`spatial_stack_bwd` returns the VJP of the spatial stack with stochastic
depth (`spatial.spatial_stack_plain` with scales) for an output gradient g:
the gradients of all 21 stacked operands, dx (F, 17, 2) and dscales (2L, F),
the three things `pallas_spatial_bwd.fused_spatial_stack_bwd` returns. On a
CUDA tensor it launches `csrc/spatial_bwd.cu` (one kernel: tiles of 7 frames,
the dense products on the tensor cores) and a fixed-order sum of the
per-thread-block gradient rows; on a CPU tensor it runs
`spatial_stack_bwd_plain`, torch.autograd of the plain version. On the bf16
rung ("default") the kernel's bf16 instance (`spatial_bwd_bf16`): its forward
replay rounds as K1's bf16 instance does, and every backward product takes
bf16-rounded operands (the gradient scaled by its branch's droppath factor
first) with fp32 sums, as the JAX kernel's `fwd_dot` / `grad_dot` at DEFAULT;
the attention, the LayerNorms and every sum stay fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..precision import BF16, check_rung
from . import cuda_lib
from .spatial import (PARAM_ORDER, check_kernel_shapes, spatial_stack_plain,
                      unpack_spatial_params)

COUNTER = "spatial_bwd"


def spatial_stack_bwd_plain(x: torch.Tensor, ops: Dict, scales: torch.Tensor,
                            g: torch.Tensor, *, num_heads: int, precision: str = "high"
                            ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """torch.autograd of `spatial_stack_plain` at the rung `precision`:
    (dparams, dx, dscales). On the bf16 rung every backward product rounds
    its operands (`precision.Bf16Matmul`), as the JAX kernel's DEFAULT dots."""
    with torch.enable_grad():
        leaves = {k: ops[k].detach().requires_grad_(True) for k in PARAM_ORDER}
        xg = x.detach().requires_grad_(True)
        sg = scales.detach().requires_grad_(True)
        out = spatial_stack_plain(xg, leaves, num_heads=num_heads, droppath_scales=sg,
                                  precision=precision)
        grads = torch.autograd.grad(out, [xg, sg, *leaves.values()], g)
    return dict(zip(PARAM_ORDER, grads[2:])), grads[0], grads[1]


def spatial_stack_bwd(x: torch.Tensor, ops: Dict, scales: torch.Tensor, g: torch.Tensor,
                      *, num_heads: int, packed: Optional[torch.Tensor] = None,
                      precision: str = "high") -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """VJP of the spatial stack: x (F, 17, 2), scales (2L, F), g (F, 17·C) →
    (dparams by operand name, dx, dscales). CPU tensor: plain version;
    CUDA tensor: K4, its bf16 instance (`spatial_bwd_bf16`) at "default"."""
    if x.device.type == "cpu":
        return spatial_stack_bwd_plain(x, ops, scales, g, num_heads=num_heads,
                                       precision=precision)
    entry = "spatial_bwd_bf16" if check_rung(precision) == BF16 else "spatial_bwd_f32"
    packed = check_kernel_shapes(x, ops, num_heads, packed, scales)
    f, p, _ = x.shape
    c = ops["pe"].shape[1]
    blocks = ops["ln1_g"].shape[0]
    cuda_lib.check_cuda("g", g, shape=(f, p * c), device=x.device)
    lib = cuda_lib.library("spatial_bwd")
    dx = torch.empty_like(x)
    ddp = torch.empty((2 * blocks, f), dtype=torch.float32, device=x.device)
    flat = torch.empty_like(packed)
    if f == 0:
        flat.zero_()
        ddp.zero_()
    else:
        workers = lib.spatial_bwd_workers(c, c // num_heads, blocks, f)
        if workers <= 0:
            raise RuntimeError(f"spatial_bwd_workers: CUDA error {-workers}")
        partial = torch.empty((workers, packed.numel()), dtype=torch.float32, device=x.device)
        scratch = torch.empty((workers, lib.spatial_bwd_scratch_floats(c, blocks)),
                              dtype=torch.float32, device=x.device)
        cuda_lib.launch("spatial_bwd", entry, COUNTER, x, g, scales, packed,
                        dx, ddp, partial, scratch, f, c, c // num_heads, blocks, workers)
        cuda_lib.launch("spatial_bwd", "sum_rows_f32", COUNTER, partial, flat, workers,
                        packed.numel())
    return unpack_spatial_params(flat, ops), dx, ddp
