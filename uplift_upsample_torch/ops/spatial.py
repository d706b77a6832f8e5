"""K1 — the fused spatial stack (counterpart of ops/pallas_spatial.py).

`spatial_stack` runs the whole spatial stage per frame: keypoint embedding +
spatial PE, the pre-norm blocks over the 17 joint tokens, and the final
LayerNorm (eps 1e-6). On a CUDA tensor it launches `csrc/spatial.cu` (which
replaces `pallas_spatial.fused_spatial_stack`); on a CPU tensor it runs
`spatial_stack_plain`, the same function in plain PyTorch.

Training (counterpart of `pallas_spatial.fused_spatial_train`): optional
stochastic-depth scales (2L, F) multiply block l's attention and MLP
branches by rows 2l and 2l+1 (`make_droppath_scales`). `spatial_stack_train`
is differentiable: on a CUDA tensor it is `SpatialStackTrain`, whose forward
is K1 and whose backward is K4 (`ops/spatial_bwd.py`), each at the train
step's spatial rung (bf16 instances at "default"); on a CPU tensor it is
the plain version under autograd. Gradients reach the stacked operands, and
through `stack_spatial_params` the module's parameters.

Unlike the TPU kernel's (P, C, F) frames-on-lanes layout, frames are rows
here: (F, 17, 2) in, (F, 17·C) out in p-major order, which is the
(B, N, P·C) layout the s2t Dense reads.

Precision (`precision.py`): `precision="high"` or "highest" runs the
3xTF32 instance (fp32-level products); "default", the TPU's one-pass bf16
rung, runs K1's bf16 instance (`spatial_stack_bf16`): the embedding's and
the dense layers' operands rounded to bf16, fp32 sums; the 17-token
attention stays fp32, as on the TPU's vector unit.

K1 is also the counterpart of `pallas_spatial.fused_spatial_stack_tiled`
(row 4 of the kernel table in PERF.md), which does the same per-frame math
on window-padded (n_tiles, P·C, wpt·72) tiles for the tiled eval pipeline:
the padding to 72 frames and the tile layout align the TPU's lanes, so the
port runs K1 on the B·N frames as rows (`models/bench_forward._tiled_forward`).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from ..precision import BF16, check_rung, mm
from . import cuda_lib

COUNTER = "spatial_stack"
_PACK_ORDER = ["ln1_g", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp",
               "ln2_g", "ln2_b", "w1", "b1", "w2", "b2"]
# The stacked operands, in the JAX package's order (pallas_spatial_bwd._PARAM_ORDER).
PARAM_ORDER = ["emb_w", "emb_b", "pe", *_PACK_ORDER, "norm_g", "norm_b"]


def _bias(state: Mapping[str, torch.Tensor], key: str, n: int, like) -> torch.Tensor:
    return state[key] if key in state else torch.zeros(n, dtype=like.dtype,
                                                       device=like.device)


def stack_spatial_params(state: Mapping[str, torch.Tensor], num_blocks: int) -> Dict:
    """Model state_dict → the spatial stack's operands, stacked over blocks.

    Matrices are (in, out), the flax layout the kernel reads; missing q/k/v
    biases (qkv_bias off) become zeros.
    """
    c = state["spatial_pe"].shape[1]

    def st(suffix, transpose=False, bias_of=None):
        out = []
        for i in range(1, num_blocks + 1):
            key = f"spatial_block_{i}.{suffix}"
            if bias_of is not None:
                t = _bias(state, key, bias_of, state["spatial_pe"])
            else:
                t = state[key]
            out.append(t.t() if transpose else t)
        return torch.stack(out).float().contiguous()

    ops = dict(
        emb_w=state["keypoint_embedding.weight"].t().float().contiguous(),
        emb_b=state["keypoint_embedding.bias"].float(),
        pe=state["spatial_pe"].float(),
        ln1_g=st("norm1.weight"), ln1_b=st("norm1.bias"),
        ln2_g=st("norm2.weight"), ln2_b=st("norm2.bias"),
        w1=st("mlp.fc1.weight", transpose=True), b1=st("mlp.fc1.bias"),
        w2=st("mlp.fc2.weight", transpose=True), b2=st("mlp.fc2.bias"),
        norm_g=state["spatial_norm.weight"].float(),
        norm_b=state["spatial_norm.bias"].float(),
    )
    for name, w in (("q", "wq"), ("k", "wk"), ("v", "wv"), ("p", "proj")):
        ops[f"w{name}"] = st(f"attn.{w}.weight", transpose=True)
        ops[f"b{name}"] = st(f"attn.{w}.bias", bias_of=c)
    return ops


def pack_spatial_params(ops: Dict) -> torch.Tensor:
    """The stacked operands as the one flat buffer csrc/spatial.cu stages."""
    parts = [ops["emb_w"], ops["emb_b"], ops["pe"]]
    for blk in range(ops["ln1_g"].shape[0]):
        parts += [ops[name][blk] for name in _PACK_ORDER]
    parts += [ops["norm_g"], ops["norm_b"]]
    return torch.cat([p.reshape(-1) for p in parts]).float().contiguous()


def unpack_spatial_params(flat: torch.Tensor, like: Dict) -> Dict:
    """The inverse of `pack_spatial_params`: a flat buffer in the packed
    layout → operands shaped as `like`'s (K4 writes its gradients so)."""
    pos = 0

    def take(shape):
        nonlocal pos
        size = math.prod(shape)
        t = flat[pos:pos + size].reshape(shape)
        pos += size
        return t

    out = {name: take(like[name].shape) for name in ("emb_w", "emb_b", "pe")}
    per_block = {name: [] for name in _PACK_ORDER}
    for _ in range(like["ln1_g"].shape[0]):
        for name in _PACK_ORDER:
            per_block[name].append(take(like[name].shape[1:]))
    for name, parts in per_block.items():
        out[name] = torch.stack(parts)
    out["norm_g"] = take(like["norm_g"].shape)
    out["norm_b"] = take(like["norm_b"].shape)
    if pos != flat.numel():
        raise ValueError(f"packed buffer of {flat.numel()} floats, layout takes {pos}")
    return out


def make_droppath_scales(generator: Optional[torch.Generator], rates: Sequence[float],
                         frames: int) -> torch.Tensor:
    """(2L, F) stochastic-depth scales on the CPU (counterpart of
    `pallas_spatial.make_droppath_scales`): per block and branch, per frame,
    floor(keep + U[0, 1)) / keep with keep = 1 - rate; ones where rate is 0."""
    rows = []
    for rate in rates:
        for _ in range(2):
            if rate == 0.0:
                rows.append(torch.ones(frames))
            else:
                keep = 1.0 - float(rate)
                u = torch.rand(frames, generator=generator)
                rows.append(torch.floor(keep + u) / keep)
    return torch.stack(rows) if rows else torch.ones((0, frames))


def spatial_stack_plain(x: torch.Tensor, ops: Dict, *, num_heads: int,
                        droppath_scales: Optional[torch.Tensor] = None,
                        precision: str = "high",
                        attention_precision: str = "highest") -> torch.Tensor:
    """(F, P, 2) keypoints → (F, P·C): the spatial stage in plain PyTorch.

    droppath_scales: (2L, F) per-frame factors of the blocks' branches, or None.
    precision: the rung of the embedding's and the dense layers' products;
    the 17-token attention stays fp32 (as K1 computes it) unless
    `attention_precision` says otherwise (the model's own attention on the
    bf16 rung: the train step's plain spatial stage)."""
    f, p, _ = x.shape
    c = ops["pe"].shape[1]
    d = c // num_heads
    rung = check_rung(precision)
    h = mm(x, ops["emb_w"], rung) + ops["emb_b"] + ops["pe"]
    for blk in range(ops["ln1_g"].shape[0]):
        g = {name: ops[name][blk] for name in _PACK_ORDER}
        y = F.layer_norm(h, (c,), g["ln1_g"], g["ln1_b"], 1e-5)
        q, k, v = ((mm(y, g[f"w{n}"], rung) + g[f"b{n}"]).reshape(f, p, num_heads, d)
                   .transpose(1, 2) for n in "qkv")
        att = torch.softmax(mm(q, k.transpose(-1, -2), attention_precision)
                            * (1.0 / d ** 0.5), dim=-1)
        ctx = mm(att, v, attention_precision).transpose(1, 2).reshape(f, p, c)
        proj = mm(ctx, g["wp"], rung) + g["bp"]
        if droppath_scales is not None:
            proj = proj * droppath_scales[2 * blk][:, None, None]
        h = h + proj
        z = F.layer_norm(h, (c,), g["ln2_g"], g["ln2_b"], 1e-5)
        z = F.gelu(mm(z, g["w1"], rung) + g["b1"], approximate="none")
        z = mm(z, g["w2"], rung) + g["b2"]
        if droppath_scales is not None:
            z = z * droppath_scales[2 * blk + 1][:, None, None]
        h = h + z
    h = F.layer_norm(h, (c,), ops["norm_g"], ops["norm_b"], 1e-6)
    return h.reshape(f, p * c)


def check_kernel_shapes(x: torch.Tensor, ops: Dict, num_heads: int,
                        packed: Optional[torch.Tensor],
                        droppath_scales: Optional[torch.Tensor]) -> torch.Tensor:
    """Raise unless K1/K4 take these operands; returns the packed weights."""
    f, p, two = x.shape
    c = ops["pe"].shape[1]
    if p != 17 or two != 2 or c not in (16, 32) or c // num_heads != 4:
        raise ValueError(f"spatial kernel takes (F, 17, 2) input, C in (16, 32) "
                         f"and head depth 4; got {tuple(x.shape)}, C={c}, "
                         f"heads={num_heads}")
    blocks = ops["ln1_g"].shape[0]
    if ops["w1"].shape[-1] != 2 * c:
        raise ValueError("spatial kernel takes an MLP hidden width of 2C")
    if packed is None:
        packed = pack_spatial_params(ops)
    cuda_lib.check_cuda("x", x)
    cuda_lib.check_cuda("packed", packed, shape=(22 * c + blocks * (8 * c * c + 11 * c),),
                        device=x.device)
    if droppath_scales is not None:
        cuda_lib.check_cuda("droppath_scales", droppath_scales, shape=(2 * blocks, f),
                            device=x.device)
    return packed


def spatial_stack(x: torch.Tensor, ops: Dict, *, num_heads: int,
                  packed: torch.Tensor = None,
                  droppath_scales: Optional[torch.Tensor] = None,
                  precision: str = "high") -> torch.Tensor:
    """(F, 17, 2) → (F, 17·C). CPU tensor: plain version; CUDA tensor: K1.

    `packed` is `pack_spatial_params(ops)` on the same device, built here if
    not given (callers that run many batches pack once). `droppath_scales`
    (2L, F) as in `spatial_stack_plain`. `precision` "default" launches the
    bf16 instance (`spatial_stack_bf16`, the same packed weights, rounded as
    K1 stages them), "high" and "highest" the 3xTF32 one.
    """
    if x.device.type == "cpu":
        return spatial_stack_plain(x, ops, num_heads=num_heads,
                                   droppath_scales=droppath_scales, precision=precision)
    entry = "spatial_stack_bf16" if check_rung(precision) == BF16 else "spatial_stack_f32"
    packed = check_kernel_shapes(x, ops, num_heads, packed, droppath_scales)
    f, p, _ = x.shape
    c = ops["pe"].shape[1]
    out = torch.empty((f, p * c), dtype=torch.float32, device=x.device)
    if f == 0:
        return out
    cuda_lib.launch("spatial", entry, COUNTER, x, packed, droppath_scales,
                    out, f, c, c // num_heads, ops["ln1_g"].shape[0])
    return out


class SpatialStackTrain(torch.autograd.Function):
    """K1 forward, K4 backward (counterpart of `fused_spatial_train`).

    apply(x, droppath_scales, num_heads, precision, *operands in PARAM_ORDER);
    returns gradients for x, the scales and every operand. `precision`
    "default" runs K1's and K4's bf16 instances.
    """

    @staticmethod
    def forward(ctx, x, scales, num_heads, precision, *leaves):
        ops = dict(zip(PARAM_ORDER, leaves))
        packed = pack_spatial_params(ops)
        out = spatial_stack(x, ops, num_heads=num_heads, packed=packed,
                            droppath_scales=scales, precision=precision)
        ctx.save_for_backward(x, scales, packed, *leaves)
        ctx.num_heads, ctx.precision = num_heads, precision
        return out

    @staticmethod
    def backward(ctx, g):
        from .spatial_bwd import spatial_stack_bwd
        x, scales, packed, *leaves = ctx.saved_tensors
        dparams, dx, ddp = spatial_stack_bwd(x, dict(zip(PARAM_ORDER, leaves)), scales,
                                             g.contiguous(), num_heads=ctx.num_heads,
                                             packed=packed, precision=ctx.precision)
        return (dx, ddp, None, None, *[dparams[name] for name in PARAM_ORDER])


def spatial_stack_train(x: torch.Tensor, ops: Dict, droppath_scales: torch.Tensor, *,
                        num_heads: int, precision: str = "high") -> torch.Tensor:
    """Differentiable (F, 17, 2) → (F, 17·C) with stochastic depth.

    CPU tensor: the plain version under autograd (on the bf16 rung its
    products' backward rounds their operands too, `precision.Bf16Matmul`,
    as K4 does); CUDA tensor: K1 forward and K4 backward
    (`SpatialStackTrain`), at the rung `precision`.
    """
    if x.device.type == "cpu":
        return spatial_stack_plain(x, ops, num_heads=num_heads,
                                   droppath_scales=droppath_scales, precision=precision)
    return SpatialStackTrain.apply(x, droppath_scales.float().contiguous(), num_heads,
                                   check_rung(precision),
                                   *[ops[name] for name in PARAM_ORDER])


def spatial_stack_apply(ops: Dict, x2d: torch.Tensor, *, num_heads: int,
                        packed: torch.Tensor = None, precision: str = "high") -> torch.Tensor:
    """(B, N, P, 2) masked keypoints → (B, N, P·C) spatial output.

    Drop-in replacement for the model's spatial stage + reshape (before the
    spatial_to_temporal Dense), eval mode, at the rung `precision`.
    """
    b, n, p, c_in = x2d.shape
    y = spatial_stack(x2d.reshape(b * n, p, c_in).contiguous(), ops,
                      num_heads=num_heads, packed=packed, precision=precision)
    return y.reshape(b, n, -1)
