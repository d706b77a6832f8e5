"""K1 — the fused spatial stack (counterpart of ops/pallas_spatial.py).

`spatial_stack` runs the whole spatial stage per frame: keypoint embedding +
spatial PE, the pre-norm blocks over the 17 joint tokens, and the final
LayerNorm (eps 1e-6). On a CUDA tensor it launches `csrc/spatial.cu` (which
replaces `pallas_spatial.fused_spatial_stack`); on a CPU tensor it runs
`spatial_stack_plain`, the same function in plain PyTorch.

Unlike the TPU kernel's (P, C, F) frames-on-lanes layout, frames are rows
here: (F, 17, 2) in, (F, 17·C) out in p-major order, which is the
(B, N, P·C) layout the s2t Dense reads.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from . import cuda_lib

COUNTER = "spatial_stack"
_PACK_ORDER = ["ln1_g", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp",
               "ln2_g", "ln2_b", "w1", "b1", "w2", "b2"]


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


def spatial_stack_plain(x: torch.Tensor, ops: Dict, *, num_heads: int) -> torch.Tensor:
    """(F, P, 2) keypoints → (F, P·C): the spatial stage in plain PyTorch."""
    f, p, _ = x.shape
    c = ops["pe"].shape[1]
    d = c // num_heads
    h = x @ ops["emb_w"] + ops["emb_b"] + ops["pe"]
    for blk in range(ops["ln1_g"].shape[0]):
        g = {name: ops[name][blk] for name in _PACK_ORDER}
        y = F.layer_norm(h, (c,), g["ln1_g"], g["ln1_b"], 1e-5)
        q, k, v = ((y @ g[f"w{n}"] + g[f"b{n}"]).reshape(f, p, num_heads, d)
                   .transpose(1, 2) for n in "qkv")
        att = torch.softmax(q @ k.transpose(-1, -2) * (1.0 / d ** 0.5), dim=-1)
        ctx = (att @ v).transpose(1, 2).reshape(f, p, c)
        h = h + (ctx @ g["wp"] + g["bp"])
        z = F.layer_norm(h, (c,), g["ln2_g"], g["ln2_b"], 1e-5)
        z = F.gelu(z @ g["w1"] + g["b1"], approximate="none")
        h = h + (z @ g["w2"] + g["b2"])
    h = F.layer_norm(h, (c,), ops["norm_g"], ops["norm_b"], 1e-6)
    return h.reshape(f, p * c)


def spatial_stack(x: torch.Tensor, ops: Dict, *, num_heads: int,
                  packed: torch.Tensor = None) -> torch.Tensor:
    """(F, 17, 2) → (F, 17·C). CPU tensor: plain version; CUDA tensor: K1.

    `packed` is `pack_spatial_params(ops)` on the same device, built here if
    not given (callers that run many batches pack once).
    """
    if x.device.type == "cpu":
        return spatial_stack_plain(x, ops, num_heads=num_heads)
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
    out = torch.empty((f, p * c), dtype=torch.float32, device=x.device)
    if f == 0:
        return out
    cuda_lib.launch("spatial", "spatial_stack_f32", COUNTER, x, packed, out,
                    f, c, c // num_heads, blocks)
    return out


def spatial_stack_apply(ops: Dict, x2d: torch.Tensor, *, num_heads: int,
                        packed: torch.Tensor = None) -> torch.Tensor:
    """(B, N, P, 2) masked keypoints → (B, N, P·C) spatial output.

    Drop-in replacement for the model's spatial stage + reshape (before the
    spatial_to_temporal Dense), eval mode.
    """
    b, n, p, c_in = x2d.shape
    y = spatial_stack(x2d.reshape(b * n, p, c_in).contiguous(), ops,
                      num_heads=num_heads, packed=packed)
    return y.reshape(b, n, -1)
