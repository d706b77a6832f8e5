"""K3 — strided block 1 (counterpart of ops/pallas_strided.py).

`strided_block1` runs the first strided transformer block on the temporal
stack's output: per-block PE, LN, qkv, full-window attention (no key mask),
proj, residual, LN, fc1 + relu, then the k=3 conv with stride s0 and the
residual. It returns only the n_out rows the next block reads,
out[:, t] = x[:, s0·t + (p0 == 0)] + conv(h1)[:, t], for paddings (p0, p1)
with p0, p1 ∈ {0, 1}: (0, 0) for h36m_351, (1, 1) for h36m_81.

On a CUDA tensor it launches the GEMM, LayerNorm and attention kernels of
`csrc/temporal.cu` and the conv kernel of `csrc/strided.cu` (together they
replace `pallas_strided.make_strided_b1_epilogue`); on a CPU tensor it runs
`strided_block1_plain`, the same function in plain PyTorch. Every product,
the conv's too, runs on the tensor cores in 3xTF32 from TF32 halves split
once with the operands (DENSE, `temporal.add_tf32_halves`); the conv's
operand T, its three taps of h1 side by side, is gathered as it is loaded
(`conv_tap_rows` is its index).

K3 is also the counterpart of the TPU's other strided-block-1 kernels (rows
of the kernel table in PERF.md), which compute the same function in other
Mosaic layouts:
  - row 7, `make_strided_b1_epilogue_sel` with `make_strided_sel`: the
    selection of rows u = s0·t as one-hot dots inside the kernel; K3 computes
    only the n_out selected rows in any case;
  - rows 5 and 6, `make_strided_b1_epilogue_banded_sel` and
    `make_strided_b1_epilogue_banded`: the same block after banded
    attention, paddings (0, 0);
  - row 8, `fused_strided_block1`: the block as its own pass. The TPU kernel
    returns the pre-selection (B, N_pad, C) and every caller keeps only the
    rows s0·t; `strided_block1` returns only those rows, (B, n_out, C).

Precision (`precision.py`): "default", the TPU's one-pass bf16 rung, runs
the bf16 instances of K2's GEMM and attention and `strided_conv_bf16` (T
rounded to bf16 as it leaves shared memory, one TF32 pass on Wc's bf16
plane "wc_bf"); the planes come from `temporal.add_bf16_planes` (DENSE).
"high" and "highest" run the 3xTF32 kernels. Not split over mp.

Split over mp (`tp`: the operands stacked from an mp rank's shard of the
weights), the block runs as K2's split blocks do (`temporal.py`) and ends in
the conv over the rank's hidden channels as a partial sum, then an
all-reduce: mp rank 0 passes the crop residual and bc, the other ranks zeros
in their place, so the sum is x + bc + conv. The rank's conv operand is its
hidden shard taken inside every tap, then flattened (3·hidden/mp, C).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import TensorParallel, active, all_reduce_sum
from ..precision import BF16, check_rung, mm, round_bf16
from . import cuda_lib
from .temporal import (add_weight_operands, attention_sublayer, check_bf16_planes, gemm,
                       layernorm, split_attention_sublayer, window_attention_plain)

COUNTER = "strided_block1"
DENSE = ("wqkv", "wp", "w1", "wc")  # the block's (in, out) matrices on the tensor cores


def output_length(n: int, stride: int, paddings: Tuple[int, int]) -> int:
    return (n + paddings[0] + paddings[1] - 3) // stride + 1


def conv_tap_rows(n: int, stride: int, paddings: Tuple[int, int]) -> torch.Tensor:
    """(n_out, 3) int64: the h1 row that tap j of output row t reads, s0·t + j - p0,
    or -1 where it falls outside [0, n) (the tap reads zero). This is the index
    the CUDA loaders compute: row r = (b, t), column k = j·hidden + i of the
    taps matrix T (B·n_out, 3·hidden) is h1[b, rows[t, j], i]."""
    n_out = output_length(n, stride, paddings)
    rows = stride * torch.arange(n_out)[:, None] + torch.arange(3)[None] - int(paddings[0])
    return torch.where((rows >= 0) & (rows < n), rows, -1)


def conv_taps_plain(h1: torch.Tensor, stride: int, paddings: Tuple[int, int]) -> torch.Tensor:
    """(B, n, hidden) → T (B, n_out, 3·hidden) through `conv_tap_rows`: the
    matrix the conv's products gather and never write out."""
    b, n, hidden = h1.shape
    rows = conv_tap_rows(n, stride, paddings).to(h1.device)
    taps = torch.where((rows >= 0)[None, :, :, None], h1[:, rows.clamp(min=0)], 0.0)
    return taps.reshape(b, rows.shape[0], 3 * hidden)


def conv_scatter_plain(dtaps: torch.Tensor, n: int, stride: int,
                       paddings: Tuple[int, int]) -> torch.Tensor:
    """The transpose of `conv_taps_plain`: (B, n_out, 3·hidden) → (B, n, hidden),
    each tap's slice added into the h1 row it read, taps in the order 0, 1, 2
    (rows that several taps read, s0 < 3, sum in that order); rows no tap
    reads are 0."""
    b, n_out, k = dtaps.shape
    rows = conv_tap_rows(n, stride, paddings).to(dtaps.device)
    d = dtaps.reshape(b, n_out, 3, k // 3)
    out = dtaps.new_zeros((b, n, k // 3))
    for j in range(3):
        ok = rows[:, j] >= 0
        out[:, rows[ok, j]] += d[:, ok, j]
    return out


def strided_conv_plain(h1: torch.Tensor, x: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor,
                       *, stride: int, paddings: Tuple[int, int],
                       precision: str = "high") -> torch.Tensor:
    """The block's conv with its residual, (B, n, hidden) and (B, n, C) →
    (B, n_out, C): x[:, s0·t + (p0 == 0)] + bc + Σ_j h1[:, s0·t + j - p0] · W_j,
    the products at the rung `precision`."""
    _, n, hidden = h1.shape
    p0, p1 = paddings
    n_out = output_length(n, stride, paddings)
    h1 = F.pad(h1, (0, 0, p0, p1))  # zero taps outside the window
    last = stride * (n_out - 1) + 1
    taps = torch.cat([h1[:, j: j + last: stride] for j in range(3)], dim=-1)
    conv = mm(taps, wc.reshape(3 * hidden, -1), check_rung(precision)) + bc
    off = 1 if p0 == 0 else 0
    return x[:, off: off + last: stride] + conv


def strided_conv(h1: torch.Tensor, x: torch.Tensor, ops: Dict, *, stride: int,
                 paddings: Tuple[int, int], counter: Optional[str] = COUNTER,
                 precision: str = "high") -> torch.Tensor:
    """`strided_conv_plain` on a CPU tensor; on a CUDA tensor one launch of
    `strided_conv_f32` (T · Wc on the tensor cores in 3xTF32, T gathered from
    h1 as it is read, Wc's halves "wc_tc") or, with `precision` "default",
    of `strided_conv_bf16` (Wc's bf16 plane "wc_bf"), counted for `counter`."""
    bf16 = check_rung(precision) == BF16
    if h1.device.type == "cpu":
        return strided_conv_plain(h1, x, ops["wc"], ops["bc"], stride=stride, paddings=paddings,
                                  precision=precision)
    b, n, hidden = h1.shape
    c = x.shape[-1]
    n_out = output_length(n, stride, paddings)
    h1 = h1.reshape(b * n, hidden).contiguous()
    x = x.reshape(b * n, c).contiguous()
    cuda_lib.check_cuda("h1", h1)
    cuda_lib.check_cuda("x", x, device=h1.device)
    w = ops["wc_bf"] if bf16 else ops["wc_tc"]
    cuda_lib.check_cuda("wc_bf" if bf16 else "wc_tc", w,
                        shape=(c, 3 * hidden) if bf16 else (2, c, 3 * hidden), device=h1.device)
    cuda_lib.check_cuda("bc", ops["bc"], shape=(c,), device=h1.device)
    out = torch.empty((b * n_out, c), dtype=torch.float32, device=h1.device)
    cuda_lib.launch("strided", "strided_conv_bf16" if bf16 else "strided_conv_f32", counter,
                    h1, x, w, ops["bc"], out, b, n, hidden, c, stride, int(paddings[0]), n_out)
    return out.reshape(b, n_out, c)


def stack_strided_block1_params(state: Mapping[str, torch.Tensor],
                                name: str = "strided_temporal_block_1",
                                pe_name: str = "strided_temporal_pe_1",
                                precision: str = "high") -> Dict:
    """Model state_dict → strided block 1's operands.

    Matrices are (in, out); the conv kernel is (3·hidden, C), the flax
    (3, hidden, C) kernel flattened; biases absent with qkv_bias off become
    zeros (as `pallas_strided.stack_strided_block1_params` does). The dense
    matrices' TF32 halves are split here (`temporal.add_tf32_halves`; at
    `precision` "default" their bf16 planes, `add_weight_operands`). From
    an mp rank's shard: wqkv is (C, 3·C/mp), its q, k and v shards side by
    side, and wc (3·hidden/mp, C), its hidden shard within every tap.
    """
    pe = state[pe_name]
    c = pe.shape[1]
    c_local = state[f"{name}.attn.wq.weight"].shape[0]

    def get(key, n=None):
        full = f"{name}.{key}"
        if full in state:
            return state[full]
        return torch.zeros(n, dtype=pe.dtype, device=pe.device)

    conv = get("mlp.fc2.weight")  # (C, hidden, 3), nn.Conv1d layout
    ops = dict(
        pe=pe,
        ln1_g=get("norm1.weight"), ln1_b=get("norm1.bias"),
        wqkv=torch.cat([get(f"attn.{w}.weight").t() for w in ("wq", "wk", "wv")], 1),
        bqkv=torch.cat([get(f"attn.{w}.bias", c_local) for w in ("wq", "wk", "wv")]),
        wp=get("attn.proj.weight").t(), bp=get("attn.proj.bias", c),
        ln2_g=get("norm2.weight"), ln2_b=get("norm2.bias"),
        w1=get("mlp.fc1.weight").t(), b1=get("mlp.fc1.bias"),
        wc=conv.permute(2, 1, 0).reshape(-1, conv.shape[0]),
        bc=get("mlp.fc2.bias", c),
    )
    return add_weight_operands({k: v.float().contiguous() for k, v in ops.items()}, DENSE,
                               precision)


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to bf16."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


def strided_block1_plain(x: torch.Tensor, ops: Dict, *, num_heads: int,
                         stride: int, paddings: Tuple[int, int],
                         relu_mask: Optional[torch.Tensor] = None,
                         tp: Optional[TensorParallel] = None,
                         precision: str = "high", train: bool = False) -> torch.Tensor:
    """(B, N, C) → (B, n_out, C): strided block 1 in plain PyTorch.

    relu_mask (B·N, hidden) booleans replace fc1's relu decisions (a gradient
    comparison hands it a kernel forward's, as `temporal_stack_plain` takes
    K5's). tp: `ops` are an mp rank's operands; the proj and conv partials
    are summed over mp before their replicated biases are added.
    precision: the rung of every product, the conv's too. `train`: the
    training kernel's (K6) function on the bf16 rung: q scaled before its
    rounding (`window_attention_plain`), and the PE's gradient the sum of
    the bf16-rounded input gradient over windows (a DEFAULT dot with a
    one-hot matrix in `pallas_strided_bwd.py:152`)."""
    c = x.shape[-1]
    tp = active(tp)
    rung = check_rung(precision)
    heads = num_heads if tp is None else num_heads // tp.size
    reduce = (lambda t: t) if tp is None else (lambda t: all_reduce_sum(tp, t))
    if train and rung == BF16:
        x = x + _RoundGrad.apply(ops["pe"].expand_as(x))
    else:
        x = x + ops["pe"]
    y = F.layer_norm(x, (c,), ops["ln1_g"], ops["ln1_b"], 1e-5)
    ctx = window_attention_plain(mm(y, ops["wqkv"], rung) + ops["bqkv"], None, heads, rung,
                                 train)
    x = x + (reduce(mm(ctx, ops["wp"], rung)) + ops["bp"])
    z = F.layer_norm(x, (c,), ops["ln2_g"], ops["ln2_b"], 1e-5)
    h1 = mm(z, ops["w1"], rung) + ops["b1"]
    h1 = torch.relu(h1) if relu_mask is None else h1 * relu_mask.reshape(h1.shape).to(h1.dtype)
    bc = ops["bc"]
    if tp is not None and tp.rank != 0:  # the crop residual and bc enter on mp rank 0 only
        x, bc = torch.zeros_like(x), torch.zeros_like(bc)
    return reduce(strided_conv_plain(h1, x, ops["wc"], bc, stride=stride,
                                     paddings=tuple(paddings), precision=rung))


def strided_block1(x: torch.Tensor, ops: Dict, *, num_heads: int, stride: int,
                   paddings: Tuple[int, int],
                   tp: Optional[TensorParallel] = None,
                   precision: str = "high") -> torch.Tensor:
    """(B, N, C) → (B, n_out, C). CPU tensor: plain version; CUDA tensor: K3.
    tp: `ops` are an mp rank's operands and the block runs split over mp
    (module docstring); every mp rank returns the whole result. precision:
    the rung (module docstring)."""
    p0, p1 = (int(paddings[0]), int(paddings[1]))
    tp = active(tp)
    if not (0 <= p0 <= 1 and 0 <= p1 <= 1):
        raise ValueError(f"strided block 1 takes paddings in {{0, 1}}, got {paddings}")
    if x.device.type == "cpu":
        return strided_block1_plain(x, ops, num_heads=num_heads, stride=stride,
                                    paddings=(p0, p1), tp=tp, precision=precision)
    bf16 = check_rung(precision, tp=tp) == BF16
    if bf16:
        check_bf16_planes(ops, DENSE)
    w = "_bf" if bf16 else "_tc"
    b, n, c = x.shape
    n_out = output_length(n, stride, (p0, p1))
    if n_out < 1:
        raise ValueError(f"N={n} is too short for stride {stride}")
    h = x.reshape(b * n, c).contiguous()
    cuda_lib.check_cuda("x", h)
    cuda_lib.check_cuda("pe", ops["pe"], shape=(n, c), device=x.device)
    h, y = layernorm(h, ops["ln1_g"], ops["ln1_b"], 1e-5, pe=ops["pe"],
                     counter=COUNTER)
    weights = (ops["wqkv" + w], ops["bqkv"], ops["wp" + w], ops["bp"])
    attn = dict(key_mask=None, windows=b, n=n, num_heads=num_heads, counter=COUNTER)
    if tp is None:
        h = attention_sublayer(h, y, *weights, precision=precision, **attn)
    else:
        h = split_attention_sublayer(h, y, *weights, tp=tp, **attn)
    z = layernorm(h, ops["ln2_g"], ops["ln2_b"], 1e-5, counter=COUNTER)
    h1 = gemm(z, ops["w1" + w], ops["b1"], relu=True, counter=COUNTER, precision=precision)
    if tp is None:
        return strided_conv(h1.reshape(b, n, -1), h.reshape(b, n, c), ops, stride=stride,
                            paddings=(p0, p1), precision=precision)
    if tp.rank != 0:  # the crop residual and bc enter on mp rank 0 only
        h, ops = torch.zeros_like(h), dict(ops, bc=torch.zeros_like(ops["bc"]))
    part = strided_conv(h1.reshape(b, n, -1), h.reshape(b, n, c), ops, stride=stride,
                        paddings=(p0, p1))
    return all_reduce_sum(tp, part)
