"""K2 — the temporal stack (counterpart of ops/pallas_temporal_v3.py).

`temporal_stack` runs the pre-norm temporal blocks over (B, N, C): LN, qkv,
per-window multi-head attention with an additive -1e9 key mask on
stride-masked frames for the first `first_masked_blocks` blocks, proj,
residual, LN, relu MLP, residual. On a CUDA tensor each block is seven
launches of the kernels in `csrc/temporal.cu` (which replace
`pallas_temporal_v3.fused_temporal_stack_v3`); on a CPU tensor it runs
`temporal_stack_plain`, the same function in plain PyTorch.

K2 is also the counterpart of the TPU's other temporal eval kernels, which
compute the same function in other Mosaic layouts (rows of the kernel table
in PERF.md):
  - row 6, `fused_temporal_stack_v3(attn_mode="banded")`: its band softmax
    is attention inside each window, which K2's per-window attention is;
  - row 10, `pallas_temporal.fused_temporal_stack` (v2): the same blocks,
    windows padded to 72 tokens with the pad token blocked;
  - row 9, `pallas_temporal.fused_temporal_block`: one block, reached through
    `pallas_temporal.temporal_stack_apply`; here `temporal_block` and
    `temporal_stack_apply`, K2 over one block at a time.

The eval kernels fold the attention's 1/sqrt(D) into the q columns of the
qkv weights and biases, as the TPU's do (`_transposed_operands(q_scale=)`,
`pallas_temporal_v3.py:319-322`): `stack_temporal_params(q_scale=)` folds
fp32(1/sqrt(D)) (`folded_q_scale`) and records it as the operand
"q_scale", and K2 and its plain version then scale nothing after q·kᵀ. On
the bf16 rung that rounds q·1/sqrt(D), where scaling after the product
would round q (ROADMAP C7); at fp32 the two differ by rounding. The training
kernels (K5, K6) keep q unscaled (`pallas_strided.py:43-46`).

The GEMM, LayerNorm and window-attention wrappers below are shared with K3
(`ops/strided.py`); each counts its launches for the K it runs for. The GEMM
runs on the tensor cores in 3xTF32 (`csrc/gemm_tc.cuh`) and reads each
weight matrix as its two TF32 halves, which `stack_temporal_params` (and
`strided.stack_strided_block1_params`) split when they stack the operands:
once for serving, anew from each step's weights in training.

Precision (`precision.py`): "high" and "highest" run the 3xTF32 GEMM and
attention (`gemm_f32`, `window_attention_f32`); "default", the TPU's
one-pass bf16 rung, their bf16 instances (`gemm_bf16`: native bf16, A
rounded to bf16 pairs as the consumers read it, wgmma k16 on W's bf16 plane
"<w>_bf", a torch.bfloat16 tensor from `add_bf16_planes`;
`window_attention_bf16`: q, k, the normalised probabilities and v rounded,
fp32 sums). The LayerNorms are fp32 on every rung. The plain versions take
the same `precision=` and round W themselves.

Split over mp (`tp`, tensor parallelism: the operands stacked from an mp
rank's shard of the weights, `parallel/sharding.py`), each block runs per
rank: LN1 at full width; qkv into the rank's (rows, 3·C/mp), its q, k and v
shards side by side; the window attention over its C/mp channels and H/mp
heads; proj on its C/mp rows of wp as a partial sum; an all-reduce over mp;
LN2, its fc1 columns with relu, its fc2 rows as a partial; the all-reduce.
The bias and the residual of proj and fc2 enter on mp rank 0 only, so the
sum over the ranks is h + proj + b. The same launches as unsplit, at the
split widths (no kernel of its own).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from ..parallel.sharding import TensorParallel, active, all_reduce_sum
from ..precision import BF16, check_rung, mm
from . import cuda_lib

COUNTER = "temporal_stack"
DENSE = ("wqkv", "wp", "w1", "w2")  # the blocks' (in, out) weight matrices


def tf32_halves_plain(w: torch.Tensor, transpose: bool = True) -> torch.Tensor:
    """(…, K, N) → (…, 2, N, K) with `transpose`, else (…, 2, K, N): [0] = w
    rounded to TF32 (to nearest, ties away from zero, by `csrc/tf32.cuh`'s
    integer rounding), [1] = w - [0] (exact in fp32)."""
    w = w.detach().float().contiguous()
    bits = w.view(torch.int32)
    big = (torch.where(torch.isfinite(w), bits + 0x1000, bits) & -0x2000).view(torch.float32)
    halves = torch.stack([big, w - big], dim=-3)
    return halves.transpose(-1, -2).contiguous() if transpose else halves


def tf32_halves(w: torch.Tensor, transpose: bool = True) -> torch.Tensor:
    """The TF32 halves of w (…, K, N) that `gemm` (transposed) and the
    backward's `gemm_dx` (as stored) read. CPU tensor: the plain version;
    CUDA tensor: one launch of `tf32_halves_f32`, bit for bit the same."""
    if w.device.type == "cpu":
        return tf32_halves_plain(w, transpose)
    w = w.detach().float().contiguous()
    *lead, k, n = w.shape
    out = torch.empty((*lead, 2, n, k) if transpose else (*lead, 2, k, n),
                      dtype=torch.float32, device=w.device)
    cuda_lib.launch("temporal", "tf32_halves_f32", None, w, out, math.prod(lead), k, n,
                    int(transpose))
    return out


def add_tf32_halves(ops: Dict, names: Sequence[str] = DENSE) -> Dict:
    """`ops` with each named matrix's TF32 halves beside it: "<name>_tc" for
    x @ w (`gemm`), "<name>_tc_dx" for dy @ wᵀ (`temporal_train.gemm_dx`)."""
    out = dict(ops)
    for name in names:
        out[f"{name}_tc"] = tf32_halves(ops[name], transpose=True)
        out[f"{name}_tc_dx"] = tf32_halves(ops[name], transpose=False)
    return out


PLANE_DTYPE = torch.bfloat16  # the bf16 planes' dtype


def bf16_plane(w: torch.Tensor, transpose: bool = True) -> torch.Tensor:
    """(…, K, N) → (…, N, K) with `transpose`, else (…, K, N): w rounded to
    bf16 (to nearest, even) as a torch.bfloat16 tensor, the operand the bf16
    GEMMs read (`gemm_bf16` transposed; the backward's `gemm_dx` as stored;
    the strided conv's Wc likewise)."""
    plane = w.detach().float().to(PLANE_DTYPE)
    return (plane.transpose(-1, -2) if transpose else plane).contiguous()


def operand_dtype(key: str) -> torch.dtype:
    """The dtype of a kernel operand by its key: the bf16 planes ("<w>_bf",
    "<w>_bf_dx") bf16, every other operand fp32."""
    return PLANE_DTYPE if key.endswith(("_bf", "_bf_dx")) else torch.float32


def add_bf16_planes(ops: Dict, names: Sequence[str] = DENSE, dx: bool = False) -> Dict:
    """`ops` with each named matrix's bf16 plane (`bf16_plane`) beside it,
    "<name>_bf": the weights of the bf16 rung, prepared once
    (`models/bench_forward.prepare_fused_params`); with `dx` also
    "<name>_bf_dx", the plane as stored, for dy @ wᵀ (training)."""
    out = {**ops, **{f"{name}_bf": bf16_plane(ops[name]) for name in names}}
    if dx:
        out.update({f"{name}_bf_dx": bf16_plane(ops[name], transpose=False) for name in names})
    return out


def add_weight_operands(ops: Dict, names: Sequence[str], precision: str) -> Dict:
    """`ops` with what the kernels read of each named matrix at the rung: the
    TF32 halves (`add_tf32_halves`) at "high" and "highest", both bf16 planes
    (`add_bf16_planes(dx=True)`) at "default"."""
    if check_rung(precision) == BF16:
        return add_bf16_planes(ops, names, dx=True)
    return add_tf32_halves(ops, names)


def weight_keys(names: Sequence[str], precision: str) -> list:
    """The keys `add_weight_operands` adds for `names` at the rung, in a
    fixed order: each matrix's TF32 halves "<w>_tc", "<w>_tc_dx", or on the
    bf16 rung its planes "<w>_bf", "<w>_bf_dx"."""
    kinds = ("_bf", "_bf_dx") if check_rung(precision) == BF16 else ("_tc", "_tc_dx")
    return [f"{name}{kind}" for kind in kinds for name in names]


def folded_q_scale(c: int, num_heads: int) -> float:
    """1/sqrt(D) as the TPU's eval kernels take it (`1.0 / np.sqrt(c //
    num_heads)`, a double that the fold rounds to fp32)."""
    return 1.0 / math.sqrt(c // num_heads)


def fold_q(w: torch.Tensor, b: torch.Tensor, c_q: int, q_scale: float):
    """(…, K, 3·c_q) weights and (…, 3·c_q) biases with the first c_q
    columns (q's) multiplied by fp32(q_scale) in fp32, as
    `_transposed_operands` and `pallas_strided.stack_strided_block1_params`
    fold it."""
    s = torch.tensor(q_scale, dtype=torch.float32, device=w.device)
    return (torch.cat([w[..., :c_q] * s, w[..., c_q:]], dim=-1),
            torch.cat([b[..., :c_q] * s, b[..., c_q:]], dim=-1))


def check_unfolded(ops: Dict) -> None:
    """Raise if `ops` fold 1/sqrt(D) into q (the eval's operands): the
    training kernels and their plain versions take q unscaled."""
    if "q_scale" in ops:
        raise ValueError("the training kernels take q unscaled; these operands fold "
                         "1/sqrt(D) into q (stack_temporal_params(q_scale=), the eval's)")


def stack_temporal_params(state: Mapping[str, torch.Tensor], num_blocks: int,
                          prefix: str = "temporal_block_", precision: str = "high",
                          q_scale: Optional[float] = None) -> Dict:
    """Model state_dict → the temporal blocks' operands, stacked over blocks.

    q/k/v are concatenated into one (C, 3C) matrix per block; matrices are
    (in, out); missing biases become zeros. Each matrix's TF32 halves are
    split here, from these weights (`add_tf32_halves`), or at `precision`
    "default" its bf16 planes (`add_weight_operands`). From an mp rank's
    shard of the weights (tensor parallelism) the matrix is (C, 3·C/mp):
    the rank's q, k and v shards side by side, never a third of the whole
    fused matrix. `q_scale` (the eval's K2: `folded_q_scale`) is folded into
    q's columns and biases before the halves or planes are taken, and kept
    as "q_scale" (L,), the mark of folded operands.
    """
    first = state[f"{prefix}1.attn.wq.weight"]
    c_local, c = first.shape  # the rank's q width (C unsplit), the model width

    def get(i, key, n=None):
        full = f"{prefix}{i}.{key}"
        if full in state:
            return state[full]
        return torch.zeros(n, dtype=first.dtype, device=first.device)

    def st(fn):
        return torch.stack([fn(i) for i in range(1, num_blocks + 1)]).float().contiguous()

    wqkv = st(lambda i: torch.cat([get(i, f"attn.{w}.weight").t()
                                   for w in ("wq", "wk", "wv")], dim=1))
    bqkv = st(lambda i: torch.cat([get(i, f"attn.{w}.bias", c_local)
                                   for w in ("wq", "wk", "wv")]))
    folded = {}
    if q_scale is not None:
        wqkv, bqkv = fold_q(wqkv, bqkv, c_local, q_scale)
        folded = dict(q_scale=torch.full((num_blocks,), q_scale, dtype=torch.float32,
                                         device=wqkv.device))
    return add_weight_operands(dict(
        ln1_g=st(lambda i: get(i, "norm1.weight")),
        ln1_b=st(lambda i: get(i, "norm1.bias")),
        wqkv=wqkv, bqkv=bqkv, **folded,
        wp=st(lambda i: get(i, "attn.proj.weight").t()),
        bp=st(lambda i: get(i, "attn.proj.bias", c)),
        ln2_g=st(lambda i: get(i, "norm2.weight")),
        ln2_b=st(lambda i: get(i, "norm2.bias")),
        w1=st(lambda i: get(i, "mlp.fc1.weight").t()),
        b1=st(lambda i: get(i, "mlp.fc1.bias")),
        w2=st(lambda i: get(i, "mlp.fc2.weight").t()),
        b2=st(lambda i: get(i, "mlp.fc2.bias")),
    ), DENSE, precision)


# -- plain versions -----------------------------------------------------------

def window_attention_plain(qkv: torch.Tensor, key_mask: Optional[torch.Tensor],
                           num_heads: int, precision: str = "high",
                           train: bool = False, q_folded: bool = False) -> torch.Tensor:
    """(B, N, 3C) packed q|k|v → (B, N, C) context; key_mask (B, N), 1 = blocked.
    On the bf16 rung q and k are rounded as they are (the logits scaled after
    the product) and the normalised probabilities and v for P·V; with `train`
    (the training kernels K5 and K6, `pallas_temporal_bwd.py:420-426`) q is
    scaled by 1/sqrt(D) first and rounded so. `q_folded`: q carries
    1/sqrt(D) already (the eval's folded operands, `stack_temporal_params(
    q_scale=)`), so the logits take no factor after the product."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    rung = check_rung(precision)
    q, k, v = (t.reshape(b, n, num_heads, d).transpose(1, 2)
               for t in qkv.split(c, dim=-1))
    if q_folded:
        logits = mm(q, k.transpose(-1, -2), rung)
    elif train and rung == BF16:
        logits = mm(q * (1.0 / d ** 0.5), k.transpose(-1, -2), rung)
    else:
        logits = mm(q, k.transpose(-1, -2), rung) * (1.0 / d ** 0.5)
    if key_mask is not None:
        logits = logits + key_mask[:, None, None, :] * -1e9
    ctx = mm(torch.softmax(logits, dim=-1), v, rung)
    return ctx.transpose(1, 2).reshape(b, n, c)


def temporal_stack_plain(x: torch.Tensor, ops: Dict,
                         key_mask: Optional[torch.Tensor] = None, *,
                         num_heads: int, first_masked_blocks: int = 0,
                         droppath: Optional[torch.Tensor] = None,
                         relu_masks: Optional[Sequence[torch.Tensor]] = None,
                         tp: Optional[TensorParallel] = None,
                         precision: str = "high", train: bool = False) -> torch.Tensor:
    """(B, N, C) → (B, N, C): the temporal blocks in plain PyTorch.

    droppath: (L, 2, B) per-window stochastic-depth scales of each block's
    attention and MLP branches (training, `ops/temporal_train.py`), or None.
    relu_masks: per block, (B·N, 2C) booleans that replace the MLP's relu
    decisions (where fc1's output passes). A comparison of gradients hands
    it the kernel forward's decisions, so that a pre-activation within
    rounding of 0 takes the same side of the kink in both.
    tp: `ops` are an mp rank's operands (module docstring); the proj and fc2
    partials are summed over mp before their replicated biases are added.
    precision: the rung of every product (module docstring); `train`: the
    training kernel's attention (`window_attention_plain`). Operands with
    "q_scale" (folded, module docstring) scale no logits.
    """
    c = x.shape[-1]
    q_folded = "q_scale" in ops
    tp = active(tp)
    rung = check_rung(precision)
    heads = num_heads if tp is None else num_heads // tp.size
    reduce = (lambda t: t) if tp is None else (lambda t: all_reduce_sum(tp, t))
    km = None if key_mask is None else key_mask.float()
    for blk in range(ops["ln1_g"].shape[0]):
        y = F.layer_norm(x, (c,), ops["ln1_g"][blk], ops["ln1_b"][blk], 1e-5)
        qkv = mm(y, ops["wqkv"][blk], rung) + ops["bqkv"][blk]
        ctx = window_attention_plain(qkv, km if blk < first_masked_blocks else None,
                                     heads, rung, train, q_folded)
        proj = reduce(mm(ctx, ops["wp"][blk], rung)) + ops["bp"][blk]
        if droppath is not None:
            proj = proj * droppath[blk, 0][:, None, None]
        x = x + proj
        z = F.layer_norm(x, (c,), ops["ln2_g"][blk], ops["ln2_b"][blk], 1e-5)
        z = mm(z, ops["w1"][blk], rung) + ops["b1"][blk]
        if relu_masks is None:
            z = torch.relu(z)
        else:
            z = z * relu_masks[blk].reshape(z.shape).to(z.dtype)
        z = reduce(mm(z, ops["w2"][blk], rung)) + ops["b2"][blk]
        if droppath is not None:
            z = z * droppath[blk, 1][:, None, None]
        x = x + z
    return x


# -- kernel launches (CUDA tensors only) --------------------------------------

def gemm(a: torch.Tensor, w_tc: torch.Tensor, bias: Optional[torch.Tensor], *,
         counter: Optional[str], residual: Optional[torch.Tensor] = None,
         relu: bool = False, out: Optional[torch.Tensor] = None,
         precision: str = "high") -> torch.Tensor:
    """act(a @ w + bias) + residual on the card; a (M, K) row-major, w_tc
    (2, N, K) the TF32 halves of w (K, N) (`tf32_halves`), or on the bf16
    rung (`precision` "default") its bf16 plane (N, K), a torch.bfloat16
    tensor (`bf16_plane`). `out` may be `residual`, never `a`."""
    bf16 = check_rung(precision) == BF16
    m, k = a.shape
    n = w_tc.shape[-2]
    check_gemm_depth(k, bf16, n if bf16 else None)
    cuda_lib.check_cuda("a", a)
    check_weight(w_tc, n, k, bf16, a.device)
    if bias is not None:
        cuda_lib.check_cuda("bias", bias, shape=(n,), device=a.device)
    if residual is not None:
        cuda_lib.check_cuda("residual", residual, shape=(m, n), device=a.device)
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    cuda_lib.launch("temporal", "gemm_bf16" if bf16 else "gemm_f32", counter, a, w_tc, bias,
                    residual, out, m, n, k, int(relu))
    return out


def check_gemm_depth(k: int, bf16: bool, n_stored: Optional[int] = None) -> None:
    """Raise unless the tensor-core GEMM can load rows of depth K by TMA: rows
    of 16 bytes, K % 4 == 0 in fp32; the bf16 plane's rows too, K % 8 == 0.
    `n_stored`: the width of an output the bf16 rung's consumers write in
    pairs from 16-byte aligned rows (`gemm_bf16`, `gemm_branch_bf16`,
    `gemm_dx_bf16`, `s2t_prologue_bf16`), N % 4 == 0."""
    if k % (8 if bf16 else 4):
        raise ValueError(f"the tensor-core GEMM loads rows of 16 bytes: K={k} is not a "
                         f"multiple of {8 if bf16 else 4}")
    if n_stored is not None and n_stored % 4:
        raise ValueError(f"the bf16 GEMM writes rows of 16-byte multiples: N={n_stored} is "
                         "not a multiple of 4")


def check_weight(w: torch.Tensor, n: int, k: int, bf16: bool, device) -> None:
    """Raise unless w is what the GEMM reads of W: its TF32 halves (2, N, K)
    in fp32, or on the bf16 rung its bf16 plane (N, K) as torch.bfloat16 (an
    fp32 plane raises)."""
    cuda_lib.check_cuda("w_bf" if bf16 else "w_tc", w, shape=(n, k) if bf16 else (2, n, k),
                        device=device, dtype=PLANE_DTYPE if bf16 else torch.float32)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
              *, counter: Optional[str], pe: Optional[torch.Tensor] = None):
    """LN over the last dim of x (rows, C) on the card.

    With `pe` (pe_rows, C), row r first gets pe[r % pe_rows] added; returns
    (x + pe, LN(x + pe)) then, else LN(x).
    """
    rows, c = x.shape
    cuda_lib.check_cuda("x", x)
    cuda_lib.check_cuda("gamma", gamma, shape=(c,), device=x.device)
    cuda_lib.check_cuda("beta", beta, shape=(c,), device=x.device)
    y = torch.empty_like(x)
    x_pe = None
    pe_rows = 0
    if pe is not None:
        cuda_lib.check_cuda("pe", pe, device=x.device)
        pe_rows = pe.shape[0]
        x_pe = torch.empty_like(x)
    cuda_lib.launch("temporal", "layernorm_f32", counter, x, pe, gamma, beta,
                    x_pe, y, rows, c, pe_rows, float(eps))
    return (x_pe, y) if pe is not None else y


def window_attention(qkv: torch.Tensor, key_mask: Optional[torch.Tensor], *,
                     windows: int, n: int, num_heads: int,
                     counter: Optional[str], precision: str = "high",
                     q_folded: bool = False) -> torch.Tensor:
    """(windows·n, 3C) → (windows·n, C) attention inside each window, on the
    card; `precision` "default" launches the bf16 instance. `q_folded`: q
    carries 1/sqrt(D) (`window_attention_plain`)."""
    rows, c3 = qkv.shape
    c = c3 // 3
    cuda_lib.check_cuda("qkv", qkv, shape=(windows * n, c3))
    if key_mask is not None:
        cuda_lib.check_cuda("key_mask", key_mask, shape=(windows, n), device=qkv.device)
    out = torch.empty((rows, c), dtype=torch.float32, device=qkv.device)
    entry = "window_attention_bf16" if check_rung(precision) == BF16 else "window_attention_f32"
    cuda_lib.launch("temporal", entry, counter, qkv, key_mask, out, windows, n, c, num_heads,
                    int(q_folded))
    return out


def attention_sublayer(x: torch.Tensor, y: torch.Tensor, wqkv, bqkv, wp, bp, *,
                       key_mask, windows: int, n: int, num_heads: int,
                       counter: str, precision: str = "high",
                       q_folded: bool = False) -> torch.Tensor:
    """x + proj(attention(qkv(y))) on the card, y being LN(x): three launches
    (wqkv, wp: TF32 halves, or bf16 planes on the bf16 rung)."""
    qkv = gemm(y, wqkv, bqkv, counter=counter, precision=precision)
    ctx = window_attention(qkv, key_mask, windows=windows, n=n, num_heads=num_heads,
                           counter=counter, precision=precision, q_folded=q_folded)
    return gemm(ctx, wp, bp, residual=x, counter=counter, precision=precision)


def split_gemm(a: torch.Tensor, w_tc: torch.Tensor, bias: torch.Tensor,
               residual: torch.Tensor, tp: TensorParallel, *, counter: str,
               precision: str = "high") -> torch.Tensor:
    """residual + a @ w + bias summed over the mp ranks: each rank's `gemm` of
    its rows of w is a partial sum, the bias and the residual enter on mp
    rank 0 only, and one all-reduce adds the partials."""
    first = tp.rank == 0
    part = gemm(a, w_tc, bias if first else None, residual=residual if first else None,
                counter=counter, precision=precision)
    return all_reduce_sum(tp, part)


def split_attention_sublayer(x: torch.Tensor, y: torch.Tensor, wqkv, bqkv, wp, bp, *,
                             key_mask, windows: int, n: int, num_heads: int,
                             counter: str, tp: TensorParallel, precision: str = "high",
                             q_folded: bool = False) -> torch.Tensor:
    """`attention_sublayer` split over mp: the rank's qkv (rows, 3·C/mp), its
    num_heads/mp heads, its proj rows as a partial, the all-reduce."""
    qkv = gemm(y, wqkv, bqkv, counter=counter, precision=precision)
    ctx = window_attention(qkv, key_mask, windows=windows, n=n,
                           num_heads=num_heads // tp.size, counter=counter,
                           precision=precision, q_folded=q_folded)
    return split_gemm(ctx, wp, bp, x, tp, counter=counter, precision=precision)


def check_bf16_planes(ops: Dict, names: Sequence[str]) -> None:
    """Raise unless the named matrices' bf16 planes are prepared (`add_bf16_planes`)."""
    missing = [f"{name}_bf" for name in names if f"{name}_bf" not in ops]
    if missing:
        raise ValueError(f"the bf16 rung reads the weights' bf16 planes {missing}: "
                         "prepare them with add_bf16_planes")


def temporal_stack(x: torch.Tensor, ops: Dict,
                   key_mask: Optional[torch.Tensor] = None, *, num_heads: int,
                   first_masked_blocks: int = 0,
                   tp: Optional[TensorParallel] = None,
                   precision: str = "high") -> torch.Tensor:
    """(B, N, C) → (B, N, C). CPU tensor: plain version; CUDA tensor: K2.

    key_mask: (B, N), 1 = blocked key, applied in the first
    `first_masked_blocks` blocks. tp: `ops` are an mp rank's operands, and
    each block runs split over mp (module docstring); every mp rank returns
    the whole result. precision: the rung (module docstring); "default"
    reads the bf16 planes, split or not. Folded operands ("q_scale") scale
    no logits.
    """
    tp = active(tp)
    if x.device.type == "cpu":
        return temporal_stack_plain(x, ops, key_mask, num_heads=num_heads,
                                    first_masked_blocks=first_masked_blocks, tp=tp,
                                    precision=precision)
    bf16 = check_rung(precision) == BF16
    if bf16:
        check_bf16_planes(ops, DENSE)
    w = "_bf" if bf16 else "_tc"
    b, n, c = x.shape
    if c % num_heads != 0:
        raise ValueError(f"C={c} does not split into {num_heads} heads")
    km = None
    if key_mask is not None and first_masked_blocks > 0:
        km = key_mask.to(torch.float32).contiguous()
    h = x.reshape(b * n, c).contiguous()
    cuda_lib.check_cuda("x", h)
    for blk in range(ops["ln1_g"].shape[0]):
        y = layernorm(h, ops["ln1_g"][blk], ops["ln1_b"][blk], 1e-5, counter=COUNTER)
        attn = dict(key_mask=km if blk < first_masked_blocks else None, windows=b, n=n,
                    num_heads=num_heads, counter=COUNTER, precision=precision,
                    q_folded="q_scale" in ops)
        weights = (ops["wqkv" + w][blk], ops["bqkv"][blk], ops["wp" + w][blk], ops["bp"][blk])
        if tp is None:
            h = attention_sublayer(h, y, *weights, **attn)
        else:
            h = split_attention_sublayer(h, y, *weights, tp=tp, **attn)
        z = layernorm(h, ops["ln2_g"][blk], ops["ln2_b"][blk], 1e-5, counter=COUNTER)
        z = gemm(z, ops["w1" + w][blk], ops["b1"][blk], relu=True, counter=COUNTER,
                 precision=precision)
        if tp is None:
            h = gemm(z, ops["w2" + w][blk], ops["b2"][blk], residual=h, out=h, counter=COUNTER,
                     precision=precision)
        else:
            h = split_gemm(z, ops["w2" + w][blk], ops["b2"][blk], h, tp, counter=COUNTER,
                           precision=precision)
    return h.reshape(b, n, c)


def temporal_block(x: torch.Tensor, block_ops: Dict,
                   key_mask: Optional[torch.Tensor] = None, *, num_heads: int,
                   precision: str = "high") -> torch.Tensor:
    """One temporal block, (B, N, C) → (B, N, C) (row 9,
    `pallas_temporal.fused_temporal_block`): K2 over the one block of
    `block_ops` (stacked operands of one block), the key mask (B, N), 1 =
    blocked, applied when given."""
    return temporal_stack(x, block_ops, key_mask, num_heads=num_heads,
                          first_masked_blocks=0 if key_mask is None else 1,
                          precision=precision)


def temporal_stack_apply(ops: Dict, x: torch.Tensor, key_mask: Optional[torch.Tensor], *,
                         num_heads: int, first_masked_blocks: int = 0,
                         precision: str = "high") -> torch.Tensor:
    """The temporal stack block by block (`pallas_temporal.temporal_stack_apply`):
    `temporal_block` per block of the stacked `ops`, the key mask on the first
    `first_masked_blocks` blocks."""
    for blk in range(ops["ln1_g"].shape[0]):
        x = temporal_block(x, {k: v[blk:blk + 1] for k, v in ops.items()},
                           key_mask if blk < first_masked_blocks else None,
                           num_heads=num_heads, precision=precision)
    return x
