"""The bf16 rung's dense products on native bf16 (`csrc/gemm_tc.cuh` TC_BF16).

`gemm_bf16` (K2, K3's dense layers, K5's forward), `gemm_branch_bf16`,
`gemm_dx_bf16` (K5) and `s2t_prologue_bf16` read W's bf16 plane as a
torch.bfloat16 tensor and round A's fp32 tile into wgmma's register operand.

CPU tests: every place that prepares the planes (`add_bf16_planes`,
`add_weight_operands` at "default", `add_s2t_operands`, the strided block's
`add_strided_bf16_planes`, and the operands stacked from an mp = 2 rank's
shard) gives torch.bfloat16 planes equal to round_bf16(W)ᵀ (or W as stored
for dY·Wᵀ) bit for bit; the plain versions, which round W themselves, give
the same outputs whatever the planes' dtype.

`gpu` tests: the branch and the s2t prologue at the tile edges, gemm_bf16
and gemm_dx_bf16 at the split widths of mp = 2 (N 576, K 192), each against
its plain version on the rounded operands and float64, bit-identical on
repeat; every wrapper raises on an fp32 plane. They decide inside the test
whether there is a card (JAX is not imported here):

    python -m pytest --noconftest -m gpu tests/test_torch_gemm_native.py
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops.s2t import add_s2t_operands, s2t_prologue, s2t_prologue_plain
from uplift_upsample_torch.ops.strided import (DENSE as STRIDED_DENSE, add_strided_bf16_planes,
                                               strided_block1_plain)
from uplift_upsample_torch.ops.temporal import (DENSE, add_bf16_planes, add_weight_operands,
                                                bf16_plane, gemm, stack_temporal_params,
                                                temporal_stack_plain)
from uplift_upsample_torch.ops.temporal_train import _branch_gemm, gemm_dx
from uplift_upsample_torch.precision import round_bf16


def _rand(rng, *shape, scale=0.5, device="cpu"):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=device)


def _is_plane(plane, w, transpose=True):
    """plane is torch.bfloat16 and holds round_bf16(w) (transposed) bit for bit."""
    want = round_bf16(w).transpose(-1, -2) if transpose else round_bf16(w)
    return (plane.dtype == torch.bfloat16 and plane.is_contiguous()
            and torch.equal(plane.float(), want))


def _tiny_state(rng, blocks=2, c=32, hidden=64):
    """A temporal stack's state_dict (the model's key names), random weights."""
    state = {}
    for i in range(1, blocks + 1):
        p = f"temporal_block_{i}."
        for w in ("wq", "wk", "wv"):
            state[p + f"attn.{w}.weight"] = _rand(rng, c, c)
            state[p + f"attn.{w}.bias"] = _rand(rng, c)
        state[p + "attn.proj.weight"] = _rand(rng, c, c)
        state[p + "attn.proj.bias"] = _rand(rng, c)
        for ln in ("norm1", "norm2"):
            state[p + f"{ln}.weight"] = 1 + _rand(rng, c, scale=0.1)
            state[p + f"{ln}.bias"] = _rand(rng, c, scale=0.1)
        state[p + "mlp.fc1.weight"] = _rand(rng, hidden, c)
        state[p + "mlp.fc1.bias"] = _rand(rng, hidden)
        state[p + "mlp.fc2.weight"] = _rand(rng, c, hidden)
        state[p + "mlp.fc2.bias"] = _rand(rng, c)
    return state


# -- CPU ------------------------------------------------------------------------

def test_planes_are_bf16_tensors_of_the_rounded_weights():
    """`bf16_plane`, `add_bf16_planes` (with dx), `add_weight_operands` at
    "default" and `add_strided_bf16_planes`: each plane a torch.bfloat16
    tensor equal to round_bf16(W)ᵀ ("<w>_bf") or round_bf16(W) ("<w>_bf_dx")
    bit for bit, W left as it was; "high" adds no plane."""
    rng = np.random.default_rng(0)
    ops = {name: _rand(rng, 3, 48, 40) for name in DENSE}
    ops["b"] = _rand(rng, 40)
    before = {k: v.clone() for k, v in ops.items()}
    for out in (add_bf16_planes(ops, dx=True), add_weight_operands(ops, DENSE, "default")):
        for name in DENSE:
            assert _is_plane(out[f"{name}_bf"], ops[name])
            assert _is_plane(out[f"{name}_bf_dx"], ops[name], transpose=False)
            assert torch.equal(out[name], before[name]) and out[name].dtype == torch.float32
        assert torch.equal(out["b"], before["b"])
    assert not any(k.endswith(("_bf", "_bf_dx")) for k in add_weight_operands(ops, DENSE, "high"))
    strided = add_strided_bf16_planes({"wqkv": ops["wqkv"][0], "wc": _rand(rng, 96, 32)}, dx=True)
    for name in ("wqkv", "wc"):
        assert _is_plane(strided[f"{name}_bf"], strided[name])
        assert _is_plane(strided[f"{name}_bf_dx"], strided[name], transpose=False)


def test_s2t_and_stacked_planes_are_bf16():
    """`add_s2t_operands` at "default" (W's TF32 halves beside its bf16
    plane), and `stack_temporal_params` at "default" from the whole weights
    and from each mp = 2 rank's shard (the rank's q, k, v columns side by
    side, its fc1 columns, its proj and fc2 rows): every plane torch.bfloat16
    and round_bf16 of the stacked matrix, transposed, bit for bit."""
    from uplift_upsample_torch.parallel.sharding import shard_params_tp

    rng = np.random.default_rng(1)
    w = _rand(rng, 544, 384)
    s2t = add_s2t_operands(dict(w=w, bias=_rand(rng, 384), token=None, pe=_rand(rng, 9, 384)),
                           "default")
    assert _is_plane(s2t["w_bf"], w) and s2t["w_tc"].dtype == torch.float32
    assert "w_bf" not in add_s2t_operands(dict(w=w), "high")
    state = _tiny_state(rng)
    for shard in (state, shard_params_tp(state, 0, 2), shard_params_tp(state, 1, 2)):
        ops = stack_temporal_params(shard, 2, precision="default")
        for name in DENSE:
            assert _is_plane(ops[f"{name}_bf"], ops[name]), name
            assert _is_plane(ops[f"{name}_bf_dx"], ops[name], transpose=False), name
    split = stack_temporal_params(shard_params_tp(state, 1, 2), 2, precision="default")
    assert split["wqkv_bf"].shape == (2, 48, 32) and split["wp_bf"].shape == (2, 32, 16)


def test_plain_paths_do_not_read_the_planes():
    """The plain versions at "default" round W themselves: K2's, strided
    block 1's and the s2t prologue's outputs are the same bits with the
    torch.bfloat16 planes, with the planes in fp32 (the earlier operand) and
    with no planes at all."""
    rng = np.random.default_rng(2)
    c, hidden, n, heads = 32, 64, 9, 4
    state = _tiny_state(rng, c=c, hidden=hidden)
    ops = stack_temporal_params(state, 2, precision="default")
    as_fp32 = {k: v.float() for k, v in ops.items()}
    bare = {k: v for k, v in ops.items() if not k.endswith(("_bf", "_bf_dx"))}
    x = _rand(rng, 3, n, c)
    km = (torch.from_numpy(rng.uniform(size=(3, n))) < 0.3).float()
    outs = [temporal_stack_plain(x, o, km, num_heads=heads, first_masked_blocks=1,
                                 precision="default") for o in (ops, as_fp32, bare)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])

    sops = {k: v[0] for k, v in bare.items()}
    sops = dict(pe=_rand(rng, n, c), ln1_g=sops["ln1_g"], ln1_b=sops["ln1_b"],
                wqkv=sops["wqkv"], bqkv=sops["bqkv"], wp=sops["wp"], bp=sops["bp"],
                ln2_g=sops["ln2_g"], ln2_b=sops["ln2_b"], w1=sops["w1"], b1=sops["b1"],
                wc=_rand(rng, 3 * hidden, c, scale=0.1), bc=_rand(rng, c))
    with_planes = add_strided_bf16_planes(sops, dx=True)
    assert all(with_planes[f"{name}_bf"].dtype == torch.bfloat16 for name in STRIDED_DENSE)
    kw = dict(num_heads=heads, stride=3, paddings=(0, 0), precision="default")
    assert torch.equal(strided_block1_plain(x, with_planes, **kw),
                       strided_block1_plain(x, sops, **kw))

    w = _rand(rng, 40, c)
    base = dict(w=w, bias=_rand(rng, c), token=_rand(rng, c), pe=_rand(rng, n, c))
    sp, sm = _rand(rng, 3, n, 40), torch.from_numpy(rng.uniform(size=(3, n)) < 0.5)
    got = s2t_prologue(sp, add_s2t_operands(base, "default"), sm, precision="default")
    assert torch.equal(got, s2t_prologue_plain(sp, base, sm, precision="default"))


# -- the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    return torch.device("cuda")


def _r(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _rung_ok(got, plain, rung64, largest=2.0):
    """The eval rung bar: mean and largest distance to the float64-sum rung
    within 2x (`largest` x) the fp32 plain version's, + 1e-6 of the scale."""
    got, plain = got.double(), plain.double()
    err, err_plain = (got - rung64).abs(), (plain - rung64).abs()
    slack = 1e-6 * float(rung64.abs().max())
    return (float(err.mean()) <= 2 * float(err_plain.mean()) + slack
            and float(err.max()) <= largest * float(err_plain.max()) + slack)


# rows around the tile edges and the persistent walk's rounds (132 SMs)
EDGE_ROWS = (1, 65, 127, 129, 132 * 128 + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("m", EDGE_ROWS)
def test_branch_bf16_at_tile_edges(m):
    """`gemm_branch_bf16` at fc2's K 768 -> N 384 with the per-window row
    scale and a residual: both outputs against the plain version on the
    rounded operands and float64, bit-identical on repeat."""
    dev = _card()
    rng = np.random.default_rng(m)
    k, n, per = 768, 384, 71
    a, w = _rand(rng, m, k, device=dev), _rand(rng, k, n, scale=0.05, device=dev)
    bias, res = _rand(rng, n, device=dev), _rand(rng, m, n, device=dev)
    scale = torch.tensor(np.where(rng.uniform(size=-(-m // per)) < 0.9, 1 / 0.9, 0.0),
                         dtype=torch.float32, device=dev)
    plane = bf16_plane(w)
    out, branch = _branch_gemm(a, plane, bias, scale, per, res, precision="default")
    out2, branch2 = _branch_gemm(a, plane, bias, scale, per, res, precision="default")
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(branch, branch2)
    srow = scale.repeat_interleave(per)[:m, None]
    z = _r(a) @ _r(w) + bias
    z64 = _r(a).double() @ _r(w).double() + bias.double()
    assert _rung_ok(branch, z, z64)
    assert _rung_ok(out, res + z * srow, res.double() + z64 * srow.double())


@pytest.mark.gpu
@pytest.mark.parametrize("m", EDGE_ROWS)
def test_s2t_bf16_at_tile_edges(m):
    """`s2t_prologue_bf16` (K 544 -> 384, the stride mask, token and PE) at
    row counts around the tile edges: against the plain version at
    "default" and float64, bit-identical on repeat."""
    dev = _card()
    rng = np.random.default_rng(m + 7)
    n, k, c = 71, 544, 384
    b = -(-m // n)
    ops = add_s2t_operands(dict(w=_rand(rng, k, c, scale=0.05, device=dev),
                                bias=_rand(rng, c, device=dev), token=_rand(rng, c, device=dev),
                                pe=_rand(rng, n, c, device=dev)), "default")
    sp = _rand(rng, b, n, k, scale=1.0, device=dev)
    sm = torch.from_numpy(rng.uniform(size=(b, n)) < 0.4).to(dev)
    got = s2t_prologue(sp, ops, sm, precision="default")
    again = s2t_prologue(sp, ops, sm, precision="default")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    plain = s2t_prologue_plain(sp, ops, sm, precision="default")
    o64 = {k_: v.double() for k_, v in ops.items() if k_ in ("w", "bias", "token", "pe")}
    ref64 = s2t_prologue_plain(sp.double(), o64, sm, precision="default")
    assert _rung_ok(got, plain, ref64)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,relu,residual", [(384, 576, False, False),  # qkv at mp = 2
                                               (192, 384, False, True),   # proj at mp = 2
                                               (384, 384, True, False),   # fc1 at mp = 2
                                               (576, 384, False, False)])  # dX of split qkv
@pytest.mark.parametrize("m", (129, 1024 * 71))
def test_gemm_bf16_at_split_widths(m, k, n, relu, residual):
    """`gemm_bf16` at the widths K2's products take split over mp = 2 (an odd
    count of 128-column tiles at N 576; K 192 and 576, depths that are not a
    multiple of 128): against the plain version and float64, bit-identical
    on repeat."""
    dev = _card()
    rng = np.random.default_rng(k * 3 + n)
    a, w = _rand(rng, m, k, device=dev), _rand(rng, k, n, scale=0.05, device=dev)
    bias = _rand(rng, n, device=dev)
    res = _rand(rng, m, n, device=dev) if residual else None
    plane = bf16_plane(w)
    kw = dict(residual=res, relu=relu, precision="default", counter=None)
    got, again = gemm(a, plane, bias, **kw), gemm(a, plane, bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    act = torch.relu if relu else (lambda t: t)
    plain = act(_r(a) @ _r(w) + bias) + (0 if res is None else res)
    ref64 = act(_r(a).double() @ _r(w).double() + bias.double()) + (
        0 if res is None else res.double())
    assert _rung_ok(got, plain, ref64)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(384, 576), (192, 384)])
def test_gemm_dx_bf16_at_split_widths(k, n):
    """`gemm_dx_bf16` (row factors before the rounding, a relu mask) at the
    split widths: against the plain version and float64, bit-identical on
    repeat."""
    dev = _card()
    rng = np.random.default_rng(k + n)
    m, per = 512 * 71, 71
    dy, w = _rand(rng, m, k, scale=1.0, device=dev), _rand(rng, n, k, scale=0.05, device=dev)
    scale = torch.tensor(np.where(rng.uniform(size=m // per) < 0.9, 1 / 0.9, 0.0),
                         dtype=torch.float32, device=dev)
    mask = torch.relu(_rand(rng, m, n, device=dev))
    plane = bf16_plane(w, transpose=False)
    got = gemm_dx(dy, scale, per, plane, mask=mask, counter=None, precision="default")
    again = gemm_dx(dy, scale, per, plane, mask=mask, counter=None, precision="default")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    a_r, keep = _r(dy * scale.repeat_interleave(per)[:, None]), (mask > 0)
    plain = torch.where(keep, a_r @ _r(w).t(), 0.0)
    ref64 = torch.where(keep, a_r.double() @ _r(w).double().t(), 0.0)
    assert _rung_ok(got, plain, ref64)


@pytest.mark.gpu
def test_wrappers_raise_on_fp32_planes():
    """Every dense bf16 entry's wrapper refuses an fp32 plane (the TF32 pass
    that read one is gone) and a depth the bf16 plane's TMA rows cannot take."""
    dev = _card()
    rng = np.random.default_rng(3)
    a, w = _rand(rng, 71, 384, device=dev), _rand(rng, 384, 384, scale=0.05, device=dev)
    bias = _rand(rng, 384, device=dev)
    fp32_plane = bf16_plane(w).float()
    with pytest.raises(ValueError, match="bfloat16"):
        gemm(a, fp32_plane, bias, precision="default", counter=None)
    with pytest.raises(ValueError, match="bfloat16"):
        _branch_gemm(a, fp32_plane, bias, None, 71, None, precision="default")
    with pytest.raises(ValueError, match="bfloat16"):
        gemm_dx(a, None, 71, bf16_plane(w, transpose=False).float(), precision="default")
    ops = add_s2t_operands(dict(w=w, bias=bias, token=None, pe=_rand(rng, 71, 384, device=dev)),
                           "default")
    ops["w_bf"] = ops["w_bf"].float()
    with pytest.raises(ValueError, match="bfloat16"):
        s2t_prologue(a.reshape(1, 71, 384), ops, None, precision="default")
    with pytest.raises(ValueError, match="multiple of 8"):
        gemm(a[:, :12].contiguous(), bf16_plane(w[:12]), bias, precision="default",
             counter=None)

