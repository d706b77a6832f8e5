"""The training rungs' kernel instances on the card (TRAIN_MATMUL_PRECISION
"default" and "mixed").

Each bf16 mode of the training kernels against its plain version at the same
rung (`precision.Bf16Matmul` under autograd, the training attention with q
scaled before its rounding), on seeded operands at the train step's widths:

  - K5 (`csrc/temporal_bwd.cu`): the forward (`gemm_bf16`,
    `window_attention_train_bf16`, `gemm_branch_bf16`) and the backward
    (`gemm_dx_bf16`, `gemm_dw_bf16`, `window_attention_bwd_bf16`), the
    attention backward alone, and one block (row 14);
  - K6 (`csrc/strided_bwd.cu`): `strided_dh1_bf16`, `strided_dwc_bf16` and
    `sum_rows_bf16` with K3's and K5's bf16 instances, at h36m_351's block,
    overlapping taps and h36m_81's padding;
  - K1's training launch (`spatial_stack_bf16` with droppath scales) and K4
    (`spatial_bwd_bf16`).

The bar is the eval's bf16 instances' (`test_torch_precision_kernels.rung_checks`)
on the mean: the kernel's mean distance to the rung computed with float64 sums
(the plain version in float64, each product's operands rounded to bf16) at
most 2x the fp32 plain version's, + 1e-6 of the scale, for every output;
its largest distance at most 4x. The largest is set by a bf16 rounding that
flips between two sum orders and by what later layers make of it, so it
moves with any change of formulation: over six seeds of K1 at 1,031 frames
the card's and the host's fp32 plain versions part by up to 2.17x on it
(`test_largest_distance_over_seeds`), and on the train step's K4 case a
plain version whose softmax is K4's (base 2, the scale folded with log2 e)
moves the q bias gradient's largest by 1.64x where K4 sits at 3.57x
(`test_k4_largest_distance_and_the_softmax`). The plain versions replay
the kernel forward's relu decisions, as the 3xTF32 tests do. The
3xTF32 instances keep their bits: K4's outputs and K5's backward outputs on
seeded inputs equal their digests (`K4_DIGEST`, re-taken with K4's
block-major walk; `K5_BWD_DIGEST`, re-taken when dW moved to wgmma; the same
card type and toolkit).

JAX is not imported, so the file also runs on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_train_rung_kernels.py
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.spatial import PARAM_ORDER, spatial_stack, spatial_stack_plain
from uplift_upsample_torch.ops.spatial_bwd import spatial_stack_bwd, spatial_stack_bwd_plain
from uplift_upsample_torch.ops.strided import DENSE as STRIDED_DENSE
from uplift_upsample_torch.ops.strided import add_strided_bf16_planes, output_length
from uplift_upsample_torch.ops.strided_train import (ORDER as STRIDED_ORDER,
                                                     saved_relu_mask, strided_block1_bwd_plain,
                                                     strided_block1_train_plain,
                                                     strided_train_bwd, strided_train_fwd)
from uplift_upsample_torch.ops.temporal import (add_weight_operands, stack_temporal_params,
                                                temporal_stack_plain)
from uplift_upsample_torch.ops.temporal_train import (ORDER, gemm_dw, gemm_dx,
                                                      saved_relu_masks, temporal_stack_bwd_plain,
                                                      temporal_train_bwd, temporal_train_fwd,
                                                      window_attention_bwd,
                                                      window_attention_bwd_plain)
from uplift_upsample_torch.precision import mm

try:  # the card's machine collects tests/ without the package's conftest
    from tests.test_torch_precision_kernels import K4_DIGEST, _k4_outputs, k4_digest, rung_checks
    from tests.test_torch_spatial_bwd_tc import _spatial_case
except ImportError:  # pragma: no cover
    from test_torch_precision_kernels import K4_DIGEST, _k4_outputs, k4_digest, rung_checks
    from test_torch_spatial_bwd_tc import _spatial_case

# sha256 of K5's backward outputs at `_k5_bwd_outputs`' inputs (NVIDIA H100
# 80GB HBM3, nvcc 12.9, sm_90a), re-taken when dW moved to wgmma with a fresh
# partial per 32-deep stage (gemm_atb_kernel; every float64 check and grad bar
# of dW and dWc held); the mma.sync dW's, a partial per 8-deep step, was
# f864985ffdcf8d7a7034942ff9ba2d3299f1a32965729176ff788d3158a6cd05.
K5_BWD_DIGEST = "54a482ad1ee5895e549c8ee7bd2a6d49c621cdc10f30a0e8bb2ed00d0bdfe3e2"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cast(value, dtype):
    if isinstance(value, dict):
        return {k: _cast(v, dtype) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_cast(v, dtype) for v in value)
    return value.to(dtype) if torch.is_tensor(value) and value.is_floating_point() else value


def held(got, plain, plain_high, rung64, what):
    """The module docstring's bar: the kernel's mean distance to the rung
    with float64 sums at most 2x the fp32 plain version's and its largest at
    most 4x, + 1e-6 of the scale (`plain_high`, the rung's drift, is
    reported: an output with no product, a bias gradient, has none)."""
    got, plain, plain_high = (t.double() for t in (got, plain, plain_high))
    err, err_plain = (got - rung64).abs(), (plain - rung64).abs()
    slack = 1e-6 * float(rung64.abs().max())
    nums = dict(rung64_mean=float(err.mean()), plain_rung64_mean=float(err_plain.mean()),
                rung64_max=float(err.max()), plain_rung64_max=float(err_plain.max()),
                drift_mean=float((plain - plain_high).abs().mean()))
    assert (nums["rung64_mean"] <= 2 * nums["plain_rung64_mean"] + slack
            and nums["rung64_max"] <= 4 * nums["plain_rung64_max"] + slack
            and bool(torch.isfinite(got).all())), (what, nums)
    return nums


def without_key_bias(t):
    """q|k|v bias gradients (…, 3C) without the key's third, whose true
    gradient is 0 (the softmax is invariant to it): float noise on both sides."""
    c = t.shape[-1] // 3
    return torch.cat([t[..., :c], t[..., 2 * c:]], dim=-1)


def temporal_state(rng, c, blocks, scale=0.05):
    """A model state_dict's temporal blocks (glorot-like weights, small biases)."""
    state = {}
    for i in range(1, blocks + 1):
        p = f"temporal_block_{i}."

        def put(key, *shape, s=scale):
            state[p + key] = torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32))

        for w in ("wq", "wk", "wv", "proj"):
            put(f"attn.{w}.weight", c, c)
            put(f"attn.{w}.bias", c, s=0.02)
        put("mlp.fc1.weight", 2 * c, c)
        put("mlp.fc1.bias", 2 * c, s=0.02)
        put("mlp.fc2.weight", c, 2 * c)
        put("mlp.fc2.bias", c, s=0.02)
        state[p + "norm1.weight"] = 1 + torch.from_numpy(
            (rng.normal(size=c) * 0.1).astype(np.float32))
        state[p + "norm1.bias"] = torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32))
        state[p + "norm2.weight"] = 1 + torch.from_numpy(
            (rng.normal(size=c) * 0.1).astype(np.float32))
        state[p + "norm2.bias"] = torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32))
    return state


def temporal_case(seed, b, n, c, blocks, keep=0.9):
    """(state, x, key_mask, dp_all, cot) on the CPU: the train step's droppath
    scales (0 or 1/keep per window and branch) and a %5 stride mask."""
    rng = np.random.default_rng(seed)
    state = temporal_state(rng, c, blocks)
    x = torch.from_numpy((rng.normal(size=(b, n, c)) * 0.5).astype(np.float32))
    key_mask = torch.from_numpy(np.tile((np.arange(n) % 5 != 0).astype(np.float32), (b, 1)))
    dp = np.floor(keep + rng.uniform(size=(blocks, 2, b))) / keep
    cot = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32))
    return state, x, key_mask, torch.from_numpy(dp.astype(np.float32)), cot


def _k5_bwd_outputs():
    """K5's backward at "high" on seeded inputs (64 windows x 71 x 384, 2
    blocks, the key mask in block 1)."""
    state, x, km, dp, cot = temporal_case(5, 64, 71, 384, 2)
    ops = {k: v.cuda() for k, v in stack_temporal_params(state, 2).items()}
    x, km, dp, cot = (t.cuda() for t in (x, km, dp, cot))
    kw = dict(num_heads=8, first_masked_blocks=1)
    _, saved = temporal_train_fwd(x, ops, km, dp, **kw)
    dx, grads, ddp = temporal_train_bwd(saved, cot, ops, km, dp, **kw)
    return [dx] + [grads[name] for name in ORDER] + [ddp]


@pytest.mark.gpu
def test_3xtf32_instances_keep_their_bits():
    """K4 and K5's backward at "high": bit-identical on repeat and to their
    digests (`K4_DIGEST`, `K5_BWD_DIGEST`)."""
    _card()
    first, second = _k4_outputs(), _k4_outputs()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert k4_digest(first) == K4_DIGEST
    first, second = _k5_bwd_outputs(), _k5_bwd_outputs()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert k4_digest(first) == K5_BWD_DIGEST


def _k5_run(ops, x, km, dp, cot, rung, kw):
    out, saved = temporal_train_fwd(x, ops, km, dp, precision=rung, **kw)
    dx, grads, ddp = temporal_train_bwd(saved, cot, ops, km, dp, precision=rung, **kw)
    return out, saved, dx, grads, ddp


@pytest.mark.gpu
@pytest.mark.parametrize("blocks,fmb", [(2, 1), (1, 1)])
def test_k5_bf16_matches_plain(blocks, fmb):
    """K5 at "default", forward and backward, against the plain stack at the
    rung (fp32 and float64 sums), 64 windows x 71 x 384; one block is row 14."""
    dev = _card()
    state, x, km, dp, cot = (t if isinstance(t, dict) else t.to(dev)
                             for t in temporal_case(9, 64, 71, 384, blocks))
    ops = {k: v.to(dev) for k, v in stack_temporal_params(state, blocks,
                                                          precision="default").items()}
    kw = dict(num_heads=8, first_masked_blocks=fmb)
    cuda_lib.reset_launches()
    out, saved, dx, grads, ddp = _k5_run(ops, x, km, dp, cot, "default", kw)
    _, _, dx2, grads2, _ = _k5_run(ops, x, km, dp, cot, "default", kw)
    torch.cuda.synchronize()
    for entry in ("gemm_bf16", "window_attention_train_bf16", "gemm_branch_bf16",
                  "gemm_dx_bf16", "gemm_dw_bf16", "window_attention_bwd_bf16"):
        assert cuda_lib.LAUNCHES[entry] > 0, entry
    for entry in ("gemm_f32", "window_attention_f32", "gemm_branch_f32", "gemm_dx_f32",
                  "gemm_dw_f32", "window_attention_bwd_f32"):
        assert cuda_lib.LAUNCHES[entry] == 0, entry
    assert torch.equal(dx, dx2) and all(torch.equal(grads[k], grads2[k]) for k in ORDER)
    masks = saved_relu_masks(saved)

    def plain(rung, dtype):
        args = _cast((x, ops, km, dp, cot), dtype)
        fwd = temporal_stack_plain(args[0], args[1], args[2], droppath=args[3], relu_masks=masks,
                                   precision=rung, train=True, **kw)
        bwd = temporal_stack_bwd_plain(*args, relu_masks=masks, precision=rung, **kw)
        return fwd, bwd

    p32, p_high, p64 = (plain("default", torch.float32), plain("high", torch.float32),
                        plain("default", torch.float64))
    held(out, p32[0], p_high[0], p64[0], "out")
    held(dx, p32[1][0], p_high[1][0], p64[1][0], "dx")
    held(ddp, p32[1][2], p_high[1][2], p64[1][2], "ddp")
    for name in ORDER:
        pick = without_key_bias if name == "bqkv" else (lambda t: t)
        held(*(pick(t) for t in (grads[name], p32[1][1][name], p_high[1][1][name],
                                 p64[1][1][name])), name)


@pytest.mark.gpu
def test_k5_attention_bwd_bf16_matches_plain():
    """`window_attention_bwd_bf16` (512 x 71, 8 heads of 48, the key mask)
    against autograd of the training attention at the rung."""
    dev = _card()
    rng = np.random.default_rng(4)
    b, n, c = 512, 71, 384
    qkv = torch.from_numpy((rng.normal(size=(b * n, 3 * c)) * 0.5).astype(np.float32)).to(dev)
    dctx = torch.from_numpy(rng.normal(size=(b * n, c)).astype(np.float32)).to(dev)
    km = torch.from_numpy(np.tile((np.arange(n) % 5 != 0).astype(np.float32), (b, 1))).to(dev)
    kw = dict(windows=b, n=n, num_heads=8)
    cuda_lib.reset_launches()
    got = window_attention_bwd(qkv, dctx, km, precision="default", **kw)
    assert torch.equal(got, window_attention_bwd(qkv, dctx, km, precision="default", **kw))
    assert cuda_lib.LAUNCHES["window_attention_bwd_bf16"] == 2
    plain = {(r, d): window_attention_bwd_plain(qkv.to(d), dctx.to(d), km.to(d), precision=r,
                                                **kw)
             for r, d in (("default", torch.float32), ("high", torch.float32),
                          ("default", torch.float64))}
    for part, sl in (("dq", slice(0, c)), ("dk", slice(c, 2 * c)), ("dv", slice(2 * c, None))):
        held(got[:, sl], plain["default", torch.float32][:, sl],
             plain["high", torch.float32][:, sl], plain["default", torch.float64][:, sl], part)


@pytest.mark.gpu
def test_k5_dx_dw_bf16_match_plain():
    """`gemm_dx_bf16` (dY scaled per window, rounded, the relu mask) and
    `gemm_dw_bf16` (dY scaled) at the train step's fc2 shapes against the
    rounded operands' products."""
    dev = _card()
    rng = np.random.default_rng(6)
    rows, n, k, m = 36352, 71, 384, 768
    w = torch.from_numpy((rng.normal(size=(m, k)) * 0.05).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32)).to(dev)
    h1 = torch.from_numpy(np.maximum(rng.normal(size=(rows, m)), 0).astype(np.float32)).to(dev)
    s = torch.from_numpy((np.floor(0.9 + rng.uniform(size=rows // n)) / 0.9).astype(
        np.float32)).to(dev)
    planes = add_weight_operands({"w2": w}, ["w2"], "default")
    got_dx = gemm_dx(g, s, n, planes["w2_bf_dx"], mask=h1, precision="default")
    got_dw = torch.empty((m, k), dtype=torch.float32, device=dev)
    gemm_dw(h1, g, s, n, got_dw, precision="default")
    sg = g * s.repeat_interleave(n)[:, None]

    def dx(rung, d):
        return torch.where(h1 > 0, mm(sg.to(d), w.t().to(d), rung), 0.0)

    def dw(rung, d):
        return mm(h1.t().to(d), sg.to(d), rung)

    for name, got, ref in (("dx", got_dx, dx), ("dw", got_dw, dw)):
        ok, nums = rung_checks(got, ref("default", torch.float32), ref("high", torch.float32),
                               ref("default", torch.float64))
        assert ok, (name, nums)


def strided_ops(rng, n, c, hidden, dev, precision):
    def rand(*shape, scale=0.1):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    ops = dict(
        pe=rand(n, c), ln1_g=1 + rand(c), ln1_b=rand(c), wqkv=rand(c, 3 * c, scale=0.05),
        bqkv=rand(3 * c), wp=rand(c, c, scale=0.05), bp=rand(c), ln2_g=1 + rand(c),
        ln2_b=rand(c), w1=rand(c, hidden, scale=0.05), b1=rand(hidden),
        wc=rand(3 * hidden, c, scale=0.03), bc=rand(c))
    if precision == "default":  # Wc's planes as torch.bfloat16, as the block's operands hold them
        return add_strided_bf16_planes(ops, dx=True)
    return add_weight_operands(ops, STRIDED_DENSE, precision)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,hidden,stride,pads", [
    (64, 71, 384, 768, 3, (0, 0)),   # h36m_351's strided block 1
    (5, 27, 128, 256, 2, (0, 0)),    # taps overlap (s0 < 3)
    (7, 41, 128, 256, 4, (1, 1)),    # h36m_81's padded geometry
])
def test_k6_bf16_matches_plain(b, n, c, hidden, stride, pads):
    """K6 at "default", forward and backward, against the plain block at the
    rung with the kernel's relu decisions."""
    dev = _card()
    rng = np.random.default_rng(b + n)
    ops = strided_ops(rng, n, c, hidden, dev, "default")
    x = torch.tensor(rng.normal(size=(b, n, c)) * 0.5, dtype=torch.float32, device=dev)
    g = torch.tensor(rng.normal(size=(b, output_length(n, stride, pads), c)),
                     dtype=torch.float32, device=dev)
    kw = dict(num_heads=8, stride=stride, paddings=pads)
    cuda_lib.reset_launches()
    out, saved = strided_train_fwd(x, ops, precision="default", **kw)
    dx, grads = strided_train_bwd(saved, g, ops, precision="default", **kw)
    dx2, again = strided_train_bwd(saved, g, ops, precision="default", **kw)
    torch.cuda.synchronize()
    for entry in ("strided_conv_bf16", "strided_dh1_bf16", "strided_dwc_bf16", "sum_rows_bf16",
                  "window_attention_train_bf16", "window_attention_bwd_bf16"):
        assert cuda_lib.LAUNCHES[entry] > 0, entry
    for entry in ("strided_conv_f32", "strided_dh1_f32", "strided_dwc_f32", "gemm_f32"):
        assert cuda_lib.LAUNCHES[entry] == 0, entry
    assert torch.equal(dx, dx2) and all(torch.equal(again[k], grads[k]) for k in STRIDED_ORDER)
    mask = saved_relu_mask(saved)

    def plain(rung, dtype):
        xx, oo, gg = _cast((x, ops, g), dtype)
        fwd = strided_block1_train_plain(xx, oo, relu_mask=mask, precision=rung, **kw)
        return fwd, strided_block1_bwd_plain(xx, oo, gg, relu_mask=mask, precision=rung, **kw)

    p32, p_high, p64 = (plain("default", torch.float32), plain("high", torch.float32),
                        plain("default", torch.float64))
    held(out, p32[0], p_high[0], p64[0], "out")
    held(dx, p32[1][0], p_high[1][0], p64[1][0], "dx")
    for name in STRIDED_ORDER:
        pick = without_key_bias if name == "bqkv" else (lambda t: t)
        held(*(pick(t) for t in (grads[name], p32[1][1][name], p_high[1][1][name],
                                 p64[1][1][name])), name)


@pytest.mark.gpu
@pytest.mark.parametrize("f,c,heads", [(25600, 32, 8), (1031, 32, 8), (1031, 16, 4)])
def test_k1_train_and_k4_bf16_match_plain(f, c, heads):
    """K1's training launch (`spatial_stack_bf16` with droppath scales) and
    K4's bf16 instance against the plain stack at the rung and its autograd."""
    dev = _card()
    ops, x, scales, g, heads = _spatial_case(12, f, c, heads, 4)
    ops = {k: v.to(dev) for k, v in ops.items()}
    x, scales, g = x.to(dev), scales.to(dev), g.to(dev)
    cuda_lib.reset_launches()
    out = spatial_stack(x, ops, num_heads=heads, droppath_scales=scales, precision="default")
    dparams, dx, ddp = spatial_stack_bwd(x, ops, scales, g, num_heads=heads,
                                         precision="default")
    again, _, _ = spatial_stack_bwd(x, ops, scales, g, num_heads=heads, precision="default")
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["spatial_stack_bf16"] == 1
    assert cuda_lib.LAUNCHES["spatial_bwd_bf16"] == 2
    assert cuda_lib.LAUNCHES["spatial_stack_f32"] == 0
    assert cuda_lib.LAUNCHES["spatial_bwd_f32"] == 0
    assert all(torch.equal(again[k], dparams[k]) for k in PARAM_ORDER)

    def plain(rung, dtype):
        xx, oo, ss, gg = _cast((x, ops, scales, g), dtype)
        fwd = spatial_stack_plain(xx, oo, num_heads=heads, droppath_scales=ss, precision=rung)
        return fwd, spatial_stack_bwd_plain(xx, oo, ss, gg, num_heads=heads, precision=rung)

    p32, p_high, p64 = (plain("default", torch.float32), plain("high", torch.float32),
                        plain("default", torch.float64))
    held(out, p32[0], p_high[0], p64[0], "out")
    held(dx, p32[1][1], p_high[1][1], p64[1][1], "dx")
    held(ddp, p32[1][2], p_high[1][2], p64[1][2], "ddp")
    for name in PARAM_ORDER:
        if name == "bk":  # a true gradient of 0
            continue
        held(dparams[name], p32[1][0][name], p_high[1][0][name], p64[1][0][name], name)


@pytest.mark.gpu
@pytest.mark.parametrize("rung", ["default", "mixed", "high", "highest"])
def test_train_step_launches_the_rungs_instances(rung):
    """`make_train_step` on the card at each rung (K6 on): the bf16 entries
    where section 1's table puts them, the 3xTF32 ones elsewhere."""
    from uplift_upsample_torch.config import UpliftUpsampleConfig
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step

    dev = _card()
    config = UpliftUpsampleConfig()
    config.update_from(dict(
        SEQUENCE_LENGTH=27, SEQUENCE_STRIDE=5, SPATIAL_EMBED_DIM=32, TEMPORAL_EMBED_DIM=128,
        SPATIAL_TRANSFORMER_BLOCKS=2, TEMPORAL_TRANSFORMER_BLOCKS=2, STRIDES=[3, 3, 3],
        PADDINGS=[[0, 0], [0, 0], [0, 0]], NUM_HEADS=8, BATCH_SIZE=16, MASK_STRIDE=5,
        FIRST_STRIDED_TOKEN_ATTENTION_LAYER=1, DROP_PATH_RATE=[0.1, 0.1, 0.0],
        TRAIN_FUSED_STRIDED=True, EMA_ENABLED=False, TRAIN_MATMUL_PRECISION=rung))
    model = build_uplift_upsample_transformer(config, device=dev, seed=0)
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=False)
    step = make_train_step(model, opt, config, device=dev)
    rng = np.random.default_rng(0)
    n = config.SEQUENCE_LENGTH
    batch = (rng.normal(size=(16, n, 17, 3)).astype(np.float32) * 0.1,
             rng.normal(size=(16, n, 17, 2)).astype(np.float32) * 0.1,
             (np.arange(n) % 5 == 0)[None].repeat(16, 0))
    cuda_lib.reset_launches()
    _, loss = step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    spatial_bf16 = rung == "default"
    temporal_bf16 = rung in ("default", "mixed")
    counts = cuda_lib.LAUNCHES
    for bf16, pair in ((spatial_bf16, ("spatial_stack", "spatial_bwd")),
                       (temporal_bf16, ("gemm_branch", "gemm_dx", "gemm_dw",
                                        "window_attention_bwd", "strided_dh1",
                                        "strided_dwc", "strided_conv"))):
        for name in pair:
            assert counts[f"{name}_bf16"] > 0 if bf16 else counts[f"{name}_bf16"] == 0, name
            assert counts[f"{name}_f32"] == 0 if bf16 else counts[f"{name}_f32"] > 0, name
    assert (counts["window_attention_train_bf16"] > 0) == temporal_bf16


def _ratios(got, plain, rung64):
    e, ep = (got.double() - rung64).abs(), (plain.double() - rung64).abs()
    return float(e.mean() / ep.mean()), float(e.max() / ep.max())


@pytest.mark.gpu
@pytest.mark.parametrize("c,heads", [(16, 4), (32, 8)])
def test_largest_distance_over_seeds(c, heads):
    """The spread the module docstring's bar allows for, over six seeds at
    1,031 frames: K1's bf16 instance and the host's fp32 plain version, each
    against the card's fp32 plain version (mean and largest distance to the
    float64-sum rung), and K4's worst output; printed (-s), and each kernel
    held to the bar."""
    dev = _card()
    for seed in range(12, 18):
        ops, x, sc, g, heads = _spatial_case(seed, 1031, c, heads, 4)
        dops = {k: v.to(dev) for k, v in ops.items()}
        dx, dsc, dg = x.to(dev), sc.to(dev), g.to(dev)
        kw = dict(num_heads=heads, precision="default")
        out = spatial_stack(dx, dops, droppath_scales=dsc, **kw)
        card = spatial_stack_plain(dx, dops, droppath_scales=dsc, **kw)
        host = spatial_stack_plain(x, ops, droppath_scales=sc, **kw)
        rung64 = spatial_stack_plain(dx.double(), _cast(dops, torch.float64),
                                     droppath_scales=dsc.double(), **kw)
        k1, plains = _ratios(out, card, rung64), _ratios(host.to(dev), card, rung64)
        kd, _, _ = spatial_stack_bwd(dx, dops, dsc, dg, **kw)
        pd, _, _ = spatial_stack_bwd_plain(dx, dops, dsc, dg, **kw)
        qd, _, _ = spatial_stack_bwd_plain(dx.double(), _cast(dops, torch.float64),
                                           dsc.double(), dg.double(), **kw)
        k4 = {k: _ratios(kd[k], pd[k], qd[k]) for k in PARAM_ORDER if k not in ("bk", "norm_b")}
        worst_mean, worst_max = max(v[0] for v in k4.values()), max(v[1] for v in k4.values())
        print(f"C={c} seed {seed}: K1 mean/largest {k1[0]:.2f}/{k1[1]:.2f}; host plain "
              f"{plains[0]:.2f}/{plains[1]:.2f}; K4 worst of {len(k4)} outputs "
              f"{worst_mean:.2f}/{worst_max:.2f}")
        assert k1[0] <= 2 and k1[1] <= 4 and worst_mean <= 2 and worst_max <= 4, seed


@pytest.mark.gpu
def test_k4_largest_distance_and_the_softmax():
    """The train step's K4 case (h36m_351's seeded weights, the 25,600
    keyframes, its droppath rates): K4's bf16 instance, the fp32 plain
    version and a plain version whose 17-token softmax is K4's (base 2, the
    scale folded with log2 e), each against the float64-sum rung, output by
    output (printed with -s); K4 held to the module docstring's bar."""
    import math

    import uplift_upsample_torch.ops.spatial as spatial_mod
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import prepare_fused_params
    from uplift_upsample_torch.ops.spatial import make_droppath_scales
    from uplift_upsample_torch.parallel.train_step import keyframe_budget

    dev = _card()
    rng = np.random.default_rng(0)
    config = get_config("h36m_351")
    model = build_uplift_upsample_transformer(config, device=dev, seed=0)
    fp = prepare_fused_params(model)
    ops, packed = fp["spatial"], fp["spatial_packed"]
    budget = keyframe_budget(model, config)
    sc = make_droppath_scales(torch.Generator().manual_seed(0),
                              [0.1 * i / 3 for i in range(4)], budget).to(dev)
    x = torch.from_numpy((rng.normal(size=(budget, 17, 2)) * 0.5).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(budget, 17 * 32)).astype(np.float32)).to(dev)
    kw = dict(num_heads=8, precision="default")
    kernel = spatial_stack_bwd(x, ops, sc, g, packed=packed, **kw)
    plain = spatial_stack_bwd_plain(x, ops, sc, g, **kw)
    rung64 = spatial_stack_bwd_plain(x.double(), _cast(ops, torch.float64), sc.double(),
                                     g.double(), **kw)
    softmax = torch.softmax

    def base2(t, dim=-1):
        u = t * math.log2(math.e)
        e = torch.exp2(u - u.amax(dim, keepdim=True))
        return e / e.sum(dim, keepdim=True)

    spatial_mod.torch.softmax = base2
    try:
        other = spatial_stack_bwd_plain(x, ops, sc, g, **kw)
    finally:
        spatial_mod.torch.softmax = softmax

    def outputs(r):
        return [(k, r[0][k]) for k in PARAM_ORDER if k != "bk"] + [("dx", r[1]), ("ddp", r[2])]

    for (name, k), (_, p), (_, o), (_, d) in zip(*(outputs(r) for r in (kernel, plain, other,
                                                                        rung64))):
        ko, oo = _ratios(k, p, d), _ratios(o, p, d)
        print(f"{name}: K4 / plain mean {ko[0]:.2f} largest {ko[1]:.2f}; base-2 softmax plain / "
              f"plain mean {oo[0]:.2f} largest {oo[1]:.2f}")
        held(k, p, p, d, name)
