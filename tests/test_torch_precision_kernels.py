"""The bf16 rung's kernel instances on the card (EVAL_MATMUL_PRECISION "default").

Each bf16 instance (K1 `spatial_stack_bf16`, K2's `gemm_bf16` and
`window_attention_bf16`, K3's `strided_conv_bf16` at h36m_351's paddings
(0, 0) and h36m_81's (1, 1), `s2t_prologue_bf16`) against its plain
version at the same rung, on a seeded full-width model's operands. Both
round the same operands to bf16 and sum in fp32; only the order of the
sums differs, and that flips a later bf16 rounding now and then (each flip
moves an operand by a bf16 ulp, and later layers carry it on). Two bars:

  - the rung with exact sums (`rung64`: the plain version in float64, each
    product's operands rounded to bf16): the kernel's mean and largest
    distance to it at most 2x the fp32 plain version's, + 1e-6 of the
    scale, as the 3xTF32 kernels are held to float64 (4x there);
  - mean |kernel - plain("default")| at most 0.25 x the rung's own drift,
    mean |plain("default") - plain("high")|: a kernel that computed fp32
    would sit at 1.0. Over K2's four blocks the flips cascade (0.40 on an
    NVIDIA H100 80GB HBM3), so K2 takes this bar over one block.

The largest gap is not held to a fraction of the largest drift: one flip
next to a relu's kink or in the attention's probabilities moves an output
by 0.3-0.6 x the largest drift in K1, K2, K3 and the attention core on
that card, while their distance to `rung64` stays the plain version's.

K4 (`csrc/spatial_bwd.cu`, which shares `csrc/spatial_common.cuh` with K1's
bf16 instance) has no bf16 mode: its outputs on seeded inputs are
bit-identical on repeat and to the digest its build gave before the bf16
mode was added (`K4_DIGEST`, the same card type and toolkit).

JAX is not imported, so the file also runs on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_precision_kernels.py
"""

import hashlib

import numpy as np
import pytest
import torch

from uplift_upsample_torch.configs import get_config
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.models.bench_forward import bench_forward, prepare_fused_params
from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.s2t import s2t_prologue, s2t_prologue_plain
from uplift_upsample_torch.ops.spatial import PARAM_ORDER, spatial_stack, spatial_stack_plain
from uplift_upsample_torch.ops.spatial_bwd import spatial_stack_bwd
from uplift_upsample_torch.ops.strided import (strided_block1, strided_block1_plain,
                                               strided_conv, strided_conv_plain)
from uplift_upsample_torch.ops.temporal import (gemm, temporal_stack, temporal_stack_plain,
                                                window_attention, window_attention_plain)
from uplift_upsample_torch.precision import mm

try:  # the card's machine collects tests/ without the package's conftest
    from tests.test_torch_spatial_bwd_tc import _spatial_case
except ImportError:  # pragma: no cover
    from test_torch_spatial_bwd_tc import _spatial_case

# sha256 of K4's outputs at `_k4_outputs`' inputs, from the build before the
# bf16 mode (NVIDIA H100 80GB HBM3, nvcc 12.9, sm_90a).
K4_DIGEST = "09707c3aa839d1c6d932b3c9db72f9567c206f5dab18fdd0f74b540c5481c4c7"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def rung_checks(got, plain, plain_high, rung64, mean_frac=0.25):
    """The two bars of the module docstring: (ok, numbers). `mean_frac`
    None skips the drift bar (it is then only reported)."""
    got, plain, plain_high = (t.double() for t in (got, plain, plain_high))
    err, err_plain = (got - rung64).abs(), (plain - rung64).abs()
    slack = 1e-6 * float(rung64.abs().max())
    gap, drift = float((got - plain).abs().mean()), float((plain - plain_high).abs().mean())
    ok = (float(err.mean()) <= 2 * float(err_plain.mean()) + slack
          and float(err.max()) <= 2 * float(err_plain.max()) + slack)
    if mean_frac is not None:
        ok = ok and gap <= mean_frac * drift
    return ok, dict(rung64_mean=float(err.mean()), plain_rung64_mean=float(err_plain.mean()),
                    rung64_max=float(err.max()), plain_rung64_max=float(err_plain.max()),
                    gap_over_drift=gap / drift)


def _cast(value, dtype):
    if isinstance(value, dict):
        return {k: _cast(v, dtype) for k, v in value.items()}
    return value.to(dtype) if torch.is_tensor(value) and value.is_floating_point() else value


def _check(kernel, plain, counter, entry, launches=1, mean_frac=0.25):
    """kernel("default") against plain(rung, dtype) (`rung_checks`);
    `launches` launches of `entry`, none of its fp32 twin."""
    cuda_lib.reset_launches()
    got = kernel("default")
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[entry] == launches, dict(cuda_lib.LAUNCHES)
    assert cuda_lib.LAUNCHES[entry.replace("_bf16", "_f32")] == 0
    assert cuda_lib.LAUNCHES[counter] >= launches
    ok, nums = rung_checks(got, plain("default", torch.float32), plain("high", torch.float32),
                           plain("default", torch.float64), mean_frac)
    assert ok, nums
    assert torch.equal(got, kernel("default"))  # fixed sum orders: the same bits


@pytest.fixture(scope="module")
def h36m_351():
    dev = _card()
    config = get_config("h36m_351")
    config.MASK_STRIDE = 5
    model = build_uplift_upsample_transformer(config, device=dev, seed=0)
    return model, prepare_fused_params(model, "default"), np.random.default_rng(3)


def _rand(rng, *shape, scale=0.5):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("frames", [1031, 72704])
def test_k1_bf16_within_rung_drift(h36m_351, frames):
    model, fp, rng = h36m_351
    x = _rand(rng, frames, 17, 2)
    ops, heads = fp["spatial"], model.num_heads
    _check(lambda p: spatial_stack(x, ops, num_heads=heads, packed=fp["spatial_packed"],
                                   precision=p),
           lambda p, d: spatial_stack_plain(x.to(d), _cast(ops, d), num_heads=heads,
                                            precision=p),
           "spatial_stack", "spatial_stack_bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("blocks", [1, 4])
def test_k2_bf16_within_rung_drift(h36m_351, masked, blocks):
    model, fp, rng = h36m_351
    b, n, c = 64, model.num_frames, model.temporal_d_model
    x = _rand(rng, b, n, c)
    km = (torch.from_numpy(rng.uniform(size=(b, n)) < 0.8).float().cuda() if masked else None)
    kw = dict(num_heads=model.num_heads, first_masked_blocks=1 if masked else 0)
    ops = {k: v[:blocks] for k, v in fp["temporal"].items()}
    _check(lambda p: temporal_stack(x, ops, km, precision=p, **kw),
           lambda p, d: temporal_stack_plain(x.to(d), _cast(ops, d), _cast(km, d), precision=p,
                                             **kw),
           "temporal_stack", "gemm_bf16", launches=4 * blocks,
           mean_frac=0.25 if blocks == 1 else None)


@pytest.mark.gpu
def test_k2_attention_bf16_within_rung_drift(h36m_351):
    model, _, rng = h36m_351
    b, n, c, heads = 128, model.num_frames, model.temporal_d_model, model.num_heads
    qkv = _rand(rng, b * n, 3 * c, scale=1.0)
    km = torch.from_numpy(rng.uniform(size=(b, n)) < 0.5).float().cuda()
    _check(lambda p: window_attention(qkv, km, windows=b, n=n, num_heads=heads, counter="t",
                                      precision=p),
           lambda p, d: window_attention_plain(qkv.reshape(b, n, 3 * c).to(d), km.to(d),
                                               heads, p).reshape(b * n, c),
           "t", "window_attention_bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("name,k_in", [("wqkv", 384), ("wp", 384), ("w1", 384), ("w2", 768)])
def test_k2_gemm_bf16_within_rung_drift(h36m_351, name, k_in):
    """Each dense product of K2 at 1,031 x 71 rows (not a multiple of the
    128-row tile), with its bias, relu or residual as the block runs it."""
    model, fp, rng = h36m_351
    ops = fp["temporal"]
    rows = 1031 * 71
    a = _rand(rng, rows, k_in)
    w, bias = ops[name][0], ops["b" + name[1:]][0]
    relu, res = name == "w1", (_rand(rng, rows, w.shape[1]) if name in ("wp", "w2") else None)
    halves = {"default": ops[name + "_bf"][0], "high": ops[name + "_tc"][0]}
    act = torch.relu if relu else (lambda t: t)
    _check(lambda p: gemm(a, halves[p], bias, relu=relu, residual=res, counter="t", precision=p),
           lambda p, d: act(mm(a.to(d), w.to(d), p) + bias.to(d)) + (
               0 if res is None else res.to(d)),
           "t", "gemm_bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", ["h36m_351", "h36m_81"])
def test_k3_bf16_within_rung_drift(h36m_351, geometry):
    """Strided block 1 at paddings (0, 0) and h36m_81's (1, 1)."""
    model, fp, rng = h36m_351
    if geometry == "h36m_81":
        config = get_config("h36m_81")
        config.MASK_STRIDE = config.MASK_STRIDE[0]
        model = build_uplift_upsample_transformer(config, device="cuda", seed=0)
        fp = prepare_fused_params(model, "default")
    x = _rand(rng, 64, model.num_frames, model.temporal_d_model)
    kw = dict(num_heads=model.num_heads, stride=model.strides[0], paddings=model.paddings[0])
    _check(lambda p: strided_block1(x, fp["strided"], precision=p, **kw),
           lambda p, d: strided_block1_plain(x.to(d), _cast(fp["strided"], d), precision=p,
                                             **kw),
           "strided_block1", "strided_conv_bf16")


@pytest.mark.gpu
def test_k3_conv_bf16_within_rung_drift(h36m_351):
    model, fp, rng = h36m_351
    b, n, c = 257, model.num_frames, model.temporal_d_model
    h1, x = torch.relu(_rand(rng, b, n, 2 * c)), _rand(rng, b, n, c)
    ops = fp["strided"]
    kw = dict(stride=model.strides[0], paddings=model.paddings[0])
    _check(lambda p: strided_conv(h1, x, ops, counter="t", precision=p, **kw),
           lambda p, d: strided_conv_plain(h1.to(d), x.to(d), ops["wc"].to(d), ops["bc"].to(d),
                                           precision=p, **kw),
           "t", "strided_conv_bf16")


@pytest.mark.gpu
def test_s2t_bf16_within_rung_drift(h36m_351):
    model, fp, rng = h36m_351
    b, n = 257, model.num_frames
    sp = _rand(rng, b, n, 17 * model.spatial_d_model, scale=1.0)
    sm = torch.from_numpy(rng.uniform(size=(b, n)) < 0.5).cuda()
    _check(lambda p: s2t_prologue(sp, fp["s2t"], sm, precision=p),
           lambda p, d: s2t_prologue_plain(sp.to(d), _cast(fp["s2t"], d), sm, precision=p),
           "s2t_prologue", "s2t_prologue_bf16")


@pytest.mark.gpu
@pytest.mark.parametrize("fuse_s2t", [False, True])
def test_bench_forward_bf16_launches_and_drift(h36m_351, fuse_s2t):
    """The default and the tiled route at "default": K1, K2, K3 (and the s2t
    kernel on the tiled route) launch their bf16 instances only, and the
    central output sits as close to the same route's plain versions (the
    model on the CPU) as the sum orders allow: mean gap at most 0.75 x the
    rung's mean drift, largest gap at most the largest drift (a path that
    computed fp32 would sit at 1.0)."""
    model, fp, rng = h36m_351
    b, n = 64, model.num_frames
    x = _rand(rng, b, n, 17, 2, scale=0.3)
    sm = torch.ones((b, n), dtype=torch.bool, device="cuda")
    sm[:, 1::5] = False
    x = x * sm[..., None, None]
    route = dict(temporal_attn="banded", fuse_s2t=True) if fuse_s2t else {}
    cuda_lib.reset_launches()
    got = bench_forward(model, x, sm, fp, precision="default", **route)
    torch.cuda.synchronize()
    counts = dict(cuda_lib.LAUNCHES)
    for entry in ("spatial_stack_bf16", "gemm_bf16", "window_attention_bf16",
                  "strided_conv_bf16", *(("s2t_prologue_bf16",) if fuse_s2t else ())):
        assert counts.get(entry, 0) > 0, counts
    for entry in ("spatial_stack_f32", "gemm_f32", "window_attention_f32", "strided_conv_f32",
                  "s2t_prologue_f32"):
        assert counts.get(entry, 0) == 0, counts
    cpu = build_uplift_upsample_transformer(get_config("h36m_351"), device="cpu", seed=0)
    plain = {p: bench_forward(cpu, x.cpu(), sm.cpu(), precision=p, **route) for p in
             ("default", "high")}
    gap, drift = (got.cpu() - plain["default"]).abs(), (plain["default"] - plain["high"]).abs()
    assert gap.mean() <= 0.75 * drift.mean() and gap.max() <= drift.max(), (
        float(gap.mean() / drift.mean()), float(gap.max() / drift.max()))


def _k4_outputs():
    """K4 on seeded inputs (1,031 frames, C = 32, 4 blocks, droppath scales)."""
    ops, x, scales, g, heads = _spatial_case(11, 1031, 32, 8, 4)
    ops = {k: v.cuda() for k, v in ops.items()}
    dparams, dx, dscales = spatial_stack_bwd(x.cuda(), ops, scales.cuda(), g.cuda(),
                                             num_heads=heads)
    return [dparams[name] for name in PARAM_ORDER] + [dx, dscales]


def k4_digest(outputs) -> str:
    digest = hashlib.sha256()
    for t in outputs:
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


@pytest.mark.gpu
def test_k4_unchanged_by_the_bf16_mode():
    _card()
    first, second = _k4_outputs(), _k4_outputs()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert k4_digest(first) == K4_DIGEST
