"""K2's and K3's launches at the widths of their split over mp = 2
(`ops/temporal.py`, `ops/strided.py` with `tp=`): h36m_351 (C = 384, 8 heads
of 48, hidden 768) gives each mp rank qkv K = 384 → N = 576 (its q, k and v
shards side by side), proj K = 192 → 384 as a partial sum (no bias, no
residual on ranks other than 0), fc1 384 → 384, fc2 384 → 384, the window
attention over c = 192 channels in 4 heads of 48 (k and v at 768 and 1,536
bytes into a row of 576 floats), and the conv over 384 hidden channels with
zeros in place of the residual and bc on ranks other than 0.

`gpu` tests: each launch against its plain version and float64, and
bit-identical on repeat; each launch's bf16 instance at mp rank 0's widths
(the bf16 rung under mp > 1) against its plain version at "default" within
the rung's drift. They decide inside the test whether there is a card and
skip without one. JAX is not imported here:

    python -m pytest --noconftest -m gpu tests/test_torch_tp_kernels.py
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.strided import strided_conv, strided_conv_plain
from uplift_upsample_torch.ops.temporal import (add_tf32_halves, gemm, tf32_halves,
                                                window_attention, window_attention_plain)

N_TOKENS = 71
# (K, N, bias, residual, relu) of mp rank 0's and the other ranks' products
GEMMS = [
    (384, 576, True, False, False),   # qkv: the rank's q|k|v
    (192, 384, True, True, False),    # proj on rank 0: + bp + h
    (192, 384, False, False, False),  # proj elsewhere: the partial alone
    (384, 384, True, False, True),    # fc1: the rank's hidden half, relu
    (384, 384, True, True, False),    # fc2 on rank 0
    (384, 384, False, False, False),  # fc2 elsewhere
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    return torch.device("cuda")


def _rand(rng, *shape, scale=0.5):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device="cuda")


def _close(got, ref):
    return float((got - ref).abs().max()) <= 2e-4 * max(1.0, float(ref.abs().max()))


def _f64_ok(got, plain, ref64):
    """The float64 criterion: the kernel's error against float64 at most 4x
    the fp32 plain version's plus 1e-6 of the output scale."""
    err = float((got.double() - ref64).abs().max())
    err_plain = float((plain.double() - ref64).abs().max())
    return err <= 4 * err_plain + 1e-6 * float(ref64.abs().max()), err, err_plain


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [1024, 65])
@pytest.mark.parametrize("k,n,bias,residual,relu", GEMMS)
def test_gemm_at_split_widths(windows, k, n, bias, residual, relu):
    _card()
    rng = np.random.default_rng(k + n + windows)
    m = windows * N_TOKENS
    a, w = _rand(rng, m, k), _rand(rng, k, n, scale=0.05)
    b = _rand(rng, n, scale=0.1) if bias else None
    res = _rand(rng, m, n) if residual else None
    w_tc = tf32_halves(w)
    cuda_lib.reset_launches()
    got = gemm(a, w_tc, b, residual=res, relu=relu, counter="test")
    again = gemm(a, w_tc, b, residual=res, relu=relu, counter="test")
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["gemm_f32"] == 2
    assert torch.equal(got, again)

    def plain(a_, w_, b_, r_):
        y = a_ @ w_ + (0 if b_ is None else b_)
        y = torch.relu(y) if relu else y
        return y + (0 if r_ is None else r_)

    ref = plain(a, w, b, res)
    assert _close(got, ref)
    ref64 = plain(a.double(), w.double(), None if b is None else b.double(),
                  None if res is None else res.double())
    ok, err, err_plain = _f64_ok(got, ref, ref64)
    assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [1024, 65])
@pytest.mark.parametrize("masked", [True, False])
def test_window_attention_at_split_width(windows, masked):
    """c = 192 in 4 heads of 48 (mp rank's share of 384 in 8): the vector
    path's alignment holds (q, k, v at 0, 768 and 1,536 bytes, rows of 576
    floats)."""
    _card()
    rng = np.random.default_rng(windows + masked)
    c, heads = 192, 4
    qkv = _rand(rng, windows * N_TOKENS, 3 * c)
    key_mask = None
    if masked:
        key_mask = (torch.rand((windows, N_TOKENS), device="cuda") < 0.6).float()
        key_mask[:, N_TOKENS // 2] = 0.0  # every window keeps a key
    cuda_lib.reset_launches()
    got = window_attention(qkv, key_mask, windows=windows, n=N_TOKENS, num_heads=heads,
                           counter="test")
    again = window_attention(qkv, key_mask, windows=windows, n=N_TOKENS, num_heads=heads,
                             counter="test")
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["window_attention_f32"] == 2
    assert torch.equal(got, again)
    q3 = qkv.reshape(windows, N_TOKENS, 3 * c)
    ref = window_attention_plain(q3, key_mask, heads).reshape(-1, c)
    assert _close(got, ref)
    ref64 = window_attention_plain(q3.double(), None if key_mask is None else key_mask.double(),
                                   heads).reshape(-1, c)
    ok, err, err_plain = _f64_ok(got, ref, ref64)
    assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [1024, 65])
@pytest.mark.parametrize("first", [True, False])
def test_split_conv(windows, first):
    """K3's conv over one rank's 384 hidden channels at stride 3, paddings
    (0, 0): with the crop residual and bc on mp rank 0, zeros in their place
    on the other ranks (the partial alone)."""
    _card()
    rng = np.random.default_rng(windows + first)
    c, hidden = 384, 384
    h1 = torch.relu(_rand(rng, windows, N_TOKENS, hidden))
    x = _rand(rng, windows, N_TOKENS, c)
    ops = add_tf32_halves(dict(wc=_rand(rng, 3 * hidden, c, scale=0.03),
                               bc=_rand(rng, c, scale=0.1)), ("wc",))
    if not first:
        x, ops = torch.zeros_like(x), dict(ops, bc=torch.zeros_like(ops["bc"]))
    kw = dict(stride=3, paddings=(0, 0))
    cuda_lib.reset_launches()
    got = strided_conv(h1, x, ops, counter="test", **kw)
    again = strided_conv(h1, x, ops, counter="test", **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["strided_conv_f32"] == 2
    assert torch.equal(got, again)
    ref = strided_conv_plain(h1, x, ops["wc"], ops["bc"], **kw)
    assert _close(got, ref)
    ref64 = strided_conv_plain(h1.double(), x.double(), ops["wc"].double(),
                               ops["bc"].double(), **kw)
    ok, err, err_plain = _f64_ok(got, ref, ref64)
    assert ok, (err, err_plain)


def _within_drift(got, ref, high):
    """The bf16 rung's bar for one launch: the mean gap to the plain version
    within 0.25 of the rung's mean drift from "high" (chip_smoke phase 11's
    BF16_DRIFT_FRAC) and the largest within the rung's largest drift."""
    gap, drift = (got - ref).abs(), (ref - high).abs()
    return (float(gap.mean()) <= 0.25 * float(drift.mean())
            and float(gap.max()) <= float(drift.max())), float(gap.mean() / drift.mean())


@pytest.mark.gpu
@pytest.mark.parametrize("part", ["qkv", "proj", "fc1", "fc2", "attention", "conv"])
def test_bf16_launches_at_split_widths(part):
    """The bf16 rung under mp = 2 (A4): each of K2's and K3's launches at mp
    rank 0's widths on the bf16 planes (`gemm_bf16`, `window_attention_bf16`
    on folded q, `strided_conv_bf16`) against its plain version at
    "default", 1,024 windows, and bit-identical on repeat."""
    from uplift_upsample_torch.ops.temporal import bf16_plane
    from uplift_upsample_torch.precision import mm

    _card()
    rng = np.random.default_rng(len(part))
    windows, m, c = 1024, 1024 * N_TOKENS, 192
    if part == "attention":
        qkv = _rand(rng, m, 3 * c)
        km = (torch.rand((windows, N_TOKENS), device="cuda") < 0.6).float()
        run = lambda r: window_attention(qkv, km, windows=windows, n=N_TOKENS, num_heads=4,
                                         counter="test", precision=r, q_folded=True)
        plain = lambda r: window_attention_plain(qkv.reshape(windows, N_TOKENS, 3 * c), km, 4,
                                                 r, q_folded=True).reshape(-1, c)
        entry = "window_attention_bf16"
    elif part == "conv":
        h1, x = torch.relu(_rand(rng, windows, N_TOKENS, 384)), _rand(rng, windows, N_TOKENS, 384)
        ops = dict(wc=_rand(rng, 3 * 384, 384, scale=0.03), bc=_rand(rng, 384, scale=0.1))
        ops["wc_bf"] = bf16_plane(ops["wc"]).to(torch.bfloat16)  # the native bf16 conv's operand
        kw = dict(stride=3, paddings=(0, 0))
        run = lambda r: strided_conv(h1, x, ops, counter="test", precision=r, **kw)
        plain = lambda r: strided_conv_plain(h1, x, ops["wc"], ops["bc"], precision=r, **kw)
        entry = "strided_conv_bf16"
    else:
        k, n, bias, residual, relu = {"qkv": GEMMS[0], "proj": GEMMS[1], "fc1": GEMMS[3],
                                      "fc2": GEMMS[4]}[part]
        a, w = _rand(rng, m, k), _rand(rng, k, n, scale=0.05)
        b, res = _rand(rng, n, scale=0.1), (_rand(rng, m, n) if residual else None)
        a = torch.relu(a) if part == "fc2" else a
        run = lambda r: gemm(a, bf16_plane(w), b, residual=res, relu=relu, counter="test",
                             precision=r)

        def plain(r):
            y = mm(a, w, r) + b
            return (torch.relu(y) if relu else y) + (0 if res is None else res)
        entry = "gemm_bf16"
    cuda_lib.reset_launches()
    got, again = run("default"), run("default")
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[entry] == 2 and torch.equal(got, again)
    ok, frac = _within_drift(got, plain("default"), plain("high"))
    assert ok, frac
