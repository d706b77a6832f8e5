"""The strided conv's products on the tensor cores (`csrc/strided.cu`,
`csrc/strided_bwd.cu`, the gathered operand of `csrc/conv_taps.cuh`).

K3 and K6 compute strided block 1's k=3 conv as GEMMs over the taps matrix
T (B·n_out, 3·hidden), whose row (b, t) is h1's rows s0·t + j − p0 for the
taps j = 0, 1, 2 side by side (zero outside the window): the forward T · Wc
plus the crop residual, dH1 = g · Wcᵀ scattered back onto the rows the taps
read (relu-masked), and dWc = Tᵀ · g. The loaders gather T from h1; it is
never written out.

CPU tests: the index the loaders compute (`conv_tap_rows`, and a scalar
model of `ConvTaps` and of the dH1 epilogue's scatter, for each launch
schedule) against the plain block's taps and the autograd of the plain
conv; a float64 emulation of the kernels' 3xTF32 sums at the conv's depths
held to the float64 criterion the card holds them to.

`gpu` tests: each launch against its plain version and float64 at the
geometries of `tests/test_torch_strided_train.py` with odd window counts,
the backward bit-identical on repeat. JAX is not imported here, so the file
also runs where JAX is not installed (the card's machine):

    python -m pytest --noconftest -m gpu tests/test_torch_conv_tc.py
"""

import numpy as np
import pytest
import torch

from test_torch_gemm_tc import _emulate_3xtf32, _f64_ok
from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.strided import (DENSE, conv_scatter_plain, conv_tap_rows,
                                               conv_taps_plain, output_length, strided_conv,
                                               strided_conv_plain)
from uplift_upsample_torch.ops.strided_train import (conv_dh1, conv_dh1_plain, conv_dwc,
                                                     conv_dwc_plain)
from uplift_upsample_torch.ops.temporal import add_tf32_halves
from uplift_upsample_torch.ops.temporal_train import dw_splits

# (s0, paddings): h36m_351, overlapping taps, h36m_81, every row read thrice
GEOMETRIES = [(3, (0, 0)), (2, (0, 0)), (4, (1, 1)), (1, (1, 1))]


def _operands(seed, b, n, hidden, c, stride, pads, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=0.5: torch.tensor(rng.normal(size=shape) * scale, dtype=dtype)
    h1 = torch.relu(t(b, n, hidden))  # relu'd: its zeros are the mask
    g = t(b, output_length(n, stride, pads), c, scale=1.0)
    return h1, t(b, n, c), t(3 * hidden, c, scale=0.05), t(c, scale=0.1), g


# -- CPU ------------------------------------------------------------------------

@pytest.mark.parametrize("stride,pads", GEOMETRIES)
def test_loader_index_matches_plain_taps(stride, pads):
    """`conv_taps_plain` (through `conv_tap_rows`) is the taps matrix the
    plain block builds (its conv with Wc = I, no bias, no residual), and a
    scalar model of `ConvTaps` (row(r): tap 0's flat offset and row; at(row,
    k): h1[off + k] or zero) reads the same element at every (r, k)."""
    b, n, hidden = 3, 13, 4
    h1, *_ = _operands(stride, b, n, hidden, 1, stride, pads)
    taps = conv_taps_plain(h1, stride, pads)
    n_out = output_length(n, stride, pads)
    assert taps.shape == (b, n_out, 3 * hidden)
    eye = torch.eye(3 * hidden)
    plain = strided_conv_plain(h1, torch.zeros(b, n, 3 * hidden), eye,
                               torch.zeros(3 * hidden), stride=stride, paddings=pads)
    assert torch.equal(taps, plain)
    rows = conv_tap_rows(n, stride, pads)
    assert rows.shape == (n_out, 3) and int(rows.max()) < n
    flat = h1.reshape(-1)
    for r in range(b * n_out + 2):  # two rows past T read zeros
        bb, t = divmod(r, n_out)
        first = stride * t - pads[0] if r < b * n_out else -4
        off = (bb * n + first) * hidden
        for k in range(3 * hidden):
            src = first + k // hidden
            got = float(flat[off + k]) if 0 <= src < n else 0.0
            want = float(taps[bb, t, k]) if r < b * n_out else 0.0
            assert got == want, (r, k)
            if r < b * n_out:
                assert (src if 0 <= src < n else -1) == int(rows[t, k // hidden])


def _scatter_model(prod, h1, stride, pads):
    """The dH1 epilogue (`TapScatter`) on the product g · Wcᵀ (B·n_out,
    3·hidden), launch by launch: one launch over every tap for s0 >= 3
    (disjoint rows), else one per tap in tap order, each adding into the
    last; zero where relu cut. Rows no tap reads keep the memset's 0."""
    b, n, hidden = h1.shape
    n_out = output_length(n, stride, pads)
    out = torch.zeros(b * n * hidden)
    mask = h1.reshape(-1) > 0
    launches = [(0, 3, False)] if stride >= 3 else [(j, 1, True) for j in range(3)]
    for tap0, taps, accumulate in launches:
        for r in range(b * n_out):
            bb, t = divmod(r, n_out)
            for col in range(taps * hidden):
                j, i = divmod(col, hidden)
                src = stride * t + tap0 + j - pads[0]
                if not 0 <= src < n:
                    continue
                o = (bb * n + src) * hidden + i
                v = prod[r, (tap0 + j) * hidden + i]
                out[o] = (out[o] + v if accumulate else v) if mask[o] else 0.0
    return out.reshape(b, n, hidden)


@pytest.mark.parametrize("stride,pads", GEOMETRIES)
def test_scatter_and_plain_pieces_match_autograd(stride, pads):
    """dH1 and dWc: the plain pieces the kernels are held to equal the
    autograd of the plain conv (dH1 through fc1's relu); the dH1 epilogue's
    launch schedule gives `conv_scatter_plain`'s sums bit for bit; the CPU
    wrappers are the plain versions."""
    b, n, hidden, c = 3, 13, 4, 5
    h1, x, wc, bc, g = _operands(10 + stride, b, n, hidden, c, stride, pads)
    leaves = [t.clone().requires_grad_(True) for t in (h1, wc)]
    out = strided_conv_plain(torch.relu(leaves[0]), x, leaves[1], bc, stride=stride,
                             paddings=pads)
    d_h1, d_wc = torch.autograd.grad(out, leaves, g)
    kw = dict(stride=stride, paddings=pads)
    dh1 = conv_dh1_plain(g, wc, h1, **kw)
    torch.testing.assert_close(dh1, d_h1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(conv_dwc_plain(h1, g, **kw), d_wc, rtol=1e-5, atol=1e-6)
    prod = g.reshape(-1, c) @ wc.t()
    scattered = conv_scatter_plain(prod.reshape(b, -1, 3 * hidden), n, stride, pads)
    assert torch.equal(_scatter_model(prod, h1, stride, pads),
                       torch.where(h1 > 0, scattered, 0.0))
    assert torch.equal(conv_dh1(g, dict(wc=wc), h1, **kw), dh1)
    got = conv_dwc(h1, g, torch.empty(3 * hidden, c), **kw)
    assert torch.equal(got, conv_dwc_plain(h1, g, **kw))
    assert torch.equal(strided_conv(h1, x, dict(wc=wc, bc=bc), **kw),
                       strided_conv_plain(h1, x, wc, bc, **kw))


@pytest.mark.parametrize("k,promote,rows_split,taps", [
    (3 * 768, 4, False, True),    # the forward T · Wc: a partial per 32-deep stage
    (384, 4, False, False),       # dH1 = g · Wcᵀ: the same kernel over C
    (512 * 23, 1, True, True),    # dWc = Tᵀ · g over the train step's 11,776 rows
])
def test_3xtf32_emulation_meets_float64_criterion_at_conv_depths(k, promote, rows_split, taps):
    """The float64 criterion holds for the kernels' arithmetic at the conv's
    depths: gemm_tc_kernel's fresh partial per 32-deep stage over K = 2,304
    (the forward, 72 stages) and K = 384 (dH1), gemm_atb_kernel's partial per
    8-deep step over the 11,776 selected rows of the train step, split as
    `dw_splits` cuts dWc (3·768 x 384). The deepest sums would miss it with
    one running sum."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(16, k)).astype(np.float32)
    if taps:  # T is relu'd h1
        a = np.maximum(a, 0)
    b = rng.normal(size=(k, 16)).astype(np.float32)
    k_split = k
    if rows_split:  # chunks of whole 32-row stages
        splits = dw_splits(k, 3 * 768, 384)
        assert splits > 1
        k_split = -(-k // splits)
        k_split = -(-k_split // 32) * 32
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    plain = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy().astype(np.float64)
    ok, err, err_plain = _f64_ok(_emulate_3xtf32(a, b, k_split, promote).astype(np.float64),
                                 plain, ref64)
    assert ok, (err, err_plain)
    if k > 384:
        one_sum = _emulate_3xtf32(a, b, k_split, None).astype(np.float64)
        assert not _f64_ok(one_sum, plain, ref64)[0]


def test_conv_kernel_halves_split_with_the_block():
    """The conv kernel's TF32 halves are split with the block's dense
    matrices: "wc_tc" (2, C, 3·hidden) for the forward, "wc_tc_dx" (2,
    3·hidden, C) for dH1."""
    assert "wc" in DENSE
    ops = add_tf32_halves(dict(wc=torch.randn(3 * 8, 4)), ("wc",))
    assert ops["wc_tc"].shape == (2, 4, 24) and ops["wc_tc_dx"].shape == (2, 24, 4)
    assert torch.equal(ops["wc_tc"].sum(0), ops["wc"].t())
    assert torch.equal(ops["wc_tc_dx"].sum(0), ops["wc"])


# -- the card -------------------------------------------------------------------

# (windows, n, C, hidden, s0, paddings): the geometries of K6's gpu tests with
# odd window counts, and the serving and train shapes of h36m_351
CARD = [
    (65, 71, 384, 768, 3, (0, 0)),
    (5, 27, 128, 256, 2, (0, 0)),    # taps overlap (s0 < 3): per-tap launches
    (7, 41, 128, 256, 4, (1, 1)),    # h36m_81's padded geometry
    (1023, 71, 384, 768, 3, (0, 0)),
    (511, 71, 384, 768, 3, (0, 0)),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    return torch.device("cuda")


def _card_operands(b, n, c, hidden, stride, pads):
    dev = _card()
    h1, x, wc, bc, g = (t.to(dev) for t in _operands(b + n, b, n, hidden, c, stride, pads))
    return h1, x, g, add_tf32_halves(dict(wc=wc, bc=bc), ("wc",))


def _f64(got, plain, ref64):
    return _f64_ok(got.double().cpu().numpy(), plain.double().cpu().numpy(),
                   ref64.cpu().numpy())


def _grad_close(got, ref):
    scale = max(float(ref.abs().max()), 1e-3)
    return bool(((got - ref).abs() <= 2e-4 * scale + 2e-3 * ref.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,hidden,stride,pads", CARD)
def test_conv_forward_matches_plain(b, n, c, hidden, stride, pads):
    """`strided_conv_f32` (one launch) against the plain conv and float64."""
    h1, x, _, ops = _card_operands(b, n, c, hidden, stride, pads)
    kw = dict(stride=stride, paddings=pads)
    cuda_lib.reset_launches()
    got = strided_conv(h1, x, ops, counter="test", **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["strided_conv_f32"] == 1
    ref = strided_conv_plain(h1, x, ops["wc"], ops["bc"], **kw)
    assert float((got - ref).abs().max()) <= 2e-4 * max(1.0, float(ref.abs().max()))
    ref64 = strided_conv_plain(h1.double(), x.double(), ops["wc"].double(),
                               ops["bc"].double(), **kw)
    ok, err, err_plain = _f64(got, ref, ref64)
    assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,hidden,stride,pads", CARD)
def test_conv_backward_matches_plain(b, n, c, hidden, stride, pads):
    """dH1 (`strided_dh1_f32`) and dWc (`strided_dwc_f32`) against the plain
    pieces (the grad bar) and float64, bit-identical on repeat."""
    h1, _, g, ops = _card_operands(b, n, c, hidden, stride, pads)
    kw = dict(stride=stride, paddings=pads)
    cuda_lib.reset_launches()
    dh1, dh1_again = conv_dh1(g, ops, h1, **kw), conv_dh1(g, ops, h1, **kw)
    dwc = conv_dwc(h1, g, torch.empty_like(ops["wc"]), **kw).clone()
    dwc_again = conv_dwc(h1, g, torch.empty_like(ops["wc"]), **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["strided_dh1_f32"] == 2
    assert cuda_lib.LAUNCHES["strided_dwc_f32"] == 2
    assert torch.equal(dh1, dh1_again) and torch.equal(dwc, dwc_again)
    for got, plain, ref64 in (
            (dh1, conv_dh1_plain(g, ops["wc"], h1, **kw),
             conv_dh1_plain(g.double(), ops["wc"].double(), h1.double(), **kw)),
            (dwc, conv_dwc_plain(h1, g, **kw), conv_dwc_plain(h1.double(), g.double(), **kw))):
        assert _grad_close(got, plain)
        ok, err, err_plain = _f64(got, plain, ref64)
        assert ok, (err, err_plain)
