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
the backward bit-identical on repeat; dWc in both modes (gemm_atb_kernel's
gathered X) at strides 3, 2, 4 and 1 and a tap width that splits a tile.
JAX is not imported here, so the file also runs where JAX is not installed
(the card's machine):

    python -m pytest --noconftest -m gpu tests/test_torch_conv_tc.py
"""

import numpy as np
import pytest
import torch

from test_torch_gemm_tc import _bf16, _emulate_3xtf32, _emulate_bf16, _f64_ok, _rung_bar
from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.strided import (DENSE, add_strided_bf16_planes,
                                               conv_forward_tiles, conv_scatter_plain,
                                               conv_tap_rows, conv_taps_plain, conv_tile_rows,
                                               dh1_tiles, output_length, strided_conv,
                                               strided_conv_plain, tma_box, tma_box_store,
                                               tma_im2col)
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
    """The dH1 kernel's sums (`Dh1Rows`) on the product g · Wcᵀ (B·n_out,
    3·hidden), h1 row by row: the taps j ≡ u + p0 (mod s0) that reach row u
    added in tap order into its accumulator, from g's row (u + p0 − j) / s0
    where that lies in [0, n_out); zero where relu cut. Every row is written
    once, rows no tap reads as 0."""
    b, n, hidden = h1.shape
    n_out = output_length(n, stride, pads)
    taps = prod.reshape(b, n_out, 3, hidden)
    out = torch.full((b, n, hidden), float("nan"))
    for u in range(n):
        acc = torch.zeros(b, hidden)
        for j in range(3):
            t, off = divmod(u + pads[0] - j, stride)
            if off == 0 and 0 <= t < n_out:
                acc = acc + taps[:, t, j]
        out[:, u] = torch.where(h1[:, u] > 0, acc, 0.0)
    return out


@pytest.mark.parametrize("stride,pads", GEOMETRIES)
def test_scatter_and_plain_pieces_match_autograd(stride, pads):
    """dH1 and dWc: the plain pieces the kernels are held to equal the
    autograd of the plain conv (dH1 through fc1's relu); the dH1 kernel's
    sums, each row's taps in tap order in one accumulator, give
    `conv_scatter_plain`'s sums bit for bit; the CPU wrappers are the plain
    versions."""
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
    (512 * 23, 4, True, True),    # dWc = Tᵀ · g over the train step's 11,776 rows
])
def test_3xtf32_emulation_meets_float64_criterion_at_conv_depths(k, promote, rows_split, taps):
    """The float64 criterion holds for the kernels' arithmetic at the conv's
    depths: gemm_tc_kernel's fresh partial per 32-deep stage over K = 2,304
    (the forward, 72 stages) and K = 384 (dH1), and gemm_atb_kernel's partial
    per 32-deep stage over the 11,776 selected rows of the train step, split
    as `dw_splits` cuts dWc (3·768 x 384). The deepest sums would miss it
    with one running sum."""
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


# (s0, paddings) x n of the TMA boxes' tests: h36m_351's and h36m_81's pads,
# taps that overlap and do not, windows of 9 to 81 rows
BOX_GEOMETRIES = [(s, p, n) for s, p in ((3, (0, 0)), (2, (0, 0)), (3, (1, 1)), (2, (1, 1)))
                  for n in (71, 81, 9)] + [(2, (1, 1), 300)]  # dH1: a window in two tiles


def _int_operands(seed, b, n, hidden, c, stride, pads):
    """Small integers in float64: every sum of their products is exact, so
    two orders of the same sum agree bit for bit."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, lo=-3: torch.tensor(rng.integers(lo, 4, size=shape), dtype=torch.float64)
    h1 = torch.relu(t(b, n, hidden))
    return h1, t(3 * hidden, c, lo=-2), t(b, output_length(n, stride, pads), c)


@pytest.mark.parametrize("stride,pads,n", BOX_GEOMETRIES)
def test_tma_boxes_build_the_conv_forward(stride, pads, n):
    """`conv_forward_tiles` (the forward's A as `ConvTapsTma` loads it: one
    im2col box a stage, 128 of T's rows across windows, each tap's rows s0
    apart, zeros outside the window, past the last window and past hidden)
    places T's tiles as `conv_taps_plain` builds T; its stages' products
    (W's columns j·hidden + c0.., the next tap's or none past the tap,
    against the box's zeros) sum to T · Wc. hidden = 40 and C = 36 leave
    part-filled boxes; the window count leaves the last tile part full."""
    hidden, c = 40, 36
    n_out = output_length(n, stride, pads)
    windows = 2 * 128 // n_out + 1
    h1, wc, _ = _int_operands(n + stride, windows, n, hidden, c, stride, pads)
    taps = conv_taps_plain(h1, stride, pads).reshape(-1, 3 * hidden)
    w_pad = torch.cat([wc, torch.zeros(32, c, dtype=wc.dtype)])  # k past 3·hidden reads 0
    lower, upper = -pads[0], stride * (n_out - 1) - pads[0] - (n - 1)
    model = torch.full_like(taps, float("nan"))
    prod = torch.full((windows * n_out, c), float("nan"), dtype=torch.float64)
    tiles = list(conv_forward_tiles(windows, n, hidden, stride, pads))
    assert len(tiles) == -(-windows * n_out // 128) and tiles[-1][1] < 128
    for m0, rows, stages in tiles:
        acc = torch.zeros(128, c, dtype=torch.float64)
        for j, c0, (col, origin, win, offset) in stages:
            box = tma_im2col(h1, col, origin, win, offset, stride, lower, upper)
            width = min(32, hidden - c0)
            assert not box[:, width:].any() and not box[rows:].any()
            model[m0: m0 + rows, j * hidden + c0: j * hidden + c0 + width] = box[:rows, :width]
            acc += box @ w_pad[j * hidden + c0: j * hidden + c0 + 32]
        prod[m0: m0 + rows] = acc[:rows]
    assert torch.equal(model, taps)
    assert torch.equal(prod, taps @ wc)


@pytest.mark.parametrize("stride,pads,n", BOX_GEOMETRIES)
def test_tma_boxes_build_dh1(stride, pads, n):
    """`dh1_tiles` (dH1 as `Dh1Rows` walks it: phase ρ's rows of wpt
    windows, each tap that reaches the phase a box of g's rows shifted by
    (ρ + p0 − j) / s0, zeros outside [0, n_out), summed in tap order; h1's
    mask and the store through boxes of the phase map, nothing written
    outside it) writes every row of dH1 once and gives `conv_dh1_plain`'s
    dH1 (`conv_scatter_plain` of g · Wcᵀ, masked) bit for bit on integer
    operands; the last tile part full; a window of 300 rows at s0 2 in two
    tiles of its phases' rows."""
    hidden, c = 40, 36
    rb, wpt, chunks = conv_tile_rows(-(-n // stride))
    assert rb * wpt <= 128 and (chunks == 1) == (n < 256)
    windows = wpt + 2
    h1, wc, g = _int_operands(2 * n + stride, windows, n, hidden, c, stride, pads)
    w_pad = torch.cat([wc, torch.zeros(32, c, dtype=wc.dtype)], dim=0)  # rows past 3·hidden
    w_pad = torch.cat([w_pad, torch.zeros(w_pad.shape[0], 32, dtype=wc.dtype)], dim=1)
    dh1 = torch.full_like(h1, float("nan"))
    seen = torch.zeros(h1.shape[:2], dtype=torch.int64)
    tiles = list(dh1_tiles(windows, n, hidden, c, stride, pads))
    assert len(tiles) == min(stride, n) * -(-windows // wpt) * chunks
    for rho, t0, b0, stages in tiles:
        acc = torch.zeros(rb * wpt, hidden + 32, dtype=torch.float64)
        for j, c0, (col, row, win) in stages:
            box = tma_box(g, col, row, win, rb, wpt)
            acc += box @ w_pad[j * hidden: j * hidden + hidden + 32, c0: c0 + 32].t()
        phase_h1, phase_out = h1[:, rho::stride], dh1[:, rho::stride]
        for q in range(-(-hidden // 32)):
            mask = tma_box(phase_h1, 32 * q, t0, b0, rb, wpt)
            vals = torch.where(mask > 0, acc[:, 32 * q: 32 * q + 32], 0.0)
            tma_box_store(phase_out, vals, 32 * q, t0, b0, rb, wpt)
        rows = torch.arange(rho + stride * t0, n, stride)[:rb]
        seen[b0: b0 + wpt, rows] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    assert torch.equal(dh1, conv_dh1_plain(g, wc, h1, stride=stride, paddings=pads))


@pytest.mark.parametrize("k", [3 * 768, 384, 2 * 384])
def test_native_bf16_emulation_meets_the_rung_bar(k):
    """The conv's native bf16 instances (`strided_conv_bf16` over K = 3·768,
    `strided_dh1_bf16` over C = 384 a tap, 2 · 384 where two taps reach a
    row at s0 = 2): exact bf16 products, two k16 products a 32-deep stage
    summed by the tensor cores into a fresh partial (rounding toward zero),
    the partials added in fp32 stage by stage. That meets the bf16 rung's
    float64-sum bar against the plain version on the rounded operands; over
    the forward's K = 2,304 one running sum misses it."""
    rng = np.random.default_rng(k)
    a = _bf16(np.maximum(rng.normal(size=(16, k)), 0).astype(np.float32))
    b = _bf16((rng.normal(size=(k, 16)) * 0.05).astype(np.float32))
    rung64 = a.astype(np.float64) @ b.astype(np.float64)
    plain = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy().astype(np.float64)
    ok, err, err_plain = _rung_bar(_emulate_bf16(a, b, k, 2).astype(np.float64), plain, rung64)
    assert ok, (err, err_plain)
    if k == 3 * 768:
        assert not _rung_bar(_emulate_bf16(a, b, k, None).astype(np.float64), plain,
                             rung64)[0]


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
    (5, 27, 128, 256, 2, (0, 0)),    # taps overlap (s0 < 3): two taps in a row's sum
    (7, 41, 128, 256, 4, (1, 1)),    # h36m_81's padded geometry
    (3, 300, 128, 256, 2, (1, 1)),   # dH1: a window's phase rows in two tiles
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


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("windows", [1, 33, 511])
@pytest.mark.parametrize("stride,pads,hidden", [(3, (0, 0), 768), (2, (0, 0), 768),
                                                (4, (1, 1), 768), (1, (1, 1), 768),
                                                (3, (0, 0), 100)])
def test_dwc_matches_plain(stride, pads, hidden, windows, bf16):
    """dWc (`strided_dwc_f32` / `strided_dwc_bf16`: gemm_atb_kernel with the
    taps gathered from h1, a run of a row per tap) at strides 3, 2, 4 and 1,
    paddings (0, 0) and (1, 1), odd window counts, and a tap width (100)
    that splits a 128-column tile: 3xTF32 to the grad bar and float64, bf16
    to the training rungs' float64-sum bar on the rounded operands; one launch a
    call, bit-identical on repeat."""
    n, c = 71, 384
    h1, _, g, _ = _card_operands(windows, n, c, hidden, stride, pads)
    kw = dict(stride=stride, paddings=pads)
    rung = "default" if bf16 else "high"
    entry = "strided_dwc_bf16" if bf16 else "strided_dwc_f32"
    cuda_lib.reset_launches()
    got = conv_dwc(h1, g, torch.empty(3 * hidden, c, device=h1.device), precision=rung,
                   **kw).clone()
    again = conv_dwc(h1, g, torch.empty(3 * hidden, c, device=h1.device), precision=rung, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[entry] == 2 and torch.equal(got, again)
    plain = conv_dwc_plain(h1, g, precision=rung, **kw)
    if bf16:
        rung64 = conv_dwc_plain(h1.double(), g.double(), precision=rung, **kw)
        ok, err, err_plain = _rung_bar(got.double().cpu().numpy(),
                                       plain.double().cpu().numpy(), rung64.cpu().numpy())
        assert ok, (err, err_plain)
        return
    assert _grad_close(got, plain)
    ok, err, err_plain = _f64(got, plain, conv_dwc_plain(h1.double(), g.double(), **kw))
    assert ok, (err, err_plain)


def _bf16_card_operands(b, n, c, hidden, stride, pads):
    h1, x, g, ops = _card_operands(b, n, c, hidden, stride, pads)
    return h1, x, g, add_strided_bf16_planes(dict(wc=ops["wc"], bc=ops["bc"]), dx=True)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,hidden,stride,pads", CARD)
def test_conv_bf16_matches_plain(b, n, c, hidden, stride, pads):
    """The native bf16 instances (`strided_conv_bf16`, `strided_dh1_bf16`:
    Wc's torch.bfloat16 planes, one launch each) against the plain version
    on the rounded operands by the bf16 rung's float64-sum bar, bit-identical
    on repeat."""
    h1, x, g, ops = _bf16_card_operands(b, n, c, hidden, stride, pads)
    assert ops["wc_bf"].dtype == ops["wc_bf_dx"].dtype == torch.bfloat16
    kw = dict(stride=stride, paddings=pads, precision="default")
    cuda_lib.reset_launches()
    fwd = [strided_conv(h1, x, ops, counter="test", **kw) for _ in range(2)]
    dh1 = [conv_dh1(g, ops, h1, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["strided_conv_bf16"] == 2
    assert cuda_lib.LAUNCHES["strided_dh1_bf16"] == 2
    assert torch.equal(*fwd) and torch.equal(*dh1)
    wc, bc = ops["wc"], ops["bc"]
    for got, plain, rung64 in (
            (fwd[0], strided_conv_plain(h1, x, wc, bc, **kw),
             strided_conv_plain(h1.double(), x.double(), wc.double(), bc.double(), **kw)),
            (dh1[0], conv_dh1_plain(g, wc, h1, **kw),
             conv_dh1_plain(g.double(), wc.double(), h1.double(), **kw))):
        ok, err, err_plain = _rung_bar(got.double().cpu().numpy(),
                                       plain.double().cpu().numpy(), rung64.cpu().numpy())
        assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_conv_digests(bf16):
    """The conv's and dH1's cases of `tools/gemm_digests.py` (h36m_351's and
    h36m_81's conv, dH1 at s0 3 and 2) give `GEMM_DIGESTS`' bits, twice."""
    _card()
    from uplift_upsample_torch.tools import gemm_digests
    libs = gemm_digests.port_libs()
    for case in gemm_digests.cases(0, bf16, torch.device("cuda")):
        if case.lib not in ("strided", "strided_bwd"):
            continue
        first, again = gemm_digests.digest(libs, case), gemm_digests.digest(libs, case)
        assert first == again == gemm_digests.GEMM_DIGESTS[case.name], case.name
