"""K4 on the tensor cores (`csrc/spatial_bwd.cu`).

K4 walks tiles of 7 frames (119 token rows, padded to 128: eight m16 tiles,
one per warp) and runs every dense product of the forward replay, the block
recompute and the backward on mma.sync in 3xTF32: x·W and dY·Wᵀ with the
warp's 16 rows as M, dW = Xᵀ·dY with the tile's rows as K. Each tile's dW
partial is added into the thread block's own gradient row; the rows are
summed in a fixed order.

CPU tests: a float64 model of the two products' fragment bookkeeping (the
kernel's index arithmetic on m16n8k8 lane fragments, dW's rows permuted in
each 8-row step) against plain products; a float64 emulation of dW's 3xTF32
sums over one thread block's rows at the train step's depth (25,600 frames
on 132 blocks), a fresh partial per 8-row step and per tile against one
running sum, held to the float64 criterion; and the kernel's partition of
the frames (tiles of 7, the tail tile at F = 1,031, tiles dealt to the
blocks in turn, per-block rows summed in order) run with the plain version
per tile, against the plain version on all frames.

`gpu` tests: K4 at the train step's 25,600 frames (C = 32) and at 1,031
(C = 32, 16) against its plain version (grad bar), float64 and itself (bit
for bit). JAX is not imported here, so the file also runs on the card's
machine:

    python -m pytest --noconftest -m gpu tests/test_torch_spatial_bwd_tc.py
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops.spatial import (PARAM_ORDER, make_droppath_scales,
                                               stack_spatial_params)
from uplift_upsample_torch.ops.spatial_bwd import spatial_stack_bwd, spatial_stack_bwd_plain

try:  # the card's machine collects tests/ without the package's conftest
    from tests.test_torch_attention_bwd_tc import _G, _T, _mma
    from tests.test_torch_gemm_tc import _emulate_3xtf32, _f64_ok
    from tests.test_torch_kernels import _spatial_tree, _state
except ImportError:  # pragma: no cover
    from test_torch_attention_bwd_tc import _G, _T, _mma
    from test_torch_gemm_tc import _emulate_3xtf32, _f64_ok
    from test_torch_kernels import _spatial_tree, _state

TF, ROWS, PADDED = 7, 7 * 17, 128  # frames per tile, their rows, padded to 8 x 16
SMS = 132


def _rows_gemm_model(a, w):
    """a (128, K) · w (K, N) as rows_gemm (csrc/spatial_common.cuh) takes it:
    warp w's rows 16w.., A at rows g, g+8 and columns t, t+4 of each 8-deep
    step, B (w) at rows t, t+4 and column g of each 8-column tile."""
    k, n = w.shape
    out = np.full((PADDED, n), np.nan)
    g, t = _G, _T
    for warp in range(PADDED // 16):
        r0, r1 = 16 * warp + g, 16 * warp + g + 8
        acc = np.zeros((n // 8, 4, 32))
        for kk in range(k // 8):
            af = (a[r0, 8 * kk + t], a[r1, 8 * kk + t], a[r0, 8 * kk + t + 4],
                  a[r1, 8 * kk + t + 4])
            for j in range(n // 8):
                acc[j] = _mma(acc[j], af, (w[8 * kk + t, 8 * j + g], w[8 * kk + t + 4, 8 * j + g]))
        for j in range(n // 8):
            c = 8 * j + 2 * t
            out[r0, c], out[r0, c + 1], out[r1, c], out[r1, c + 1] = acc[j]
    return out


def _tile_dw_model(x, dy, f):
    """Xᵀ·(f ⊙ dY) over the tile's 128 rows as tile_dw takes it: output
    tiles (m16 of X's columns, n8 of dY's), each 8-row step's rows permuted
    (A column t <-> row 2t, t+4 <-> 2t+1, the same rows of dY)."""
    cin, n = x.shape[1], dy.shape[1]
    out = np.full((cin, n), np.nan)
    g, t = _G, _T
    for tile in range(cin // 16 * (n // 8)):
        i0, o0 = 16 * (tile // (n // 8)) + g, 8 * (tile % (n // 8)) + g
        acc = np.zeros((4, 32))
        for s in range(PADDED // 8):
            ra, rb = 8 * s + 2 * t, 8 * s + 2 * t + 1
            acc = _mma(acc, (x[ra, i0], x[ra, i0 + 8], x[rb, i0], x[rb, i0 + 8]),
                       (dy[ra, o0] * f[ra], dy[rb, o0] * f[rb]))
        i, o = i0, o0 - g + 2 * t
        out[i, o], out[i, o + 1], out[i + 8, o], out[i + 8, o + 1] = acc
    return out


@pytest.mark.parametrize("k,n", [(32, 96), (32, 64), (64, 32), (96, 32), (16, 48)])
def test_k4_fragment_model_gives_the_products(k, n):
    """The lane-fragment bookkeeping of K4's two products, in float64 with
    exact products: rows_gemm gives a·w on every row, tile_dw gives
    Xᵀ·(f ⊙ dY) (padded rows carry f = 0); every output element written once."""
    rng = np.random.default_rng(k * n)
    a, w = rng.normal(size=(PADDED, k)), rng.normal(size=(k, n))
    np.testing.assert_allclose(_rows_gemm_model(a, w), a @ w, rtol=1e-12, atol=1e-12)
    f = np.where(np.arange(PADDED) < ROWS, rng.uniform(0.5, 1.5, size=PADDED), 0.0)
    dy = rng.normal(size=(PADDED, n))
    np.testing.assert_allclose(_tile_dw_model(a, dy, f), a.T @ (dy * f[:, None]),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cin,n", [(32, 96), (64, 32)])
def test_k4_dw_emulation_meets_float64_criterion(cin, n):
    """dW of q|k|v (32 x 96) and of fc2 (64 x 32) over the rows one thread
    block takes at the train step (25,600 frames in tiles of 7 on 132 blocks:
    28 tiles of 119 rows), dY scaled per frame at keep 0.9: with a fresh
    partial per 8-row step and per tile, added into the block's row in fp32,
    the kernel's error against float64 is at most 4x the fp32 plain
    version's plus 1e-6 of the scale; one running sum over the block's rows
    (the tensor cores round toward zero at every add) misses it."""
    rng = np.random.default_rng(cin + n)
    tiles = -(-(25600 // TF) // SMS)
    rows = tiles * ROWS
    x_t = rng.normal(size=(cin, rows)).astype(np.float32)
    keep = rng.uniform(size=rows // 17) < 0.9
    scale = np.repeat(np.where(keep, 1 / 0.9, 0.0), 17).astype(np.float32)
    dy = (rng.normal(size=(rows, n)) * scale[:, None]).astype(np.float32)
    ref64 = x_t.astype(np.float64) @ dy.astype(np.float64)
    plain = (torch.from_numpy(x_t) @ torch.from_numpy(dy)).numpy().astype(np.float64)
    got = _emulate_3xtf32(x_t, dy, ROWS, 1).astype(np.float64)
    ok, err, err_plain = _f64_ok(got, plain, ref64)
    assert ok, (err, err_plain)
    one_sum = _emulate_3xtf32(x_t, dy, rows, None).astype(np.float64)
    assert not _f64_ok(one_sum, plain, ref64)[0]


def _spatial_case(seed, f, c, heads, blocks):
    rng = np.random.default_rng(seed)
    ops = stack_spatial_params(_state(_spatial_tree(rng, c, blocks)), blocks)
    x = torch.from_numpy((rng.normal(size=(f, 17, 2)) * 0.5).astype(np.float32))
    gen = torch.Generator().manual_seed(seed)
    scales = make_droppath_scales(gen, [0.1 * i for i in range(blocks)], f).float()
    g = torch.from_numpy(rng.normal(size=(f, 17 * c)).astype(np.float32))
    return ops, x, scales, g, heads


def _grad_ok(got, ref, zero_at=None):
    if zero_at is not None:  # the key bias: its true gradient is 0, both sides noise
        bar = 2e-4 * max(float(zero_at.abs().max()), 1e-3)
        return float(got.abs().max()) <= bar and float(ref.abs().max()) <= bar
    scale = max(float(ref.abs().max()), 1e-3)
    return bool(((got - ref).abs() <= 2e-4 * scale + 2e-3 * ref.abs()).all())


def test_k4_tile_partition_matches_plain():
    """The kernel's partition at F = 1,031: tiles of 7 frames (the last of
    2), tile i on thread block i mod min(132, tiles), each block's row the
    sum of its tiles in order, the rows summed in block order; with the
    plain version on each tile it gives the plain version's gradients on
    all frames (the grad bar), and dx and dscales frame by frame."""
    f, c, heads, blocks = 1031, 16, 4, 2
    ops, x, scales, g, heads = _spatial_case(5, f, c, heads, blocks)
    tiles = -(-f // TF)
    grid = min(SMS, tiles)
    assert tiles == 148 and f - (tiles - 1) * TF == 2
    rows = [None] * grid
    dx = torch.empty_like(x)
    ddp = torch.empty_like(scales)
    for tile in range(tiles):
        sl = slice(tile * TF, min(f, (tile + 1) * TF))
        dp, dxt, ddt = spatial_stack_bwd_plain(x[sl], ops, scales[:, sl], g[sl],
                                               num_heads=heads)
        b = tile % grid
        rows[b] = dp if rows[b] is None else {k: rows[b][k] + dp[k] for k in dp}
        dx[sl], ddp[:, sl] = dxt, ddt
    total = {k: sum(r[k] for r in rows[1:]) + rows[0][k] for k in PARAM_ORDER}
    want, want_dx, want_ddp = spatial_stack_bwd_plain(x, ops, scales, g, num_heads=heads)
    for name in PARAM_ORDER:
        zero_at = want["bq"] if name == "bk" else None
        assert _grad_ok(total[name], want[name], zero_at), name
    assert _grad_ok(dx, want_dx) and _grad_ok(ddp, want_ddp)


# -- gpu --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("f,c,heads", [(25600, 32, 8), (1031, 32, 8), (1031, 16, 4)])
def test_k4_kernel_matches_plain_and_float64(f, c, heads):
    """K4 at four blocks against its plain version (grad bar; the key bias's
    gradient, exactly 0, as noise), float64 (every leaf but the key bias,
    dx and dscales: at most 4x the plain version's error + 1e-6 of the
    scale) and a second call (bit for bit); two launches a call."""
    from uplift_upsample_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    ops, x, scales, g, heads = _spatial_case(7, f, c, heads, 4)
    ops = {k: v.to(dev) for k, v in ops.items()}
    x, scales, g = x.to(dev), scales.to(dev), g.to(dev)
    cuda_lib.reset_launches()
    got = spatial_stack_bwd(x, ops, scales, g, num_heads=heads)
    again = spatial_stack_bwd(x, ops, scales, g, num_heads=heads)
    assert cuda_lib.LAUNCHES["spatial_bwd"] == 4
    want = spatial_stack_bwd_plain(x, ops, scales, g, num_heads=heads)
    want64 = spatial_stack_bwd_plain(x.double(), {k: v.double() for k, v in ops.items()},
                                     scales.double(), g.double(), num_heads=heads)
    torch.cuda.synchronize()
    (dp, dx, ddp), (dp2, dx2, ddp2) = got, again
    assert all(torch.equal(dp[k], dp2[k]) for k in PARAM_ORDER)
    assert torch.equal(dx, dx2) and torch.equal(ddp, ddp2)
    (wp, wdx, wddp), (wp64, wdx64, wddp64) = want, want64
    for name in PARAM_ORDER:
        assert _grad_ok(dp[name], wp[name], wp["bq"] if name == "bk" else None), name
    assert _grad_ok(dx, wdx) and _grad_ok(ddp, wddp)
    pairs = [(dp[k], wp[k], wp64[k]) for k in PARAM_ORDER if k != "bk"]
    for name, (a, b, ref) in zip([k for k in PARAM_ORDER if k != "bk"] + ["dx", "ddp"],
                                 pairs + [(dx, wdx, wdx64), (ddp, wddp, wddp64)]):
        ok, err, err_plain = _f64_ok(a.double().cpu().numpy(), b.double().cpu().numpy(),
                                     ref.cpu().numpy())
        assert ok, (name, err, err_plain)
