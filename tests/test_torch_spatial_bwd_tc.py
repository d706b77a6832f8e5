"""K4 on the tensor cores (`csrc/spatial_bwd.cu`).

K4 walks tiles of 7 frames (119 token rows, padded to 128: eight m16 tiles,
one per warp), each thread block its own tiles (tile i on block i mod the
grid), block-major: the forward replay block by block over the block's
tiles, then the backward block by block, last to first, with each block's
weights staged once per pass and the tiles' checkpoints, contexts and
residual gradients in a scratch buffer. Every dense product runs on
mma.sync in 3xTF32: x·W and dY·Wᵀ with the warp's 16 rows as M, dW = Xᵀ·dY
with the tile's rows as K, each tile's dW partial added in tile order into
the block's dW (in shared memory on the bf16 rung, in the thread block's
gradient row in 3xTF32); the rows are summed in a fixed order.

CPU tests: a float64 model of the two products' fragment bookkeeping (the
kernel's index arithmetic on m16n8k8 lane fragments, dW's rows permuted in
each 8-row step) against plain products; the deal of dW's output tiles to
the warps; float64 emulations of dW's sums over one thread block's tiles at
the train step's depth (25,600 frames on 132 blocks), a fresh partial per
8-row step and per tile against one running sum, in 3xTF32 held to the
float64 criterion and on the bf16 rung to the training rungs' bar; a mirror
of the block-major walk (every tile and frame once per pass, a static
assignment, scratch offsets in range) at 25,600, 1,031, 7 and 1 frames; and
the kernel's partition of the frames (tiles of 7, the tail tile at F =
1,031, tiles dealt to the blocks in turn, per-block rows summed in order)
run with the plain version per tile, against the plain version on all
frames.

`gpu` tests: K4 at the train step's 25,600 frames (C = 32) and at 1,031
(C = 32, 16) against its plain version (grad bar), float64 and itself (bit
for bit); at "default", the activations its replay keeps against K1's bf16
forward, bit for bit. JAX is not imported here, so the file also runs on
the card's machine:

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
    from tests.test_torch_gemm_tc import (_bf16, _emulate_3xtf32, _f64_ok, _round_toward_zero,
                                          _rung_bar)
    from tests.test_torch_kernels import _spatial_tree, _state
except ImportError:  # pragma: no cover
    from test_torch_attention_bwd_tc import _G, _T, _mma
    from test_torch_gemm_tc import (_bf16, _emulate_3xtf32, _f64_ok, _round_toward_zero,
                                    _rung_bar)
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


@pytest.mark.parametrize("cin,n", [(32, 96), (32, 32), (32, 64), (64, 32), (16, 48), (16, 16),
                                   (16, 32), (32, 16)])
def test_k4_dw_tiles_dealt_once(cin, n):
    """tile_dw's deal of dW's (m16, n8) output tiles to K4's 16 warps (NT =
    ceil(tiles / 16) side by side to a warp, within one m16 tile), for K4's
    four dW shapes at C = 32 and 16: every tile on exactly one warp, and the
    bias added by the warps of the first m16 tile, once per column."""
    n8, warps = n // 8, 2 * PADDED // 16
    tiles = cin // 16 * n8
    nt = -(-tiles // warps)
    assert n8 % nt == 0
    seen, bias_cols = [], []
    for warp in range(warps):
        first = warp * nt
        if first >= tiles:
            continue
        assert first % n8 + nt <= n8  # one m16 tile
        seen += [(first // n8, first % n8 + u) for u in range(nt)]
        if first < n8:
            bias_cols += [8 * (first % n8 + u) + c for u in range(nt) for c in range(8)]
    assert sorted(seen) == [(m, j) for m in range(cin // 16) for j in range(n8)]
    assert sorted(bias_cols) == list(range(n))


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


def _emulate_k4_dw_bf16(x_t, dy, tile_rows, per_tile):
    """x_t (CIN, rows) · dy (rows, N) as K4's bf16 dW sums it over a thread
    block's tiles: each 8-row step one TF32 product of the bf16-rounded
    operands (exact) into a fresh partial, rounded toward zero as the tensor
    cores add; the step's partial joins the tile's fp32 sum (per_tile) or
    the partial runs on over every row of the tiles (per_tile False: one
    running sum in the tensor cores); the tiles' sums added in tile order."""
    a, b = x_t.astype(np.float64), dy.astype(np.float64)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = np.zeros_like(total)
    for t0 in range(0, a.shape[1], tile_rows):
        acc = np.zeros_like(total)
        for s in range(t0, min(a.shape[1], t0 + tile_rows), 8):
            sl = slice(s, min(s + 8, t0 + tile_rows))
            part = _round_toward_zero(part + a[:, sl] @ b[sl])
            if per_tile:
                acc, part = acc + part, np.zeros_like(total)
        if per_tile:
            total = total + acc
    return total if per_tile else part


@pytest.mark.parametrize("cin,n", [(32, 96), (64, 32)])
def test_k4_dw_bf16_emulation_meets_rung_bar(cin, n):
    """The bf16 rung's dW of q|k|v and of fc2 over one thread block's tiles
    at the train step (28 tiles of 119 rows), dY scaled per frame at keep
    0.9 before its rounding: a fresh partial per 8-row step, added into the
    tile's fp32 sum and the tiles' sums in order, meets the training rungs'
    bar against the rung with float64 sums (mean within 2x the fp32 plain
    version's distance, largest within 4x); one running sum over the
    block's rows misses it."""
    rng = np.random.default_rng(cin * n)
    tiles = -(-(25600 // TF) // SMS)
    rows = tiles * ROWS
    x_t = _bf16(np.abs(rng.normal(size=(cin, rows))))  # gelu's and LayerNorm's outputs
    keep = rng.uniform(size=rows // 17) < 0.9
    scale = np.repeat(np.where(keep, 1 / 0.9, 0.0), 17).astype(np.float32)
    dy = _bf16((rng.normal(size=(rows, n)) + 0.5).astype(np.float32) * scale[:, None])
    rung64 = x_t.astype(np.float64) @ dy.astype(np.float64)
    plain = (torch.from_numpy(x_t) @ torch.from_numpy(dy)).numpy().astype(np.float64)
    got = _emulate_k4_dw_bf16(x_t, dy, ROWS, True).astype(np.float64)
    ok, mean, mean_plain = _rung_bar(got, plain, rung64)
    assert ok, (mean, mean_plain)
    one_sum = _emulate_k4_dw_bf16(x_t, dy, ROWS, False).astype(np.float64)
    assert not _rung_bar(one_sum, plain, rung64)[0]


def _k4_walk(frames, sms=SMS, blocks=4, c=32):
    """A mirror of spatial_bwd.cu's walk: the thread blocks (min(SMs,
    tiles)), each block's tiles (blockIdx.x, + gridDim.x, ...), the passes
    (the replay's blocks 0..L-1, then the backward's L-1..0) and, per tile,
    the scratch slices the kernel reads and writes (2L + 1 of 128 x c per
    tile of the block's, spatial_bwd_scratch_floats). Returns (workers,
    per-worker floats, [(worker, pass, tile, frames, slice offsets)])."""
    tiles = -(-frames // TF)
    workers = min(sms, tiles)
    per, slots = -(-tiles // workers), 2 * blocks + 1
    floats = per * slots * PADDED * c
    visits = []
    passes = [("replay", b) for b in range(blocks)] + [("backward", b)
                                                       for b in reversed(range(blocks))]
    for w in range(workers):
        mine = (tiles - w + workers - 1) // workers
        base = w * floats
        for kind, b in passes:
            for j in range(mine):
                tile = w + j * workers
                f0 = tile * TF
                nf = min(TF, frames - f0)
                if kind == "replay":  # reads X_b (b > 0), writes ctx_b, X_{b+1} or dY
                    used = [b] * (b > 0) + [blocks + b, b + 1 if b < blocks - 1 else 2 * blocks]
                    used += [0] * (b == 0)
                else:  # reads X_b, ctx_b and dY, writes dY (b > 0)
                    used = [b, blocks + b, 2 * blocks]
                offs = [base + (j * slots + s) * PADDED * c for s in used]
                visits.append((w, (kind, b), tile, range(f0, f0 + nf), offs))
    return workers, floats, visits


@pytest.mark.parametrize("frames", [25600, 1031, 7, 1])
def test_k4_walk_covers_every_tile_once(frames):
    """The block-major walk: in every pass each tile on exactly one thread
    block and every frame in exactly one tile; the assignment static (tile i
    on block i mod workers, the same in every pass); each slice the walk
    touches inside its block's part of the scratch, and distinct tiles'
    slices apart."""
    c, blocks = 32, 4
    workers, floats, visits = _k4_walk(frames, blocks=blocks, c=c)
    tiles = -(-frames // TF)
    assert workers == min(SMS, tiles)
    by_pass = {}
    for w, kind, tile, fr, offs in visits:
        assert tile % workers == w  # static: the same owner in every pass
        by_pass.setdefault(kind, []).append((tile, fr))
        for off in offs:
            assert w * floats <= off and off + PADDED * c <= (w + 1) * floats
    assert len(by_pass) == 2 * blocks
    for kind, seen in by_pass.items():
        assert sorted(t for t, _ in seen) == list(range(tiles)), kind
        covered = sorted(f for _, fr in seen for f in fr)
        assert covered == list(range(frames)), kind
    # a slice belongs to one tile of one block: (tile, slot) -> offset is one to one
    owners = {}
    for w, kind, tile, fr, offs in visits:
        for off in offs:
            assert owners.setdefault(off, tile) == tile
    assert floats < 2 ** 31  # spatial_bwd_scratch_floats returns it as a C int


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


@pytest.mark.gpu
@pytest.mark.parametrize("f,c,heads", [(1031, 32, 8), (1031, 16, 4)])
def test_k4_replay_equals_k1_bf16(f, c, heads):
    """At "default" the activations K4's replay keeps, each block's input
    X_b in its scratch, are K1's bf16 forward bit for bit. Like with like:
    K1 over the first b blocks returns its final LayerNorm of its own X_b;
    K1 over no block, with the embedding's weights 0 and one frame of K4's
    X_b as the position embedding, returns the same LayerNorm, by the same
    code, of K4's X_b (the sums before it add zeros exactly). b = 1, 2, 3
    (X_4 is not kept: K4 replaces it by the residual gradient)."""
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.spatial import pack_spatial_params, spatial_stack

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    ops, x, scales, g, heads = _spatial_case(13, f, c, heads, 4)
    ops = {k: v.to(dev) for k, v in ops.items()}
    x, scales, g = x.to(dev), scales.to(dev), g.to(dev)
    lib = cuda_lib.library("spatial_bwd")
    workers = lib.spatial_bwd_workers(c, 4, 4, f)
    floats = lib.spatial_bwd_scratch_floats(c, 4, f, workers)
    packed = pack_spatial_params(ops)
    scratch = torch.full((workers, floats), float("nan"), device=dev)
    partial = torch.empty((workers, packed.numel()), device=dev)
    dx, ddp = torch.empty_like(x), torch.empty((8, f), device=dev)
    cuda_lib.launch("spatial_bwd", "spatial_bwd_bf16", None, x, g, scales, packed, dx, ddp,
                    partial, scratch, f, c, 4, 4, workers)
    tiles = -(-f // TF)
    per = -(-tiles // workers)
    slices = scratch.view(workers, per, 9, PADDED, c)
    blockwise = PARAM_ORDER[3:-2]
    ln_only = {k: (v[:0] if k in blockwise else torch.zeros_like(v)) for k, v in ops.items()}
    ln_only["norm_g"], ln_only["norm_b"] = ops["norm_g"], ops["norm_b"]
    for b in (1, 2, 3):
        xb = torch.cat([slices[t % workers, t // workers, b, :min(TF, f - t * TF) * 17]
                        for t in range(tiles)]).reshape(f, 17, c)
        cut = {k: v[:b] if k in blockwise else v for k, v in ops.items()}
        k1 = spatial_stack(x, cut, num_heads=heads, droppath_scales=scales[:2 * b].contiguous(),
                           precision="default")
        want = torch.cat([spatial_stack(x[i:i + 1], {**ln_only, "pe": xb[i]}, num_heads=heads,
                                        precision="default") for i in range(f)])
        gap = (k1 - want).abs()
        assert torch.equal(k1, want), (b, float(gap.max()), float((gap > 0).float().mean()))
