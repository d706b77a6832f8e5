"""The attention kernels on native bf16 mma.sync: row 11 on bf16 tensors
(`csrc/attention.cuh`'s head_attention_bf16_kernel, `csrc/attention_bf16.cu`'s
packed_attention_bf16io and packed_attention_bf16io_bf16) and the
window-attention backward (`csrc/temporal_bwd.cu`, both rungs).

GPU-only helpers live here with the gpu tests; the CPU tests are below them.
JAX is not imported, so the file also runs on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_attention_native.py
"""

import hashlib
import math

import numpy as np
import pytest
import torch

# sha256 (first 16 hex digits) of the fp32-tensor attention kernels'
# outputs at `fp32_attention_digests`' inputs, taken from the build before
# row 11's bf16-tensor instances left head_attention_tc_kernel (NVIDIA H100
# 80GB HBM3, nvcc 12.9, sm_90a): K2's window attention at both rungs, folded
# and not, K5's training forward at the bf16 rung, and row 11 on fp32
# tensors at both rungs. The fp32-tensor instances compile from unchanged
# code, so their bits stay.
FP32_ATTENTION_DIGESTS = {
    "k2 high": "5d993654292f0dbe", "k2 high folded": "e3a2216becb2fe79",
    "k2 default": "95372ced4f5d9a66", "k2 default folded": "6e91532d024475ae",
    "k5 train default": "98e07c3a68b53f79", "row11 fp32 high": "5d993654292f0dbe",
    "row11 fp32 default": "95372ced4f5d9a66"}


def fp32_attention_digests():
    """{case: digest} of the fp32-tensor instances of the attention kernel on
    seeded inputs (64 windows x 71 tokens x 384, 8 heads, a key mask)."""
    from uplift_upsample_torch.ops.packed_attention import packed_multihead_attention
    from uplift_upsample_torch.ops.temporal import window_attention
    from uplift_upsample_torch.ops.temporal_train import window_attention_train

    rng = np.random.default_rng(24)
    b, n, c, heads = 64, 71, 384, 8
    qkv = torch.from_numpy((rng.normal(size=(b * n, 3 * c)) * 0.5).astype(np.float32)).cuda()
    km = torch.from_numpy((rng.uniform(size=(b, n)) < 0.4).astype(np.float32)).cuda()
    kw = dict(windows=b, n=n, num_heads=heads, counter=None)
    q, k, v = (t.reshape(b, n, c).contiguous() for t in qkv.split(c, dim=-1))
    outs = {
        "k2 high": window_attention(qkv, km, precision="high", **kw),
        "k2 high folded": window_attention(qkv, None, precision="high", q_folded=True, **kw),
        "k2 default": window_attention(qkv, km, precision="default", **kw),
        "k2 default folded": window_attention(qkv, km, precision="default", q_folded=True,
                                              **kw),
        "k5 train default": window_attention_train(qkv, km, precision="default", **kw),
        "row11 fp32 high": packed_multihead_attention(q, k, v, km, num_heads=heads),
        "row11 fp32 default": packed_multihead_attention(q, k, v, km, num_heads=heads,
                                                         precision="default"),
    }
    torch.cuda.synchronize()
    return {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
            for name, t in outs.items()}


try:  # the card's machine collects tests/ without the package's conftest
    from tests.test_torch_gemm_tc import _bf16, _f64_ok, _round_toward_zero
except ImportError:  # pragma: no cover
    from test_torch_gemm_tc import _bf16, _f64_ok, _round_toward_zero

LOG2E = 1.4426950408889634
F32 = np.float32

# -- fragment models ----------------------------------------------------------
# Lane l of a warp: (g, t) = (l / 4, l % 4) in the mma.sync fragments; ldmatrix
# and stmatrix take the address of row l % 8 of matrix l / 8 from lane l.
_L = np.arange(32)
_G, _T, _LR, _LM = _L >> 2, _L & 3, _L & 7, _L >> 3


def _ldmatrix(tile, addr, trans=False):
    """ldmatrix.x4 from a flat tile: addr[l] is lane l's element offset.
    (4, 2, 32): matrix m's pair (low, high) lane (g, t) receives: row g,
    columns 2t, 2t+1; transposed, rows 2t, 2t+1 of column g."""
    out = np.zeros((4, 2, 32))
    for m in range(4):
        rows = addr[8 * m: 8 * m + 8]
        if trans:
            out[m, 0], out[m, 1] = tile[rows[2 * _T] + _G], tile[rows[2 * _T + 1] + _G]
        else:
            out[m, 0], out[m, 1] = tile[rows[_G] + 2 * _T], tile[rows[_G] + 2 * _T + 1]
    return out


def _stmatrix_trans(tile, addr, regs):
    """stmatrix.x4.trans: regs (4, 2, 32) as `_ldmatrix` returns them; the row
    lane 8m + r addresses receives column r of matrix m."""
    for m in range(4):
        for r in range(8):
            tile[addr[8 * m + r] + np.arange(8)] = regs[m, r % 2, 4 * np.arange(8) + r // 2]


def _mma16(acc, a, b0, b1):
    """acc (4, 32) + A·B for mma.sync.m16n8k16 in float64: a (4, 2, 32), the
    pairs of rows g | g+8 of columns 2t.., then of columns 8+2t..; b0, b1
    (2, 32): rows 2t.. | 8+2t.. of column g; acc rows g, g+8 of columns 2t,
    2t+1."""
    am, bm = np.zeros((16, 16)), np.zeros((16, 8))
    for h in range(2):
        am[_G, 2 * _T + h], am[_G + 8, 2 * _T + h] = a[0, h], a[1, h]
        am[_G, 8 + 2 * _T + h], am[_G + 8, 8 + 2 * _T + h] = a[2, h], a[3, h]
        bm[2 * _T + h, _G], bm[8 + 2 * _T + h, _G] = b0[h], b1[h]
    cm = am @ bm
    return acc + np.stack([cm[_G, 2 * _T], cm[_G, 2 * _T + 1], cm[_G + 8, 2 * _T],
                           cm[_G + 8, 2 * _T + 1]])


def _pairs(x, y):
    """The A fragment of one 16-key step from two 8-key accumulators."""
    return np.stack([x[0:2], x[2:4], y[0:2], y[2:4]])


def _softmax_rows(s, mk, scale, nt):
    """In place: s (nt, 4, 32) logits → P, the kernels' register softmax in
    float64 (a row's keys in one quad)."""
    for j in range(nt):
        m0, m1 = mk[8 * j + 2 * _T], mk[8 * j + 2 * _T + 1]
        s[j] = s[j] * scale + np.stack([m0, m1, m0, m1])
    quad = lambda x, f: f(x.reshape(8, 4), axis=1).repeat(4)
    mx0, mx1 = quad(s[:, :2].max(axis=(0, 1)), np.max), quad(s[:, 2:].max(axis=(0, 1)), np.max)
    s[:, :2], s[:, 2:] = np.exp2(s[:, :2] - mx0), np.exp2(s[:, 2:] - mx1)
    s[:, :2] /= quad(s[:, :2].sum(axis=(0, 1)), np.sum)
    s[:, 2:] /= quad(s[:, 2:].sum(axis=(0, 1)), np.sum)


def _attention64(q, k, v, mask):
    s = q @ k.T / math.sqrt(q.shape[1]) + (0.0 if mask is None else mask)
    p = np.exp(s - s.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)) @ v


def _forward_model(q, k, v, mask):
    """One (sequence, head) through head_attention_bf16_kernel's index
    arithmetic in float64, with exact products: the staged tiles (pitch,
    padding), the ldmatrix addresses of q, k and v (transposed), the P
    fragments from S's accumulators, the staging tile and the copy-out."""
    n, d = q.shape
    dp, nk = -(-d // 16) * 16, -(-n // 16) * 16
    pb, nt = dp + 8, nk // 8

    def stage(x):
        flat = np.zeros(nk * pb)
        for r in range(n):
            flat[r * pb: r * pb + d] = x[r]
        return flat

    qs, ks, vs = stage(q), stage(k), stage(v)
    mk = np.full(nk, -np.inf)
    mk[:n] = 0.0 if mask is None else mask * LOG2E
    out = np.full((n, d), np.nan)
    for w in range(nk // 16):
        qa = (w * 16 + _LR + 8 * (_LM & 1)) * pb + 8 * (_LM >> 1)
        kb = (_LR + 8 * (_LM >> 1)) * pb + 8 * (_LM & 1)
        s = np.zeros((nt, 4, 32))
        for kk in range(dp // 16):
            a = _ldmatrix(qs, qa + 16 * kk)
            for j in range(0, nt, 2):
                b = _ldmatrix(ks, kb + 8 * j * pb + 16 * kk)
                s[j], s[j + 1] = _mma16(s[j], a, b[0], b[1]), _mma16(s[j + 1], a, b[2], b[3])
        _softmax_rows(s, mk, LOG2E / math.sqrt(d), nt)
        vb = (_LR + 8 * (_LM & 1)) * pb + 8 * (_LM >> 1)
        stage_tile = qs[w * 16 * pb:].copy()  # the warp's q rows
        for c0 in range(0, dp // 8, 2):
            o = np.zeros((2, 4, 32))
            for j in range(0, nt, 2):
                b = _ldmatrix(vs, vb + 8 * j * pb + 8 * c0, trans=True)
                a = _pairs(s[j], s[j + 1])
                o[0], o[1] = _mma16(o[0], a, b[0], b[1]), _mma16(o[1], a, b[2], b[3])
            for u in range(2):
                col = 8 * (c0 + u) + 2 * _T
                for e, (r, cl) in enumerate(((_G, col), (_G, col + 1), (_G + 8, col),
                                             (_G + 8, col + 1))):
                    stage_tile[r * pb + cl] = o[u][e]
        for r in range(16):
            if w * 16 + r < n:
                out[w * 16 + r] = stage_tile[r * pb: r * pb + d]
    return out


def _store_tile(out, row0, col0, o, f, n, d):
    """store_tile (temporal_bwd.cu), its 16-byte form: lanes t and t^1 trade
    a pair, even t writes row g's 4 columns, odd t row g+8's."""
    odd = (_T & 1).astype(bool)
    partner = _L ^ 1
    r0 = np.where(odd, o[0], o[2])[partner]
    r1 = np.where(odd, o[1], o[3])[partner]
    vals = np.where(odd, [r0, r1, o[2], o[3]], [o[0], o[1], r0, r1])
    row, col = row0 + _G + 8 * odd, col0 + 4 * (_T >> 1)
    for lane in range(32):
        if row[lane] < n and col[lane] < d:
            assert np.isnan(out[row[lane], col[lane]: col[lane] + 4]).all()  # one writer
            out[row[lane], col[lane]: col[lane] + 4] = vals[:, lane] * f


def _backward_model(q, k, v, do, mask):
    """One (window, head) through window_attention_bwd_bf16_kernel's index
    arithmetic in float64, exact products: q scaled once as staged, pass 1's
    ldmatrix fragments of S and dP, dq on dS's accumulators and k transposed,
    P^T and dS^T stored by stmatrix, pass 2's fragments of them and of q and
    dO transposed, every output through store_tile. Returns dq, dk, dv."""
    n, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dp, warps = -(-d // 16) * 16, -(-n // 16)
    pb, nq, nt = dp + 8, 16 * warps, -(-n // 8)
    pp = nq + 8

    def stage(x):
        flat = np.zeros(nq * pb)
        for r in range(n):
            flat[r * pb: r * pb + d] = x[r]
        return flat

    qs, gs, ks, vs = stage(q * scale), stage(do), stage(k), stage(v)
    mk = np.full(nq, -np.inf)
    mk[:n] = 0.0 if mask is None else mask * LOG2E
    dq, dk, dv = (np.full((n, d), np.nan) for _ in range(3))
    pt, dst = np.full(nq * pp, np.nan), np.full(nq * pp, np.nan)
    tiles = 2 * warps  # NT rounded up: the kernel's last pair may be half zeros

    def rows_dot(a_tile, b_tile, w):
        acc = np.zeros((tiles, 4, 32))
        pa = (w * 16 + _LR + 8 * (_LM & 1)) * pb + 8 * (_LM >> 1)
        pbk = (_LR + 8 * (_LM >> 1)) * pb + 8 * (_LM & 1)
        for kk in range(dp // 16):
            a = _ldmatrix(a_tile, pa + 16 * kk)
            for j in range(0, nt, 2):
                b = _ldmatrix(b_tile, pbk + 8 * j * pb + 16 * kk)
                acc[j], acc[j + 1] = _mma16(acc[j], a, b[0], b[1]), _mma16(acc[j + 1], a, b[2],
                                                                           b[3])
        return acc

    held = []
    for w in range(warps):  # pass 1
        s = rows_dot(qs, ks, w)
        _softmax_rows(s[:nt], mk, LOG2E, nt)  # the tile past the real keys stays 0
        dpm = rows_dot(gs, vs, w)
        rs0 = (s[:, :2] * dpm[:, :2]).sum(axis=(0, 1)).reshape(8, 4).sum(1).repeat(4)
        rs1 = (s[:, 2:] * dpm[:, 2:]).sum(axis=(0, 1)).reshape(8, 4).sum(1).repeat(4)
        ds = s.copy()
        ds[:, :2] *= dpm[:, :2] - rs0
        ds[:, 2:] *= dpm[:, 2:] - rs1
        kt = (_LR + 8 * (_LM & 1)) * pb + 8 * (_LM >> 1)
        for c0 in range(0, dp // 8, 2):
            o = np.zeros((2, 4, 32))
            for j in range(0, nt, 2):
                b = _ldmatrix(ks, kt + 8 * j * pb + 8 * c0, trans=True)
                a = _pairs(ds[j], ds[j + 1])
                o[0], o[1] = _mma16(o[0], a, b[0], b[1]), _mma16(o[1], a, b[2], b[3])
            for u in range(2):
                _store_tile(dq, w * 16, 8 * (c0 + u), o[u], scale, n, d)
        held.append((s, ds))
    for w, (s, ds) in enumerate(held):  # P^T and dS^T by stmatrix
        key, q0 = 8 * (_LM >> 1) + _LR, w * 16 + 8 * (_LM & 1)
        for j in range(0, tiles, 2):
            for tile, x in ((pt, s), (dst, ds)):
                _stmatrix_trans(tile, (8 * j + key) * pp + q0, _pairs(x[j], x[j + 1]))
    for w in range(warps):  # pass 2
        a_off = (w * 16 + _LR + 8 * (_LM & 1)) * pp + 8 * (_LM >> 1)
        b_off = (_LR + 8 * (_LM & 1)) * pb + 8 * (_LM >> 1)
        for c0 in range(0, dp // 8, 2):
            ok, ov = np.zeros((2, 4, 32)), np.zeros((2, 4, 32))
            for i in range(warps):
                ap, as_ = _ldmatrix(pt, a_off + 16 * i), _ldmatrix(dst, a_off + 16 * i)
                bq = _ldmatrix(qs, b_off + 16 * i * pb + 8 * c0, trans=True)
                bg = _ldmatrix(gs, b_off + 16 * i * pb + 8 * c0, trans=True)
                for u in range(2):
                    ok[u] = _mma16(ok[u], as_, bq[2 * u], bq[2 * u + 1])
                    ov[u] = _mma16(ov[u], ap, bg[2 * u], bg[2 * u + 1])
            for u in range(2):
                _store_tile(dk, w * 16, 8 * (c0 + u), ok[u], 1.0, n, d)
                _store_tile(dv, w * 16, 8 * (c0 + u), ov[u], 1.0, n, d)
    return dq, dk, dv


def _grads64(q, k, v, do, mask):
    """Float64 dq, dk, dv of one head; mask additive (n,) or None."""
    d = q.shape[1]
    scale = 1.0 / math.sqrt(d)
    s = q @ k.T * scale + (0.0 if mask is None else mask)
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    dp = do @ v.T
    ds = p * (dp - (p * dp).sum(1, keepdims=True))
    return ds @ k * scale, ds.T @ q * scale, p.T @ do


MODEL_CASES = [(n, d) for n in (71, 41, 23, 13, 128) for d in (48, 16)]


@pytest.mark.parametrize("n,d", MODEL_CASES)
def test_forward_fragment_model_gives_the_attention(n, d):
    """head_attention_bf16_kernel's layouts (bf16 tile pitches, ldmatrix
    addressing, v transposed, P from S's accumulators, padding, the staging
    tile) modelled in float64: the float64 attention, every output written."""
    rng = np.random.default_rng(n * d)
    q, k, v = (rng.normal(size=(n, d)) * 0.5 for _ in range(3))
    mask = (rng.uniform(size=n) < 0.4) * -1e9
    got = _forward_model(q, k, v, mask)
    np.testing.assert_allclose(got, _attention64(q, k, v, mask), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n,d", MODEL_CASES)
def test_backward_fragment_model_gives_the_gradients(n, d):
    """window_attention_bwd_bf16_kernel's layouts (pitches, ldmatrix and
    stmatrix addressing, the transposed tiles, padding, store_tile's 16-byte
    pieces) modelled in float64: the float64 gradients, each output written
    once."""
    rng = np.random.default_rng(n + d)
    q, k, v = (rng.normal(size=(n, d)) * 0.5 for _ in range(3))
    do = rng.normal(size=(n, d))
    mask = (rng.uniform(size=n) < 0.4) * -1e9 if n % 2 else None
    for got, want in zip(_backward_model(q, k, v, do, mask), _grads64(q, k, v, do, mask)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


# -- float64 emulations of the new sums -------------------------------------------

try:
    from tests.test_torch_gemm_tc import _emulate_bf16
except ImportError:  # pragma: no cover
    from test_torch_gemm_tc import _emulate_bf16


def _terms_product(x, v, terms, promote):
    """x (M, K) fp32 · v (K, N) bf16 as the "high" P·V sums it: x in `terms`
    bf16 terms (its rounding, the remainder's, ...), per 16-deep step the
    terms' products added by the tensor cores into a partial rounding toward
    zero, the smallest first; with `promote` the partial joins an fp32
    accumulator each step, else one running sum."""
    parts, rest = [], x.astype(F32)
    for _ in range(terms):
        parts.append(_bf16(rest))
        rest = (rest - parts[-1]).astype(F32)
    v = v.astype(np.float64)
    acc = np.zeros((x.shape[0], v.shape[1]), F32)
    part = np.zeros_like(acc)
    for s0 in range(0, x.shape[1], 16):
        sl = slice(s0, s0 + 16)
        for p in reversed(parts):
            part = _round_toward_zero(part + p[:, sl].astype(np.float64) @ v[sl])
        if promote:
            acc, part = (acc + part).astype(F32), np.zeros_like(acc)
    return acc + part


def _forward_emulation(q, k, v, mask, rung, promote=1, terms=3):
    """One head of head_attention_bf16_kernel in fp32 arithmetic, q, k, v
    bf16 values: Q·Kᵀ a fresh partial per 16-deep step (`promote` None: one
    running sum), the base-2 softmax; "high" P·V in `terms` bf16 terms of the
    unnormalised P (`_terms_product`), the row sum dividing after; "default"
    P normalised, rounded, one running sum. The fp32 context before its
    rounding to bf16."""
    n, d = q.shape
    logits = _emulate_bf16(q, np.ascontiguousarray(k.T), d, promote)
    logits = (logits * F32(LOG2E / math.sqrt(d))
              + (F32(0) if mask is None else (mask * LOG2E).astype(F32))).astype(F32)
    e = np.exp2(logits - logits.max(1, keepdims=True)).astype(F32)
    inv = (F32(1) / e.sum(1, keepdims=True, dtype=F32)).astype(F32)
    if rung == "default":
        return _emulate_bf16(_bf16(e * inv), v, n, None)
    return (_terms_product(e, v, terms, promote) * inv).astype(F32)


def _bf16_heads(seed, n, d, heads, masked):
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(rng.normal(size=(heads, n, d))) for _ in range(3))
    mask = (((rng.uniform(size=n) < 0.4) * -1e9).astype(F32) if masked else None)
    return q, k, v, mask


def _high_case(n, masked):
    """(three-term verdict, two-term verdict, one-sum error, error) of the
    "high" emulation against float64 on 8 heads of 48, bf16 values."""
    from uplift_upsample_torch.ops.packed_attention import packed_attention_plain

    d, heads = 48, 8
    q, k, v, mask = _bf16_heads(n, n, d, heads, masked)
    ref = np.stack([_attention64(*(x[h].astype(np.float64) for x in (q, k, v)), mask)
                    for h in range(heads)])
    pack = lambda x: torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)).reshape(
        1, n, heads * d))
    km = None if mask is None else torch.from_numpy((mask < 0).astype(F32))[None]
    plain = packed_attention_plain(pack(q), pack(k), pack(v), km, num_heads=heads).numpy()
    plain = plain.reshape(n, heads, d).transpose(1, 0, 2).astype(np.float64)
    emulate = lambda **kw: np.stack([_forward_emulation(q[h], k[h], v[h], mask, "high", **kw)
                                     for h in range(heads)]).astype(np.float64)
    got = emulate()
    return (_f64_ok(got, plain, ref), _f64_ok(emulate(terms=2), plain, ref)[0],
            float(np.abs(emulate(promote=None) - ref).max()))


def test_forward_high_emulation_meets_float64_criterion():
    """Row 11 on bf16 tensors at "high" (8 heads of 48; 71 tokens with the
    key mask, 23 and 41): the fp32 context the kernel rounds to bf16 is
    within 4x the fp32 plain version's error against float64 + 1e-6 of the
    scale. P·V in two bf16 terms of P misses that bar (here at 23 and 41
    tokens), and one running sum for Q·Kᵀ and P·V errs more than the fresh
    partials at every shape."""
    two_terms = []
    for n, masked in ((71, True), (23, False), (41, True)):
        (ok, err, err_plain), ok_two, err_one_sum = _high_case(n, masked)
        assert ok, (n, err, err_plain)
        assert err < err_one_sum, (n, err, err_one_sum)
        two_terms.append(ok_two)
    assert not all(two_terms), two_terms


@pytest.mark.parametrize("n,masked", [(71, True), (23, False)])
def test_forward_default_emulation_meets_the_rung_bar(n, masked):
    """Row 11 on bf16 tensors at "default": the emulated context within the
    rung bar of the rung with float64 sums (mean within 2x the fp32 plain
    version's distance, largest within 4x off the P at a bf16 tie plus the
    ties' allowance)."""
    from uplift_upsample_torch.ops.packed_attention import (bf16_flip_allowance,
                                                            packed_attention_plain)

    d, heads = 48, 8
    q, k, v, mask = _bf16_heads(n + 1, n, d, heads, masked)
    pack = lambda x: torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2)).reshape(
        1, n, heads * d))
    unpack = lambda t: t.numpy().reshape(n, heads, d).transpose(1, 0, 2).astype(np.float64)
    km = None if mask is None else torch.from_numpy((mask < 0).astype(F32))[None]
    args = (pack(q), pack(k), pack(v))
    rung64 = unpack(packed_attention_plain(*(a.double() for a in args), km, num_heads=heads,
                                           precision="default"))
    plain = unpack(packed_attention_plain(*args, km, num_heads=heads, precision="default"))
    allowance = unpack(bf16_flip_allowance(*args, km, num_heads=heads))
    got = np.stack([_forward_emulation(q[h], k[h], v[h], mask, "default")
                    for h in range(heads)]).astype(np.float64)
    err, err_plain = np.abs(got - rung64), np.abs(plain - rung64)
    slack = 1e-6 * float(np.abs(rung64).max())
    off = allowance == 0
    assert err.mean() <= 2 * err_plain.mean() + slack, (err.mean(), err_plain.mean())
    assert bool((err <= 4 * err_plain[off].max() + slack + allowance).all())


def _backward_emulation(q, k, v, do, mask, promote=1):
    """One head of window_attention_bwd_bf16_kernel in fp32 arithmetic: the
    operands rounded once (q after its 1/sqrt(D)), the five products on bf16
    operands with a fresh partial per 16-deep step (`promote` None: one
    running sum each), the base-2 softmax and dS in fp32."""
    n, d = q.shape
    scale = F32(1.0 / math.sqrt(d))
    qb, kb, vb, gb = _bf16((q * scale).astype(F32)), _bf16(k), _bf16(v), _bf16(do)
    logits = (_emulate_bf16(qb, np.ascontiguousarray(kb.T), d, promote) * F32(LOG2E)
              + (F32(0) if mask is None else (mask * LOG2E).astype(F32))).astype(F32)
    e = np.exp2(logits - logits.max(1, keepdims=True)).astype(F32)
    p = (e * (F32(1) / e.sum(1, keepdims=True, dtype=F32))).astype(F32)
    dp = _emulate_bf16(gb, np.ascontiguousarray(vb.T), d, promote)
    ds = (p * (dp - (p * dp).sum(1, keepdims=True, dtype=F32))).astype(F32)
    dsb, pb = _bf16(ds), _bf16(p)
    return ((_emulate_bf16(dsb, kb, n, promote) * scale).astype(F32),
            _emulate_bf16(np.ascontiguousarray(dsb.T), qb, n, promote),
            _emulate_bf16(np.ascontiguousarray(pb.T), gb, n, promote))


def _flip_allowance(q, k, v, do, mask):
    """(dq, dk, dv) of one head: how far flipped bf16 roundings can move each
    output of the bf16 rung, as `packed_attention.bf16_flip_allowance` has
    it for row 11. The rung's P (float64 sums) within 2^-16 of itself of a
    midpoint between two bf16 values (`packed_attention.TIE_REL`) rounds
    either way under fp32 sums in another order or a base-2 softmax, and so
    does a dS within 2^-16 of P·(|dP| + |rowsum(P·dP)|), 3x the largest
    fp32 error of dS seen over six seeds; each such value moves its outputs
    by one bf16 unit of it times the other operand."""
    from uplift_upsample_torch.ops.packed_attention import TIE_REL

    d = q.shape[1]
    scale = 1.0 / math.sqrt(d)
    r = lambda x: _bf16(x.astype(F32)).astype(np.float64)
    qb, kb, gb = r((q * F32(scale)).astype(F32)), r(k), r(do)
    s = qb @ kb.T + (0.0 if mask is None else mask.astype(np.float64))
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    dp = gb @ r(v).T
    rs = (p * dp).sum(1, keepdims=True)
    ds = p * (dp - rs)

    def tie_ulps(x, tol):
        ulp = np.ldexp(1.0, np.frexp(x)[1] - 8)
        return np.where(ulp * 0.5 - np.abs(x - r(x)) <= tol, ulp, 0.0)

    up, us = tie_ulps(p, TIE_REL * p), tie_ulps(ds, TIE_REL * p * (np.abs(dp) + np.abs(rs)))
    return us @ np.abs(kb) * scale, us.T @ np.abs(qb), up.T @ np.abs(gb)


@pytest.mark.parametrize("n,masked", [(71, True), (41, False)])
def test_backward_bf16_emulation_meets_the_rung_bar(n, masked):
    """The bf16 rung's five k16 products over 8 heads of one window (d =
    48): dq, dk and dv each within the rung bar of the rung with float64
    sums: the mean within 2x the fp32 plain version's distance, the largest
    within 4x (+ 1e-6 of the scale) off the rows a flipped rounding of a P or
    dS at a bf16 tie can move (`_tied_rows`: a few in a hundred); one running
    sum per product errs more."""
    from uplift_upsample_torch.ops.temporal_train import window_attention_bwd_plain

    d, heads = 48, 8
    rng = np.random.default_rng(n + 7)
    qkv = (rng.normal(size=(n, 3 * heads * d)) * 0.5).astype(F32)
    dctx = rng.normal(size=(n, heads * d)).astype(F32)
    km = (rng.uniform(size=(1, n)) < 0.5).astype(F32) if masked else None
    mask = None if km is None else (km[0] * -1e9).astype(F32)
    kw = dict(windows=1, n=n, num_heads=heads, precision="default")
    tk = lambda a: None if a is None else torch.from_numpy(a)
    rung64 = window_attention_bwd_plain(tk(qkv).double(), tk(dctx).double(),
                                        None if km is None else tk(km).double(), **kw).numpy()
    plain = window_attention_bwd_plain(tk(qkv), tk(dctx), tk(km), **kw).numpy().astype(np.float64)
    heads_of = lambda x, i: x[:, i * heads * d:(i + 1) * heads * d].reshape(n, heads, d)
    q, k, v = (heads_of(qkv, i) for i in range(3))
    do = dctx.reshape(n, heads, d)
    allowance = np.zeros((n, 3, heads, d))
    for h in range(heads):
        for i, a in enumerate(_flip_allowance(q[:, h], k[:, h], v[:, h], do[:, h], mask)):
            allowance[:, i, h] = a
    allowance = allowance.reshape(n, 3 * heads * d)

    def emulate(promote):
        out = np.zeros((n, 3, heads, d))
        for h in range(heads):
            for i, g in enumerate(_backward_emulation(q[:, h], k[:, h], v[:, h], do[:, h], mask,
                                                      promote)):
                out[:, i, h] = g
        return out.reshape(n, 3 * heads * d)

    got, one_sum = emulate(1), emulate(None)
    slack = 1e-6 * float(np.abs(rung64).max())
    for part in range(3):
        cols = slice(part * heads * d, (part + 1) * heads * d)
        err, err_plain = np.abs(got - rung64)[:, cols], np.abs(plain - rung64)[:, cols]
        allow = allowance[:, cols]
        assert err.mean() <= 2 * err_plain.mean() + slack, (part, err.mean(), err_plain.mean())
        bar = 4 * err_plain[allow == 0].max() + slack
        assert bool((err <= bar + allow).all()), (part, float((err - bar - allow).max()))
    assert np.abs(got - rung64).mean() < np.abs(one_sum - rung64).mean()


# -- on the card ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


ROW11_CASES = [  # (frames, tokens, channels, key mask): row 11's two shapes, then odd ones
    (1024, 71, 384, True), (1024, 23, 384, False), (3, 128, 384, True), (5, 41, 72, True),
    (9, 33, 128, False), (4, 100, 64, True), (6, 17, 96, False)]
ROW11_ENTRIES = {"high": "packed_attention_bf16io", "default": "packed_attention_bf16io_bf16"}


@pytest.mark.gpu
@pytest.mark.parametrize("rung", list(ROW11_ENTRIES))
@pytest.mark.parametrize("f,s,c,masked", ROW11_CASES)
def test_row11_bf16_tensors_on_the_card(rung, f, s, c, masked):
    """Row 11's tensor-core kernel on bf16 tensors, 8 heads: "high" within
    one bf16 unit of the plain version and within 4x its error against
    float64 + 1e-6 of the scale; "default" the rung bar with the flips'
    allowance and the mean gap within 0.25 of the rung's drift; both bit for
    bit on repeat."""
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.packed_attention import (packed_attention_plain,
                                                            packed_multihead_attention)
    try:
        from tests.test_torch_packed_attention_bf16 import BF16_ULP, _gap, _within_flips
    except ImportError:  # pragma: no cover
        from test_torch_packed_attention_bf16 import BF16_ULP, _gap, _within_flips

    dev, heads = _card(), 8
    rng = np.random.default_rng(f + s + c)
    q, k, v = (torch.from_numpy(rng.normal(size=(f, s, c)).astype(F32)).to(dev)
               .to(torch.bfloat16) for _ in range(3))
    mask = (torch.from_numpy((rng.uniform(size=(f, s)) < 0.4).astype(F32)).to(dev)
            if masked else None)
    cuda_lib.reset_launches()
    got = packed_multihead_attention(q, k, v, mask, num_heads=heads, precision=rung)
    again = packed_multihead_attention(q, k, v, mask, num_heads=heads, precision=rung)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[ROW11_ENTRIES[rung]] == 2 and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    ref = packed_attention_plain(q, k, v, mask, num_heads=heads, precision=rung)
    if rung == "high":
        ref64 = packed_attention_plain(q.double(), k.double(), v.double(), mask,
                                       num_heads=heads)
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= BF16_ULP * ref.float().abs() + 1e-6).all()), float(diff.max())
        ok, err, err_plain = _f64_ok(got.double().cpu().numpy(), ref.double().cpu().numpy(),
                                     ref64.cpu().numpy())
        assert ok, (err, err_plain)
    else:
        high = packed_attention_plain(q, k, v, mask, num_heads=heads, precision="high")
        (g_mean, _), (d_mean, _) = _gap(got, ref), _gap(ref, high)
        assert g_mean <= 0.25 * d_mean, g_mean / d_mean
        ok, past = _within_flips(got, ref, q, k, v, mask)
        assert ok, past


BWD_CASES = [  # (windows, tokens, channels, heads, key mask)
    (512, 71, 384, 8, True), (512, 71, 384, 8, False), (512, 41, 384, 8, True),
    (64, 128, 384, 8, True), (5, 71, 128, 8, True), (7, 13, 36, 4, True), (9, 23, 40, 4, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("rung", ["high", "default"])
@pytest.mark.parametrize("b,n,c,heads,masked", BWD_CASES)
def test_attention_bwd_on_the_card(rung, b, n, c, heads, masked):
    """The window-attention backward at both rungs against its plain version:
    "high" the grad bar and the float64 criterion; "default" the rung bar of
    the training rungs (`test_torch_train_rung_kernels.held`); both bit for
    bit on repeat."""
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.temporal_train import (window_attention_bwd,
                                                          window_attention_bwd_plain)
    try:
        from tests.test_torch_attention_bwd_tc import _assert_grad_bar, _case
        from tests.test_torch_train_rung_kernels import held
    except ImportError:  # pragma: no cover
        from test_torch_attention_bwd_tc import _assert_grad_bar, _case
        from test_torch_train_rung_kernels import held

    dev = _card()
    qkv, dctx, km = (None if a is None else torch.from_numpy(a).to(dev)
                     for a in _case(b * n + c, b, n, c, masked))
    kw = dict(windows=b, n=n, num_heads=heads)
    entry = "window_attention_bwd_f32" if rung == "high" else "window_attention_bwd_bf16"
    cuda_lib.reset_launches()
    got = window_attention_bwd(qkv, dctx, km, precision=rung, **kw)
    again = window_attention_bwd(qkv, dctx, km, precision=rung, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[entry] == 2
    assert torch.equal(got, again)
    plain = lambda r, d: window_attention_bwd_plain(
        qkv.to(d), dctx.to(d), None if km is None else km.to(d), precision=r, **kw)
    if rung == "high":
        ref = plain("high", torch.float32)
        _assert_grad_bar(got.cpu().numpy(), ref.cpu().numpy())
        ok, err, err_plain = _f64_ok(got.double().cpu().numpy(), ref.double().cpu().numpy(),
                                     plain("high", torch.float64).cpu().numpy())
        assert ok, (err, err_plain)
    else:
        p32, p_high, p64 = (plain("default", torch.float32), plain("high", torch.float32),
                            plain("default", torch.float64))
        for part in range(3):
            sl = slice(part * c, (part + 1) * c)
            held(got[:, sl], p32[:, sl], p_high[:, sl], p64[:, sl], ("dq", "dk", "dv")[part])


@pytest.mark.gpu
def test_fp32_attention_keeps_the_parent_bits():
    """The fp32-tensor instances of the attention kernel (K2's at both rungs,
    folded and not, K5's training forward at "default", row 11 on fp32
    tensors) give the bits of the build before the bf16-tensor redesign."""
    _card()
    assert fp32_attention_digests() == FP32_ATTENTION_DIGESTS
