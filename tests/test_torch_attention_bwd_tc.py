"""The window-attention backward on the tensor cores (`csrc/temporal_bwd.cu`).

K5's (and K6's) attention backward runs its five products (S = q·kᵀ,
dP = dO·vᵀ, dq = dS·k, dk = dSᵀ·q, dv = Pᵀ·dO) on mma.sync in 3xTF32, one
thread block per (window, head).

CPU tests: the wrapper's plain version (torch.autograd of
`window_attention_plain`) against `jax.vjp` of the JAX package's per-head
attention (`pallas_attention._head_attention`); a model of the kernel's
fragment bookkeeping (m16n8k8 tiles, the permuted keys and queries, padding,
P^T and dS^T through shared memory with the kernel's pitches) in float64,
which must give the float64 gradients; and a float64 emulation of the
kernel's 3xTF32 sums (a fresh partial per 8-deep step) held to the float64
criterion at n = 71 and 41, d = 48.

`gpu` tests: the kernel at the main paths' shapes (512 windows x 71 x 384
with and without the key mask, h36m_81's 41 tokens, 128 tokens) and at small
odd ones, against its plain version (grad bar), against float64 and twice
(bit for bit). JAX is imported inside the CPU test that needs it, so the
file also runs where JAX is not installed (the card's machine):

    python -m pytest --noconftest -m gpu tests/test_torch_attention_bwd_tc.py
"""

import math

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops.temporal_train import (window_attention_bwd,
                                                      window_attention_bwd_plain)

try:  # the card's machine collects tests/ without the package's conftest
    from tests.test_torch_gemm_tc import _emulate_3xtf32, _f64_ok
except ImportError:  # pragma: no cover
    from test_torch_gemm_tc import _emulate_3xtf32, _f64_ok

LOG2E = 1.4426950408889634


def _case(seed, b, n, c, masked):
    rng = np.random.default_rng(seed)
    qkv = (rng.normal(size=(b * n, 3 * c)) * 0.5).astype(np.float32)
    dctx = rng.normal(size=(b * n, c)).astype(np.float32)
    km = (rng.uniform(size=(b, n)) < 0.5).astype(np.float32) if masked else None
    if km is not None:
        km[0] = 1.0  # a window whose keys are all blocked: a uniform softmax
    return qkv, dctx, km


def _grads64(q, k, v, do, mask):
    """Float64 dq, dk, dv of one head; mask additive (n,) or None."""
    d = q.shape[1]
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = (a.astype(np.float64) for a in (q, k, v, do))
    s = q @ k.T * scale + (0.0 if mask is None else mask.astype(np.float64))
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    dp = do @ v.T
    ds = p * (dp - (p * dp).sum(1, keepdims=True))
    return ds @ k * scale, ds.T @ q * scale, p.T @ do


def _assert_grad_bar(got, ref):
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=2e-3)


# -- CPU ------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [True, False])
def test_attention_bwd_plain_matches_jax(masked):
    """The CPU wrapper (the plain version) against jax.vjp of the JAX
    package's per-head attention, head by head: the grad bar."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from uplift_upsample_tpu.ops.pallas_attention import _head_attention

    b, n, c, heads = 3, 13, 32, 4
    d = c // heads
    qkv, dctx, km = _case(1, b, n, c, masked)
    got = window_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(dctx),
                               None if km is None else torch.from_numpy(km),
                               windows=b, n=n, num_heads=heads).numpy()
    x = qkv.reshape(b, n, 3, heads, d)
    g = dctx.reshape(b, n, heads, d)
    neg = None if km is None else jnp.asarray(km * -1e9)[:, None, :]
    want = np.zeros((b, n, 3, heads, d), np.float32)
    for h in range(heads):
        fn = lambda qh, kh, vh: _head_attention(qh, kh, vh, 1.0 / math.sqrt(d), neg, d)
        _, vjp = jax.vjp(fn, *(jnp.asarray(x[:, :, i, h]) for i in range(3)))
        for i, gi in enumerate(vjp(jnp.asarray(g[:, :, h]))):
            want[:, :, i, h] = np.asarray(gi)
    _assert_grad_bar(got, want.reshape(b * n, 3 * c))


_G, _T = np.arange(32) >> 2, np.arange(32) & 3  # fragment row group, thread in group


def _mma(acc, a, b):
    """acc + a·b for mma.sync.m16n8k8 on per-lane fragments (arrays of 32),
    float64: A at rows g, g+8 and columns t, t+4; B at rows t, t+4 and
    column g; C at rows g, g+8 and columns 2t, 2t+1."""
    g, t = _G, _T
    am = np.zeros((16, 8))
    am[g, t], am[g + 8, t], am[g, t + 4], am[g + 8, t + 4] = a
    bm = np.zeros((8, 8))
    bm[t, g], bm[t + 4, g] = b
    cm = am @ bm
    return acc + np.stack([cm[g, 2 * t], cm[g, 2 * t + 1], cm[g + 8, 2 * t],
                           cm[g + 8, 2 * t + 1]])


def _kernel_model(q, k, v, do, mask):
    """One (window, head) through the kernel's index arithmetic, float64:
    the staged tiles as flat arrays with the kernel's pitches and padding,
    each product as m16n8k8 tiles on lane fragments. Returns dq, dk, dv."""
    mma, g, t = _mma, _G, _T
    n, d = q.shape
    dp_, warps = -(-d // 8) * 8, -(-n // 16)
    dk_, p = dp_ // 8, dp_ + 4  # attn_v_pitch
    nq, nk = 16 * warps, -(-n // 8) * 8
    nt = nk // 8
    pp = nq if nq % 16 == 8 else nq + 8  # attn_qk_pitch(nq)

    def stage(x, rows):
        flat = np.zeros(rows * p)
        for r in range(x.shape[0]):
            flat[r * p: r * p + d] = x[r]
        return flat

    qs, gs, ks, vs = stage(q, nq), stage(do, nq), stage(k, nk), stage(v, nk)
    mk = np.full(nk, -np.inf)
    mk[:n] = 0.0 if mask is None else mask * LOG2E
    sl = LOG2E / math.sqrt(d)
    dq, dk, dv = np.zeros((n, d)), np.zeros((n, d)), np.zeros((n, d))
    pt, dst = np.zeros(nq * pp), np.zeros(nq * pp)

    def rows_dot(a, b, warp):
        acc = np.zeros((nt, 4, 32))
        aw = warp * 16 * p
        for kk in range(dk_):
            a0 = aw + g * p + 8 * kk + t
            af = (a[a0], a[a0 + 8 * p], a[a0 + 4], a[a0 + 8 * p + 4])
            for j in range(nt):
                b0 = (8 * j + g) * p + 8 * kk + t
                acc[j] = mma(acc[j], af, (b[b0], b[b0 + 4]))
        return acc

    held = []
    for warp in range(warps):  # pass 1
        s = rows_dot(qs, ks, warp)
        for j in range(nt):
            m0, m1 = mk[8 * j + 2 * t], mk[8 * j + 2 * t + 1]
            s[j] = s[j] * sl + np.stack([m0, m1, m0, m1])
        mx0 = s[:, :2].max(axis=(0, 1)).reshape(8, 4).max(1).repeat(4)
        mx1 = s[:, 2:].max(axis=(0, 1)).reshape(8, 4).max(1).repeat(4)
        s[:, :2] = np.exp2(s[:, :2] - mx0)
        s[:, 2:] = np.exp2(s[:, 2:] - mx1)
        s[:, :2] /= s[:, :2].sum(axis=(0, 1)).reshape(8, 4).sum(1).repeat(4)
        s[:, 2:] /= s[:, 2:].sum(axis=(0, 1)).reshape(8, 4).sum(1).repeat(4)
        ds = rows_dot(gs, vs, warp)
        rs0 = (s[:, :2] * ds[:, :2]).sum(axis=(0, 1)).reshape(8, 4).sum(1).repeat(4)
        rs1 = (s[:, 2:] * ds[:, 2:]).sum(axis=(0, 1)).reshape(8, 4).sum(1).repeat(4)
        ds[:, :2] = s[:, :2] * (ds[:, :2] - rs0)
        ds[:, 2:] = s[:, 2:] * (ds[:, 2:] - rs1)
        row0 = warp * 16 + g
        for cc in range(dk_):
            o = np.zeros((4, 32))
            for j in range(nt):
                kj = (8 * j + 2 * t) * p + 8 * cc + g
                o = mma(o, (ds[j][0], ds[j][2], ds[j][1], ds[j][3]), (ks[kj], ks[kj + p]))
            col = 8 * cc + 2 * t
            for e, (r, cl) in enumerate(((row0, col), (row0, col + 1), (row0 + 8, col),
                                         (row0 + 8, col + 1))):
                ok = (r < n) & (cl < d)
                dq[r[ok], cl[ok]] = o[e][ok] / math.sqrt(d)
        held.append((s, ds, row0))
    for s, ds, row0 in held:  # P^T and dS^T, keys x queries
        for j in range(nt):
            k0 = (8 * j + 2 * t) * pp
            k1 = k0 + pp
            for arr, src in ((pt, s), (dst, ds)):
                arr[k0 + row0], arr[k1 + row0] = src[j][0], src[j][1]
                arr[k0 + row0 + 8], arr[k1 + row0 + 8] = src[j][2], src[j][3]
    for warp in range(warps):  # pass 2
        key0 = warp * 16 + g
        for cc in range(dk_):
            ok_, ov = np.zeros((4, 32)), np.zeros((4, 32))
            for i in range(nt):
                a = key0 * pp + 8 * i + 2 * t
                pf = (pt[a], pt[a + 8 * pp], pt[a + 1], pt[a + 8 * pp + 1])
                sf = (dst[a], dst[a + 8 * pp], dst[a + 1], dst[a + 8 * pp + 1])
                bi = (8 * i + 2 * t) * p + 8 * cc + g
                ov = mma(ov, pf, (gs[bi], gs[bi + p]))
                ok_ = mma(ok_, sf, (qs[bi], qs[bi + p]))
            col = 8 * cc + 2 * t
            for e, (r, cl) in enumerate(((key0, col), (key0, col + 1), (key0 + 8, col),
                                         (key0 + 8, col + 1))):
                ok = (r < n) & (cl < d)
                dk[r[ok], cl[ok]] = ok_[e][ok] / math.sqrt(d)
                dv[r[ok], cl[ok]] = ov[e][ok]
    return dq, dk, dv


@pytest.mark.parametrize("n,d,masked", [(71, 48, True), (41, 48, False), (13, 12, True),
                                        (128, 16, True)])
def test_attention_bwd_fragment_model_gives_the_gradients(n, d, masked):
    """The kernel's tiles, pitches, permuted keys (dq) and queries (dk, dv),
    padding and the P^T / dS^T hand-over, modelled in float64 with exact
    products: the float64 gradients to rounding, every output element
    written once."""
    rng = np.random.default_rng(n + d)
    q, k, v = (rng.normal(size=(n, d)) * 0.5 for _ in range(3))
    do = rng.normal(size=(n, d))
    mask = (rng.uniform(size=n) < 0.5) * -1e9 if masked else None
    got = _kernel_model(q, k, v, do, mask)
    for a, b in zip(got, _grads64(q, k, v, do, mask)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def _emulate_kernel(q, k, v, do, mask, promote):
    """One head as the kernel sums it: each product in 3xTF32 with a fresh
    partial per 8-deep step (promote 1; None: one running sum), the softmax
    in base 2 in fp32."""
    n, d = q.shape
    scale = np.float32(1 / math.sqrt(d))
    s = (_emulate_3xtf32(q, np.ascontiguousarray(k.T), d, promote) * (scale * np.float32(LOG2E))
         + (np.float32(0) if mask is None else (mask * LOG2E).astype(np.float32)))
    e = np.exp2(s - s.max(1, keepdims=True)).astype(np.float32)
    p = e * (np.float32(1) / e.sum(1, keepdims=True, dtype=np.float32))
    dp = _emulate_3xtf32(do, np.ascontiguousarray(v.T), d, promote)
    ds = (p * (dp - (p * dp).sum(1, keepdims=True, dtype=np.float32))).astype(np.float32)
    return (_emulate_3xtf32(ds, k, n, promote) * scale,
            _emulate_3xtf32(np.ascontiguousarray(ds.T), q, n, promote) * scale,
            _emulate_3xtf32(np.ascontiguousarray(p.T), do, n, promote))


@pytest.mark.parametrize("n,masked", [(71, True), (41, False)])
def test_attention_bwd_emulation_meets_float64_criterion(n, masked):
    """The kernel's 3xTF32 arithmetic over 8 heads of one window (d = 48):
    its error against float64 is at most 4x the fp32 plain version's plus
    1e-6 of the scale, in each of dq, dk and dv; with one running sum per
    product (rounded toward zero by the tensor cores at every add) it is
    larger."""
    d, heads = 48, 8
    rng = np.random.default_rng(n)
    got, one_sum, plain, ref = [], [], [], []
    for _ in range(heads):
        q, k, v = ((rng.normal(size=(n, d)) * 0.5).astype(np.float32) for _ in range(3))
        do = rng.normal(size=(n, d)).astype(np.float32)
        mask = ((rng.uniform(size=n) < 0.5) * -1e9).astype(np.float32) if masked else None
        got.append(np.concatenate(_emulate_kernel(q, k, v, do, mask, 1), 1))
        one_sum.append(np.concatenate(_emulate_kernel(q, k, v, do, mask, None), 1))
        ref.append(np.concatenate(_grads64(q, k, v, do, mask), 1))
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        logits = leaves[0] @ leaves[1].T * (1 / math.sqrt(d))
        if mask is not None:
            logits = logits + torch.from_numpy(mask)
        out = torch.softmax(logits, -1) @ leaves[2]
        plain.append(torch.cat(torch.autograd.grad(out, leaves, torch.from_numpy(do)),
                               1).numpy())
    got, one_sum, plain, ref = (np.concatenate(a).astype(np.float64)
                                for a in (got, one_sum, plain, ref))
    for part in range(3):
        cols = slice(part * d, (part + 1) * d)
        ok, err, err_plain = _f64_ok(got[:, cols], plain[:, cols], ref[:, cols])
        assert ok, (part, err, err_plain)
    assert np.abs(got - ref).max() < np.abs(one_sum - ref).max()


def test_attention_bwd_cpu_is_plain():
    """On a CPU tensor the wrapper is the plain version, bit for bit."""
    b, n, c, heads = 2, 9, 24, 3
    qkv, dctx, km = (torch.from_numpy(a) for a in _case(2, b, n, c, True))
    got = window_attention_bwd(qkv, dctx, km, windows=b, n=n, num_heads=heads)
    want = window_attention_bwd_plain(qkv, dctx, km, windows=b, n=n, num_heads=heads)
    assert torch.equal(got, want)


# -- gpu --------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,heads,masked", [
    (512, 71, 384, 8, True),    # K5's first block at the train step
    (512, 71, 384, 8, False),   # K5's blocks 2-4, K6
    (512, 41, 384, 8, True),    # h36m_81
    (64, 128, 384, 8, True),    # the longest window the kernel takes
    (64, 128, 384, 8, False),
    (5, 71, 128, 8, True),      # K5's one-block test shapes (d = 16)
    (7, 13, 36, 4, True),       # d = 9: padded D, 4-byte copies
])
def test_attention_bwd_kernel_matches_plain(b, n, c, heads, masked):
    """Against the plain version (grad bar), against float64 (at most 4x the
    plain version's error + 1e-6 of the scale) and bit for bit on repeat."""
    from uplift_upsample_torch.ops import cuda_lib

    dev = _card()
    qkv, dctx, km = (None if a is None else torch.from_numpy(a).to(dev)
                     for a in _case(b + n, b, n, c, masked))
    kw = dict(windows=b, n=n, num_heads=heads)
    cuda_lib.reset_launches()
    got = window_attention_bwd(qkv, dctx, km, **kw)
    again = window_attention_bwd(qkv, dctx, km, **kw)
    ref = window_attention_bwd_plain(qkv, dctx, km, **kw)
    ref64 = window_attention_bwd_plain(qkv.double(), dctx.double(),
                                       None if km is None else km.double(), **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["window_attention_bwd_f32"] == 2
    assert torch.equal(got, again)
    _assert_grad_bar(got.cpu().numpy(), ref.cpu().numpy())
    ok, err, err_plain = _f64_ok(got.double().cpu().numpy(), ref.double().cpu().numpy(),
                                 ref64.cpu().numpy())
    assert ok, (err, err_plain)
