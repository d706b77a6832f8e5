"""The tensor-core GEMMs of the dense layers (`csrc/gemm_tc.cuh`, 3xTF32).

K2, K3, K5 and K6 run every dense-layer product on the tensor cores: the
forward's (`gemm_f32`, `gemm_branch_f32`) and the backward's dX
(`gemm_dx_f32`) on TMA + wgmma from W's TF32 halves, the backward's dW
(`gemm_dw_f32`) on mma.sync, split over the rows.

CPU tests: the plain TF32 split (the halves the kernels read, the same
integer rounding as `csrc/tf32.cuh`); a float64 emulation of the kernels'
three-product sums held to the float64 criterion the card holds them to; and
the stale-halves guard: on the training path the halves are split anew from
each step's weights.

`gpu` tests: each launch against its plain version at the main paths'
(K, N), at odd row counts, and against float64. They decide inside the test
whether there is a card and skip without one. JAX is not imported here, so
the file also runs where JAX is not installed (the card's machine):

    python -m pytest --noconftest -m gpu tests/test_torch_gemm_tc.py
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.strided import DENSE as STRIDED_DENSE
from uplift_upsample_torch.ops.temporal import (DENSE, gemm, tf32_halves,
                                                tf32_halves_plain)
from uplift_upsample_torch.ops.temporal_train import _branch_gemm, dw_splits, gemm_dw, gemm_dx

# the dense layers' (K, N) on the main paths: qkv, proj, fc1, fc2
SHAPES = [(384, 1152), (384, 384), (384, 768), (768, 384)]
TRAIN_ROWS = 512 * 71  # the train step's 36,352 rows


def _tf32_trunc(x: np.ndarray) -> np.ndarray:
    """x as the tensor cores read a TF32 operand: its 13 low mantissa bits cleared."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _f64_ok(got64, plain64, ref64):
    """The float64 criterion: the kernel's error against float64 at most 4x the
    fp32 plain version's plus 1e-6 of the output scale."""
    err = float(np.abs(got64 - ref64).max())
    err_plain = float(np.abs(plain64 - ref64).max())
    return err <= 4 * err_plain + 1e-6 * float(np.abs(ref64).max()), err, err_plain


# -- CPU ------------------------------------------------------------------------

def test_tf32_halves_add_back_to_w():
    """big is w rounded to 10 mantissa bits; big + small, with small truncated
    to TF32 as the tensor cores read it, is w within 2^-22 relative; the
    transposed layout holds the same halves; the CPU wrapper is the plain
    version."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(3, 40, 24)) * np.exp(rng.uniform(-20, 20, size=(3, 40, 24))))
    w = w.astype(np.float32)
    w[0, 0, :4] = [0.0, -0.0, 1.0, -2.5]
    halves = tf32_halves_plain(torch.from_numpy(w), transpose=False).numpy()
    assert halves.shape == (3, 2, 40, 24)
    big, small = halves[:, 0], halves[:, 1]
    assert np.all(big.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.array_equal(big + small, w)  # the split is exact in fp32
    back = big.astype(np.float64) + _tf32_trunc(small).astype(np.float64)
    rel = np.abs(back - w) / np.maximum(np.abs(w.astype(np.float64)), 1e-300)
    assert rel.max() <= 2.0 ** -22
    assert np.abs(small).max() > 0  # the small half carries bits
    rounded = np.abs(big.astype(np.float64) - w) <= np.abs(w) * 2.0 ** -11
    assert rounded.all()  # to nearest: at most half a TF32 ulp away
    transposed = tf32_halves(torch.from_numpy(w)).numpy()
    assert np.array_equal(transposed, np.swapaxes(halves, -1, -2))


def _split(x):
    halves = tf32_halves_plain(torch.from_numpy(np.ascontiguousarray(x)), transpose=False)
    big, small = halves.unbind(-3)
    return big.numpy().astype(np.float64), _tf32_trunc(small.numpy()).astype(np.float64)


def _round_toward_zero(x: np.ndarray) -> np.ndarray:
    """float64 → float32, rounded toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _emulate_3xtf32(a, b, k_split, promote):
    """a (M, K) · b (K, N) as the kernels compute it: each operand split into
    TF32 halves, the small halves truncated as the tensor cores read them;
    per 8-deep step three products (small·big, big·small, big·big, in that
    order), each added by the tensor cores into a partial sum rounding toward
    zero; every `promote` steps (None: never) the partial joins an fp32
    accumulator with a rounded add; chunks of k_split rows (split-K) summed
    in a fixed order."""
    a_big, a_small = _split(a)
    b_big, b_small = _split(b)
    k = a.shape[1]
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, k, k_split):
        acc = np.zeros_like(total)
        part, steps = np.zeros_like(total), 0
        for s in range(k0, min(k, k0 + k_split), 8):
            sl = slice(s, min(s + 8, k, k0 + k_split))
            for pa, pb in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
                part = _round_toward_zero(part + pa[:, sl] @ pb[sl])
            steps += 1
            if promote and steps % promote == 0:
                acc, part = acc + part, np.zeros_like(total)
        total = total + (acc + part if promote else part)
    return total


@pytest.mark.parametrize("k,n,dw", [(768, 384, False), (TRAIN_ROWS, 1152, True)])
def test_3xtf32_emulation_meets_float64_criterion(k, n, dw):
    """The float64 criterion holds for the kernels' arithmetic at fc2's K = 768
    (gemm_tc_kernel: a fresh partial per 32-deep stage) and at dW's K = 36,352
    rows (gemm_atb_kernel: a partial per 8-deep step; split-K as `dw_splits`
    cuts the rows, the per-window row scale on dY). One running sum, rounded
    toward zero by the tensor cores at every add, would miss it, and so
    would one TF32 pass."""
    rng = np.random.default_rng(k)
    m, cols = 16, 16  # a corner of the output; every K is whole
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, cols)).astype(np.float32)
    k_split, promote = k, 4
    if dw:  # a = Xᵀ, b = dY scaled per window of 71 rows (0 or 1/0.9 at keep 0.9)
        keep = rng.uniform(size=k // 71) < 0.9
        scale = np.repeat(np.where(keep, 1 / 0.9, 0.0), 71).astype(np.float32)
        b = (b * scale[:, None]).astype(np.float32)
        splits = dw_splits(k, 384, n)
        k_split = -(-k // splits)
        k_split, promote = -(-k_split // 32) * 32, 1
        assert splits > 1
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    plain = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy().astype(np.float64)
    got = _emulate_3xtf32(a, b, k_split, promote).astype(np.float64)
    ok, err, err_plain = _f64_ok(got, plain, ref64)
    assert ok, (err, err_plain)
    one_sum = _emulate_3xtf32(a, b, k_split, None).astype(np.float64)
    assert not _f64_ok(one_sum, plain, ref64)[0]
    one_pass = _split(a)[0] @ _split(b)[0]
    assert not _f64_ok(one_pass, plain, ref64)[0]


def test_training_path_splits_halves_from_each_steps_weights(monkeypatch):
    """Stale-halves guard: the train step stacks K5's and K6's operands anew
    each step, and their TF32 halves with them (K6's conv kernel "wc" too).
    Two steps of make_train_step on the CPU with the temporal and strided
    kernel paths on: at each call
    the halves are those of that call's weights, and after an optimizer step
    both the weights and the halves have changed."""
    from uplift_upsample_torch.config import UpliftUpsampleConfig
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step
    from uplift_upsample_torch.parallel import train_step as ts

    config = UpliftUpsampleConfig()
    config.update_from(dict(
        SEQUENCE_LENGTH=9, SEQUENCE_STRIDE=5, SPATIAL_EMBED_DIM=16, TEMPORAL_EMBED_DIM=32,
        SPATIAL_TRANSFORMER_BLOCKS=1, TEMPORAL_TRANSFORMER_BLOCKS=2, STRIDES=[3, 3],
        PADDINGS=[[0, 0], [0, 0]], NUM_HEADS=4, BATCH_SIZE=4, MASK_STRIDE=3,
        FIRST_STRIDED_TOKEN_ATTENTION_LAYER=1, DROP_PATH_RATE=[0.0, 0.0, 0.0],
        ROOT_KEYTPOINT=0, TRAIN_FUSED_SPATIAL=True, TRAIN_FUSED_TEMPORAL=True,
        TRAIN_FUSED_STRIDED=True, EMA_ENABLED=False, TRAIN_MATMUL_PRECISION="high"))
    model = build_uplift_upsample_transformer(config, device="cpu", seed=1)
    assert ts.fused_stages(model, config, True) == (True, True, True)
    seen = {"temporal": [], "strided": []}

    def spy(kind, fn, names):
        def wrapped(x, ops, *args, **kwargs):
            seen[kind].append({key: ops[key].detach().clone() for key in ops
                               if key.split("_tc")[0] in names})
            return fn(x, ops, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(ts, "temporal_stack_train",
                        spy("temporal", ts.temporal_stack_train, DENSE))
    monkeypatch.setattr(ts, "strided_block1_train",
                        spy("strided", ts.strided_block1_train, STRIDED_DENSE))
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=False)
    step = make_train_step(model, opt, config, device="cpu")
    rng = np.random.default_rng(0)
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    for _ in range(2):
        batch = (rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.1,
                 rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.1,
                 (np.arange(n)[None] + rng.integers(0, 3, size=(b, 1))) % 3 == 0)
        state, loss = step(state, batch)
        assert np.isfinite(float(loss))
    for kind, names in (("temporal", DENSE), ("strided", STRIDED_DENSE)):
        calls = seen[kind]
        assert len(calls) == 2, kind
        for call in calls:
            for name in names:
                assert torch.equal(call[f"{name}_tc"], tf32_halves_plain(call[name]))
                assert torch.equal(call[f"{name}_tc_dx"],
                                   tf32_halves_plain(call[name], transpose=False))
        for name in names:
            assert not torch.equal(calls[0][name], calls[1][name]), (kind, name)
            assert not torch.equal(calls[0][f"{name}_tc"], calls[1][f"{name}_tc"])
            assert not torch.equal(calls[0][f"{name}_tc_dx"], calls[1][f"{name}_tc_dx"])


# -- the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    return torch.device("cuda")


def _rand(rng, *shape, scale=0.5):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device="cuda")


def _close(got, ref):
    return float((got - ref).abs().max()) <= 2e-4 * max(1.0, float(ref.abs().max()))


def _grad_close(got, ref):
    scale = max(float(ref.abs().max()), 1e-3)
    return bool(((got - ref).abs() <= 2e-4 * scale + 2e-3 * ref.abs()).all())


def _f64_card(got, plain, ref64):
    return _f64_ok(got.double().cpu().numpy(), plain.double().cpu().numpy(),
                   ref64.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 127, 129, TRAIN_ROWS])
@pytest.mark.parametrize("k,n", SHAPES)
def test_gemm_matches_plain(m, k, n):
    """`gemm_f32` (bias, no epilogue extras) against a @ w + bias and float64."""
    dev = _card()
    rng = np.random.default_rng(m + k + n)
    a, w, bias = _rand(rng, m, k), _rand(rng, k, n, scale=0.05), _rand(rng, n, scale=0.1)
    cuda_lib.reset_launches()
    got = gemm(a, tf32_halves(w), bias, counter="test")
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["gemm_f32"] == 1 and got.device.type == dev.type
    ref = a @ w + bias
    assert _close(got, ref)
    ok, err, err_plain = _f64_card(got, ref, a.double() @ w.double() + bias.double())
    assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", SHAPES)
def test_gemm_relu_and_residual(k, n):
    """relu, a residual, and a residual that aliases out (the fc2 sublayer's
    `gemm(..., residual=h, out=h)`), at 1,031 rows."""
    _card()
    rng = np.random.default_rng(k * n)
    m = 1031
    a, w, bias = _rand(rng, m, k), _rand(rng, k, n, scale=0.05), _rand(rng, n, scale=0.1)
    res = _rand(rng, m, n)
    halves = tf32_halves(w)
    pre = a @ w + bias
    assert _close(gemm(a, halves, bias, relu=True, counter=None), torch.relu(pre))
    assert _close(gemm(a, halves, bias, residual=res, counter=None), pre + res)
    h = res.clone()
    out = gemm(a, halves, None, residual=h, out=h, relu=True, counter=None)
    torch.cuda.synchronize()
    assert out.data_ptr() == h.data_ptr()
    assert _close(h, torch.relu(a @ w) + res)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,relu", [(384, 384, False), (768, 384, False), (384, 768, True)])
def test_gemm_branch_matches_plain(k, n, relu):
    """`gemm_branch_f32`: out = residual + s[row // 71] · act(a @ w + bias) and
    the unscaled branch, at the train step's 36,352 rows."""
    _card()
    rng = np.random.default_rng(k + n)
    m, per = TRAIN_ROWS, 71
    a, w, bias = _rand(rng, m, k), _rand(rng, k, n, scale=0.05), _rand(rng, n, scale=0.1)
    res = _rand(rng, m, n)
    scale = torch.tensor(np.where(rng.uniform(size=m // per) < 0.9, 1 / 0.9, 0.0),
                         dtype=torch.float32, device="cuda")
    out, branch = _branch_gemm(a, tf32_halves(w), bias, scale, per, res, relu=relu)
    pre = a @ w + bias
    want_branch = torch.relu(pre) if relu else pre
    want = res + want_branch * scale.repeat_interleave(per)[:, None]
    assert _close(branch, want_branch) and _close(out, want)
    ref64 = a.double() @ w.double() + bias.double()
    ok, err, err_plain = _f64_card(branch, want_branch, torch.relu(ref64) if relu else ref64)
    assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [129, TRAIN_ROWS])
@pytest.mark.parametrize("k,n,scaled,masked", [
    (384, 768, True, True),     # dh1 = (s2 · g) @ w2ᵀ, relu mask of h1
    (768, 384, False, False),   # dz = dh1 @ w1ᵀ
    (384, 384, True, False),    # dctx = (s1 · dx2) @ wpᵀ
    (1152, 384, False, False),  # dy = dqkv @ wqkvᵀ
])
def test_gemm_dx_matches_plain(m, k, n, scaled, masked):
    """`gemm_dx_f32` against (s · dy) @ wᵀ with the relu mask, to the grad bar
    and float64; w (N, K) as the forward stores it."""
    _card()
    rng = np.random.default_rng(m + k)
    dy, w = _rand(rng, m, k, scale=1.0), _rand(rng, n, k, scale=0.05)
    per = 71
    scale = mask = None
    rows_scale = torch.ones(m, 1, device="cuda")
    if scaled:
        scale = torch.tensor(np.where(rng.uniform(size=-(-m // per)) < 0.9, 1 / 0.9, 0.0),
                             dtype=torch.float32, device="cuda")
        rows_scale = scale.repeat_interleave(per)[:m, None]
    if masked:
        mask = torch.relu(_rand(rng, m, n))
    cuda_lib.reset_launches()
    got = gemm_dx(dy, scale, per, tf32_halves(w, transpose=False), mask=mask, counter="test")
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["gemm_dx_f32"] == 1
    keep = torch.ones_like(got) if mask is None else (mask > 0).float()
    ref = (dy * rows_scale) @ w.t() * keep
    assert _grad_close(got, ref)
    ref64 = (dy.double() * rows_scale.double()) @ w.double().t() * keep.double()
    ok, err, err_plain = _f64_card(got, ref, ref64)
    assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(768, 384), (384, 768), (384, 384), (384, 1152)])
def test_gemm_dw_matches_plain(m, n):
    """`gemm_dw_f32` + the fixed-order sum: xᵀ @ (s · dy) over the train step's
    36,352 rows with a per-window row scale, to the grad bar and float64, and
    bit-identical on repeat (no float atomics)."""
    _card()
    rng = np.random.default_rng(m * 7 + n)
    rows, per = TRAIN_ROWS, 71
    x, dy = _rand(rng, rows, m), _rand(rng, rows, n, scale=1.0)
    scale = torch.tensor(np.where(rng.uniform(size=rows // per) < 0.9, 1 / 0.9, 0.0),
                         dtype=torch.float32, device="cuda")
    out = torch.empty((m, n), device="cuda")
    cuda_lib.reset_launches()
    gemm_dw(x, dy, scale, per, out, counter="test")
    first = out.clone()
    gemm_dw(x, dy, scale, per, out, counter="test")
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["gemm_dw_f32"] == 2 and torch.equal(first, out)
    dys = dy * scale.repeat_interleave(per)[:, None]
    ref = x.t() @ dys
    assert _grad_close(out, ref)
    ok, err, err_plain = _f64_card(out, ref, x.double().t() @ dys.double())
    assert ok, (err, err_plain)


@pytest.mark.gpu
def test_tf32_halves_kernel_matches_plain():
    """`tf32_halves_f32` gives the plain split's bits, in both layouts, over a
    stack of blocks."""
    _card()
    rng = np.random.default_rng(5)
    w = _rand(rng, 4, 384, 1152, scale=0.05)
    for transpose in (True, False):
        got = tf32_halves(w, transpose=transpose)
        assert torch.equal(got.cpu(), tf32_halves_plain(w.cpu(), transpose=transpose))
