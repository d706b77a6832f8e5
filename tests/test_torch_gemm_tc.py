"""The tensor-core GEMMs of the dense layers (`csrc/gemm_tc.cuh`, 3xTF32).

K2, K3, K5 and K6 run every dense-layer product on the tensor cores: the
forward's (`gemm_f32`, `gemm_branch_f32`) and the backward's dX
(`gemm_dx_f32`) on TMA + wgmma from W's TF32 halves, the backward's dW
(`gemm_dw_f32`, `gemm_dw_bf16`: gemm_atb_kernel) on wgmma too, split over
the rows.

CPU tests: the plain TF32 split (the halves the kernels read, the same
integer rounding as `csrc/tf32.cuh`); a float64 emulation of the kernels'
three-product sums held to the float64 criterion the card holds them to (and
of the bf16 dW's k16 sums held to the rung bar); a mirror of gemm_atb_kernel's
walk over tiles, row chunks and tap runs; and the stale-halves guard: on the
training path the halves are split anew from each step's weights.

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


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _emulate_bf16(a, b, k_split, promote):
    """a (M, K) · b (K, N) as gemm_atb_kernel's bf16 mode computes it on
    bf16-rounded operands: per 16-deep step one product, added by the tensor
    cores into a partial rounding toward zero; every `promote` steps (None:
    never) the partial joins an fp32 accumulator with a rounded add; chunks
    of k_split rows summed in a fixed order."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    k = a.shape[1]
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, k, k_split):
        acc = np.zeros_like(total)
        part, steps = np.zeros_like(total), 0
        for s in range(k0, min(k, k0 + k_split), 16):
            sl = slice(s, min(s + 16, k, k0 + k_split))
            part = _round_toward_zero(part + a[:, sl] @ b[sl])
            steps += 1
            if promote and steps % promote == 0:
                acc, part = acc + part, np.zeros_like(total)
        total = total + (acc + part if promote else part)
    return total


def _rung_bar(got64, plain64, rung64):
    """The training rungs' float64-sum bar: the mean distance to the rung with
    float64 sums within 2x the fp32 plain version's, the largest within 4x,
    + 1e-6 of the scale."""
    err, err_plain = np.abs(got64 - rung64), np.abs(plain64 - rung64)
    slack = 1e-6 * float(np.abs(rung64).max())
    return (err.mean() <= 2 * err_plain.mean() + slack
            and err.max() <= 4 * err_plain.max() + slack), err.mean(), err_plain.mean()


@pytest.mark.parametrize("k,n,dw", [(768, 384, False), (TRAIN_ROWS, 1152, True),
                                    (512 * 23, 384, "dwc"), (TRAIN_ROWS, 1152, "bf16"),
                                    (TRAIN_ROWS, 384, "bf16 fc2"), (512 * 23, 384, "dwc bf16")])
def test_3xtf32_emulation_meets_float64_criterion(k, n, dw):
    """The float64 criterion holds for the kernels' arithmetic at fc2's K = 768
    (gemm_tc_kernel: a fresh partial per 32-deep stage) and at dW's K = 36,352
    rows and dWc's 11,776 (gemm_atb_kernel: a fresh partial per 32-deep
    stage too; split-K as `dw_splits` cuts the rows, the per-window row
    scale on dY).
    One running sum, rounded toward zero by the tensor cores at every add,
    would miss it, and so would one TF32 pass. The bf16 mode (on the rounded
    operands: a partial per 32-deep stage of two k16 products, over the same
    chunks, qkv's and fc2's at 36,352 rows, dWc's at 11,776) meets the training
    rungs' float64-sum bar, which one running sum misses."""
    rng = np.random.default_rng(k)
    m, cols = 16, 16  # a corner of the output; every K is whole
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, cols)).astype(np.float32)
    k_split, promote = k, 4
    if dw:  # a = Xᵀ, b = dY, scaled per window of 71 rows (0 or 1/0.9 at keep 0.9)
        wm = 2304 if "dwc" in str(dw) else 768 if "fc2" in str(dw) else 384
        if "dwc" in str(dw):  # T is relu'd h1, g unscaled
            a = np.maximum(a, 0)
        else:
            keep = rng.uniform(size=k // 71) < 0.9
            scale = np.repeat(np.where(keep, 1 / 0.9, 0.0), 71).astype(np.float32)
            b = (b * scale[:, None]).astype(np.float32)
        splits = dw_splits(k, wm, n)
        k_split = -(-k // splits)
        k_split = -(-k_split // 32) * 32
        assert splits > 1
    if "bf16" in str(dw):
        a, b = _bf16(a), _bf16(b)
        rung64 = a.astype(np.float64) @ b.astype(np.float64)
        plain = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy().astype(np.float64)
        ok, err, err_plain = _rung_bar(_emulate_bf16(a, b, k_split, 2).astype(np.float64),
                                       plain, rung64)
        assert ok, (err, err_plain)
        one_sum = _emulate_bf16(a, b, k_split, None).astype(np.float64)
        assert not _rung_bar(one_sum, plain, rung64)[0]
        return
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    plain = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy().astype(np.float64)
    got = _emulate_3xtf32(a, b, k_split, promote).astype(np.float64)
    ok, err, err_plain = _f64_ok(got, plain, ref64)
    assert ok, (err, err_plain)
    one_sum = _emulate_3xtf32(a, b, k_split, None).astype(np.float64)
    assert not _f64_ok(one_sum, plain, ref64)[0]
    one_pass = _split(a)[0] @ _split(b)[0]
    assert not _f64_ok(one_pass, plain, ref64)[0]


# the depths of gemm_tc_kernel's dense bf16 callers: qkv, proj and fc1's 384,
# s2t's 544, fc2's 768, dX of qkv's 1,152; split over mp = 2, proj's 192
# and fc2's 384, qkv's N 576 (dX of the split qkv: K 576)
NATIVE_DEPTHS = (384, 544, 768, 1152, 192, 576)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("k", NATIVE_DEPTHS)
def test_native_bf16_emulation_meets_rung_bars(k, scaled):
    """gemm_tc_kernel's native bf16 sums (on bf16-rounded operands: per
    32-deep stage a fresh partial of two k16 products, each rounded toward
    zero as the tensor cores add, joined to fp32 accumulators with a rounded
    add) meet the eval rung bar (mean and largest distance to the rung with
    float64 sums within 2x the fp32 plain version's) and so the training
    bar (largest 4x) at every dense caller's depth, split or not. With
    `scaled` A's rows carry dX's droppath factors (0 or 1/0.9), applied
    before the rounding as the kernel and the TPU do: a factor that is no
    power of two rounds another value than scaling after the product."""
    rng = np.random.default_rng(k + scaled)
    m, cols = 64, 32
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, cols)) * 0.05).astype(np.float32)
    if scaled:
        s = np.where(rng.uniform(size=m) < 0.9, 1 / 0.9, 0.0).astype(np.float32)
        assert not np.array_equal(_bf16(a * s[:, None]), _bf16(a) * s[:, None])
        a = a * s[:, None]
    a, b = _bf16(a), _bf16(b)
    rung64 = a.astype(np.float64) @ b.astype(np.float64)
    plain = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy().astype(np.float64)
    got = _emulate_bf16(a, b, k, 2).astype(np.float64)
    err, err_plain = np.abs(got - rung64), np.abs(plain - rung64)
    slack = 1e-6 * float(np.abs(rung64).max())
    assert err.mean() <= 2 * err_plain.mean() + slack, (err.mean(), err_plain.mean())
    assert err.max() <= 2 * err_plain.max() + slack, (err.max(), err_plain.max())
    assert _rung_bar(got, plain, rung64)[0]


def _atb_walk(m, n, rows, splits, run_end=None):
    """gemm_atb_kernel's walk as `launch_gemm_atb` and the kernel cut it: a
    block per (n tile, m tile, chunk) of 128 x 128 outputs and k_split rows
    (a multiple of 32), 32 rows a stage, loader lane l on row k0 + l; its X
    row's columns [m0, m_end) in runs (`run_end`: ConvTaps' runs of one tap;
    None: DenseRows, one run). Yields (chunk, m0, n0, row, runs) per row a
    loader lane copies, and (chunk, m0, n0, row, None) per lane that
    zero-fills."""
    k_split = -(-rows // splits)
    k_split = -(-k_split // 32) * 32
    for z in range(splits):
        k_begin = z * k_split
        k_end = min(rows, k_begin + k_split)
        ktiles = -(-(k_end - k_begin) // 32) if k_end > k_begin else 0
        for m0 in range(0, m, 128):
            for n0 in range(0, n, 128):
                m_end = min(m0 + 128, m)
                for it in range(ktiles):
                    for lane in range(32):
                        gk = k_begin + 32 * it + lane
                        if gk >= k_end:
                            yield z, m0, n0, gk, None
                            continue
                        runs, c = [], m0
                        while c < m_end:
                            e = run_end(c, m_end) if run_end else m_end
                            runs.append((c, e))
                            c = e
                        yield z, m0, n0, gk, runs


@pytest.mark.parametrize("m,n,rows,hidden", [
    (384, 1152, TRAIN_ROWS, None), (384, 384, TRAIN_ROWS, None), (384, 768, TRAIN_ROWS, None),
    (768, 384, TRAIN_ROWS, None), (4, 4, 1, None), (124, 132, 31, None), (132, 124, 33, None),
    (2304, 4, 71, None), (4, 2304, 257, None), (132, 1152, 8193, None),
    (3 * 768, 384, 512 * 23, 768), (3 * 256, 128, 7 * 11, 256), (3 * 100, 384, 5 * 13, 100),
])
def test_atb_walk_covers_every_tile_and_row_once(m, n, rows, hidden):
    """The mirror of gemm_atb_kernel's walk at the train step's dW and dWc
    shapes and at edges (m, n not multiples of 128, rows under a stage, a
    tap width that is not a multiple of 128): every output tile meets every
    row exactly once, in one chunk; rows past a chunk only pad its last
    stage; each tile row's columns [m0, m_end) are copied in runs that cover
    them once, each run within one tap."""
    splits = dw_splits(rows, m, n)
    run_end = None
    if hidden:
        run_end = lambda c, end: min(end, (c // hidden + 1) * hidden)  # noqa: E731
    seen, chunks, pads = {}, {}, {}
    for z, m0, n0, gk, runs in _atb_walk(m, n, rows, splits, run_end):
        if runs is None:  # zero-filled: past the chunk, in its last stage
            pads[z, m0, n0] = pads.get((z, m0, n0), 0) + 1
            assert pads[z, m0, n0] < 32
            continue
        key = (m0, n0, gk)
        assert key not in seen, key
        seen[key] = z
        chunks.setdefault(gk, z)
        assert chunks[gk] == z  # a row lies in one chunk, for every tile
        cols = [c for a, e in runs for c in range(a, e)]
        assert cols == list(range(m0, min(m0 + 128, m)))
        for a, e in runs:
            assert (e - a) % 4 == 0 and (a - m0) % 4 == 0  # 16-byte bulk copies
            if hidden:
                assert a // hidden == (e - 1) // hidden
    tiles = -(-m // 128) * -(-n // 128)
    assert len(seen) == tiles * rows
    assert sorted(chunks) == list(range(rows))
    assert max(chunks.values()) <= splits - 1


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


def test_gemm_digest_cases_fit_the_c_entries(monkeypatch):
    """Each case of `tools/gemm_digests.py` (every caller of gemm_tc_kernel
    and of gemm_atb_kernel, 3xTF32 and bf16) passes its C entries as many
    arguments as `cuda_lib` binds (the stream appended), W as that entry
    reads it (the TF32 halves (2, N, K) or the bf16 plane (N, K)), and has a
    recorded digest and a recorded parent time; a dW case sums the partials
    it launched into (`dw_splits` of them) with `sum_rows_f32`; at a cut
    size on the CPU."""
    from uplift_upsample_torch.tools import gemm_digests as gd
    monkeypatch.setattr(gd, "SERVING", 3 * 71)
    monkeypatch.setattr(gd, "TRAIN", 2 * 71)
    monkeypatch.setattr(gd, "CONV_WINDOWS", (3, 2))
    monkeypatch.setattr(gd, "DH1_WINDOWS", 2)
    monkeypatch.setattr(gd, "DWC_WINDOWS", (3, 2))
    cases = gd.all_cases(0, torch.device("cpu"))
    assert len(cases) == 34 and len({c.name for c in cases}) == 34
    gemm_cases = {c.name for c in cases if not c.then}
    assert gemm_cases == set(gd.GEMM_DIGESTS)
    assert {c.name for c in cases} - gemm_cases == set(gd.DW_DIGESTS)
    assert {c.name for c in cases} == set(gd.DIGESTS) == set(gd.PARENT_MS)
    for case in cases:
        for lib, fn, args in ((case.lib, case.fn, case.args),) + case.then:
            sig = cuda_lib._SIGNATURES[lib][fn]
            assert len(args) + 1 == len(sig), (case.name, fn)
            for a, kind in zip(args, sig):
                assert (kind == "p") == (a is None or torch.is_tensor(a)), (case.name, kind)
        if case.then:  # gemm_dw / strided_dwc into partials, then their sum
            part = case.args[4] if case.fn.startswith("gemm_dw") else case.args[2]
            rows = case.args[7] if case.fn.startswith("gemm_dw") else \
                case.args[3] * case.args[9]
            m, n = part.shape[1:]
            assert part.shape[0] == case.args[-1] == dw_splits(rows, m, n), case.name
            (lib, fn, args), = case.then
            assert fn == "sum_rows_f32" and args[0] is part and args[1] is case.outputs[0]
            assert args[2:] == [part.shape[0], m * n] and case.outputs[0].shape == (m, n)
        else:
            w = case.args[3] if case.fn.startswith("gemm_dx") else \
                case.args[2] if case.fn.startswith("strided_conv") else case.args[1]
            bf16 = case.fn.endswith("_bf16")
            assert w.dim() == (2 if bf16 else 3), case.name
            assert w.dtype == (torch.bfloat16 if bf16 else torch.float32), case.name
            if bf16:  # a build from before native bf16 is handed the same plane in fp32
                w32 = case.fp32_args[next(i for i, a in enumerate(case.args) if a is w)]
                assert w32.dtype == torch.float32 and torch.equal(w32.to(torch.bfloat16), w)
        assert all(t.dtype == torch.float32 for t in case.outputs)


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


# gemm_dw's (m, n, rows, per-window row scale): the train step's products and
# dWc's width at its 36,352 rows, then every pair of widths around the tile
# edges at row counts under, at and past a stage and a window
_DW_WIDTHS = (4, 124, 132, 384, 768, 1152, 2304)
DW_CASES = ([(m, n, TRAIN_ROWS, scaled) for m, n in
             ((768, 384), (384, 768), (384, 384), (384, 1152), (2304, 384))
             for scaled in (False, True)]
            + [(m, n, (1, 31, 33, 71)[i % 4], i % 3 != 0) for i, (m, n) in
               enumerate((m, n) for m in _DW_WIDTHS for n in _DW_WIDTHS)])


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n,rows,scaled", DW_CASES)
def test_gemm_dw_matches_plain(m, n, rows, scaled, bf16):
    """`gemm_dw_f32` / `gemm_dw_bf16` + the fixed-order sum: xᵀ @ (s · dy),
    s a per-window row scale or none. 3xTF32: to the grad bar and float64;
    bf16: on the rounded operands, to the training rungs' float64-sum bar. Both
    bit-identical on repeat (no float atomics), one launch a call."""
    _card()
    rng = np.random.default_rng(m * 7 + n + rows)
    per = 71
    x, dy = _rand(rng, rows, m), _rand(rng, rows, n, scale=1.0)
    scale, rs = None, torch.ones(rows, 1, device="cuda")
    if scaled:
        scale = torch.tensor(np.where(rng.uniform(size=-(-rows // per)) < 0.9, 1 / 0.9, 0.0),
                             dtype=torch.float32, device="cuda")
        rs = scale.repeat_interleave(per)[:rows, None]
    out = torch.empty((m, n), device="cuda")
    entry = "gemm_dw_bf16" if bf16 else "gemm_dw_f32"
    precision = "default" if bf16 else "high"
    cuda_lib.reset_launches()
    gemm_dw(x, dy, scale, per, out, counter="test", precision=precision)
    first = out.clone()
    gemm_dw(x, dy, scale, per, out, counter="test", precision=precision)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[entry] == 2 and torch.equal(first, out)
    dys = dy * rs
    if bf16:
        xr, dyr = _bf16_round(x), _bf16_round(dys)
        rung64 = xr.double().t() @ dyr.double()
        ok, err, err_plain = _rung_bar(out.double().cpu().numpy(),
                                       (xr.t() @ dyr).double().cpu().numpy(),
                                       rung64.cpu().numpy())
        assert ok, (err, err_plain)
        return
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


# -- the pipelined kernel: its schedule's edges and the parent's bits -----------

def _tiles(t):
    """Rows giving t 128 x 128 tiles at n = 128, the last one partial (one
    block per SM walks them: 131, 132, 133 and 265 leave SMs a tile more than
    others, or none)."""
    return 91 if t == 1 else 128 * t - 37


EDGES = ([(_tiles(t), 128) for t in (1, 131, 132, 133, 2 * 132 + 1)]
         + [(m, 384) for m in (1, 64, 65, 127, 129)]
         + [(1031, n) for n in (8, 120, 384, 1152, 2304)])


def _bf16_round(x):
    return x.to(torch.bfloat16).to(x.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n", EDGES)
def test_schedule_edges(m, n, bf16):
    """`gemm_f32` / `gemm_bf16` (bias, relu, a residual) at tile counts and
    at m and n around the tile edges: against the plain version (at bf16 on
    the rounded operands) and float64, and bit-identical on repeat."""
    _card()
    rng = np.random.default_rng(m * 31 + n)
    k = 384
    a, w, bias = _rand(rng, m, k), _rand(rng, k, n, scale=0.05), _rand(rng, n, scale=0.1)
    res = _rand(rng, m, n)
    if bf16:
        from uplift_upsample_torch.ops.temporal import bf16_plane
        w_op, a_r, w_r = bf16_plane(w), _bf16_round(a), _bf16_round(w)
    else:
        w_op, a_r, w_r = tf32_halves(w), a, w
    precision = "default" if bf16 else "high"
    got = gemm(a, w_op, bias, residual=res, relu=True, precision=precision, counter=None)
    again = gemm(a, w_op, bias, residual=res, relu=True, precision=precision, counter=None)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = torch.relu(a_r @ w_r + bias) + res
    assert _close(got, ref)
    ref64 = torch.relu(a_r.double() @ w_r.double() + bias.double()) + res.double()
    ok, err, err_plain = _f64_card(got, ref, ref64)
    assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_aliased_residual_schedule(bf16):
    """fc2's sublayer, `out` = `residual`, over 265 tiles: the epilogue
    threads read each residual element before they write it."""
    _card()
    rng = np.random.default_rng(265)
    m, k, n = _tiles(265), 768, 128
    a, w, bias, h = _rand(rng, m, k), _rand(rng, k, n, scale=0.05), _rand(rng, n), _rand(rng, m, n)
    from uplift_upsample_torch.ops.temporal import bf16_plane
    w_op = bf16_plane(w) if bf16 else tf32_halves(w)
    a_r, w_r = (_bf16_round(a), _bf16_round(w)) if bf16 else (a, w)
    ref = a_r @ w_r + bias + h
    out = gemm(a, w_op, bias, residual=h, out=h, precision="default" if bf16 else "high",
               counter=None)
    torch.cuda.synchronize()
    assert out.data_ptr() == h.data_ptr() and _close(h, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [129, 2 * 132 * 128 + 1])
def test_bf16_row_scale(m):
    """`gemm_dx_bf16` (TmaAScaled: each row of dY times its factor before its
    bf16 rounding) with a relu mask, against the plain version on the rounded
    operands and float64, bit-identical on repeat."""
    _card()
    rng = np.random.default_rng(m)
    k, n, per = 384, 768, 71
    dy, w = _rand(rng, m, k, scale=1.0), _rand(rng, n, k, scale=0.05)
    scale = torch.tensor(np.where(rng.uniform(size=-(-m // per)) < 0.9, 1 / 0.9, 0.0),
                         dtype=torch.float32, device="cuda")
    mask = torch.relu(_rand(rng, m, n))
    from uplift_upsample_torch.ops.temporal import bf16_plane
    plane = bf16_plane(w, transpose=False)
    got = gemm_dx(dy, scale, per, plane, mask=mask, counter=None, precision="default")
    again = gemm_dx(dy, scale, per, plane, mask=mask, counter=None, precision="default")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    a_r = _bf16_round(dy * scale.repeat_interleave(per)[:m, None])
    keep = (mask > 0).float()
    ref = a_r @ plane.float().t() * keep
    assert _grad_close(got, ref)
    ok, err, err_plain = _f64_card(got, ref, a_r.double() @ plane.double().t() * keep.double())
    assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [3, 2])
@pytest.mark.parametrize("windows", [7, 1031])
def test_gathered_a_schedule(stride, windows):
    """The conv's gathered A (the loader threads' row table and cp.async) at
    strides 3 and 2, from one tile to a few waves: against the plain conv and
    float64, bit-identical on repeat."""
    from uplift_upsample_torch.ops.strided import strided_conv, strided_conv_plain
    from uplift_upsample_torch.ops.temporal import add_tf32_halves
    _card()
    rng = np.random.default_rng(windows + stride)
    n, c, hidden = 71, 384, 768
    h1, x = torch.relu(_rand(rng, windows, n, hidden)), _rand(rng, windows, n, c)
    ops = add_tf32_halves(dict(wc=_rand(rng, 3 * hidden, c, scale=0.03),
                               bc=_rand(rng, c, scale=0.1)), ("wc",))
    kw = dict(stride=stride, paddings=(0, 0))
    got, again = strided_conv(h1, x, ops, counter=None, **kw), strided_conv(h1, x, ops, counter=None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = strided_conv_plain(h1, x, ops["wc"], ops["bc"], **kw)
    assert _close(got, ref)
    ref64 = strided_conv_plain(h1.double(), x.double(), ops["wc"].double(), ops["bc"].double(),
                               **kw)
    ok, err, err_plain = _f64_card(got, ref, ref64)
    assert ok, (err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_gemm_digests_equal_the_parent_build(bf16):
    """Every caller of gemm_tc_kernel and gemm_atb_kernel (`tools/gemm_digests.py`)
    at its main path's shape gives its recorded bits (`GEMM_DIGESTS`: the
    build before the pipelined kernel; `DW_DIGESTS`), and the same bits on a
    second call."""
    from uplift_upsample_torch.tools import gemm_digests as gd
    dev = _card()
    libs = gd.port_libs()
    for case in gd.cases(0, bf16, dev) + gd.dw_cases(0, bf16, dev):
        first, again = gd.digest(libs, case), gd.digest(libs, case)
        assert first == again, case.name
        assert first == gd.DIGESTS[case.name], case.name
