"""Row 11 on the bf16 rung and on bf16 operands (`ops/packed_attention.py`,
`csrc/attention_bf16.cu`).

CPU tests:
  - `packed_attention_plain` at "default" against a float64 emulation of
    `pallas_attention._head_attention` under the DEFAULT dot: at head depth
    4 the logits are exact products (the VPU path, `:36-41`), at depth 48
    bf16(q)·bf16(k); scaled after the product, masked, a softmax, and
    bf16(P)·bf16(v), every sum float64 (the key mask added in fp32, as the
    kernel adds it). With and without a key mask. Bar:
    mean within 0.02 and largest within 0.25 of the rung's drift (the
    emulation against the same attention unrounded); measured at most
    0.0004 / 0.014 (fp32 sums where the emulation's are float64);
  - on bf16 operands against the JAX `packed_multihead_attention` in
    interpret mode on bf16 inputs (on the CPU the "high" function: the
    kernel widens to fp32 and writes bf16): the port's output is bf16 and
    within one bf16 unit in the last place of the JAX output (two fp32
    results that round to neighbouring bf16 values), at most 1 % of the
    elements apart (measured 0.05 %);
  - the bf16 rung on bf16 operands is the rung's function of the widened
    operands, rounded once.
`gpu` tests (skipped without a card): each kernel mode against its plain
version on the card at row 11's four h36m_351 shapes (frames cut) and at
odd ones (head depths 3 to 48, more than 17 keys). On the bf16 rung the
mean gap within 0.25 of the rung's mean drift from "high" (phase 11's bar
for one block), and every output within PR 16's largest bar (4x the
plain version's largest distance to the rung with float64 sums) plus the
flips' allowance: both round the same operands, but the kernel's base-2
softmax and sum order round a P that lies at a bf16 tie the other way now
and then, which moves an output by one bf16 unit of P times |v|
(`bf16_flip_allowance`). A CPU test holds that bar's power: the plain
version with a base-2 softmax passes it and an unrounded one fails it, at
row 11's four shapes. bf16 tensors at "high" within one bf16 unit of the
plain version; a second call bit for bit. JAX is imported inside the CPU
tests only.
"""

import math

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.packed_attention import (bf16_flip_allowance,
                                                        packed_attention_plain,
                                                        packed_multihead_attention)

HEADS = 8
CASES = [  # (frames, tokens, head depth, key mask): the spatial and temporal regimes
    (7, 17, 4, False), (7, 17, 4, True), (5, 71, 48, True), (5, 23, 48, False),
    (9, 3, 48, False), (9, 3, 48, True)]
BF16_ULP = 2.0 ** -7  # a bf16 unit in the last place is at most this of the value


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, f, s, c, masked, device="cpu"):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(f, s, c)).astype(np.float32)).to(device)
               for _ in range(3))
    mask = None
    if masked:
        mask = torch.from_numpy((rng.uniform(size=(f, s)) < 0.4).astype(np.float32))
        mask[::3] = 1.0  # every key of every third sequence blocked
        mask = mask.to(device)
    return q, k, v, mask


def _head_attention64(q, k, v, mask, heads, rounded):
    """`_head_attention` of every head in float64: the DEFAULT dots' operands
    rounded to bf16 (`rounded`) beyond depth 8, P rounded for P·V."""
    f, s, c = q.shape
    d = c // heads
    r = (lambda t: t.float().to(torch.bfloat16).double()) if rounded else (lambda t: t)
    qh, kh, vh = (t.double().reshape(f, s, heads, d).transpose(1, 2) for t in (q, k, v))
    qk = (lambda t: t) if d <= 8 else r
    logits = qk(qh) @ qk(kh).transpose(-1, -2) * (1.0 / math.sqrt(d))
    if mask is not None:  # added in fp32, as the kernel adds it: a blocked key is -1e9
        logits = (logits.float() + mask[:, None, None, :].float() * -1e9).double()
    ctx = r(torch.softmax(logits, dim=-1)) @ r(vh)
    return ctx.transpose(1, 2).reshape(f, s, c)


def _gap(a, b):
    d = (a.double() - b.double()).abs()
    return float(d.mean()), float(d.max())


def _within_flips(got, plain, q, k, v, mask, rung="default"):
    """PR 16's largest bar for the bf16 rung, through the rung with float64
    sums: every output of `got` within 4x the plain version's largest
    distance to it, taken off the P ties, plus the flips' allowance
    (`bf16_flip_allowance`) where a P of its row is at a tie. A sequence
    whose keys are all blocked has no float64 reference (fp32's -1e9
    absorbs its logits whole, a uniform P in both versions): its outputs
    are held to the plain version within the same 4x."""
    rung64 = packed_attention_plain(q.double(), k.double(), v.double(), mask,
                                    num_heads=HEADS, precision=rung)
    allowance = bf16_flip_allowance(q, k, v, mask, num_heads=HEADS)
    err, err_plain = (got.double() - rung64).abs(), (plain.double() - rung64).abs()
    dead = torch.zeros(q.shape[0], dtype=torch.bool) if mask is None else mask.bool().all(-1)
    dead = dead.cpu()[:, None, None].expand_as(err.cpu()).to(err.device)
    off = (allowance == 0) & ~dead
    bar = 4 * float(err_plain[off].max()) + 1e-6 * float(rung64[~dead].abs().max())
    err = torch.where(dead, (got.double() - plain.double()).abs(), err)
    return bool((err <= bar + allowance).all()), float((err - bar - allowance).max())


ROW11_SHAPES = [  # (frames, tokens, channels, key mask): row 11's four shapes, frames cut
    (1024, 3, 384, False), (96, 23, 384, False), (32, 71, 384, True), (1024, 17, 32, False)]


@pytest.mark.parametrize("f,s,c,masked", ROW11_SHAPES)
def test_flip_allowance_holds_a_second_formulation(f, s, c, masked):
    """The bf16 rung's largest bar (chip_smoke's `row11_checks`) on the CPU:
    the plain version with the kernels' base-2 softmax, whose P differs
    from the plain version's by fp32 units and so rounds some P at a tie
    the other way, passes; a version that rounds nothing does not."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    q, k, v, mask = _inputs(f * s + c, f, s, c, masked)
    plain = packed_attention_plain(q, k, v, mask, num_heads=HEADS, precision="default")
    base2 = smoke.row11_base2_plain(torch, q, k, v, mask, HEADS)
    assert _within_flips(base2, plain, q, k, v, mask)[0]
    unrounded = packed_attention_plain(q, k, v, mask, num_heads=HEADS, precision="high")
    assert not _within_flips(unrounded, plain, q, k, v, mask)[0]


@pytest.mark.parametrize("f,s,d,masked", CASES)
def test_plain_at_default_matches_the_float64_emulation(f, s, d, masked):
    q, k, v, mask = _inputs(f * s + d, f, s, HEADS * d, masked)
    got = packed_attention_plain(q, k, v, mask, num_heads=HEADS, precision="default")
    emu = _head_attention64(q, k, v, mask, HEADS, rounded=True)
    exact = _head_attention64(q, k, v, mask, HEADS, rounded=False)
    (g_mean, g_max), (d_mean, d_max) = _gap(got, emu), _gap(emu, exact)
    assert d_mean > 0
    assert g_mean <= 0.02 * d_mean and g_max <= 0.25 * d_max, (g_mean / d_mean, g_max / d_max)
    # the rung is read: "high" is the unrounded function
    high = packed_attention_plain(q, k, v, mask, num_heads=HEADS, precision="high")
    assert _gap(high, exact)[1] <= 1e-5


@pytest.mark.parametrize("f,s,d,masked", CASES)
def test_bf16_operands_match_the_jax_kernel(f, s, d, masked):
    """bf16 q, k, v through the interpret-mode Pallas kernel (jitted) and the
    port's plain version: bf16 outputs within one bf16 unit."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_attention import packed_multihead_attention as jax_op

    q, k, v, mask = _inputs(f * s + d + 1, f, s, HEADS * d, masked)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    jm = None if mask is None else jnp.asarray(mask.numpy())
    fn = jax.jit(lambda a, b, c_, m: jax_op(a, b, c_, m, num_heads=HEADS))
    with pltpu.force_tpu_interpret_mode():
        ref = fn(jq, jk, jv, jm)
    assert ref.dtype == jnp.bfloat16
    ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
    got = packed_attention_plain(q, k, v, mask, num_heads=HEADS)
    assert got.dtype == torch.bfloat16
    diff = (got.float() - ref).abs()
    assert bool((diff <= BF16_ULP * ref.abs()).all()), float(diff.max())
    assert float((diff > 0).float().mean()) <= 0.01


@pytest.mark.parametrize("f,s,d,masked", CASES[:3])
def test_bf16_operands_on_the_bf16_rung(f, s, d, masked):
    """The rung's function of the widened operands, rounded once to bf16."""
    q, k, v, mask = _inputs(f * s + d + 2, f, s, HEADS * d, masked)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = packed_attention_plain(qb, kb, vb, mask, num_heads=HEADS, precision="default")
    want = packed_attention_plain(qb.float(), kb.float(), vb.float(), mask, num_heads=HEADS,
                                  precision="default").to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# -- on the card ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


SHAPES = [  # row 11's h36m_351 shapes (frames cut), then odd ones
    (4099, 17, 32, False), (64, 71, 384, True), (64, 23, 384, False), (256, 3, 384, False),
    (33, 17, 32, True), (65, 3, 384, True), (31, 12, 128, True), (17, 24, 64, False),
    (5, 8, 96, True), (7, 128, 40, True), (13, 71, 384, True), (129, 9, 32, True),
    (33, 41, 32, True), (31, 5, 24, False)]
ENTRIES = {(torch.float32, "default"): "packed_attention_bf16",
           (torch.bfloat16, "high"): "packed_attention_bf16io",
           (torch.bfloat16, "default"): "packed_attention_bf16io_bf16"}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rung", list(ENTRIES))
@pytest.mark.parametrize("f,s,c,masked", SHAPES)
def test_kernel_mode_matches_plain(dtype, rung, f, s, c, masked):
    dev = _card()
    q, k, v, mask = _inputs(f + s + c, f, s, c, masked, dev)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    cuda_lib.reset_launches()
    got = packed_multihead_attention(q, k, v, mask, num_heads=HEADS, precision=rung)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[ENTRIES[dtype, rung]] == 1 and got.dtype == dtype
    ref = packed_attention_plain(q, k, v, mask, num_heads=HEADS, precision=rung)
    if rung == "high":  # fp32-level sums, rounded to bf16 as they are stored
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= BF16_ULP * ref.float().abs() + 1e-6).all()), float(diff.max())
    else:  # sum orders and the softmax's base differ: a P at a tie rounds either way
        high = packed_attention_plain(q, k, v, mask, num_heads=HEADS, precision="high")
        (g_mean, _), (d_mean, _) = _gap(got, ref), _gap(ref, high)
        assert g_mean <= 0.25 * d_mean, g_mean / d_mean
        ok, past = _within_flips(got, ref, q, k, v, mask)
        assert ok, past
    assert torch.equal(packed_multihead_attention(q, k, v, mask, num_heads=HEADS,
                                                  precision=rung), got)
