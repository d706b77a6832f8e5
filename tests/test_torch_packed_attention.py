"""Row 11, packed multi-head attention, and its wiring into the port's model.

CPU tests: `packed_attention_plain` (the op's CPU path) against the JAX
package's Pallas kernel in interpret mode, as tests/test_pallas_attention.py
runs it; the port's model with `use_pallas=True` against the JAX model with
`use_pallas=True`; USE_PALLAS_ATTENTION reaching the op from the config.

`gpu` tests: the CUDA kernels against their plain version and float64 on the
card, at the h36m_351 shapes and at odd ones, and a second call bit for bit.
They decide inside the test whether there is a card. JAX is imported inside
the CPU tests only, so this file also runs where JAX is not installed (the
card's machine).
"""

import os

import numpy as np
import pytest
import torch

from uplift_upsample_torch.models import UpliftUpsampleTransformer
from uplift_upsample_torch.models import primitives
from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.packed_attention import (packed_attention_plain,
                                                        packed_multihead_attention)
from uplift_upsample_torch.utils.weights_h5 import load_keras_h5

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL = os.path.join(FIXTURE_DIR, "small_strided")
# tests/test_pallas_attention.py:63-68, the small_strided.h5 geometry
SMALL_KWARGS = dict(
    num_frames=9, num_keypoints=17, spatial_d_model=16, temporal_d_model=32,
    spatial_depth=2, temporal_depth=2, strides=(3, 3), paddings=((0, 0), (0, 0)),
    num_heads=4, mlp_ratio=2.0, qkv_bias=True, drop_path_rate=(0.0, 0.0, 0.0),
    has_strided_input=True, first_strided_token_attention_layer=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs six
    workers on the CPU's cores, and OpenMP pools of one thread per core in
    each worker spin against each other and against XLA's threads in the
    JAX tests beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv_mask(rng, f, s, c, masked):
    """masked: False (no mask), True (random keys blocked) or "blocked"
    (random, and every key of every third sequence blocked)."""
    q, k, v = (rng.normal(size=(f, s, c)).astype(np.float32) for _ in range(3))
    mask = (rng.uniform(size=(f, s)) < 0.5) if masked else None
    if masked == "blocked":
        mask[::3] = True
    return q, k, v, mask


def _assert_fp32_level(got, ref, ref64):
    """The kernel's error against a float64 reference at most 4x the fp32
    plain version's, plus 1e-6 of the output scale: 3xTF32 keeps fp32-level
    sums, where one TF32 pass (10 bits) would miss by ~1e-3."""
    err = float((got.double() - ref64).abs().max())
    err_plain = float((ref.double() - ref64).abs().max())
    assert err <= 4 * err_plain + 1e-6 * float(ref64.abs().max()), (err, err_plain)


@pytest.mark.parametrize("s,depth,masked", [
    (17, 4, False), (17, 4, True), (23, 8, False), (23, 4, True),
    (71, 8, True), (71, 4, False), (128, 4, True), (71, 4, "blocked"),
    (3, 48, False), (3, 48, True),  # strided block 3's 3 x 384 (h36m_351)
])
def test_plain_matches_pallas_interpret(s, depth, masked):
    """packed_attention_plain against the interpret-mode Pallas kernel, 8
    heads, an odd frame count: 1e-5 (tests/test_pallas_attention.py:49-50);
    also at the longest sequence (128) and with rows whose keys are all
    blocked (the finite mask still gives them a softmax over every key)."""
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_attention import packed_multihead_attention as jax_op

    rng = np.random.default_rng(s * 10 + depth)
    q, k, v, mask = _qkv_mask(rng, 6, s, 8 * depth, masked)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_op(q, k, v, mask, num_heads=8)
    got = packed_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                 None if mask is None else torch.from_numpy(mask),
                                 num_heads=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _small_models(use_pallas):
    from uplift_upsample_tpu.models import UpliftUpsampleTransformer as JaxModel
    from uplift_upsample_tpu.utils.weights_h5 import load_keras_h5 as jax_load

    jmodel = JaxModel(use_pallas=use_pallas, drop_rate=0.0, **SMALL_KWARGS)
    variables = jax_load(SMALL + ".h5", jmodel)
    model = UpliftUpsampleTransformer(use_pallas=use_pallas, **SMALL_KWARGS).eval()
    load_keras_h5(SMALL + ".h5", model)
    return jmodel, variables, model


def test_model_pallas_flag_matches_jax():
    """The port's model with use_pallas=True against the JAX model with
    use_pallas=True (its Pallas kernel in interpret mode), same .h5 and
    inputs: 2e-5 / 1e-4 (tests/test_pallas_attention.py:79-80)."""
    from jax.experimental.pallas import tpu as pltpu

    import jax

    jmodel, variables, model = _small_models(use_pallas=True)
    data = np.load(SMALL + ".npz")
    # One jitted computation: applied eagerly, the host would dispatch the
    # next ops while an interpreted kernel's callbacks dispatch their own on
    # the same CPU device, which can deadlock.
    apply = jax.jit(lambda v, x, sm: jmodel.apply(v, x, stride_mask=sm, training=False))
    with pltpu.force_tpu_interpret_mode():
        j_full, j_central = apply(variables, data["x_masked"], data["stride_mask"])
    with torch.inference_mode():
        full, central = model(torch.from_numpy(data["x_masked"]),
                              torch.from_numpy(data["stride_mask"]))
    np.testing.assert_allclose(central.numpy(), np.asarray(j_central), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(full.numpy(), np.asarray(j_full), atol=2e-5, rtol=1e-4)


def test_config_flag_reaches_packed_attention(monkeypatch):
    """USE_PALLAS_ATTENTION → model_kwargs → every attention layer calls the
    row-11 op (its plain version on the CPU): 2 spatial, 2 temporal (the
    first with its key mask) and 2 strided layers per forward; without the
    flag none does."""
    from uplift_upsample_torch.configs import resolve_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer

    calls = []

    def counting(q, k, v, mask=None, *, num_heads, precision="high"):
        calls.append((tuple(q.shape), None if mask is None else tuple(mask.shape)))
        return packed_multihead_attention(q, k, v, mask, num_heads=num_heads,
                                          precision=precision)

    monkeypatch.setattr(primitives, "packed_multihead_attention", counting)
    config = resolve_config(os.path.join(FIXTURE_DIR, "eval_small_config.json"))
    data = np.load(SMALL + ".npz")
    x, sm = torch.from_numpy(data["x_masked"]), torch.from_numpy(data["stride_mask"])
    outs = {}
    for flag in (False, True):
        config.USE_PALLAS_ATTENTION = flag
        model = load_keras_h5(SMALL + ".h5",
                              build_uplift_upsample_transformer(config, device="cpu"))
        assert all(m.use_pallas == flag for m in model.modules()
                   if isinstance(m, primitives.MultiHeadAttention))
        calls.clear()
        with torch.inference_mode():
            outs[flag] = model(x, sm)[1]
        if not flag:
            assert calls == []
    b = x.shape[0]
    assert len(calls) == 6
    assert calls[0] == ((b * 9, 17, 16), None)            # spatial block 1
    assert calls[2] == ((b, 9, 32), (b, 9))               # temporal block 1, key mask
    assert calls[3] == ((b, 9, 32), None)
    assert calls[5] == ((b, 3, 32), None)                 # strided block 2
    torch.testing.assert_close(outs[True], outs[False], atol=2e-5, rtol=1e-4)


def test_training_with_pallas_raises(monkeypatch):
    """The op has no backward (the JAX kernel has no VJP of its own):
    training with USE_PALLAS_ATTENTION and no attention dropout raises
    instead of differentiating something else. With attention dropout the
    JAX gate takes the split-head path in training (`primitives.py:95`),
    and so does the port: it trains without calling row 11's op."""
    model = UpliftUpsampleTransformer(use_pallas=True, **SMALL_KWARGS).train()
    x = torch.zeros(2, 9, 17, 2)
    with pytest.raises(NotImplementedError, match="USE_PALLAS_ATTENTION"):
        model(x, torch.ones(2, 9, dtype=torch.bool))
    calls = []
    monkeypatch.setattr(primitives, "packed_multihead_attention",
                        lambda *a, **kw: calls.append(a))
    model = UpliftUpsampleTransformer(use_pallas=True, attn_drop_rate=0.1,
                                      **SMALL_KWARGS).train()
    _, central = model(torch.randn(2, 9, 17, 2), torch.ones(2, 9, dtype=torch.bool))
    central.sum().backward()
    assert torch.isfinite(model.spatial_block_1.attn.wq.weight.grad).all() and not calls


def test_wrapper_takes_plain_path_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    rng = np.random.default_rng(3)
    q, k, v, mask = (torch.from_numpy(t) for t in _qkv_mask(rng, 5, 17, 32, True))
    cuda_lib.reset_launches()
    got = packed_multihead_attention(q, k, v, mask, num_heads=8)
    torch.testing.assert_close(got, packed_attention_plain(q, k, v, mask, num_heads=8),
                               rtol=0, atol=0)
    assert sum(cuda_lib.LAUNCHES.values()) == 0


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("f,s,c,heads,masked", [
    (1027, 17, 32, 8, False),   # spatial blocks, a thread per (frame, query, head)
    (1, 17, 32, 8, False),      # frame counts off the 4-frame group
    (31, 17, 32, 8, False),
    (33, 17, 32, 8, False),
    (72704, 17, 32, 8, False),  # the serving call's spatial shape
    (1027, 17, 32, 8, True),
    (1027, 17, 32, 8, "blocked"),
    (33, 71, 384, 8, True),     # temporal block 1, one block per (window, head)
    (33, 71, 384, 8, False),
    (33, 23, 384, 8, False),    # strided block 2
    (65, 3, 384, 8, False),     # strided block 3, one warp per window
    (65, 3, 384, 8, True),
    (65, 3, 384, 8, "blocked"),
    (1024, 3, 384, 8, False),   # the eval call's strided block 3
    (31, 12, 128, 8, True),     # a warp per frame at C = 128 and 256 (16 heads)
    (31, 6, 256, 16, "blocked"),
    (129, 9, 32, 4, True),      # head depth 8
    (33, 41, 32, 8, True),      # more than 17 keys: the running max over chunks
    (9, 71, 16, 4, "blocked"),
    (17, 24, 64, 4, False),     # head depths 16, 32, 48 and 64 on the task kernel
    (17, 24, 64, 2, True),
    (5, 8, 96, 2, True),
    (17, 24, 64, 1, True),
    (7, 128, 40, 8, True),      # head depth 5: the per-(sequence, head) kernel
    (9, 1, 384, 8, "blocked"),  # one real key among 8 padded ones
    (11, 72, 384, 8, True),
    (5, 80, 384, 8, False),
    (3, 128, 384, 8, True),
    (13, 71, 384, 8, "blocked"),  # padded keys must not share an all-blocked row
    (17, 23, 384, 8, "blocked"),
])
def test_packed_attention_kernel_matches_plain(f, s, c, heads, masked):
    dev = _card()
    rng = np.random.default_rng(f + s)
    q, k, v, mask = (None if t is None else torch.from_numpy(t).to(dev)
                     for t in _qkv_mask(rng, f, s, c, masked))
    cuda_lib.reset_launches()
    got = packed_multihead_attention(q, k, v, mask, num_heads=heads)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["packed_attention"] == 1
    ref = packed_attention_plain(q, k, v, mask, num_heads=heads)
    ref64 = packed_attention_plain(q.double(), k.double(), v.double(), mask,
                                   num_heads=heads)
    # fp32 sums over S <= 128 keys in another order: 2e-4 of the output scale
    assert float((got - ref).abs().max()) <= 2e-4 * max(1.0, float(ref.abs().max()))
    _assert_fp32_level(got, ref, ref64)
    # every kernel sums in a fixed order, without atomics
    assert torch.equal(packed_multihead_attention(q, k, v, mask, num_heads=heads), got)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True, "blocked"])
def test_window_attention_kernel_matches_plain(masked):
    """K2's window attention (the same kernel on the packed q|k|v rows, row
    stride 3C) against window_attention_plain on 37 windows of 71 frames at
    h36m_351 width: the 2e-4 bar and the float64 criterion."""
    from uplift_upsample_torch.ops.temporal import window_attention, window_attention_plain
    dev = _card()
    rng = np.random.default_rng(71)
    b, n, c, heads = 37, 71, 384, 8
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * c)).astype(np.float32)).to(dev)
    km = None
    if masked:
        km = torch.from_numpy((rng.uniform(size=(b, n)) < 0.5).astype(np.float32))
        if masked == "blocked":
            km[::3] = 1.0
        km = km.to(dev)
    cuda_lib.reset_launches()
    got = window_attention(qkv.reshape(b * n, 3 * c), km, windows=b, n=n, num_heads=heads,
                           counter="probe").reshape(b, n, c)
    ref = window_attention_plain(qkv, km, heads)
    ref64 = window_attention_plain(qkv.double(), None if km is None else km.double(), heads)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["window_attention_f32"] == 1
    assert float((got - ref).abs().max()) <= 2e-4 * max(1.0, float(ref.abs().max()))
    _assert_fp32_level(got, ref, ref64)
