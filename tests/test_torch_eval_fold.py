"""C7: the eval kernels' folded q scale (ROADMAP C7).

The TPU's eval kernels multiply q's columns of the qkv weights and biases by
fp32(1/sqrt(D)) before their dot and scale nothing after it
(`pallas_temporal_v3._transposed_operands(q_scale=)`, `:319-322`, for K2's
blocks; `pallas_strided.stack_strided_block1_params(fold_q_scale=True)` for
K3's). On the bf16 rung q is then bf16(y)·bf16(fp32(Wq·s)) + bq·s and the
logits bf16(q)·bf16(k); rounding the unscaled q and scaling the logits
after the product is another function, since s is no power of two.

On an h36m_351-shaped model cut to two blocks a stack, C = 96 in 2 heads
(the head depth 48 of h36m_351), JAX init, six windows of 27 frames from a
numpy seed, a mask stride of 5 with two phases:

  (a) the port's eval operands (`prepare_fused_params`) equal, bit for bit,
      the JAX kernels' folded ones on the same parameters, and their bf16
      planes are the planes of the folded weights;
  (b) the plain K2 (`temporal_stack_plain`, key mask in block 1) and K3
      (`strided_block1_plain`) at "default" on those operands match a
      float64 emulation of the TPU kernels built on the JAX operands: each
      dot on bf16-rounded operands with float64 sums, the rest float64.
      The bar is 0.1 of the rung's own mean drift (the emulation against
      the same blocks with no rounding) for the mean distance and 0.5 of
      its largest for the largest; measured 0.0013 / 0.146 (K2) and
      below 1e-4 / 1e-4 (K3);
  (c) the unfolded function (what the port computed before C7: operands
      without the fold, the logits scaled after the product) misses that
      emulation by at least 0.3 of the drift, mean (measured 0.81 for K2,
      0.78 for K3, the gap logged in ROADMAP C7); (b) is the test that
      fails on the unrepaired code, whose eval operands were these;
  (d) the fused step at "default" follows the port's drift simulator on
      its folded map (`sim_drift.FUSED_FOLDED`) within 0.6 of the drift, the
      bar `test_torch_precision.py` holds the step to against the JAX
      simulator, and at most 0.75 of its distance to the unfolded map
      (measured 0.22 and 0.52: the sums of K1's plain version and of the
      simulator's spatial stage part in order and flip a few bf16
      roundings of the s2t Dense);
  (e) the training kernels' entry points refuse the folded operands.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.eval import make_test_step
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.models.bench_forward import prepare_fused_params
from uplift_upsample_torch.ops.strided import (stack_strided_block1_params,
                                               strided_block1_plain)
from uplift_upsample_torch.ops.temporal import stack_temporal_params, temporal_stack_plain
from uplift_upsample_torch.tools import sim_drift as tsim
from uplift_upsample_torch.utils.weights_h5 import params_from_jax

OVERRIDES = {
    "SEQUENCE_LENGTH": 27, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 32,
    "TEMPORAL_EMBED_DIM": 96, "SPATIAL_TRANSFORMER_BLOCKS": 2,
    "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3, 3],
    "PADDINGS": [[0, 0], [0, 0], [0, 0]], "NUM_HEADS": 2,
    "MASK_STRIDE": 5, "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1,
    "DROP_PATH_RATE": [0.1, 0.1, 0.0],
}
MEAN_BAR, MAX_BAR = 0.1, 0.5   # (b): of the rung's drift
GAP = 0.3                      # (c): the unfolded function's least distance
STEP_BAR, CLOSER = 0.6, 0.75   # (d): of the drift; of the distance to the unfolded map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    """The JAX init in both packages, its folded kernel operands, inputs."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.ops.pallas_strided import stack_strided_block1_params as jax_strided
    from uplift_upsample_tpu.ops.pallas_temporal import stack_temporal_params as jax_stack
    from uplift_upsample_tpu.ops.pallas_temporal_v3 import _transposed_operands

    jconfig = JaxConfig()
    jconfig.update_from(OVERRIDES)
    variables = init_model_params(jax_build(jconfig), seed=0)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), variables["params"])
    config = UpliftUpsampleConfig()
    config.update_from(OVERRIDES)
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax(variables))
    c, heads, blocks = config.TEMPORAL_EMBED_DIM, config.NUM_HEADS, 2
    temporal = _transposed_operands(jax_stack(params, blocks), blocks, jnp.float32,
                                    q_scale=1.0 / np.sqrt(c // heads))
    strided = jax_strided(params, config.SEQUENCE_LENGTH, weights_dtype=jnp.float32,
                          num_heads=heads, fold_q_scale=True)
    rng = np.random.default_rng(0)
    b, n = 6, config.SEQUENCE_LENGTH
    sm = (np.arange(n) % 5 == 0)[None].repeat(b, axis=0)
    sm[1] = np.roll(sm[1], 2)
    x2d = (rng.normal(size=(b, n, 17, 2)) * 0.3).astype(np.float32) * sm[:, :, None, None]
    y = rng.normal(size=(b, n, c)).astype(np.float32)
    return dict(config=config, model=model, heads=heads,
                temporal=[np.asarray(a) for a in temporal],
                strided={k: np.asarray(v) for k, v in strided.items()},
                x2d=torch.from_numpy(x2d), sm=torch.from_numpy(sm), y=torch.from_numpy(y),
                key_mask=torch.from_numpy(1.0 - sm.astype(np.float32)))


def _f64(a):
    return torch.from_numpy(np.array(a, np.float64))


def _dot(a, b, rounded):
    """a @ b in float64, both operands rounded to bf16 first if `rounded`."""
    r = (lambda t: t.float().to(torch.bfloat16).double()) if rounded else (lambda t: t)
    return r(a) @ r(b)


def _attention64(y, wqkv_t, bqkv, heads, key_mask, rounded):
    """The TPU kernel's attention on folded operands (q carries 1/sqrt(D),
    no factor after q·kᵀ): (B, N, C) → (B, N, C) context, float64."""
    b, n, c = y.shape
    d = c // heads
    qkv = _dot(y, wqkv_t.T, rounded) + bqkv
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in qkv.split(c, dim=-1))
    logits = _dot(q, k.transpose(-1, -2), rounded)
    if key_mask is not None:
        logits = logits + key_mask.double()[:, None, None, :] * -1e9
    ctx = _dot(torch.softmax(logits, dim=-1), v, rounded)
    return ctx.transpose(1, 2).reshape(b, n, c)


def _emulate_k2(y, ops, heads, key_mask, rounded=True):
    """The v3 kernel's blocks on `_transposed_operands(q_scale=)`, float64
    sums (the key mask in block 1)."""
    x = y.double()
    c = x.shape[-1]
    for blk in range(len(ops) // 12):
        g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, bb1, w2, bb2 = (
            _f64(a) for a in ops[12 * blk: 12 * blk + 12])
        h = F.layer_norm(x, (c,), g1[:, 0], b1[:, 0], 1e-5)
        ctx = _attention64(h, wqkv, bqkv[:, 0], heads, key_mask if blk == 0 else None, rounded)
        x = x + _dot(ctx, wp.T, rounded) + bp[:, 0]
        z = F.layer_norm(x, (c,), g2[:, 0], b2[:, 0], 1e-5)
        z = torch.relu(_dot(z, w1.T, rounded) + bb1[:, 0])
        x = x + _dot(z, w2.T, rounded) + bb2[:, 0]
    return x


def _emulate_k3(y, ops, heads, stride, rounded=True):
    """The strided epilogue on `stack_strided_block1_params(fold_q_scale=True)`
    at paddings (0, 0): out[t] = x[s·t + 1] + bc + Σ_j h1[s·t + j] · Wc_j."""
    o = {k: _f64(v) for k, v in ops.items()}
    n, c = y.shape[1], y.shape[2]
    x = y.double() + o["pe"][:, :n].T
    h = F.layer_norm(x, (c,), o["ln1_g"][:, 0], o["ln1_b"][:, 0], 1e-5)
    x = x + _dot(_attention64(h, o["wqkv"], o["bqkv"][:, 0], heads, None, rounded),
                 o["wp"].T, rounded) + o["bp"][:, 0]
    z = F.layer_norm(x, (c,), o["ln2_g"][:, 0], o["ln2_b"][:, 0], 1e-5)
    h1 = torch.relu(_dot(z, o["w1"].T, rounded) + o["b1"][:, 0])
    n_out = (n - 3) // stride + 1
    last = stride * (n_out - 1) + 1
    conv = sum(_dot(h1[:, j: j + last: stride], o[f"wc{j}"].T, rounded) for j in range(3))
    return x[:, 1: 1 + last: stride] + conv + o["bc"][:, 0]


def _gap(a, b):
    d = (a.double() - b.double()).abs()
    return float(d.mean()), float(d.max())


def _state(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


def test_eval_operands_are_the_jax_kernels_folded_operands(case):
    """(a): wqkv and bqkv of K2's blocks and of K3, bit for bit; the other
    operands unchanged by the fold; the bf16 planes of the folded weights."""
    model, heads = case["model"], case["heads"]
    fp = prepare_fused_params(model, "default")
    t, s = fp["temporal"], fp["strided"]
    for blk in range(2):
        jt = case["temporal"][12 * blk: 12 * blk + 12]
        assert np.array_equal(t["wqkv"][blk].numpy().T, jt[2])
        assert np.array_equal(t["bqkv"][blk].numpy(), jt[3][:, 0])
        assert np.array_equal(t["wp"][blk].numpy().T, jt[4])
        assert torch.equal(t["wqkv_bf"][blk], torch.from_numpy(jt[2].copy()).to(torch.bfloat16))
    assert np.array_equal(s["wqkv"].numpy().T, case["strided"]["wqkv"])
    assert np.array_equal(s["bqkv"].numpy(), case["strided"]["bqkv"][:, 0])
    assert torch.equal(s["wqkv_bf"], torch.from_numpy(case["strided"]["wqkv"].copy())
                       .to(torch.bfloat16))
    c = model.temporal_d_model
    unfolded = stack_temporal_params(_state(model), 2)
    assert torch.equal(t["wqkv"][..., c:], unfolded["wqkv"][..., c:])
    assert not torch.equal(t["wqkv"][..., :c], unfolded["wqkv"][..., :c])
    assert "q_scale" in t and "q_scale" in s and "q_scale" not in unfolded
    np.testing.assert_array_equal(t["q_scale"].numpy(), np.float32(1.0 / np.sqrt(c // heads)))


def _k2(case, ops):
    return temporal_stack_plain(case["y"], ops, case["key_mask"], num_heads=case["heads"],
                                first_masked_blocks=1, precision="default")


def _k3(case, ops):
    return strided_block1_plain(case["y"], ops, num_heads=case["heads"], stride=3,
                                paddings=(0, 0), precision="default")


def _emulations(case):
    """(K2's, K3's) emulation rounded and exact (no rounding), float64."""
    y, heads = case["y"], case["heads"]
    return ((_emulate_k2(y, case["temporal"], heads, case["key_mask"]),
             _emulate_k2(y, case["temporal"], heads, case["key_mask"], rounded=False)),
            (_emulate_k3(y, case["strided"], heads, 3),
             _emulate_k3(y, case["strided"], heads, 3, rounded=False)))


def test_plain_k2_k3_at_default_match_the_float64_emulation(case):
    """(b): the folded plain versions within 0.1 (mean) and 0.5 (largest)
    of the rung's drift from the emulation of the TPU kernels."""
    fp = prepare_fused_params(case["model"], "default")
    (k2_emu, k2_exact), (k3_emu, k3_exact) = _emulations(case)
    for name, got, emu, exact in (("K2", _k2(case, fp["temporal"]), k2_emu, k2_exact),
                                  ("K3", _k3(case, fp["strided"]), k3_emu, k3_exact)):
        (g_mean, g_max), (d_mean, d_max) = _gap(got, emu), _gap(emu, exact)
        print(f"{name} folded plain vs emulation: {g_mean / d_mean:.4f} / "
              f"{g_max / d_max:.4f} of the drift")
        assert g_mean <= MEAN_BAR * d_mean and g_max <= MAX_BAR * d_max, (
            name, g_mean / d_mean, g_max / d_max)


def test_unfolded_function_misses_the_emulation(case):
    """(c): the operands without the fold (the logits then scaled after the
    product) part from the emulation by at least 0.3 of the drift: the gap
    the repair closes (ROADMAP C7)."""
    state = _state(case["model"])
    (k2_emu, k2_exact), (k3_emu, k3_exact) = _emulations(case)
    for name, got, emu, exact in (
            ("K2", _k2(case, stack_temporal_params(state, 2)), k2_emu, k2_exact),
            ("K3", _k3(case, stack_strided_block1_params(state)), k3_emu, k3_exact)):
        (g_mean, g_max), (d_mean, d_max) = _gap(got, emu), _gap(emu, exact)
        print(f"{name} unfolded plain vs emulation: {g_mean / d_mean:.4f} / "
              f"{g_max / d_max:.4f} of the drift")
        assert g_mean >= GAP * d_mean, (name, g_mean / d_mean)


def test_fused_step_follows_the_folded_simulator_map(case):
    """(d): the fused "full" step at "default" against the port's simulator
    on FUSED_FOLDED, and closer to it than to the unfolded FUSED_DEFAULT."""
    model, config = case["model"], case["config"]
    step = make_test_step(model, flip_tta=False, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                          fused="full", precision="default")
    got = step(case["x2d"], case["sm"])[1]
    params, cfg = tsim.params_tree(model), tsim.sim_config(model)
    run = lambda assign: torch.from_numpy(tsim.run(params, case["x2d"], case["sm"], cfg,
                                                   assign))
    folded, unfolded, f32 = run(tsim.FUSED_FOLDED), run(tsim.FUSED_DEFAULT), run({})
    drift = _gap(folded, f32)[0]
    near, far = _gap(got, folded)[0] / drift, _gap(got, unfolded)[0] / drift
    print(f"step vs folded map {near:.3f}, vs unfolded {far:.3f} of the drift")
    assert near <= STEP_BAR and near <= CLOSER * far, (near, far)


def test_training_refuses_folded_operands(case):
    """The fold is the eval kernels'; the training kernels (K5, K6) take q
    unscaled (`pallas_strided.py:43-46`) and refuse the eval's operands."""
    from uplift_upsample_torch.ops.strided_train import strided_block1_train
    from uplift_upsample_torch.ops.temporal_train import temporal_stack_train

    fp = prepare_fused_params(case["model"])
    y, heads = case["y"], case["heads"]
    with pytest.raises(ValueError, match="q unscaled"):
        temporal_stack_train(y, fp["temporal"], None, torch.ones(2, 2, y.shape[0]),
                             num_heads=heads)
    with pytest.raises(ValueError, match="q unscaled"):
        strided_block1_train(y, fp["strided"], num_heads=heads, stride=3)
