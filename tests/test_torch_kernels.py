"""The port's kernel modules against the JAX package's Pallas kernels.

CPU tests: each plain version (the CPU path of its kernel wrapper) against the
Pallas kernel it replaces, run in interpret mode as tests/test_pallas_*.py
run them, at small widths (C <= 64) with an odd batch. Inputs and weights are
made with numpy and handed to both sides.

`gpu` tests: each CUDA kernel against its plain version on the card, and the
test step's kernel path against the plain model. They decide inside the
test whether there is a card, and skip without one. JAX is
imported inside the CPU tests only, so this file also runs where JAX is not
installed (the card's machine).
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.spatial import (spatial_stack, spatial_stack_plain,
                                               stack_spatial_params)
from uplift_upsample_torch.ops.strided import (output_length,
                                               stack_strided_block1_params,
                                               strided_block1, strided_block1_plain)
from uplift_upsample_torch.ops.temporal import (stack_temporal_params,
                                                temporal_stack, temporal_stack_plain)
from uplift_upsample_torch.utils.weights_h5 import params_from_jax


def _rand_tree(rng, tree, scale=0.1):
    """Replace every leaf of a params tree by seeded normals (non-zero biases
    and LN affines, so every operand is exercised)."""
    if isinstance(tree, dict):
        return {k: _rand_tree(rng, v, scale) for k, v in tree.items()}
    a = np.asarray(tree)
    return (rng.normal(size=a.shape) * scale).astype(np.float32) + (
        1.0 if a.ndim == 1 and np.all(a == 1.0) else 0.0)


def _block_tree(rng, c, hidden, strided=False, qkv_bias=True):
    dense = lambda i, o, bias=True: dict(kernel=np.zeros((i, o)), **(
        {"bias": np.zeros(o)} if bias else {}))
    tree = {
        "norm1": {"scale": np.ones(c), "bias": np.zeros(c)},
        "attn": {"wq": dense(c, c, qkv_bias), "wk": dense(c, c, qkv_bias),
                 "wv": dense(c, c, qkv_bias), "proj": dense(c, c)},
        "norm2": {"scale": np.ones(c), "bias": np.zeros(c)},
        "mlp": {"fc1": dense(c, hidden),
                "fc2": ({"kernel": np.zeros((3, hidden, c)), "bias": np.zeros(c)}
                        if strided else dense(hidden, c))},
    }
    return _rand_tree(rng, tree)


def _spatial_tree(rng, c, blocks):
    params = {f"spatial_block_{i + 1}": _block_tree(rng, c, 2 * c) for i in range(blocks)}
    params["keypoint_embedding"] = {"kernel": rng.normal(size=(2, c)).astype(np.float32),
                                    "bias": (rng.normal(size=c) * 0.1).astype(np.float32)}
    params["spatial_pe"] = (rng.normal(size=(17, c)) * 0.1).astype(np.float32)
    params["spatial_norm"] = _rand_tree(rng, {"scale": np.ones(c), "bias": np.zeros(c)})
    return params


def _state(params):
    return params_from_jax({"params": params})


def test_spatial_plain_matches_pallas():
    """spatial_stack_plain vs pallas_spatial.spatial_stack_apply (interpret
    mode, HIGHEST dots) at C=32, 8 heads: the TPU kernel's approximate erf is
    within 1.5e-7 of the exact one, so 2e-5 holds."""
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_spatial import spatial_stack_apply

    rng = np.random.default_rng(0)
    c, heads, blocks, b, n = 32, 8, 2, 3, 5
    params = _spatial_tree(rng, c, blocks)
    x = (rng.normal(size=(b, n, 17, 2)) * 0.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = spatial_stack_apply(params, jax.numpy.asarray(x), num_blocks=blocks,
                                  num_heads=heads,
                                  precision=jax.lax.Precision.HIGHEST)
    ops = stack_spatial_params(_state(params), blocks)
    got = spatial_stack(torch.from_numpy(x.reshape(b * n, 17, 2)), ops,
                        num_heads=heads).reshape(b, n, -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def _temporal_tree(rng, c, blocks):
    return {f"temporal_block_{i + 1}": _block_tree(rng, c, 2 * c) for i in range(blocks)}


@pytest.mark.parametrize("fmb", [0, 1])
def test_temporal_plain_matches_pallas(fmb):
    """temporal_stack_plain vs pallas_temporal_v3.fused_temporal_stack_v3
    (interpret mode, f32 weights, full attention) with the key mask on the
    first `fmb` blocks; odd batch, N not a multiple of 8; 3e-5 as in
    tests/test_pallas_temporal.py."""
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_temporal import (
        stack_temporal_params as jax_stack)
    from uplift_upsample_tpu.ops.pallas_temporal_v3 import fused_temporal_stack_v3

    rng = np.random.default_rng(1 + fmb)
    c, heads, blocks, b, n = 64, 8, 2, 3, 13
    params = _temporal_tree(rng, c, blocks)
    x = (rng.normal(size=(b, n, c)) * 0.5).astype(np.float32)
    key_mask = rng.uniform(size=(b, n)) < 0.5
    key_mask[:, 0] = False  # keep one real key per window
    with pltpu.force_tpu_interpret_mode():
        ref = fused_temporal_stack_v3(
            jax.numpy.asarray(x), jax_stack(params, blocks), jax.numpy.asarray(key_mask),
            num_blocks=blocks, num_heads=heads, first_masked_blocks=fmb,
            windows_per_tile=4, weights_dtype=jax.numpy.float32)
    ops = stack_temporal_params(_state(params), blocks)
    got = temporal_stack(torch.from_numpy(x), ops,
                         torch.from_numpy(key_mask.astype(np.float32)),
                         num_heads=heads, first_masked_blocks=fmb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("pads,n,stride", [((0, 0), 13, 3), ((1, 1), 13, 4)])
def test_strided_plain_matches_pallas_epilogue(pads, n, stride):
    """strided_block1_plain vs make_strided_b1_epilogue fused into the last
    call of fused_temporal_stack_v3 (interpret mode), with the caller's lane
    selection u = s0*t as in bench_forward._post_s2t; paddings (0,0) and the
    h36m_81 kind (1,1), odd batch; 3e-5 as in tests/test_pallas_strided.py."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_strided import (
        _OP_ORDER, make_strided_b1_epilogue)
    from uplift_upsample_tpu.ops.pallas_strided import (
        stack_strided_block1_params as jax_sops)
    from uplift_upsample_tpu.ops.pallas_temporal import (
        stack_temporal_params as jax_stack)
    from uplift_upsample_tpu.ops.pallas_temporal_v3 import fused_temporal_stack_v3

    rng = np.random.default_rng(5)
    c, heads, b = 64, 8, 3
    params = _temporal_tree(rng, c, 1)
    params["strided_temporal_block_1"] = _block_tree(rng, c, 2 * c, strided=True)
    params["strided_temporal_pe_1"] = (rng.normal(size=(n, c)) * 0.1).astype(np.float32)
    x = (rng.normal(size=(b, n, c)) * 0.5).astype(np.float32)

    wpt = 1  # b = 3 is odd: fused_temporal_stack_v3 halves wpt 4 → 1
    s_pad = -(-n // 8) * 8
    sops = jax_sops(params, n, weights_dtype=jnp.float32, num_heads=heads)
    ep_ops = [sops[name] for name in _OP_ORDER]
    if pads != (0, 0):
        valid = np.zeros((1, wpt * s_pad), np.float32)
        valid[0, :n] = 1.0
        ep_ops.append(jnp.asarray(valid))
    with pltpu.force_tpu_interpret_mode():
        out = fused_temporal_stack_v3(
            jnp.asarray(x), jax_stack(params, 1), None, num_blocks=1,
            num_heads=heads, windows_per_tile=4, weights_dtype=jnp.float32,
            epilogue=make_strided_b1_epilogue(heads, wpt, s_pad, c, paddings=pads),
            epilogue_ops=tuple(ep_ops))
    n_out = output_length(n, stride, pads)
    ref = np.asarray(out)[:, : (n_out - 1) * stride + 1: stride]

    state = _state(params)
    y = temporal_stack(torch.from_numpy(x), stack_temporal_params(state, 1),
                       num_heads=heads)
    got = strided_block1(y, stack_strided_block1_params(state), num_heads=heads,
                         stride=stride, paddings=pads)
    assert got.shape == (b, n_out, c)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=1e-4)


def test_wrappers_take_plain_path_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    rng = np.random.default_rng(7)
    state = _state(_temporal_tree(rng, 32, 1))
    ops = stack_temporal_params(state, 1)
    x = torch.from_numpy((rng.normal(size=(2, 9, 32))).astype(np.float32))
    cuda_lib.reset_launches()
    got = temporal_stack(x, ops, num_heads=4)
    torch.testing.assert_close(got, temporal_stack_plain(x, ops, num_heads=4),
                               rtol=0, atol=0)
    assert sum(cuda_lib.LAUNCHES.values()) == 0


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _to(ops, device):
    return {k: v.to(device) for k, v in ops.items()}


def _tol(ref):
    # fp32 sums over K <= 2304 taken in another order: 2e-4 of the output scale
    return 2e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("c,heads", [(32, 8), (16, 4)])
def test_spatial_kernel_matches_plain(c, heads):
    dev = _card()
    rng = np.random.default_rng(11)
    ops = _to(stack_spatial_params(_state(_spatial_tree(rng, c, 4)), 4), dev)
    x = torch.from_numpy((rng.normal(size=(1027, 17, 2)) * 0.5).astype(np.float32)).to(dev)
    cuda_lib.reset_launches()
    got = spatial_stack(x, ops, num_heads=heads)
    ref = spatial_stack_plain(x, ops, num_heads=heads)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["spatial_stack"] == 1
    assert float((got - ref).abs().max()) <= _tol(ref)


@pytest.mark.gpu
def test_temporal_kernel_matches_plain():
    dev = _card()
    rng = np.random.default_rng(12)
    c, heads, b, n = 128, 8, 5, 71
    ops = _to(stack_temporal_params(_state(_temporal_tree(rng, c, 2)), 2), dev)
    x = torch.from_numpy((rng.normal(size=(b, n, c)) * 0.5).astype(np.float32)).to(dev)
    km = torch.from_numpy((rng.uniform(size=(b, n)) < 0.5).astype(np.float32)).to(dev)
    got = temporal_stack(x, ops, km, num_heads=heads, first_masked_blocks=1)
    ref = temporal_stack_plain(x, ops, km, num_heads=heads, first_masked_blocks=1)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= _tol(ref)


@pytest.mark.gpu
@pytest.mark.parametrize("pads,n,stride", [((0, 0), 71, 3), ((1, 1), 41, 4)])
def test_strided_kernel_matches_plain(pads, n, stride):
    dev = _card()
    rng = np.random.default_rng(13)
    c, heads, b = 128, 8, 3
    params = {"strided_temporal_block_1": _block_tree(rng, c, 2 * c, strided=True),
              "strided_temporal_pe_1": (rng.normal(size=(n, c)) * 0.1).astype(np.float32)}
    ops = _to(stack_strided_block1_params(_state(params)), dev)
    x = torch.from_numpy((rng.normal(size=(b, n, c)) * 0.5).astype(np.float32)).to(dev)
    got = strided_block1(x, ops, num_heads=heads, stride=stride, paddings=pads)
    ref = strided_block1_plain(x, ops, num_heads=heads, stride=stride, paddings=pads)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= _tol(ref)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", ["h36m_351", "h36m_81"])
def test_fused_step_matches_plain_model(geometry):
    """The test step's kernel path (K1 → s2t → K2 → K3 → tail) against the
    plain model on the card, flip-TTA on, at a reduced width; both strided
    block 1 geometries. Every kernel must launch."""
    from uplift_upsample_torch.config import UpliftUpsampleConfig
    from uplift_upsample_torch.eval import make_test_step
    from uplift_upsample_torch.models import build_uplift_upsample_transformer

    dev = _card()
    n, strides, pads, ms = ((27, [3, 3, 3], [[0, 0]] * 3, 5) if geometry == "h36m_351"
                            else (41, [4, 4, 3], [[1, 1], [0, 0], [0, 0]], 4))
    config = UpliftUpsampleConfig()
    config.update_from({"SEQUENCE_LENGTH": n, "SPATIAL_EMBED_DIM": 32,
                        "TEMPORAL_EMBED_DIM": 128, "SPATIAL_TRANSFORMER_BLOCKS": 2,
                        "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": strides,
                        "PADDINGS": pads, "NUM_HEADS": 8, "MASK_STRIDE": ms,
                        "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1})
    model = build_uplift_upsample_transformer(config, device=dev, seed=1)
    rng = np.random.default_rng(14)
    b = 5
    x = torch.from_numpy((rng.normal(size=(b, n, 17, 2)) * 0.3).astype(np.float32)).to(dev)
    phase = rng.integers(0, ms, size=(b, 1))
    sm = torch.from_numpy((np.arange(n)[None] + phase) % ms == 0).to(dev)
    kwargs = dict(flip_tta=True, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER)
    cuda_lib.reset_launches()
    _, got = make_test_step(model, fused="full", **kwargs)(x, sm)
    _, ref = make_test_step(model, fused="none", **kwargs)(x, sm)
    torch.cuda.synchronize()
    for name in ("spatial_stack", "temporal_stack", "strided_block1"):
        assert cuda_lib.LAUNCHES[name] > 0, name
    assert float((got - ref).abs().max()) <= _tol(ref)
