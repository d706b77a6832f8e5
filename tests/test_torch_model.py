"""The PyTorch port's model against the reference goldens and the JAX model.

Same fixtures as tests/test_model_parity.py: reference TF outputs for
random-weight `.h5` checkpoints, including the full-width h36m_351. All on
the CPU in float32.
"""

import os

import numpy as np
import pytest
import torch

from uplift_upsample_torch.models import UpliftUpsampleTransformer
from uplift_upsample_torch.utils.weights_h5 import load_keras_h5, params_from_jax

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")

# The seven cases of tests/test_model_parity.py:20-55 (flax attribute names;
# the port's constructor takes the same ones minus the dropout rates).
MODEL_KWARGS = {
    "small_strided": dict(
        num_frames=9, spatial_d_model=16, temporal_d_model=32, spatial_depth=2,
        temporal_depth=2, strides=(3, 3), paddings=((0, 0), (0, 0)), num_heads=4,
        mlp_ratio=2.0, qkv_bias=True, drop_path_rate=(0.0, 0.0, 0.0),
        has_strided_input=True, first_strided_token_attention_layer=1),
    "default_pads": dict(
        num_frames=11, spatial_d_model=16, temporal_d_model=32, spatial_depth=1,
        temporal_depth=2, strides=(4, 3), paddings=None, num_heads=4,
        mlp_ratio=2.0, qkv_bias=True, has_strided_input=True),
    "no_strided_input": dict(
        num_frames=9, spatial_d_model=16, temporal_d_model=32, spatial_depth=2,
        temporal_depth=2, strides=(3, 3), paddings=((0, 0), (0, 0)), num_heads=4,
        mlp_ratio=2.0, qkv_bias=True, has_strided_input=False),
    "no_qkv_bias_bn": dict(
        num_frames=9, spatial_d_model=16, temporal_d_model=32, spatial_depth=1,
        temporal_depth=1, strides=(3, 3), paddings=((0, 0), (0, 0)), num_heads=4,
        mlp_ratio=2.0, qkv_bias=False, output_bn=True, has_strided_input=True),
    "no_spatial": dict(
        num_frames=9, spatial_d_model=16, temporal_d_model=32, spatial_depth=0,
        temporal_depth=2, strides=(3, 3), paddings=((0, 0), (0, 0)), num_heads=4,
        mlp_ratio=2.0, qkv_bias=True, has_strided_input=True),
    "no_strides": dict(
        num_frames=9, spatial_d_model=16, temporal_d_model=32, spatial_depth=2,
        temporal_depth=2, strides=(), paddings=None, num_heads=4,
        mlp_ratio=2.0, qkv_bias=True, has_strided_input=True),
    "h36m_351": dict(
        num_frames=71, spatial_d_model=32, temporal_d_model=384, spatial_depth=4,
        temporal_depth=4, strides=(3, 10, 3), paddings=((0, 0), (0, 0), (0, 0)),
        num_heads=8, mlp_ratio=2.0, qkv_bias=True,
        drop_path_rate=(0.1, 0.1, 0.0), has_strided_input=True,
        first_strided_token_attention_layer=1),
}


def _load_case(name):
    h5_path = os.path.join(FIXTURE_DIR, f"{name}.h5")
    data = np.load(os.path.join(FIXTURE_DIR, f"{name}.npz"))
    model = UpliftUpsampleTransformer(num_keypoints=17, **MODEL_KWARGS[name]).eval()
    load_keras_h5(h5_path, model)
    return model, data


def _run(model, x, sm):
    with torch.inference_mode():
        full, central = model(torch.from_numpy(np.asarray(x)),
                              torch.from_numpy(np.asarray(sm)))
    return (None if full is None else full.numpy()), central.numpy()


@pytest.mark.parametrize("name", list(MODEL_KWARGS))
def test_forward_matches_reference_golden(name):
    """Port model on the reference .h5 vs the reference TF outputs: 2e-5, the
    JAX package's own bar (tests/test_model_parity.py:79)."""
    model, data = _load_case(name)
    full, central = _run(model, data["x_masked"], data["stride_mask"])
    np.testing.assert_allclose(central, data["central"], atol=2e-5, rtol=1e-4)
    assert full is not None
    np.testing.assert_allclose(full, data["full"], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", list(MODEL_KWARGS))
def test_forward_matches_jax_model(name):
    """Port vs the JAX model on the same .h5 and inputs: both f32 on the CPU,
    sums taken in another order, so 2e-5."""
    jax = pytest.importorskip("jax")
    from uplift_upsample_tpu.models import UpliftUpsampleTransformer as JaxModel
    from uplift_upsample_tpu.utils.weights_h5 import load_keras_h5 as jax_load

    model, data = _load_case(name)
    jmodel = JaxModel(num_keypoints=17, **MODEL_KWARGS[name])
    variables = jax_load(os.path.join(FIXTURE_DIR, f"{name}.h5"), jmodel)
    sm = data["stride_mask"] if jmodel.has_strided_input else None
    j_full, j_central = jmodel.apply(variables, jax.numpy.asarray(data["x_masked"]),
                                     stride_mask=sm, training=False)
    full, central = _run(model, data["x_masked"], data["stride_mask"])
    np.testing.assert_allclose(central, np.asarray(j_central), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(full, np.asarray(j_full), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["small_strided", "no_qkv_bias_bn",
                                  "no_spatial"])
def test_params_from_jax_init(name):
    """params_from_jax of the JAX package's init_model_params gives the port
    the same function as the JAX model (random non-zero BN stats included)."""
    jax = pytest.importorskip("jax")
    from uplift_upsample_tpu.models import UpliftUpsampleTransformer as JaxModel
    from uplift_upsample_tpu.models import init_model_params

    jmodel = JaxModel(num_keypoints=17, **MODEL_KWARGS[name])
    variables = jax.tree_util.tree_map(np.asarray, init_model_params(jmodel, seed=3))
    rng = np.random.default_rng(3)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
            variables["batch_stats"])
    n = jmodel.num_frames
    x = (rng.normal(size=(3, n, 17, 2)) * 0.3).astype(np.float32)
    sm = (np.arange(n) % 2 == 0)[None].repeat(3, axis=0)
    x = x * sm[:, :, None, None]
    j_full, j_central = jmodel.apply(variables, x, stride_mask=sm, training=False)

    model = UpliftUpsampleTransformer(num_keypoints=17, **MODEL_KWARGS[name]).eval()
    model.load_state_dict(params_from_jax(variables), strict=True)
    full, central = _run(model, x, sm)
    np.testing.assert_allclose(central, np.asarray(j_central), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(full, np.asarray(j_full), atol=2e-5, rtol=1e-4)


def test_h36m_351_param_count_and_init():
    """The full-width model has the JAX package's 10,404,902 parameters, and
    the seeded init has the flax scales (glorot bound, truncated-normal PE)."""
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer

    model = build_uplift_upsample_transformer(get_config("h36m_351"), device="cpu",
                                              seed=0)
    assert sum(p.numel() for p in model.parameters()) == 10_404_902
    w = model.temporal_block_1.attn.wq.weight
    assert w.abs().max() <= np.sqrt(6.0 / (384 + 384)) and w.std() > 0.02
    pe = model.temporal_pe.detach()
    assert pe.abs().max() <= 2 * 0.02 / 0.8796 + 1e-6
    assert abs(float(pe.std()) - 0.02) < 0.002
    again = build_uplift_upsample_transformer(get_config("h36m_351"), device="cpu",
                                              seed=0)
    assert torch.equal(again.temporal_pe, model.temporal_pe)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", None])
def test_spatial_compute_dtype_float32_only(dtype):
    """SPATIAL_COMPUTE_DTYPE is read (C2): the JAX package runs the spatial
    stage in it (`spatial_dtype`). The port raised for bfloat16 until bf16
    activations were ported; now "bfloat16" runs the spatial stage's Dense
    layers on bf16 tensors (the rest of the model at COMPUTE_DTYPE float32),
    and float32 or None keep the whole model float32, bit for bit as one
    built without the key. Parameters stay float32 either way."""
    from uplift_upsample_torch.config import UpliftUpsampleConfig
    from uplift_upsample_torch.models import build_uplift_upsample_transformer

    def build(value):
        config = UpliftUpsampleConfig()
        config.update_from({"SEQUENCE_LENGTH": 9, "SPATIAL_EMBED_DIM": 16,
                            "TEMPORAL_EMBED_DIM": 32, "SPATIAL_TRANSFORMER_BLOCKS": 1,
                            "TEMPORAL_TRANSFORMER_BLOCKS": 1, "STRIDES": [3, 3],
                            "PADDINGS": [[0, 0], [0, 0]], "NUM_HEADS": 4,
                            "DROP_PATH_RATE": 0.0, "SPATIAL_COMPUTE_DTYPE": value})
        return build_uplift_upsample_transformer(config, device="cpu", seed=0)

    model, plain = build(dtype), build(None)
    assert next(model.parameters()).dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 9, 17, 2))
                         .astype(np.float32))
    with torch.inference_mode():
        got, want = model(x)[1], plain(x)[1]
    assert got.dtype == torch.float32
    if dtype == "bfloat16":
        assert model.spatial_dtype == torch.bfloat16 and model.dtype is None
        assert model.spatial_block_1.mlp.fc1.dtype == torch.bfloat16
        assert model.temporal_block_1.mlp.fc1.dtype is None
        assert not torch.equal(got, want)
    else:
        assert model.spatial_dtype is None and torch.equal(got, want)
