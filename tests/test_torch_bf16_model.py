"""bf16 activations (COMPUTE_DTYPE, SPATIAL_COMPUTE_DTYPE) on the serving paths.

The JAX model's dtype semantics (`uplift_upsample_tpu/models/uplift_upsample.py:
125-265`, flax Dense / LayerNorm / Conv with `dtype`): the input cast to
`dtype`, the spatial stage at `spatial_dtype`, `spatial_norm` and the rest at
`dtype`, each Dense and the conv on bf16 operands with a bf16 output,
LayerNorm statistics in fp32, the attention's logits and softmax fp32, the
PEs and tokens cast, parameters fp32. The port's model carries them
(`models/primitives.py`); on the fused routes the kernels keep their fp32
operands and the tail runs bf16 (`models/bench_forward.py`).

All on an h36m_351-shaped model cut to two blocks a stack (C 32 spatial in
8 heads of depth 4, 96 temporal in 8 heads of depth 12, JAX init), six
windows of 27 frames from a numpy seed, two phases of a mask stride of 5:

  (a) the port's model at COMPUTE_DTYPE bfloat16 with SPATIAL_COMPUTE_DTYPE
      unset, "float32" and "bfloat16" against the flax model at the same
      dtypes: its mean distance to the float64 model (the float32 model in
      float64) within 2x the flax model's own; the largest within 4x
      (measured: means 0.92-1.06x, largest 1.08-1.25x). Held directly to
      the flax bf16 model too, in units of flax's drift (mean |flax bf16 -
      flax fp32|): two bf16 computations of this model that round in
      another order part by about the whole drift (the flax model eager
      against itself jitted: 0.94), so mean |port - flax bf16| is held
      within 1.25 (measured 0.88-1.03), and the port's own drift, mean
      |port - flax fp32|, within [0.6, 1.6] of flax's (measured
      0.92-1.06). A port that ran fp32 and cast its output would drift
      0.14-0.33 of it (the fp32 output cast to bf16, checked to fail);
  (b) the eval step's routes "full", "spatial" and "none", with and without
      USE_PALLAS_ATTENTION (row 11 on bf16 operands in the bf16 layers), at
      "high" and "default": bf16 central outputs, their mean distance to the
      float64 model within 2x the flax bf16 model's (with the same
      USE_PALLAS_ATTENTION); at "high" the same direct bars as (a) against
      the flax model from the route's entry (the "spatial" route's K1
      output through `clone(spatial_input=True)`, the "full" route's K3
      output through `clone(temporal_input=True, strided_entry=1)`, fp32 in
      both): measured 0.74-1.05 direct, 0.92-1.07 own drift; the fused
      "full" route bit for bit the fp32 kernels' plain versions up to K3
      and then the bf16 tail;
  (c) `run_eval` with `--bf16` (the CLI's `main`) against the JAX `run_eval`
      at COMPUTE_DTYPE bfloat16 on the synthetic split (`tests/fixtures/
      synth`, `small_strided.h5`, MASK_STRIDE 10): N-MPJPE and PA-MPJPE
      within 0.1 mm (CLAUDE.md's eval bar; measured at most 0.033 mm);
      MPJPE within 5e-4 of its value. The fixture model is untrained, its
      MPJPE 4,411 mm: two bf16 forwards whose sums run in another order
      part by 2.6e-4 of it (1.17 mm; measured), about as far as the JAX
      package's own bf16 run lies from its float32 run (4.3e-4, 1.88 mm),
      where 0.1 mm would be 2.3e-5. Every metric within 1 % of the port's
      float32 run.
"""

import os

import numpy as np
import pytest
import torch

from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.eval import make_test_step
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.utils.weights_h5 import params_from_jax

OVERRIDES = {
    "SEQUENCE_LENGTH": 27, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 32,
    "TEMPORAL_EMBED_DIM": 96, "SPATIAL_TRANSFORMER_BLOCKS": 2,
    "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3, 3],
    "PADDINGS": [[0, 0], [0, 0], [0, 0]], "NUM_HEADS": 8,
    "MASK_STRIDE": 5, "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1,
    "DROP_PATH_RATE": [0.1, 0.1, 0.0],
}
SPATIAL = [None, "float32", "bfloat16"]
# Mean distances in units of the flax model's bf16 drift, |flax bf16 - flax fp32|:
DIRECT = 1.25     # |port bf16 - flax bf16|
OWN = (0.6, 1.6)  # the port's own drift, |port bf16 - flax fp32|
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
SYNTH_DIR = os.path.join(FIXTURE_DIR, "synth")
SMALL_H5 = os.path.join(FIXTURE_DIR, "small_strided.h5")
SMALL_CONFIG = os.path.join(FIXTURE_DIR, "eval_small_config.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _overrides(dtype="float32", spatial=None, pallas=False):
    return {**OVERRIDES, "COMPUTE_DTYPE": dtype, "SPATIAL_COMPUTE_DTYPE": spatial,
            "USE_PALLAS_ATTENTION": pallas}


@pytest.fixture(scope="module")
def case():
    """The JAX init, inputs, the float64 truth, and a flax forward."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params

    jconfig = JaxConfig()
    jconfig.update_from(OVERRIDES)
    variables = init_model_params(jax_build(jconfig), seed=0)
    state = params_from_jax(variables)
    rng = np.random.default_rng(0)
    b, n = 6, OVERRIDES["SEQUENCE_LENGTH"]
    sm = (np.arange(n) % 5 == 0)[None].repeat(b, axis=0)
    sm[1] = np.roll(sm[1], 2)
    x = (rng.normal(size=(b, n, 17, 2)) * 0.3).astype(np.float32) * sm[:, :, None, None]

    def port(**over):
        config = UpliftUpsampleConfig()
        config.update_from(_overrides(**over))
        model = build_uplift_upsample_transformer(config, device="cpu")
        model.load_state_dict(state)
        return config, model

    def flax(inputs=None, entry=None, jit=True, **over):
        """The flax model's central output (jitted; interpret-mode Pallas
        attention with USE_PALLAS_ATTENTION), float64: on x, or with `entry`
        (clone flags: `spatial_input`, `temporal_input` and `strided_entry`)
        on `inputs`, the fp32 tensor a fused route hands its plain part."""
        jc = JaxConfig()
        jc.update_from(_overrides(**over))
        model = jax_build(jc)
        if entry:
            model = model.clone(**entry)
        apply = lambda v, a, m: model.apply(v, a, stride_mask=m, training=False)[1]
        apply = jax.jit(apply) if jit else apply
        a = x if inputs is None else inputs.detach().numpy()
        with pltpu.force_tpu_interpret_mode():
            out = apply(variables, jnp.asarray(a), jnp.asarray(sm))
        assert out.dtype == jnp.dtype(jc.COMPUTE_DTYPE)
        return torch.from_numpy(np.asarray(out.astype(jnp.float32), np.float64))

    _, model32 = port()
    with torch.inference_mode():
        truth = model32.double()(torch.from_numpy(x).double(), torch.from_numpy(sm))[1]
    return dict(port=port, flax=flax, truth=truth, x=torch.from_numpy(x),
                sm=torch.from_numpy(sm))


def _dist(got, truth):
    d = (got.double() - truth).abs()
    return float(d.mean()), float(d.max())


def _bf16_like_flax(got, flax_bf16, flax_fp32, label):
    """The port's bf16 output against the flax bf16 model's, on the same
    input, in units of flax's drift (mean |flax bf16 - flax fp32|). Two bf16
    computations of this model that round in another order part by about
    the whole drift (the flax model eager against itself jitted, test (a)),
    so the direct distance is held within DIRECT of it; and the port's own
    drift from fp32 (mean |port - flax fp32|) within OWN of flax's. A port
    that ran fp32 and cast its output to bf16 would drift far less: that
    cast, checked here, fails OWN's lower end."""
    drift = _dist(flax_bf16, flax_fp32)[0]
    direct = _dist(got, flax_bf16)[0] / drift
    own = _dist(got, flax_fp32)[0] / drift
    cast = _dist(flax_fp32.to(torch.bfloat16), flax_fp32)[0] / drift
    print(f"{label}: mean |port - flax bf16| {direct:.3f}, |port - flax fp32| {own:.3f}, "
          f"fp32 cast {cast:.3f} of mean |flax bf16 - flax fp32|")
    assert direct <= DIRECT and OWN[0] <= own <= OWN[1], (label, direct, own)
    assert cast < OWN[0], (label, cast)


@pytest.mark.parametrize("spatial", SPATIAL)
def test_model_matches_flax_at_bf16(case, spatial):
    """(a): the plain model at COMPUTE_DTYPE bfloat16 against the flax model."""
    _, model = case["port"](dtype="bfloat16", spatial=spatial)
    with torch.inference_mode():
        got = model(case["x"], case["sm"])[1]
    assert got.dtype == torch.bfloat16
    want = case["flax"](dtype="bfloat16", spatial=spatial)
    (g_mean, g_max), (j_mean, j_max) = _dist(got, case["truth"]), _dist(want, case["truth"])
    print(f"SPATIAL_COMPUTE_DTYPE {spatial}: to float64 {g_mean / j_mean:.3f} (mean), "
          f"{g_max / j_max:.3f} (largest) of the flax model's")
    assert g_mean <= 2 * j_mean and g_max <= 4 * j_max, (g_mean / j_mean, g_max / j_max)
    fp32 = case["flax"]()
    if spatial is None:  # the flax model against itself: eager, without XLA's fusions
        floor = _dist(case["flax"](jit=False, dtype="bfloat16"), want)[0] / _dist(want, fp32)[0]
        print(f"flax bf16 eager vs jitted: {floor:.3f} of its drift")
        assert floor <= DIRECT, floor
    _bf16_like_flax(got, want, fp32, f"SPATIAL_COMPUTE_DTYPE {spatial}")
    if spatial == "float32":  # the spatial stage at fp32 is closer to the truth
        assert g_mean < _dist(case["port"](dtype="bfloat16")[1](case["x"], case["sm"])[1],
                              case["truth"])[0]


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("fused", ["full", "spatial", "none"])
def test_routes_at_bf16(case, fused, pallas):
    """(b): every route, both rungs, with and without row 11."""
    config, model = case["port"](dtype="bfloat16", pallas=pallas)
    j_mean = _dist(case["flax"](dtype="bfloat16", pallas=pallas), case["truth"])[0]
    for rung in ("high", "default"):
        step = make_test_step(model, flip_tta=False,
                              flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER, fused=fused,
                              precision=rung)
        got = step(case["x"], case["sm"])[1]
        assert got.dtype == torch.bfloat16
        g_mean = _dist(got, case["truth"])[0]
        print(f"{fused} pallas={pallas} {rung}: {g_mean / j_mean:.3f} of the flax distance")
        assert g_mean <= 2 * j_mean, (rung, g_mean / j_mean)
        if rung == "high":  # the rung the flax model computes on the CPU
            inputs, entry = _route_entry(case, model, fused)
            _bf16_like_flax(got, case["flax"](inputs, entry, dtype="bfloat16", pallas=pallas),
                            case["flax"](inputs, entry, pallas=pallas),
                            f"{fused} pallas={pallas}")
    if fused == "full":
        _full_route_is_fp32_kernels_then_bf16_tail(case, pallas)


def _route_entry(case, model, fused):
    """The fp32 tensor the route's kernels hand its plain model at "high",
    and the flax clone flags that take it: K1's output for "spatial", K3's
    for "full" (as `_full_route_is_fp32_kernels_then_bf16_tail` builds it),
    the input itself for "none"."""
    if fused == "none":
        return None, None
    from uplift_upsample_torch.models.bench_forward import _s2t, _spatial, prepare_fused_params
    from uplift_upsample_torch.ops.strided import strided_block1
    from uplift_upsample_torch.ops.temporal import temporal_stack
    from uplift_upsample_torch.precision import matmul_precision

    x, sm = case["x"], case["sm"]
    fp = prepare_fused_params(model, "high")
    with torch.inference_mode(), matmul_precision("high"):
        sp = _spatial(model, x * sm[:, :, None, None], fp)
        if fused == "spatial":
            return sp, dict(spatial_input=True)
        m = sm.float()[..., None]
        y = m * _s2t(model, sp) + (1.0 - m) * model.strided_input_token + model.temporal_pe
        y = temporal_stack(y, fp["temporal"], 1.0 - sm.float(), num_heads=model.num_heads,
                           first_masked_blocks=1, precision="high")
        y = strided_block1(y, fp["strided"], num_heads=model.num_heads, stride=3,
                           paddings=(0, 0), precision="high")
    return y, dict(temporal_input=True, strided_entry=1)


def _full_route_is_fp32_kernels_then_bf16_tail(case, pallas):
    from uplift_upsample_torch.models.bench_forward import (_spatial, _s2t,
                                                            prepare_fused_params)
    from uplift_upsample_torch.ops.strided import strided_block1
    from uplift_upsample_torch.ops.temporal import temporal_stack
    from uplift_upsample_torch.precision import matmul_precision

    config, model = case["port"](dtype="bfloat16", pallas=pallas)
    x, sm = case["x"], case["sm"]
    fp = prepare_fused_params(model, "high")
    step = make_test_step(model, flip_tta=False, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                          fused="full", precision="high")
    with torch.inference_mode(), matmul_precision("high"):
        y = _s2t(model, _spatial(model, x * sm[:, :, None, None], fp))
        assert y.dtype == torch.float32
        m = sm.float()[..., None]
        y = m * y + (1.0 - m) * model.strided_input_token + model.temporal_pe
        y = temporal_stack(y, fp["temporal"], 1.0 - sm.float(), num_heads=model.num_heads,
                           first_masked_blocks=1, precision="high")
        y = strided_block1(y, fp["strided"], num_heads=model.num_heads, stride=3,
                           paddings=(0, 0), precision="high")
        want = model(y, sm, temporal_input=True, strided_entry=1)[1]
    assert torch.equal(step(x, sm)[1], want)


def test_run_eval_bf16_matches_jax(monkeypatch):
    """(c): `--bf16` through the CLI's main against the JAX run_eval at bf16."""
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.eval import run_eval as jax_run_eval

    from uplift_upsample_torch.eval import main

    data = dict(dataset_path=os.path.join(SYNTH_DIR, "data_3d_h36m.npz"),
                dataset2d_path=os.path.join(SYNTH_DIR, "data_2d_h36m_synth.npz"))
    jconfig = JaxConfig(config_file=SMALL_CONFIG)
    jconfig.MASK_STRIDE = 10
    jconfig.COMPUTE_DTYPE = "bfloat16"
    ref = jax_run_eval(config=jconfig, dataset_name="h36m", test_subset="test",
                       weights_path=SMALL_H5, action_wise=True, verbose=False, **data)
    args = ["--weights", SMALL_H5, "--config", SMALL_CONFIG, "--dataset", data["dataset_path"],
            "--dataset_2d", data["dataset2d_path"], "--forced_mask_stride", "10",
            "--device", "cpu"]
    got = main(args + ["--bf16"])[10]
    fp32 = main(args)[10]
    for section in (0, 1):  # all frames, keyframes
        for metric, value in ref[section][0].items():
            bar = dict(atol=0.0, rtol=5e-4) if metric == "mpjpe" else dict(atol=0.1, rtol=0.0)
            np.testing.assert_allclose(got[section][0][metric], value, **bar,
                                       err_msg=f"section {section}/{metric}")
            assert abs(got[section][0][metric] - fp32[section][0][metric]) <= (
                0.01 * fp32[section][0][metric]), (section, metric)
