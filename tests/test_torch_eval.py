"""The port's eval harness on the CPU: run_eval against the reference fixture
and the JAX run_eval, its A/B equivalences, the eval-step paths and splices.

Counterparts of tests/test_eval_parity.py and tests/test_bench_forward.py's
shared-spatial cases. `device="cpu"` everywhere: the kernels' plain versions
run where the card would launch them.
"""

import json
import os

import numpy as np
import pytest
import torch

from uplift_upsample_torch.configs import resolve_config
from uplift_upsample_torch.eval import (main, make_test_step, resolve_temporal_wpt,
                                        run_eval, scatter_parts,
                                        sparse_rows_to_compute)
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.utils.weights_h5 import params_from_jax

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
SYNTH_DIR = os.path.join(FIXTURE_DIR, "synth")
SMALL_H5 = os.path.join(FIXTURE_DIR, "small_strided.h5")
SMALL_CONFIG = os.path.join(FIXTURE_DIR, "eval_small_config.json")
DATA = dict(dataset_name="h36m",
            dataset_path=os.path.join(SYNTH_DIR, "data_3d_h36m.npz"),
            dataset2d_path=os.path.join(SYNTH_DIR, "data_2d_h36m_synth.npz"),
            test_subset="test")


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


def _config(mask_stride=5, **overrides):
    config = resolve_config(SMALL_CONFIG)
    config.MASK_STRIDE = mask_stride
    config.update_from(overrides)
    return config


def _run(config, **kwargs):
    return run_eval(config, weights_path=SMALL_H5, action_wise=True, verbose=False,
                    device="cpu", **{**DATA, **kwargs})


def _reference(mask_stride):
    with open(os.path.join(FIXTURE_DIR, "eval_parity.json")) as f:
        return json.load(f)[str(mask_stride)]


def _assert_fixture(results, ref, what):
    """The JAX test's bar (tests/test_eval_parity.py:45-47)."""
    for section, mine in zip(("all_frames", "keyframes"), results):
        for metric, ref_value in ref[section]["frame"].items():
            np.testing.assert_allclose(mine[0][metric], ref_value, atol=5e-2, rtol=1e-4,
                                       err_msg=f"{what} {section}/{metric}")


def _assert_same(a, b, what, atol, rtol=0.0):
    for section in (0, 1):  # all_frames, keyframes
        for metric, value in a[section][0].items():
            np.testing.assert_allclose(b[section][0][metric], value, atol=atol, rtol=rtol,
                                       err_msg=f"{what} section {section}/{metric}")


@pytest.mark.parametrize("mask_stride", [5, 10])
def test_eval_parity(mask_stride):
    """The plain model on the CPU (EVAL_FUSED "auto") reproduces the reference
    pipeline's metrics."""
    _assert_fixture(_run(_config(mask_stride)), _reference(mask_stride), "auto")


@pytest.mark.parametrize("shared", [False, True])
def test_eval_parity_fused_full(shared):
    """EVAL_FUSED="full" (the kernels' plain versions on the CPU), dense or
    with the shared spatial stage, reproduces the reference metrics."""
    config = _config(5, EVAL_FUSED="full", EVAL_SHARED_SPATIAL=shared)
    _assert_fixture(_run(config), _reference(5), f"full shared={shared}")


@pytest.mark.parametrize("mask_stride", [5, 10])
def test_eval_matches_jax_run_eval(mask_stride):
    """The JAX run_eval (XLA on the CPU) and the port's on the same weights
    and data: every frame metric within rtol 1e-5 / atol 1e-3 mm."""
    from uplift_upsample_tpu.config import UpliftUpsampleConfig
    from uplift_upsample_tpu.eval import run_eval as jax_run_eval

    jconfig = UpliftUpsampleConfig(config_file=SMALL_CONFIG)
    jconfig.MASK_STRIDE = mask_stride
    ref = jax_run_eval(config=jconfig, weights_path=SMALL_H5, action_wise=True,
                       verbose=False, **DATA)
    got = _run(_config(mask_stride))
    _assert_same(ref, got, "port vs JAX", atol=1e-3, rtol=1e-5)
    for section in (0, 1):  # the action-wise averages too
        for metric, value in ref[section][1].items():
            np.testing.assert_allclose(got[section][1][metric], value, atol=1e-3, rtol=1e-5)


# The A/B tests hold the JAX tests' bar, atol and rtol 1e-9 mm
# (tests/test_eval_parity.py:76-78): the port's CPU path reaches it.

@pytest.mark.parametrize("disable_upsampling", [False, True])
def test_eval_window_sparse_matches_dense(disable_upsampling):
    """EVAL_SKIP_INTERPOLATED_WINDOWS changes no metric: skipped windows are
    interpolation-only. With EVAL_DISABLE_LEARNED_UPSAMPLING the keyframe
    stride is MASK_STRIDE."""
    results = {}
    for sparse in (False, True):
        config = _config(10 if disable_upsampling else 5,
                         EVAL_SKIP_INTERPOLATED_WINDOWS=sparse,
                         EVAL_DISABLE_LEARNED_UPSAMPLING=disable_upsampling)
        results[sparse] = _run(config)
    _assert_same(results[False], results[True], "window-sparse", atol=1e-9, rtol=1e-9)


def test_eval_shared_spatial_matches_dense():
    """EVAL_SHARED_SPATIAL (features once per unique masked frame, gathered
    into windows) changes no metric on the plain path."""
    results = {shared: _run(_config(5, EVAL_SHARED_SPATIAL=shared))
               for shared in (False, True)}
    _assert_same(results[False], results[True], "shared-spatial", atol=1e-9, rtol=1e-9)


def test_eval_shared_spatial_capacity_fallback(capsys):
    """Batches over the unique-frame capacity fall back to the dense step with
    the same metrics, and the fallback is counted."""
    results = {}
    for extra in (1024, -10_000):
        results[extra] = _run(_config(5, EVAL_SHARED_SPATIAL=True,
                                      EVAL_SHARED_UMAX_EXTRA=extra))
    assert "exceeded the" in capsys.readouterr().out
    _assert_same(results[1024], results[-10_000], "capacity-fallback", atol=1e-9,
                 rtol=1e-9)


def test_eval_packed_upload_matches_unpacked():
    """EVAL_PACKED_UPLOAD (one byte buffer per flush, unpacked on the device
    with views) is bit-equal to the three-array path."""
    results = {packed: _run(_config(5, EVAL_SHARED_SPATIAL=True,
                                    EVAL_PACKED_UPLOAD=packed))
               for packed in (False, True)}
    for section in (0, 1):
        for metric, v in results[False][section][0].items():
            np.testing.assert_array_equal(results[True][section][0][metric], v)


def test_eval_cli_with_pallas_flag():
    """The CLI on the CPU: --pallas routes every attention layer through the
    packed attention op's plain version, for the same metrics; `--bf16`
    (bf16 activations) raises; EVAL_MATMUL_PRECISION "default", the
    one-pass bf16 matmul rung, is read: its metrics move off the fp32 run's,
    by less than 0.2 % (5e-4 measured on this fixture model)."""
    args = ["--weights", SMALL_H5, "--config", SMALL_CONFIG, "--dataset",
            DATA["dataset_path"], "--dataset_2d", DATA["dataset2d_path"],
            "--forced_mask_stride", "10", "--device", "cpu"]
    plain = main(args)[10]
    pallas = main(args + ["--pallas"])[10]
    _assert_fixture(plain, _reference(10), "cli")
    _assert_same(plain, pallas, "--pallas", atol=1e-3, rtol=1e-5)
    with pytest.raises(ValueError, match="float32"):
        main(args + ["--bf16"])
    high = _run(_config(5))
    default = _run(_config(5, EVAL_MATMUL_PRECISION="default"))
    for section in (0, 1):
        for metric, value in high[section][0].items():
            gap = abs(default[section][0][metric] - value)
            assert gap <= 2e-3 * value, (section, metric, gap)
        assert abs(default[section][0]["mpjpe"] - high[section][0]["mpjpe"]) > 1e-3


def test_sparse_rows_to_compute():
    """The cases of tests/test_eval_parity.py:253-277: keyframes, rows before
    a sequence's first keyframe, restarts across a batch boundary."""
    state = [None, False]
    assert sparse_rows_to_compute([3, 7, 10, 11, 15, 20], 5, state) == [0, 1, 2, 4, 5]
    assert sparse_rows_to_compute([21, 2, 4, 5, 9, 10], 5, state) == [1, 2, 3, 5]
    assert sparse_rows_to_compute([0, 1, 2, 3, 4, 5], 5, [None, False]) == [0, 5]


def test_scatter_parts_short_final_part():
    """Each part lands by its own row count: a short final part (the padded
    last batch, cut to its real rows) does not shift any row; a part whose
    rows and positions disagree raises."""
    rng = np.random.default_rng(0)
    full = rng.normal(size=(11, 17, 3)).astype(np.float32)
    order = rng.permutation(11)
    parts = [(torch.from_numpy(full[order[:4]]), order[:4]),
             (torch.from_numpy(full[order[4:8]]), order[4:8]),
             (torch.from_numpy(full[order[8:]]), order[8:])]  # 3 rows, not 4
    np.testing.assert_array_equal(scatter_parts(parts, 11, 17), full.astype(np.float64))
    with pytest.raises(AssertionError):
        scatter_parts([(torch.from_numpy(full[:4]), order[:3])], 11, 17)


def test_resolve_temporal_wpt():
    assert resolve_temporal_wpt("auto", 71) == 4   # s_pad 72: neither aligns
    assert resolve_temporal_wpt("auto", 41) == 8   # s_pad 48: 8·48 = 384
    assert resolve_temporal_wpt(None, 243) == 4
    assert resolve_temporal_wpt(2, 71) == 2


# -- the eval step's paths and the model's splices -----------------------------

def _flagship_small(**overrides):
    """h36m_351 topology at reduced width/length (as tests/test_bench_forward.py)."""
    from uplift_upsample_torch.config import UpliftUpsampleConfig
    config = UpliftUpsampleConfig()
    config.update_from({
        "SEQUENCE_LENGTH": 27, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 32,
        "TEMPORAL_EMBED_DIM": 64, "SPATIAL_TRANSFORMER_BLOCKS": 2,
        "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3, 3],
        "PADDINGS": [[0, 0], [0, 0], [0, 0]], "NUM_HEADS": 8,
        "MASK_STRIDE": 5, "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1,
    })
    config.update_from(overrides)
    return config


def _jax_and_port(seed):
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params

    config = _flagship_small()
    jmodel = jax_build(config)
    variables = init_model_params(jmodel, seed=seed)
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax(variables))
    return config, jmodel, variables, model


def _window_stream(rng, b, n, sparse_tokens):
    """Consecutive overlapping windows over one frame stream, masked, and
    their exact dedup (as the eval loop builds them)."""
    from uplift_upsample_torch.utils.dedup import dedup_rows

    stream = (rng.normal(size=(b + n - 1, 17, 2)) * 0.3).astype(np.float32)
    win = np.arange(b)[:, None] + np.arange(n)[None, :]
    sm = np.ones((b, n), bool)
    if sparse_tokens:
        sm[:] = False
        sm[:, ::2] = True
    xm = stream[win] * sm[:, :, None, None]
    uniq, inv = dedup_rows(xm.reshape(b * n, -1))
    return xm, sm, uniq.reshape(-1, 17, 2), inv.reshape(b, n)


@pytest.mark.parametrize("sparse_tokens", [False, True])
def test_shared_spatial_forward_matches_jax_model(sparse_tokens):
    """shared_spatial_forward (K1 on unique frames, s2t, gather into windows,
    K2, K3, tail; plain versions on the CPU) against the JAX model on the
    dense windows: 5e-5, the fused-path bar (tests/test_bench_forward.py:47).
    With all-real windows the key mask is dropped (assume_dense_mask)."""
    from uplift_upsample_torch.models.bench_forward import shared_spatial_forward

    config, jmodel, variables, model = _jax_and_port(17)
    xm, sm, uq, idx = _window_stream(np.random.default_rng(17), 4,
                                     config.SEQUENCE_LENGTH, sparse_tokens)
    if sparse_tokens:
        assert len(uq) <= 4 + config.SEQUENCE_LENGTH  # masked frames share one row
    _, ref = jmodel.apply(variables, xm, stride_mask=sm, training=False)
    got = shared_spatial_forward(model, torch.from_numpy(uq), torch.from_numpy(idx),
                                 torch.from_numpy(sm), assume_dense_mask=not sparse_tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-4)


def test_bench_forward_keyframe_sparse_matches_dense():
    """max_keyframes (K1 on the gathered real-input frames only) equals the
    dense path for mixed mask patterns, counts below and at the bound
    (2e-5, tests/test_bench_forward.py:148)."""
    from uplift_upsample_torch.models.bench_forward import bench_forward

    config, _, _, model = _jax_and_port(11)
    rng = np.random.default_rng(11)
    b, n = 4, config.SEQUENCE_LENGTH
    sm = np.zeros((b, n), dtype=bool)
    sm[0, 0::5] = True   # 6 keyframes (the bound)
    sm[1, 2::5] = True   # phase-shifted, 5
    sm[2, 1::10] = True  # sparser, 3
    sm[3, 4::7] = True   # irregular stride, 4
    xm = torch.from_numpy((rng.normal(size=(b, n, 17, 2)) * 0.3).astype(np.float32)
                          * sm[:, :, None, None])
    smt = torch.from_numpy(sm)
    dense = bench_forward(model, xm, smt)
    sparse = bench_forward(model, xm, smt, max_keyframes=6)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), atol=2e-5, rtol=0)


def test_model_splices():
    """s2t_output ∘ gather ∘ s2t_input, and the spatial_input splice after
    the spatial stack, equal the full model; N = 1 through the prefix."""
    from uplift_upsample_torch.ops.spatial import (spatial_stack_apply,
                                                   stack_spatial_params)

    config, _, _, model = _jax_and_port(19)
    rng = np.random.default_rng(19)
    b, n = 3, config.SEQUENCE_LENGTH
    stream = torch.from_numpy((rng.normal(size=(b + n - 1, 17, 2)) * 0.3).astype(np.float32))
    win = torch.arange(b)[:, None] + torch.arange(n)[None, :]
    sm = torch.ones((b, n), dtype=torch.bool)
    with torch.inference_mode():
        _, ref = model(stream[win], sm)
        y_u = model(stream[:, None], s2t_output=True)
        assert y_u.shape == (b + n - 1, 1, config.TEMPORAL_EMBED_DIM)
        _, central = model(y_u[:, 0][win], sm, s2t_input=True)
        state = {k: v for k, v in model.state_dict().items()}
        sp = spatial_stack_apply(stack_spatial_params(state, model.spatial_depth),
                                 stream[win], num_heads=model.num_heads)
        _, central_sp = model(sp, sm, spatial_input=True)
    np.testing.assert_allclose(central.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(central_sp.numpy(), ref.numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("fused", ["full", "none"])
def test_shared_step_matches_dense_step(fused):
    """make_test_step(shared_spatial=True) with flip-TTA (batched and two
    calls) equals the dense step on the same windows (2e-5)."""
    config, _, _, model = _jax_and_port(23)
    xm, sm, uq, idx = _window_stream(np.random.default_rng(23), 5,
                                     config.SEQUENCE_LENGTH, sparse_tokens=True)
    kwargs = dict(flip_tta=True, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                  fused=fused)
    _, dense = make_test_step(model, **kwargs)(torch.from_numpy(xm), torch.from_numpy(sm))
    for batched in (True, False):
        _, shared = make_test_step(model, shared_spatial=True, tta_batched=batched,
                                   **kwargs)(torch.from_numpy(uq), torch.from_numpy(idx),
                                             torch.from_numpy(sm))
        np.testing.assert_allclose(shared.numpy(), dense.numpy(), atol=2e-5, rtol=0)
