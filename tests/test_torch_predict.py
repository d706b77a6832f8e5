"""The port's serving path on the CPU: fused forward, test step, predict CLI,
its host data code, and the import boundary.

The fused forward runs the kernels' plain versions here (CPU tensors); the
same code launches the CUDA kernels on the card (chip_smoke.py).
"""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.configs import resolve_config
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.utils.weights_h5 import load_keras_h5, params_from_jax

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL_H5 = os.path.join(FIXTURE_DIR, "small_strided.h5")
SMALL_CONFIG = os.path.join(FIXTURE_DIR, "eval_small_config.json")


def _flagship_small(**overrides):
    """h36m_351 topology at reduced width/length (as tests/test_bench_forward.py)."""
    config = UpliftUpsampleConfig()
    config.update_from({
        "SEQUENCE_LENGTH": 27, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 32,
        "TEMPORAL_EMBED_DIM": 64, "SPATIAL_TRANSFORMER_BLOCKS": 2,
        "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3, 3],
        "PADDINGS": [[0, 0], [0, 0], [0, 0]], "NUM_HEADS": 8,
        "MASK_STRIDE": 5, "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1,
        "DROP_PATH_RATE": [0.1, 0.1, 0.0],
    })
    config.update_from(overrides)
    return config


@pytest.mark.parametrize("geometry", ["h36m_351", "h36m_81"])
def test_bench_forward_plain_matches_jax_model(geometry):
    """bench_forward (K1-K3 plain versions + plain tail) vs the JAX
    model.apply on the same weights: 5e-5, the JAX package's fused-path bar
    (tests/test_bench_forward.py:47). h36m_81 is the padded (1,1) block 1."""
    pytest.importorskip("jax")
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params

    from uplift_upsample_torch.models.bench_forward import bench_forward

    over = {} if geometry == "h36m_351" else {
        "STRIDES": [4, 4, 3], "PADDINGS": [[1, 1], [0, 0], [0, 0]],
        "SEQUENCE_LENGTH": 41, "MASK_STRIDE": 4}
    config = _flagship_small(**over)
    jmodel = jax_build(config)
    variables = init_model_params(jmodel, seed=0)
    rng = np.random.default_rng(0)
    b, n, ms = 3, config.SEQUENCE_LENGTH, config.MASK_STRIDE
    sm = (np.arange(n) % ms == 0)[None].repeat(b, axis=0)
    sm[1] = np.roll(sm[1], 2)  # a second phase of the mask
    x = (rng.normal(size=(b, n, 17, 2)) * 0.3).astype(np.float32) * sm[:, :, None, None]
    _, ref = jmodel.apply(variables, x, stride_mask=sm, training=False)

    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax(variables))
    got = bench_forward(model, torch.from_numpy(x), torch.from_numpy(sm))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("tta_batched", [True, False])
def test_test_step_full_matches_plain_model(tta_batched):
    """make_test_step: the fused path (plain kernel versions on the CPU) equals
    the plain model with flip-TTA, batched or as two calls (2e-5)."""
    from uplift_upsample_torch.eval import make_test_step

    config = _flagship_small()
    model = build_uplift_upsample_transformer(config, device="cpu", seed=4)
    rng = np.random.default_rng(4)
    n = config.SEQUENCE_LENGTH
    x = torch.from_numpy((rng.normal(size=(3, n, 17, 2)) * 0.3).astype(np.float32))
    sm = torch.from_numpy((np.arange(n) % 5 == 0)[None].repeat(3, axis=0))
    kwargs = dict(flip_tta=True, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                  tta_batched=tta_batched)
    _, fused = make_test_step(model, fused="full", **kwargs)(x, sm)
    _, plain = make_test_step(model, fused="none", **kwargs)(x, sm)
    _, no_tta = make_test_step(model, fused="none", flip_tta=False,
                               flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER)(x, sm)
    torch.testing.assert_close(fused, plain, atol=2e-5, rtol=1e-4)
    assert float((plain - no_tta).abs().max()) > 1e-6  # TTA is not a no-op


@pytest.mark.parametrize("precision", ["default", "high"])
def test_predict_step_reads_eval_precision(precision):
    """make_predict_step hands EVAL_MATMUL_PRECISION to make_test_step, as the
    eval CLI does: "default", the one-pass bf16 rung, moves the output off
    the fp32 one ("high"), which matches `precision` omitted bit for bit."""
    from uplift_upsample_torch.eval import make_test_step
    from uplift_upsample_torch.predict import make_predict_step

    config = _flagship_small(EVAL_MATMUL_PRECISION=precision)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    n = config.SEQUENCE_LENGTH
    x = torch.from_numpy((rng.normal(size=(2, n, 17, 2)) * 0.3).astype(np.float32))
    sm = torch.from_numpy((np.arange(n) % 5 == 0)[None].repeat(2, axis=0))
    _, got = make_predict_step(model, config)(x, sm)
    _, fp32 = make_test_step(model, flip_tta=True,
                             flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER)(x, sm)
    if precision == "default":
        gap = float((got - fp32).abs().max())
        assert 0 < gap <= 0.05 * float(fp32.abs().max()), gap
    else:
        assert torch.equal(got, fp32)


def _small_models():
    jax_config = pytest.importorskip("uplift_upsample_tpu.configs").resolve_config(
        SMALL_CONFIG)
    config = resolve_config(SMALL_CONFIG)
    for c in (config, jax_config):
        c.MASK_STRIDE = c.MASK_STRIDE[0]
    model = load_keras_h5(SMALL_H5, build_uplift_upsample_transformer(config, device="cpu"))
    return config, jax_config, model


@pytest.mark.parametrize("t,flip_tta", [(57, False), (130, True)])
def test_predict_sequence_matches_jax(t, flip_tta):
    """predict_sequence vs the JAX predict_sequence on small_strided.h5 with
    eval_small_config.json: windows, masks, batching (BATCH_SIZE 16, so the
    26 computed windows of 130 frames make a full batch and an edge-padded
    tail; 57 frames is not a stride multiple), flip-TTA and keyframe
    interpolation; 1e-5."""
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.predict import predict_sequence as jax_predict
    from uplift_upsample_tpu.utils.weights_h5 import load_keras_h5 as jax_load

    from uplift_upsample_torch.predict import predict_sequence

    config, jax_config, model = _small_models()
    jax_config.BATCH_SIZE = config.BATCH_SIZE = 16  # several batches + a padded tail
    jmodel = jax_build(jax_config)
    variables = jax_load(SMALL_H5, jmodel)
    rng = np.random.default_rng(t)
    kps = (rng.normal(size=(t, 17, 2)) * 0.3).astype(np.float32)
    ref = jax_predict(jmodel, variables, jax_config, kps, flip_tta=flip_tta)
    got = predict_sequence(model, config, kps, flip_tta=flip_tta)
    assert got.shape == (t, 17, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def _main(args):
    from uplift_upsample_torch.predict import main
    main(["--weights", SMALL_H5, "--config", SMALL_CONFIG, "--device", "cpu", *args])


def test_predict_cli_writes_npz(tmp_path):
    rng = np.random.default_rng(3)
    inp, out = tmp_path / "kps.npz", tmp_path / "pred.npz"
    np.savez(inp, positions_2d=rng.normal(size=(120, 17, 2)).astype(np.float32) * 0.3)
    _main(["--input", str(inp), "--output", str(out)])
    pred = np.load(out)["sequence"]
    assert pred.shape == (120, 17, 3) and np.isfinite(pred).all()
    # keyframes (stride 5) carry raw predictions; frames between interpolate
    np.testing.assert_allclose(pred[2], pred[0] * 0.6 + pred[5] * 0.4, atol=1e-5)


def test_predict_empty_sequence():
    """An empty sequence gives an empty result (the JAX version fails on one)."""
    from uplift_upsample_torch.predict import predict_sequence

    config = resolve_config(SMALL_CONFIG)
    config.MASK_STRIDE = config.MASK_STRIDE[0]
    model = build_uplift_upsample_transformer(config, device="cpu")
    got = predict_sequence(model, config, np.zeros((0, 17, 2), np.float32))
    assert got.shape == (0, 17, 3) and got.dtype == np.float32


def test_predict_vp3d_input_order(tmp_path):
    """--input_order vp3d equals the canonical-order run after the remap."""
    from uplift_upsample_torch.data.keypoint_order import H36MOrder17POriginalOrder

    rng = np.random.default_rng(5)
    kps_ours = (rng.normal(size=(40, 17, 2)) * 0.3).astype(np.float32)
    to_our = np.asarray(H36MOrder17POriginalOrder.to_our_17p_order())
    kps_vp3d = np.empty_like(kps_ours)
    kps_vp3d[:, to_our] = kps_ours
    outs = {}
    for order, kps in (("ours", kps_ours), ("vp3d", kps_vp3d)):
        inp, out = tmp_path / f"kps_{order}.npz", tmp_path / f"pred_{order}.npz"
        np.savez(inp, positions_2d=kps)
        _main(["--input", str(inp), "--output", str(out), "--input_order", order,
               "--no_flip_tta"])
        outs[order] = np.load(out)["sequence"]
    np.testing.assert_array_equal(outs["ours"], outs["vp3d"])


def test_predict_flip_tta_equivariance_and_multiseq(tmp_path):
    """Flip-TTA makes prediction L/R-equivariant (predicting the flipped input
    returns the flip-map of the prediction); covers dict (multi-sequence)
    input, and TTA changes the output."""
    config = resolve_config(SMALL_CONFIG)
    flip_idx = np.asarray(config.AUGM_FLIP_KEYPOINT_ORDER)
    rng = np.random.default_rng(9)
    kps = (rng.normal(size=(35, 17, 2)) * 0.3).astype(np.float32)
    kps_flipped = np.concatenate([-kps[..., :1], kps[..., 1:]], axis=-1)[:, flip_idx]
    inp = tmp_path / "kps_multi.npz"
    np.savez(inp, positions_2d=np.array({"orig": kps, "flipped": kps_flipped},
                                        dtype=object))
    out_tta, out_no = tmp_path / "pred_tta.npz", tmp_path / "pred_no.npz"
    _main(["--input", str(inp), "--output", str(out_tta)])
    preds = np.load(out_tta)
    p_orig, p_flip = preds["orig"], preds["flipped"]
    expected = np.concatenate([-p_orig[..., :1], p_orig[..., 1:]], axis=-1)[:, flip_idx]
    np.testing.assert_allclose(p_flip, expected, atol=2e-5, rtol=1e-4)
    _main(["--input", str(inp), "--output", str(out_no), "--no_flip_tta"])
    assert np.abs(np.load(out_no)["orig"] - p_orig).max() > 1e-6


def test_entry_points_need_a_card_unless_cpu(tmp_path):
    """Without a card, the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    config = resolve_config(SMALL_CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_uplift_upsample_transformer(config)
    inp = tmp_path / "kps.npz"
    np.savez(inp, positions_2d=np.zeros((10, 17, 2), np.float32))
    from uplift_upsample_torch.predict import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--weights", SMALL_H5, "--config", SMALL_CONFIG, "--input", str(inp),
              "--output", str(tmp_path / "o.npz")])


def test_port_imports_neither_jax_nor_the_jax_package():
    """Parse every module of the port, chip_smoke.py and kernel_probe.py: no
    `jax` and no `uplift_upsample_tpu` import, at any depth."""
    files = sorted((REPO / "uplift_upsample_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "kernel_probe.py"]
    assert len(files) > 10
    # the eval slice's modules among them, the numpy copies included, and
    # the bench slice's
    for name in ("eval.py", "ops/packed_attention.py", "data/loading.py", "data/mocap.py",
                 "data/h36m_cameras.py", "utils/metrics.py", "utils/dedup.py",
                 "bench.py", "ops/s2t.py", "models/bench_forward.py"):
        assert REPO / "uplift_upsample_torch" / name in files, name
    banned = {"jax", "jaxlib", "flax", "uplift_upsample_tpu"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_host_data_matches_jax():
    """The copied generator, batcher, keypoint order and interpolation give
    bit-identical arrays to the JAX package's."""
    from uplift_upsample_tpu.data import fast_batcher as jfb
    from uplift_upsample_tpu.data import generator as jgen
    from uplift_upsample_tpu.data.keypoint_order import (
        H36MOrder17POriginalOrder as JOrder)
    from uplift_upsample_tpu.utils.eval_protocol import (
        interpolate_between_keyframes as j_interp)

    from uplift_upsample_torch.data import fast_batcher as tfb
    from uplift_upsample_torch.data import generator as tgen
    from uplift_upsample_torch.data.keypoint_order import H36MOrder17POriginalOrder
    from uplift_upsample_torch.utils.eval_protocol import interpolate_between_keyframes

    assert H36MOrder17POriginalOrder.to_our_17p_order() == JOrder.to_our_17p_order()
    rng = np.random.default_rng(21)
    videos = [rng.normal(size=(t, 17, 2)).astype(np.float32) for t in (23, 40)]

    def batches(gen_mod, fb_mod):
        gen = gen_mod.H36mSequenceGenerator(
            [np.zeros((len(v), 17, 3), np.float32) for v in videos], videos,
            camera_params=[np.zeros(11, np.float32)] * 2, subjects=[0, 1],
            actions=[0, 1], frame_rates=[50, 50], split="test", seq_len=9,
            stride=2, padding_type="copy", mask_stride=[2, 4], flip_augment=True,
            in_batch_augment=True,
            flip_lr_indices=UpliftUpsampleConfig.AUGM_FLIP_KEYPOINT_ORDER,
            rand_shift_stride_mask=True, shuffle=False, verbose=False)
        it = fb_mod.FastH36mBatcher(gen, batch_size=50).batches()
        return [next(it) for _ in range(3)]

    for ours, ref in zip(batches(tgen, tfb), batches(jgen, jfb)):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    pred = rng.normal(size=(30, 17, 3))
    frames = np.concatenate([np.arange(17), np.arange(13)])
    for got, ref in zip(interpolate_between_keyframes(pred, frames, 5),
                        j_interp(pred, frames, 5)):
        np.testing.assert_array_equal(got, ref)
