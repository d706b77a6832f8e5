"""The port's training CLI and the modules it needs, against the JAX package.

All on the CPU (`device="cpu"`), where the kernel wrappers run their plain
versions:
  - the TRAIN_FUSED_STRIDED wiring: the flag reaches `strided_block1_train`
    (the repair of a fault: the port read the flag and dropped it), the step
    with it on against off (loss rtol 1e-6, gradients under the grad bar),
    and 3 steps against the JAX `make_train_step` (loss rtol 1e-5, no
    stochastic depth: `jax.random` and `torch.Generator` draw different
    streams by design);
  - `make_val_step` against the JAX one (1e-5);
  - the device feed's batches against the port's host batchers and the JAX
    `materialize_*` (bit-identical values, flip and in-batch pairs);
  - the camera transform against `camera_ops.npz` (atol 2e-6 / 2e-5, the JAX
    test's bars) and the JAX function (1e-6); the AMASS loader, generator and
    batcher against the JAX ones and `gen_amass_train.npz` (1e-6);
  - `MetricHistory`, `ScalarLogger`, `resolve_weight_selector`;
  - `.h5` both ways, bit for bit, and the by-name load report;
  - one run of the port's `train_and_validate` against the JAX one from the
    same `.h5` (every scalar tag; LR and WD rtol 1e-6, losses rtol 1e-5,
    metrics within 1e-3 mm + rtol 1e-5, the eval tests' bar; the same .h5
    names; the exported EMA weights within the JAX trajectory bar plus lr0/5,
    ROADMAP C), and port-only smokes with resume and on AMASS.

Grad bar: per leaf atol 2e-4 × max(max|ref|, 1e-3), rtol 2e-3
(tests/test_train.py:448-451). Torch runs on one thread: six xdist workers
share the cores.
"""

import json
import os

import numpy as np
import pytest
import torch

from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.data.keypoint_order import H36MOrder17P
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.parallel import make_optimizer, make_train_step, make_val_step
from uplift_upsample_torch.parallel.train_step import (batch_to_device, make_loss_fn,
                                                       set_droppath_generator, step_generator)
from uplift_upsample_torch.utils.weights_h5 import params_from_jax, params_to_jax

torch.set_num_threads(1)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
SYNTH_DIR = os.path.join(FIXTURE_DIR, "synth")
H36M_3D = os.path.join(SYNTH_DIR, "data_3d_h36m.npz")
H36M_2D = os.path.join(SYNTH_DIR, "data_2d_h36m_synth.npz")
AMASS_DIR = os.path.join(SYNTH_DIR, "amass")


def _tiny(**over):
    """tests/test_train.py::_tiny_config, plus overrides."""
    config = UpliftUpsampleConfig()
    config.update_from(dict({
        "SEQUENCE_LENGTH": 9, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 16,
        "TEMPORAL_EMBED_DIM": 32, "SPATIAL_TRANSFORMER_BLOCKS": 1,
        "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3],
        "PADDINGS": [[0, 0], [0, 0]], "NUM_HEADS": 4, "MASK_STRIDE": [5, 10, 20],
        "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1, "BATCH_SIZE": 16,
        "DROP_PATH_RATE": [0.1, 0.1, 0.0], "EPOCHS": 2, "STEPS_PER_EPOCH": 4,
        "VALIDATION_INTERVAL": 1, "CHECKPOINT_INTERVAL": 1, "VALIDATION_EXAMPLES": 24,
        "OPTIMIZER": "AdamW", "OPTIMIZER_PARAMS": {}, "WEIGHT_DECAY": 4e-6,
        "SCHEDULE": "ExponentialDecay",
        "SCHEDULE_PARAMS": {"initial_learning_rate": 4e-5, "decay_steps": 6000,
                            "decay_rate": 0.99, "staircase": True},
        "EMA_ENABLED": True, "EMA_DECAY": 0.999,
        "STRIDE_MASK_RAND_SHIFT": True, "IN_BATCH_AUGMENT": True,
        "DATASET_VAL_3D_SUBSAMPLE_STEP": 10,
        "TRAIN_MATMUL_PRECISION": "high",  # the fp32 rung, as the JAX step on the CPU
    }, **over))
    config.AUGM_FLIP_KEYPOINT_ORDER = H36MOrder17P.flip_lr_indices()
    return config


# TRAIN_FUSED_SPATIAL and TRAIN_FUSED_TEMPORAL as "auto" resolves them on the
# card: K6 (TRAIN_FUSED_STRIDED) runs only behind the temporal kernel op.
STACKS_ON = dict(TRAIN_FUSED_SPATIAL=True, TRAIN_FUSED_TEMPORAL=True)


def _jax_config(config):
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    jc = JaxConfig()
    jc.update_from(config.to_dict())
    return jc


def _batch(config, seed=0):
    """Random poses and per-window stride masks from the mask-stride mix."""
    rng = np.random.default_rng(seed)
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    strides = rng.choice([1, 2, 4], size=b)
    phase = rng.integers(0, 4, size=b)
    sm = (np.arange(n)[None] + phase[:, None]) % strides[:, None] == 0
    return (rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.1,
            rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.1,
            np.ones((b, n), np.float32), np.zeros((b, 11), np.float32),
            np.zeros(b, np.int32), rng.integers(0, 15, size=b).astype(np.int32),
            np.zeros(b, np.int32), sm)


def _grad_bar(got, ref, what):
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=2e-3, err_msg=what)


def _loss_and_grads(model, config, batch):
    for p in model.parameters():
        p.grad = None
    model.train()
    generator = step_generator(config.SHUFFLE_SEED, 0)
    set_droppath_generator(model, generator)
    loss = make_loss_fn(model, config)(batch_to_device(batch, "cpu"), generator)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


# -- TRAIN_FUSED_STRIDED ---------------------------------------------------------

def test_config_flag_reaches_strided_train(monkeypatch):
    """TRAIN_FUSED_STRIDED=True (with the stacks' kernel ops on, as on the
    card) sends strided block 1 through the K6 op (on the CPU its plain
    version); False keeps the model's own block."""
    import uplift_upsample_torch.parallel.train_step as train_step

    calls = []
    real = train_step.strided_block1_train
    monkeypatch.setattr(train_step, "strided_block1_train",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    batch = _batch(_tiny())
    for flag, expected in ((True, 1), (False, 0)):
        config = _tiny(TRAIN_FUSED_STRIDED=flag, **STACKS_ON)
        model = build_uplift_upsample_transformer(config, device="cpu")
        calls.clear()
        _loss_and_grads(model, config, batch)
        assert len(calls) == expected, flag
    # "auto" is the kernel path on a CUDA device only; kernels=False never
    config = _tiny(TRAIN_FUSED_STRIDED="auto", **STACKS_ON)
    model = build_uplift_upsample_transformer(config, device="cpu")
    calls.clear()
    _loss_and_grads(model, config, batch)
    assert not calls
    config.TRAIN_FUSED_STRIDED = True
    make_loss_fn(model, config, kernels=False)(batch_to_device(batch, "cpu"),
                                                step_generator(0, 0))
    assert not calls


def test_config_flags_reach_train_kernels(monkeypatch):
    """TRAIN_FUSED_SPATIAL and TRAIN_FUSED_TEMPORAL decide which stacks run
    through their kernel ops (on the CPU their plain versions under
    autograd), chained as the JAX package chains them
    (`parallel/train_step.py:168-207`): temporal only with spatial, K6 only
    with temporal; "auto" is the card; kernels=False runs everything plain.
    Every setting computes the same loss."""
    import uplift_upsample_torch.parallel.train_step as train_step

    calls = []
    for name in ("spatial_stack_train", "temporal_stack_train", "strided_block1_train"):
        real = getattr(train_step, name)
        monkeypatch.setattr(train_step, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append(_n) or _r(*a, **kw))
    batch = _batch(_tiny())
    losses = []
    for (sp, tm, st), expected in (
            ((True, True, True), {"spatial_stack_train", "temporal_stack_train",
                                  "strided_block1_train"}),
            ((True, False, True), {"spatial_stack_train"}),
            ((False, True, True), set()),
            (("auto", "auto", True), set()),
            ((True, True, False), {"spatial_stack_train", "temporal_stack_train"})):
        config = _tiny(TRAIN_FUSED_SPATIAL=sp, TRAIN_FUSED_TEMPORAL=tm, TRAIN_FUSED_STRIDED=st)
        model = build_uplift_upsample_transformer(config, device="cpu", seed=1)
        calls.clear()
        losses.append(_loss_and_grads(model, config, batch)[0])
        assert set(calls) == expected, (sp, tm, st, calls)
    calls.clear()
    config = _tiny(TRAIN_FUSED_SPATIAL=True, TRAIN_FUSED_TEMPORAL=True, TRAIN_FUSED_STRIDED=True)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=1)
    make_loss_fn(model, config, kernels=False)(batch_to_device(batch, "cpu"),
                                                step_generator(0, 0))
    assert not calls
    np.testing.assert_allclose(losses, losses[0], rtol=1e-6)


def test_fused_strided_step_matches_unfused():
    """The step with the flag on against off, with stochastic depth in the
    tail (block 2 draws from the step's generator in both): loss rtol 1e-6,
    every gradient under the grad bar."""
    config = _tiny(DROP_PATH_RATE=[0.1, 0.1, 0.2], **STACKS_ON)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=2)
    batch = _batch(config, seed=5)
    config.TRAIN_FUSED_STRIDED = True
    loss_on, grads_on = _loss_and_grads(model, config, batch)
    config.TRAIN_FUSED_STRIDED = False
    loss_off, grads_off = _loss_and_grads(model, config, batch)
    np.testing.assert_allclose(loss_on, loss_off, rtol=1e-6)
    for key, g in grads_off.items():
        _grad_bar(grads_on[key].numpy(), g.numpy(), key)


def test_fused_strided_steps_match_jax():
    """3 steps of the port with TRAIN_FUSED_STRIDED on against the JAX
    make_train_step from the same weights (loss rtol 1e-5)."""
    import jax
    import jax.numpy as jnp
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.parallel import TrainState as JaxState
    from uplift_upsample_tpu.parallel import make_optimizer as jax_optimizer
    from uplift_upsample_tpu.parallel import make_train_step as jax_step

    # the JAX step runs its own CPU path ("auto" stacks: no Pallas kernels)
    jconfig = _jax_config(_tiny(DROP_PATH_RATE=[0.0, 0.0, 0.0]))
    config = _tiny(DROP_PATH_RATE=[0.0, 0.0, 0.0], TRAIN_FUSED_STRIDED=True, **STACKS_ON)
    jmodel = jax_build(jconfig)
    params = init_model_params(jmodel, seed=0)["params"]
    tx, _, _ = jax_optimizer(jconfig)
    jstate = JaxState(params=params, opt_state=tx.init(params),
                      ema_params=jax.tree.map(jnp.copy, params), step=jnp.zeros([], jnp.int32))
    jstep = jax_step(jmodel, tx, jconfig)
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax({"params": params}))
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    step = make_train_step(model, opt, config, device="cpu")
    losses, jlosses = [], []
    for s in range(3):
        batch = _batch(config, seed=20 + s)
        jstate, jloss = jstep(jstate, tuple(jnp.asarray(a) for a in batch))
        state, loss = step(state, batch)
        jlosses.append(float(jloss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


def test_val_step_matches_jax():
    """make_val_step (flip-TTA, EMA-like params passed in) against the JAX
    val step: the central prediction, the ground truth and the loss at 1e-5."""
    import jax
    import jax.numpy as jnp
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.parallel import make_val_step as jax_val_step

    config = _tiny(EVAL_FLIP=True)
    jconfig = _jax_config(config)
    jmodel = jax_build(jconfig)
    params = init_model_params(jmodel, seed=1)["params"]
    other = jax.tree.map(lambda a: a * 1.01, params)  # stands for the EMA weights
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax({"params": params}))
    batch = _batch(config, seed=3)
    jstep = jax_val_step(jmodel, jconfig)
    step = make_val_step(model, config, device="cpu")
    for p_jax, p_torch in ((params, None),
                           (other, dict(params_from_jax({"params": other})))):
        jp, jg, jl = jstep(p_jax, tuple(jnp.asarray(a) for a in batch))
        pc, gt, loss = step(p_torch, batch)
        np.testing.assert_allclose(pc.numpy(), np.asarray(jp), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(gt.numpy(), np.asarray(jg), atol=1e-6)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


# -- data ---------------------------------------------------------------------------

def _h36m_gens(config, pad_edge):
    from uplift_upsample_tpu.train import create_h36m_generators as jax_create

    from uplift_upsample_torch.train import create_h36m_generators
    out = []
    for create in (create_h36m_generators, create_h36m_generators, jax_create):
        gen, _, _ = create(H36M_3D, H36M_2D, config, "train", None, shuffle_seed=7)
        gen.windower.pad_edge = pad_edge
        out.append(gen)
    return out


def _amass_gens(config):
    from uplift_upsample_tpu.train import create_amass_generators as jax_create

    from uplift_upsample_torch.train import create_amass_generators
    return [create(AMASS_DIR, H36M_3D, config, "train_debug", None, target_frame_rate=50,
                   shuffle_seed=7)[0]
            for create in (create_amass_generators, create_amass_generators, jax_create)]


@pytest.mark.parametrize("case", ["h36m_edge", "h36m_zeros", "amass"])
def test_device_feed_bit_identical(case):
    """Device-feed batches (materialized here on the CPU) equal the port's
    host batcher's and the JAX `materialize_*`'s, over 6 batches (epoch
    boundaries and in-batch flip pairs included)."""
    import jax.numpy as jnp
    from uplift_upsample_tpu.data.device_feed import make_device_feed as jax_feed
    from uplift_upsample_tpu.data.fast_batcher import FastAMASSBatcher as JaxAMASS
    from uplift_upsample_tpu.data.fast_batcher import FastH36mBatcher as JaxH36m

    from uplift_upsample_torch.data.device_feed import make_device_feed
    from uplift_upsample_torch.data.fast_batcher import FastAMASSBatcher, FastH36mBatcher

    config = _tiny()
    if case == "amass":
        host_gen, feed_gen, jax_gen = _amass_gens(config)
        ours, theirs = FastAMASSBatcher, JaxAMASS
    else:
        host_gen, feed_gen, jax_gen = _h36m_gens(config, pad_edge=case == "h36m_edge")
        ours, theirs = FastH36mBatcher, JaxH36m
    b = config.BATCH_SIZE
    host = ours(host_gen, batch_size=b).batches()
    feed = make_device_feed(ours(feed_gen, batch_size=b), "cpu")
    jfeed = jax_feed(theirs(jax_gen, batch_size=b))
    plans, jplans = feed.plan_batches(), jfeed.plan_batches()
    for i in range(6):
        h, plan, jplan = next(host), next(plans), next(jplans)
        dev = feed.materialize(plan)
        ref = jfeed.materialize(jfeed.store, tuple(jnp.asarray(a) for a in jplan),
                                jfeed.pad_edge)
        assert len(h) == len(dev) == len(ref)
        for j, (a, d, r) in enumerate(zip(h, dev, ref)):
            np.testing.assert_array_equal(d.numpy(), np.asarray(a, dtype=d.numpy().dtype),
                                          err_msg=f"{case} batch {i} field {j} (host)")
            np.testing.assert_array_equal(d.numpy(), np.asarray(r, dtype=d.numpy().dtype),
                                          err_msg=f"{case} batch {i} field {j} (JAX)")
        ids = feed.host_ids(plan)
        np.testing.assert_array_equal(ids[0], np.asarray(h[-4]))
        np.testing.assert_array_equal(ids[1], np.asarray(h[-3]))


def test_camera_ops_match_reference_and_jax():
    """world_to_cam_and_2d against the reference tf.data stage's fixture and
    the JAX function."""
    import jax.numpy as jnp
    from uplift_upsample_tpu.ops.camera import world_to_cam_and_2d as jax_fn

    from uplift_upsample_torch.ops.camera import project_to_2d_linear, world_to_cam_and_2d
    ref = np.load(os.path.join(FIXTURE_DIR, "camera_ops.npz"))
    cam3d, pose2d = world_to_cam_and_2d(torch.from_numpy(ref["seq3d"]),
                                        torch.from_numpy(ref["cam18"]))
    np.testing.assert_allclose(cam3d.numpy(), ref["cam3d"], atol=2e-6)
    np.testing.assert_allclose(pose2d.numpy(), ref["pose2d"], atol=2e-5)
    jc, jp = jax_fn(jnp.asarray(ref["seq3d"]), jnp.asarray(ref["cam18"]))
    np.testing.assert_allclose(cam3d.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(pose2d.numpy(), np.asarray(jp), atol=1e-6, rtol=1e-6)
    from uplift_upsample_tpu.ops.camera import project_to_2d_linear as jax_linear
    intr = torch.from_numpy(ref["cam18"][:, 7:])[:, None, None, :]
    np.testing.assert_allclose(project_to_2d_linear(cam3d, intr).numpy(),
                               np.asarray(jax_linear(jc, jnp.asarray(intr.numpy()))),
                               atol=1e-6, rtol=1e-6)


def test_amass_loader_generator_batcher_match_jax():
    """AMASSDataset, AMASSSequenceGenerator (against `gen_amass_train.npz`,
    the reference's outputs) and FastAMASSBatcher against the JAX ones."""
    from uplift_upsample_tpu.data.fast_batcher import FastAMASSBatcher as JaxBatcher
    from uplift_upsample_tpu.data.generator import AMASSSequenceGenerator as JaxGen
    from uplift_upsample_tpu.data.mocap import AMASSDataset as JaxDataset

    from uplift_upsample_torch.data.fast_batcher import FastAMASSBatcher
    from uplift_upsample_torch.data.generator import AMASSSequenceGenerator
    from uplift_upsample_torch.data.mocap import AMASSDataset

    for split in ("train_debug", "val"):
        ours, ref = (cls(path=AMASS_DIR, h36m_path=None, split=split)
                     for cls in (AMASSDataset, JaxDataset))
        assert ours._data.keys() == ref._data.keys()
        for ds in ref._data:
            for subject, actions in ref._data[ds].items():
                for action, seq in actions.items():
                    np.testing.assert_array_equal(
                        ours._data[ds][subject][action]["positions"], seq["positions"])
    kwargs = dict(seq_len=9, subsample=2, stride=5, padding_type="copy", flip_augment=True,
                  in_batch_augment=False, mask_stride=[5, 10, 20],
                  stride_mask_align_global=False, rand_shift_stride_mask=True, shuffle=True,
                  seed=0, flip_lr_indices=H36MOrder17P.flip_lr_indices(), verbose=False)
    data = AMASSDataset(path=AMASS_DIR, h36m_path=None, split="train_debug")
    gen = AMASSSequenceGenerator(amass_dataset=data, **kwargs)
    fixture = np.load(os.path.join(FIXTURE_DIR, "gen_amass_train.npz"))
    assert len(gen) == int(fixture["length"])
    for epoch in ("e1", "e2"):  # as tests/test_pipeline_parity.py's _collect draws them
        items = []
        for i, item in enumerate(gen.next_epoch_iterator()):
            if i >= fixture[f"{epoch}_0"].shape[0]:
                break
            items.append(item)
        for col in range(len(items[0])):
            got = np.stack([np.asarray(item[col]) for item in items])
            np.testing.assert_allclose(got, fixture[f"{epoch}_{col}"], atol=1e-6,
                                       err_msg=f"{epoch} col {col}")
    jdata = JaxDataset(path=AMASS_DIR, h36m_path=None, split="train_debug")
    ours = FastAMASSBatcher(AMASSSequenceGenerator(amass_dataset=data, **kwargs), 24).batches()
    ref = JaxBatcher(JaxGen(amass_dataset=jdata, **kwargs), 24).batches()
    for i in range(4):
        for j, (a, r) in enumerate(zip(next(ours), next(ref))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(r), err_msg=f"{i} {j}")


def test_pipeline_matches_jax():
    """batched, repeat_epochs, eval_batches, train_batches and _threaded
    against the JAX package's, and a producer's exception reaching the
    consumer of _threaded."""
    from uplift_upsample_tpu.data import pipeline as jax_pipeline

    from uplift_upsample_torch.data import pipeline

    def epoch():
        return ((np.full(2, i, np.float32), i) for i in range(7))

    def take(mod, n):
        return [
            list(mod.batched(epoch(), 3)), list(mod.batched(epoch(), 3, drop_remainder=True)),
            list(mod.eval_batches(epoch, 10, 4)),
            [b for _, b in zip(range(n), mod.train_batches(epoch, 4, prefetch=2))],
            list(mod._threaded(iter(range(9)), depth=2))]

    for got, ref in zip(take(pipeline, 5), take(jax_pipeline, 5)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            for a, b in zip(g if isinstance(g, tuple) else (g,), r if isinstance(r, tuple)
                            else (r,)):
                np.testing.assert_array_equal(a, b)

    def failing():
        yield 1
        raise ValueError("producer failed")

    it = pipeline._threaded(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)


def test_metric_history_logger_selector_and_paths_match_jax(tmp_path):
    from uplift_upsample_tpu.train import resolve_weight_selector as jax_resolve
    from uplift_upsample_tpu.utils.metric_history import MetricHistory as JaxHistory
    from uplift_upsample_tpu.utils.scalar_log import ScalarLogger as JaxLogger

    from uplift_upsample_torch.train import resolve_weight_selector
    from uplift_upsample_torch.utils.metric_history import MetricHistory
    from uplift_upsample_torch.utils.scalar_log import ScalarLogger

    hists = [MetricHistory(), JaxHistory()]
    for h in hists:
        h.add_metric("loss", higher_is_better=False)
        h.add_metric("acc", higher_is_better=True)
        for step, (loss, acc) in enumerate([(3.0, 0.1), (2.0, 0.5), (2.5, 0.4)], start=1):
            h.add_data("loss", loss, step)
            h.add_data("acc", acc, step)
    ours, ref = hists
    assert ours.to_dict() == ref.to_dict()
    for m in ("loss", "acc"):
        assert ours.best_value(m) == ref.best_value(m)
        assert ours.latest_value(m) == ref.latest_value(m)
        assert ours.value_at_step(m, 2) == ref.value_at_step(m, 2)
    restored = MetricHistory()
    restored.restore(ref.to_dict())
    assert restored.to_dict() == ref.to_dict()

    for cls, name in ((ScalarLogger, "ours"), (JaxLogger, "ref")):
        logger = cls(str(tmp_path / name))
        logger.scalar("train/loss", np.float32(1.25), 1)
        logger.scalar("val/MPJPE", 42.0, 2)
        logger.close()
    read = lambda name: (tmp_path / name / "scalars.jsonl").read_text()
    assert read("ours") == read("ref")

    for fname in ("best_weights_0003.h5", "best_weights_0007.h5", "last_weights_0007.h5"):
        (tmp_path / fname).write_bytes(b"")
    for query in (str(tmp_path / "best_weights"), str(tmp_path / "last_weights"),
                  str(tmp_path / "x.h5"), None):
        assert resolve_weight_selector(query) == jax_resolve(query)
    with pytest.raises(FileNotFoundError):
        resolve_weight_selector(str(tmp_path / "none_such"))

    from uplift_upsample_tpu.utils import path_utils as jax_paths

    from uplift_upsample_torch.utils import path_utils
    target = str(tmp_path / "a" / "b")
    path_utils.mkdirs(target)
    path_utils.mkdirs(target)  # exists already: no error
    assert os.path.isdir(target)
    assert path_utils.expandpath("~/x/../y") == jax_paths.expandpath("~/x/../y")


# -- .h5 ------------------------------------------------------------------------------

def test_h5_both_directions_bit_for_bit(tmp_path):
    """The port's save_keras_h5 read by the JAX load_keras_h5 gives the same
    parameters bit for bit, and the JAX writer's file read by the port."""
    import jax
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.utils.weights_h5 import load_keras_h5 as jax_load
    from uplift_upsample_tpu.utils.weights_h5 import save_keras_h5 as jax_save

    from uplift_upsample_torch.utils.weights_h5 import load_keras_h5, save_keras_h5

    config = _tiny()
    model = build_uplift_upsample_transformer(config, device="cpu", seed=5)
    jmodel = jax_build(_jax_config(config))
    ours = str(tmp_path / "ours.h5")
    save_keras_h5(ours, None, model)
    loaded = jax.tree.map(np.asarray, jax_load(ours, jmodel)["params"])
    state = params_from_jax({"params": loaded})
    own = model.state_dict()
    assert set(state) == set(own)
    for key, value in state.items():
        assert torch.equal(value, own[key]), key

    params = jax.tree.map(np.asarray, init_model_params(jmodel, seed=4)["params"])
    theirs = str(tmp_path / "theirs.h5")
    jax_save(theirs, {"params": params}, jmodel)
    load_keras_h5(theirs, model)
    back = params_to_jax(dict(model.named_parameters()), model)["params"]
    flat = lambda t: {jax.tree_util.keystr(p): v
                      for p, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(back).keys() == flat(params).keys()
    for key, value in flat(params).items():
        np.testing.assert_array_equal(flat(back)[key], value, err_msg=key)
    # and the EMA-style export: weights given in place of the model's own
    ema = {k: p.detach() * 2 for k, p in model.named_parameters()}
    save_keras_h5(ours, ema, model)
    again = params_from_jax({"params": jax_load(ours, jmodel)["params"]})
    for key, value in ema.items():
        assert torch.equal(again[key], value), key


def test_load_by_name_report_matches_jax(tmp_path):
    """A partial load (a checkpoint of another geometry: 3 strided blocks and
    one temporal block, into the tiny model) gives the JAX loader's report
    and leaves the unassigned weights at their own values."""
    import jax
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.utils.weights_h5 import load_keras_h5_by_name as jax_by_name
    from uplift_upsample_tpu.utils.weights_h5 import save_keras_h5 as jax_save

    from uplift_upsample_torch.utils.weights_h5 import load_keras_h5_by_name

    other = _tiny(STRIDES=[3, 3, 1], PADDINGS=[[0, 0], [0, 0], [1, 1]],
                  TEMPORAL_TRANSFORMER_BLOCKS=1)
    jother = jax_build(_jax_config(other))
    path = str(tmp_path / "other.h5")
    jax_save(path, init_model_params(jother, seed=3), jother)

    config = _tiny()
    jmodel = jax_build(_jax_config(config))
    template = jax.tree.map(np.asarray, init_model_params(jmodel, seed=0))
    _, ref = jax_by_name(path, jmodel, template=template, verbose=False)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=9)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_keras_h5_by_name(path, model, verbose=False)
    for field in ("assigned", "unconsumed_layers", "unassigned_layers", "unconsumed_weights",
                  "unassigned_weights", "mismatched"):
        assert sorted(getattr(report, field)) == sorted(getattr(ref, field)), field
    assert report.summary().count("\n") == ref.summary().count("\n")
    assert report.unassigned_layers == ["temporal_block_2"]
    assert torch.equal(model.state_dict()["temporal_block_2.attn.wq.weight"],
                       before["temporal_block_2.attn.wq.weight"])
    assert not torch.equal(model.state_dict()["temporal_pe"], before["temporal_pe"])


# -- the CLI ------------------------------------------------------------------------

def _scalars(out_dir):
    rows = {}
    with open(os.path.join(out_dir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            rows[(r["tag"], r["step"])] = r["value"]
    return rows


def test_train_and_validate_matches_jax(tmp_path):
    """The port's train_and_validate against the JAX one, 2 epochs × 4 steps
    on the synthetic H3.6M pair, both from one .h5 written by the JAX writer
    from the JAX init, without stochastic depth."""
    import jax
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.train import train_and_validate as jax_train
    from uplift_upsample_tpu.utils.weights_h5 import load_keras_h5 as jax_load
    from uplift_upsample_tpu.utils.weights_h5 import save_keras_h5 as jax_save

    from uplift_upsample_torch.train import train_and_validate

    config = _tiny(DROP_PATH_RATE=[0.0, 0.0, 0.0])
    jconfig = _jax_config(config)
    jmodel = jax_build(jconfig)
    init = str(tmp_path / "init.h5")
    jax_save(init, init_model_params(jmodel, seed=0), jmodel)
    data = dict(dataset_name="h36m", h36m_path=H36M_3D, dataset_2d_path=H36M_2D,
                train_subset="train", val_subset="val", test_subset=None, weights=init)
    ours_dir, ref_dir = str(tmp_path / "ours"), str(tmp_path / "ref")
    hist, best, last = train_and_validate(config=config.copy(), out_dir=ours_dir,
                                          device="cpu", **data)
    jhist, jbest, jlast = jax_train(config=jconfig, out_dir=ref_dir, **data)

    ours, ref = _scalars(ours_dir), _scalars(ref_dir)
    assert ours.keys() == ref.keys()
    assert {tag for tag, _ in ref} >= {"train/loss", "train/LR", "train/WD",
                                       "train/step_duration", "val/loss", "val/MPJPE",
                                       "val/AW-MPJPE"}
    for (tag, step), value in ref.items():
        if tag == "train/step_duration":
            continue
        if tag in ("train/LR", "train/WD"):
            np.testing.assert_allclose(ours[tag, step], value, rtol=1e-6, err_msg=tag)
        elif tag.endswith("loss"):
            np.testing.assert_allclose(ours[tag, step], value, rtol=1e-5, err_msg=tag)
        else:  # metrics, mm
            np.testing.assert_allclose(ours[tag, step], value, atol=1e-3, rtol=1e-5,
                                       err_msg=tag)
    assert os.path.basename(best) == os.path.basename(jbest)
    assert os.path.basename(last) == os.path.basename(jlast)
    assert hist.to_dict()["metrics"] == jhist.to_dict()["metrics"]

    # exported EMA weights: the JAX trajectory bar plus lr0/5 (ROADMAP C)
    model = build_uplift_upsample_transformer(config, device="cpu")
    from uplift_upsample_torch.utils.weights_h5 import load_keras_h5
    load_keras_h5(last, model)
    want = params_from_jax({"params": jax.tree.map(np.asarray,
                                                   jax_load(jlast, jmodel)["params"])})
    lr0, steps = 4e-5, 8
    for key, w in model.state_dict().items():
        w, r = w.numpy(), want[key].numpy()
        if key.endswith("attn.wk.bias"):  # a noise walk: bound its reach
            np.testing.assert_allclose(w, r, atol=steps * lr0, err_msg=key)
            continue
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(w, r, atol=1e-3 * scale + 0.2 * lr0, rtol=2e-3,
                                   err_msg=key)


def test_train_smoke_and_resume(tmp_path):
    """Two epochs with the device feed and TRAIN_FUSED_STRIDED forced on (the
    card's defaults), then a resume to a third epoch: the checkpoint restores
    the state bit for bit, epochs 1-2 stay in the history, the best .h5 is
    the best of all epochs; a checkpoint of another structure raises."""
    from uplift_upsample_torch import train as train_mod
    from uplift_upsample_torch.utils.weights_h5 import load_keras_h5

    config = _tiny(TRAIN_DEVICE_FEED=True, TRAIN_FUSED_STRIDED=True, **STACKS_ON)
    out_dir = str(tmp_path / "run")
    kw = dict(out_dir=out_dir, dataset_name="h36m", h36m_path=H36M_3D,
              dataset_2d_path=H36M_2D, train_subset="train", val_subset="val",
              test_subset=None, device="cpu")
    saved = {}
    real_save = train_mod.save_checkpoint

    def spy_save(ckpt_dir, epoch, model, state):
        saved[epoch] = (
            {k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.items()}, state.step)
        return real_save(ckpt_dir, epoch, model, state)

    train_mod.save_checkpoint = spy_save
    try:
        hist, best, last = train_mod.train_and_validate(config=config.copy(), **kw)
    finally:
        train_mod.save_checkpoint = real_save
    assert last.endswith("last_weights_0002.h5") and os.path.exists(best)
    assert train_mod.checkpoint_epochs(os.path.join(out_dir, "checkpoints")) == [1, 2]
    tags = {tag for tag, _ in _scalars(out_dir)}
    assert {"train/loss", "train/LR", "train/WD", "val/MPJPE", "val/AW-MPJPE"} <= tags
    model = build_uplift_upsample_transformer(config, device="cpu")
    load_keras_h5(last, model)

    # the restore gives the saved state bit for bit
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    train_mod.restore_checkpoint(os.path.join(out_dir, "checkpoints"), 2, model, state)
    weights, ema, step = saved[2]
    assert state.step == step == 8
    assert all(torch.equal(v, weights[k]) for k, v in model.state_dict().items())
    assert all(torch.equal(v, ema[k]) for k, v in state.ema.items())

    config3 = config.copy()
    config3.EPOCHS = 3
    hist2, best2, last2 = train_mod.train_and_validate(config=config3,
                                                       continue_training=True, **kw)
    assert last2.endswith("last_weights_0003.h5")
    for epoch in (1, 2, 3):
        assert hist2.value_at_step("MPJPE", epoch) is not None, epoch
    assert hist2.value_at_step("MPJPE", 1) == hist.value_at_step("MPJPE", 1)
    _, best_epoch = hist2.best_value(config.BEST_CHECKPOINT_METRIC)
    assert best2.endswith(f"best_weights_{best_epoch:04d}.h5") and os.path.exists(best2)

    other = _tiny(EMA_ENABLED=False)
    model = build_uplift_upsample_transformer(other, device="cpu")
    state = make_optimizer(other)[0].init(model, ema=False)
    with pytest.raises(RuntimeError, match="does not match"):
        train_mod.restore_checkpoint(os.path.join(out_dir, "checkpoints"), 3, model, state)


def test_train_amass_smoke_and_export_guard(tmp_path, monkeypatch):
    """The AMASS path (camera projection inside the step, frame-wise
    validation, .h5 export) for 1 epoch; without h5py, export_h5=True fails
    before training and export_h5=False trains without writing any .h5."""
    from uplift_upsample_torch import train as train_mod

    config = _tiny(EPOCHS=1, BEST_CHECKPOINT_METRIC="AW-MPJPE")
    kw = dict(dataset_name="amass", amass_path=AMASS_DIR, h36m_path=H36M_3D,
              train_subset="train_debug", val_subset="val", test_subset=None, device="cpu")
    hist, best, last = train_mod.train_and_validate(config=config.copy(),
                                                    out_dir=str(tmp_path / "a"), **kw)
    assert np.isfinite(hist.latest_value("MPJPE")) and "AW-MPJPE" not in hist.metrics
    assert best.endswith("best_weights_0001.h5") and last.endswith("last_weights_0001.h5")

    real_find = train_mod.importlib.util.find_spec
    monkeypatch.setattr(train_mod.importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real_find(name, *a))
    with pytest.raises(RuntimeError, match="h5py"):
        train_mod.train_and_validate(config=config.copy(), out_dir=str(tmp_path / "b"), **kw)
    assert not os.path.exists(str(tmp_path / "b"))
    hist, best, last = train_mod.train_and_validate(config=config.copy(),
                                                    out_dir=str(tmp_path / "c"),
                                                    export_h5=False, **kw)
    assert best is None and last is None and np.isfinite(hist.latest_value("MPJPE"))
    files = [f for _, _, fs in os.walk(str(tmp_path / "c")) for f in fs]
    assert not [f for f in files if f.endswith(".h5")] and "ckpt_0001.pt" in files
    with open(str(tmp_path / "c" / "train_history.json")) as f:
        assert json.load(f)["last_weights_path"] is None
