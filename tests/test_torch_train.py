"""The port's training step against the reference fixtures and the JAX step.

All on the CPU, where the training kernels' wrappers run their plain
versions under autograd:
  - schedules against the JAX package's, and one AdamW step by hand;
  - `grad_small_strided`: the loss and every gradient leaf against the TF
    reference's tape (tests/test_train.py:389-452, same bars);
  - `traj_*`: schedule pins, the per-step loss curve, final weights, EMA and
    `loss_sum` against the reference loop (tests/test_train.py:296-386);
  - 5 steps against the JAX `make_train_step` with MASK_STRIDE [5, 10, 20]
    and no stochastic depth: the port, with TRAIN_FUSED_SPATIAL on (the
    spatial kernels' plain versions here), gathers keyframes into a sparse
    budget, the JAX CPU path runs every frame;
  - keyframe-sparse against dense, and the NaN on an overflowing budget,
    both with TRAIN_FUSED_SPATIAL on: only the spatial kernels take a
    budget; with it off the port, like the JAX package, runs every frame
    and trains on a batch that overflows the budget;
  - the training guards; the train-mode batcher against the JAX one.
"""

import os

import numpy as np
import pytest
import torch

from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.parallel import make_optimizer, make_train_step
from uplift_upsample_torch.parallel.train_step import (keyframe_budget, make_loss_fn,
                                                       step_generator)
from uplift_upsample_torch.utils import schedules
from uplift_upsample_torch.utils.weights_h5 import (load_keras_h5, params_from_jax,
                                                    read_keras_h5)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
SYNTH_DIR = os.path.join(FIXTURE_DIR, "synth")
_SMALL = {
    "SEQUENCE_LENGTH": 9, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 16,
    "TEMPORAL_EMBED_DIM": 32, "SPATIAL_TRANSFORMER_BLOCKS": 2,
    "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3],
    "PADDINGS": [[0, 0], [0, 0]], "NUM_HEADS": 4, "BATCH_SIZE": 4,
    "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1,
    "DROP_PATH_RATE": [0.0, 0.0, 0.0], "MASK_STRIDE": 3,
    "ROOT_KEYTPOINT": 0, "LOSS_WEIGHT_CENTER": 1.0, "LOSS_WEIGHT_SEQUENCE": 2.0,
    # the fp32 rung: the TF fixtures and the JAX step on the CPU compute fp32
    # (the class default "default" is the one-pass bf16 rung)
    "TRAIN_MATMUL_PRECISION": "high",
}


def _config(**over):
    config = UpliftUpsampleConfig()
    config.update_from(dict(_SMALL, **over))
    return config


def _assert_grad_close(got, ref, what):
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=2e-3, err_msg=what)


@pytest.mark.parametrize("name,kwargs", [
    ("exponential_decay", dict(initial_learning_rate=4e-5, decay_steps=6000,
                               decay_rate=0.99, staircase=True)),
    ("exponential_decay_with_steps", dict(initial_learning_rate=1e-3, decay_steps=12000,
                                          decay_rate=0.95, large_decay_steps=60000,
                                          large_decay_rate=0.5)),
    ("piecewise_constant_decay", dict(boundaries=[100, 110], values=[1.0, 0.5, 0.1])),
    ("cosine_decay_restarts", dict(initial_learning_rate=1.0, first_decay_steps=10,
                                   t_mul=2.0, m_mul=0.5, alpha=0.1)),
    ("cosine_decay_restarts", dict(initial_learning_rate=4e-5, first_decay_steps=6000,
                                   t_mul=1.0, m_mul=1.0, alpha=0.0)),
])
def test_schedules_match_jax(name, kwargs):
    from uplift_upsample_tpu.utils import schedules as jax_schedules
    ours, ref = getattr(schedules, name)(**kwargs), getattr(jax_schedules, name)(**kwargs)
    for step in (0, 3, 5, 99, 100, 101, 110, 111, 2999, 5999, 6000, 12000, 12345, 18001,
                 60000, 72000):
        got = ours(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} step {step}")


def test_adamw_step_by_hand():
    """Two AdamW updates against the Keras formulas (ε outside the bias
    correction, decoupled wd on its own schedule), as
    tests/test_train.py::test_adamw_decoupled_wd_semantics."""
    config = _config(OPTIMIZER="AdamW", OPTIMIZER_PARAMS={}, WEIGHT_DECAY=1e-2,
                     SCHEDULE="ExponentialDecay",
                     SCHEDULE_PARAMS={"initial_learning_rate": 1e-3, "decay_steps": 10,
                                      "decay_rate": 0.5, "staircase": True})
    opt, _, _ = make_optimizer(config)
    model = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.tensor([[1.0, -2.0]]))
    state = opt.init(model, ema=False)
    params = dict(model.named_parameters())
    lr, wd, b1, b2, eps = 1e-3, 1e-2, 0.9, 0.999, 1e-8
    p0 = np.array([1.0, -2.0])
    g, g2 = np.array([0.5, 0.25]), np.array([0.1, -0.3])
    opt.apply(params, {"weight": torch.tensor(g[None], dtype=torch.float32)}, state)
    state.step += 1
    m, v = (1 - b1) * g, (1 - b2) * g ** 2
    p1 = p0 - lr * np.sqrt(1 - b2) / (1 - b1) * m / (np.sqrt(v) + eps) - wd * p0
    np.testing.assert_allclose(model.weight.detach().numpy()[0], p1, rtol=1e-6)
    opt.apply(params, {"weight": torch.tensor(g2[None], dtype=torch.float32)}, state)
    m2, v2 = b1 * m + (1 - b1) * g2, b2 * v + (1 - b2) * g2 ** 2
    p2 = (p1 - lr * np.sqrt(1 - b2 ** 2) / (1 - b1 ** 2) * m2 / (np.sqrt(v2) + eps)
          - wd * p1)
    np.testing.assert_allclose(model.weight.detach().numpy()[0], p2, rtol=1e-6)


def _fixture_batch(data, s=None):
    pick = (lambda a: a[s]) if s is not None else (lambda a: a)
    kp3, kp2, sm = pick(data["keypoints3d"]), pick(data["keypoints2d"]), pick(data["stride_mask"])
    b, n = sm.shape
    return (kp3, kp2, np.ones((b, n), np.float32), np.zeros((b, 11), np.float32),
            np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, np.int32), sm)


def test_grad_parity_vs_reference():
    """Loss and every gradient leaf of the port's loss against the reference
    TF train step's tape (`grad_small_strided`)."""
    from uplift_upsample_torch.parallel.train_step import batch_to_device
    case = "grad_small_strided"
    data = np.load(os.path.join(FIXTURE_DIR, f"{case}.npz"))
    config = _config(EMA_ENABLED=False)
    model = build_uplift_upsample_transformer(config, device="cpu")
    assert model.full_output and model.has_strided_input
    load_keras_h5(os.path.join(FIXTURE_DIR, f"{case}.h5"), model)
    ref = params_from_jax(read_keras_h5(os.path.join(FIXTURE_DIR, f"{case}_grads.h5"),
                                        model))
    model.train()
    loss = make_loss_fn(model, config)(batch_to_device(_fixture_batch(data), "cpu"),
                                       step_generator(0, 0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(data["loss"]), rtol=1e-5)
    params = dict(model.named_parameters())
    assert set(params) == set(ref) and len(ref) > 20
    for key, p in params.items():
        _assert_grad_close(p.grad.numpy(), ref[key].numpy(), key)


def _traj_config(case):
    """Config matching tools/make_trajectory_fixture.py's cases (as
    tests/test_train.py::_traj_config)."""
    config = _config()
    if case == "traj_adamw":
        config.update_from({
            "OPTIMIZER": "AdamW", "OPTIMIZER_PARAMS": {}, "WEIGHT_DECAY": 1e-4,
            "SCHEDULE": "ExponentialDecay",
            "SCHEDULE_PARAMS": {"initial_learning_rate": 1e-3, "decay_steps": 7,
                                "decay_rate": 0.8, "staircase": True},
            "EMA_ENABLED": True, "EMA_DECAY": 0.999})
    elif case == "traj_h81_long":
        config.update_from({
            "SEQUENCE_LENGTH": 11, "STRIDES": [4, 3], "PADDINGS": [[1, 1], [0, 0]],
            "LEARNABLE_MASKED_TOKEN": True, "OPTIMIZER": "AdamW", "OPTIMIZER_PARAMS": {},
            "WEIGHT_DECAY": 1e-4, "SCHEDULE": "ExponentialDecayWithSteps",
            "SCHEDULE_PARAMS": {"initial_learning_rate": 1e-3, "decay_steps": 20,
                                "decay_rate": 0.9, "large_decay_steps": 120,
                                "large_decay_rate": 0.3},
            "EMA_ENABLED": True, "EMA_DECAY": 0.999})
    else:
        config.update_from({
            "OPTIMIZER": "Adam", "OPTIMIZER_PARAMS": {"amsgrad": True, "epsilon": 1e-8},
            "SCHEDULE": "ExponentialDecayWithSteps",
            "SCHEDULE_PARAMS": {"initial_learning_rate": 1e-3, "decay_steps": 6,
                                "decay_rate": 0.7, "large_decay_steps": 15,
                                "large_decay_rate": 0.5},
            "EMA_ENABLED": False})
    return config


def _assert_weights_close(ours, ref, steps, lr0, what, floor=0.0):
    assert set(ours) == set(ref) and len(ref) > 20
    for key, w in ours.items():
        w, r = w.detach().numpy(), ref[key].numpy()
        if key.endswith("attn.wk.bias"):
            # The key bias's true gradient is 0 (softmax shift invariance);
            # autodiff returns cancellation noise that Adam turns into O(lr)
            # steps, a random walk in the reference too: bound its reach.
            np.testing.assert_allclose(w, r, atol=steps * lr0, err_msg=f"{what} {key}")
            continue
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(w, r, atol=1e-3 * scale + floor, rtol=2e-3,
                                   err_msg=f"{what} {key}")


# Adam moves an element whose gradient sits at the rounding floor by up to lr
# per step whatever its size, so a trajectory inherits the summation order of
# its matrix products. The JAX CPU path sums as TF's reference does (both
# Eigen) and ends within 6e-8 of it; torch's CPU products sum in another
# order, at the same per-step gradient error (~1e-6 of each leaf's scale
# against the TF tape, as JAX's). Over these two runs that noise reaches
# single elements by up to a fifth of the first learning rate; the JAX step
# itself, started from weights perturbed by 1e-7, breaks the bare bar on
# traj_h81_long in 100 elements. `floor` is that fifth of lr0.
_ROUNDING_FLOOR = {"traj_adamw": 0.0, "traj_adam_ams": 0.2, "traj_h81_long": 0.2}


@pytest.mark.parametrize("case", ["traj_adamw", "traj_adam_ams", "traj_h81_long"])
def test_trajectory_parity_vs_reference(case):
    """The port's make_train_step replays the reference loop's stream: the
    schedules at the pre-increment step, the loss curve, the final weights,
    the final EMA and loss_sum (bars of tests/test_train.py)."""
    data = np.load(os.path.join(FIXTURE_DIR, f"{case}.npz"))
    steps = len(data["losses"])
    config = _traj_config(case)
    model = build_uplift_upsample_transformer(config, device="cpu")
    load_keras_h5(os.path.join(FIXTURE_DIR, f"{case}_init.h5"), model)
    opt, lr_schedule, wd_schedule = make_optimizer(config)
    state = opt.init(model, ema=config.EMA_ENABLED)
    step = make_train_step(model, opt, config, device="cpu")
    losses = []
    for s in range(steps):
        np.testing.assert_allclose(float(lr_schedule(s)), data["lrs"][s], rtol=1e-6)
        if wd_schedule is not None:
            np.testing.assert_allclose(float(wd_schedule(s)), data["wds"][s], rtol=1e-6)
        state, loss = step(state, _fixture_batch(data, s))
        losses.append(float(loss))
    loss_rtol = 1e-3 if steps > 100 else 3e-4
    np.testing.assert_allclose(losses, data["losses"], rtol=loss_rtol, atol=1e-5)

    def ref_state(h5):
        return params_from_jax(read_keras_h5(os.path.join(FIXTURE_DIR, h5), model))

    lr0 = float(data["lrs"][0])
    floor = _ROUNDING_FLOOR[case] * lr0
    _assert_weights_close(dict(model.named_parameters()), ref_state(f"{case}_final.h5"),
                          steps, lr0, "final weights", floor)
    if config.EMA_ENABLED and os.path.exists(os.path.join(FIXTURE_DIR, f"{case}_ema.h5")):
        _assert_weights_close(state.ema, ref_state(f"{case}_ema.h5"), steps, lr0, "EMA",
                              floor)
    np.testing.assert_allclose(float(state.loss_sum), np.sum(losses), rtol=1e-5)


def _mixed_batch(config, seed=0):
    """Random poses and per-window stride masks from the h36m mask-stride mix."""
    rng = np.random.default_rng(seed)
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    strides = rng.choice([1, 2, 4], size=b)  # mask strides 5, 10, 20 over stride 5
    phase = rng.integers(0, 4, size=b)
    sm = (np.arange(n)[None] + phase[:, None]) % strides[:, None] == 0
    return (rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.1,
            rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.1,
            np.ones((b, n), np.float32), np.zeros((b, 11), np.float32),
            np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, np.int32), sm)


def _sparse_config(**over):
    return _config(**dict(dict(
        MASK_STRIDE=[5, 10, 20], BATCH_SIZE=32, TRAIN_SPATIAL_BLOCK_F=128,
        TRAIN_KEYFRAME_BUDGET=200, OPTIMIZER="AdamW", OPTIMIZER_PARAMS={},
        WEIGHT_DECAY=4e-6, SCHEDULE="ExponentialDecay",
        SCHEDULE_PARAMS={"initial_learning_rate": 1e-4, "decay_steps": 6000,
                         "decay_rate": 0.99, "staircase": True},
        EMA_ENABLED=True, EMA_DECAY=0.999), **over))


def test_train_step_matches_jax():
    """5 steps of the port (keyframe-sparse spatial budget of 256 of 288
    frames) against the JAX make_train_step on the CPU (every frame through
    the flax model) from the same weights: the loss curve, the final
    weights, EMA and loss_sum."""
    import jax
    import jax.numpy as jnp
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.parallel import TrainState as JaxState
    from uplift_upsample_tpu.parallel import make_optimizer as jax_optimizer
    from uplift_upsample_tpu.parallel import make_train_step as jax_step

    config = _sparse_config()
    jmodel = jax_build(config)
    pconfig = config.copy()  # the port's sparse path; JAX stays on its CPU path
    pconfig.TRAIN_FUSED_SPATIAL = True
    params = init_model_params(jmodel, seed=0)["params"]
    tx, _, _ = jax_optimizer(config)
    jstate = JaxState(params=params, opt_state=tx.init(params),
                      ema_params=jax.tree.map(jnp.copy, params),
                      step=jnp.zeros([], jnp.int32))
    jstep = jax_step(jmodel, tx, config)

    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax({"params": params}))
    assert keyframe_budget(model, pconfig) == 256
    opt, _, _ = make_optimizer(pconfig)
    state = opt.init(model, ema=True)
    step = make_train_step(model, opt, pconfig, device="cpu")

    losses, jlosses = [], []
    for s in range(5):
        batch = _mixed_batch(config, seed=s)
        assert batch[-1].sum() <= 256
        jstate, jloss = jstep(jstate, tuple(jnp.asarray(a) for a in batch))
        state, loss = step(state, batch)
        jlosses.append(float(jloss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    ref = params_from_jax({"params": jax.tree.map(np.asarray, jstate.params)})
    _assert_weights_close(dict(model.named_parameters()), ref, 5, 1e-4, "weights")
    ref_ema = params_from_jax({"params": jax.tree.map(np.asarray, jstate.ema_params)})
    _assert_weights_close(state.ema, ref_ema, 5, 1e-4, "EMA")
    np.testing.assert_allclose(float(state.loss_sum), float(jstate.loss_sum), rtol=1e-5)


def _loss_and_grads(config, model, batch):
    from uplift_upsample_torch.parallel.train_step import batch_to_device
    for p in model.parameters():
        p.grad = None
    model.train()
    loss = make_loss_fn(model, config)(batch_to_device(batch, "cpu"), step_generator(0, 0))
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_keyframe_sparse_matches_dense():
    """Masked frames' spatial outputs are replaced by the strided-input token,
    so gathering only keyframes changes neither the loss nor any gradient
    (tests/test_fused_spatial_train.py:202-242)."""
    config = _sparse_config(DROP_PATH_RATE=[0.1, 0.1, 0.0], TRAIN_FUSED_SPATIAL=True)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=3)
    batch = _mixed_batch(config, seed=11)
    assert keyframe_budget(model, config) == 256 and batch[-1].sum() <= 256
    loss_s, grads_s = _loss_and_grads(config, model, batch)
    config.TRAIN_KEYFRAME_SPARSE = False
    assert keyframe_budget(model, config) is None
    loss_d, grads_d = _loss_and_grads(config, model, batch)
    np.testing.assert_allclose(loss_s, loss_d, rtol=1e-6)
    for key, g in grads_d.items():
        np.testing.assert_allclose(grads_s[key].numpy(), g.numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=key)


def test_keyframe_sparse_overflow_gives_nan():
    """More keyframes than the budget poisons the loss with NaN instead of
    dropping keyframes (tests/test_fused_spatial_train.py:245-267)."""
    config = _sparse_config(BATCH_SIZE=16, TRAIN_KEYFRAME_BUDGET=128,
                            TRAIN_FUSED_SPATIAL=True)
    model = build_uplift_upsample_transformer(config, device="cpu")
    assert keyframe_budget(model, config) == 128
    batch = list(_mixed_batch(config))
    batch[-1] = np.ones((16, config.SEQUENCE_LENGTH), bool)  # 144 > 128
    loss, _ = _loss_and_grads(config, model, tuple(batch))
    assert not np.isfinite(loss)


def test_plain_spatial_overflow_matches_jax():
    """With TRAIN_FUSED_SPATIAL off the port sizes no keyframe budget and
    applies the model to every frame, as the JAX package does
    (`parallel/train_step.py:302-304, 376-379`): on the batch that overflows
    the budget above, the loss is finite and equals the JAX make_loss_fn's
    from the same weights."""
    import jax
    import jax.numpy as jnp
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.parallel.train_step import make_loss_fn as jax_loss_fn

    config = _sparse_config(BATCH_SIZE=16, TRAIN_KEYFRAME_BUDGET=128,
                            TRAIN_FUSED_SPATIAL=False)
    jmodel = jax_build(config)
    params = init_model_params(jmodel, seed=0)["params"]
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax({"params": params}))
    assert keyframe_budget(model, config) == 128
    batch = list(_mixed_batch(config))
    batch[-1] = np.ones((16, config.SEQUENCE_LENGTH), bool)  # 144 > 128
    batch = tuple(batch)
    rngs = {name: jax.random.PRNGKey(i)
            for i, name in enumerate(("dropout", "droppath", "token_mask"))}
    jloss = float(jax.jit(jax_loss_fn(jmodel, config))(
        params, tuple(jnp.asarray(a) for a in batch), rngs))
    loss, _ = _loss_and_grads(config, model, batch)
    assert np.isfinite(loss) and np.isfinite(jloss)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)


def test_h36m_351_budget():
    """The shipped h36m_351 mix at B=512: 25,600 of 36,352 frames."""
    from uplift_upsample_torch.configs import get_config
    config = get_config("h36m_351")
    model = build_uplift_upsample_transformer(config, device="cpu")
    assert keyframe_budget(model, config) == 25_600


@pytest.mark.parametrize("key,value", [("OUTPUT_BN", True), ("DROP_RATE", 0.1),
                                       ("ATTENTION_DROP_RATE", 0.1),
                                       ("TOKEN_MASK_RATE", 0.1),
                                       ("LEARNABLE_MASKED_TOKEN", True)])
def test_unported_training_features_raise(key, value):
    """OUTPUT_BN, and token masking with LEARNABLE_MASKED_TOKEN, still raise
    in training: the JAX step fails on both, so there is no function to
    match. DROP_RATE, ATTENTION_DROP_RATE and TOKEN_MASK_RATE train now (held
    against the JAX step in test_torch_train_dropout.py): each turns the
    kernel stages off, and a step with them runs to a finite loss and
    gradient."""
    over = {key: value, "TRAIN_FUSED_SPATIAL": True, "TRAIN_FUSED_TEMPORAL": True}
    if key == "LEARNABLE_MASKED_TOKEN":
        over["TOKEN_MASK_RATE"] = 0.1
    config = _config(**over)
    model = build_uplift_upsample_transformer(config, device="cpu")
    if key in ("OUTPUT_BN", "LEARNABLE_MASKED_TOKEN"):
        with pytest.raises(NotImplementedError, match="the JAX step fails there too"):
            make_loss_fn(model, config)
        return
    from uplift_upsample_torch.parallel.train_step import fused_stages
    assert fused_stages(model, config, kernels=True) == (False, False, False)
    loss, grads = _loss_and_grads(config, model, _mixed_batch(config))
    assert np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())


def test_droppath_module_train_and_eval():
    """DropPath keeps whole samples with probability keep and scales them by
    1/keep in training, and is the identity under eval."""
    from uplift_upsample_torch.models.primitives import DropPath
    layer = DropPath(0.25)
    layer.generator = torch.Generator().manual_seed(0)
    x = torch.ones(100_000, 2, 3)
    y = layer.train()(x)
    per_sample = y[:, 0, 0]
    assert torch.equal(y, per_sample[:, None, None].expand_as(y))
    assert set(np.unique(per_sample.numpy()).tolist()) <= {0.0, np.float32(1 / 0.75)}
    assert abs(float((per_sample > 0).float().mean()) - 0.75) <= 0.01 * 0.75
    assert layer.eval()(x) is x


def test_train_batcher_matches_jax():
    """The train-mode FastH36mBatcher (shuffle, flip with in-batch pairs,
    mask strides [5, 10, 20] with a random shift) gives the JAX batcher's
    arrays bit for bit, for 3 batches."""
    from uplift_upsample_tpu.data.fast_batcher import FastH36mBatcher as JaxBatcher
    from uplift_upsample_tpu.data.generator import H36mSequenceGenerator as JaxGenerator
    from uplift_upsample_tpu.data.loading import (filter_and_subsample_dataset,
                                                  load_dataset_and_2d_poses)

    from uplift_upsample_torch.data.fast_batcher import FastH36mBatcher
    from uplift_upsample_torch.data.generator import H36mSequenceGenerator
    from uplift_upsample_torch.data.keypoint_order import H36MOrder17P

    dataset, keypoints = load_dataset_and_2d_poses(
        os.path.join(SYNTH_DIR, "data_3d_h36m.npz"),
        os.path.join(SYNTH_DIR, "data_2d_h36m_synth.npz"), verbose=False)
    cams, p3d, p2d, _, subj, act, frates = filter_and_subsample_dataset(
        dataset=dataset, poses_2d=keypoints, subjects=["S1", "S5"], action_filter="*",
        downsample=1, image_base_path=None, verbose=False)
    kwargs = dict(camera_params=cams, subjects=subj, actions=act, frame_rates=frates,
                  split="train", seq_len=9, subsample=1, stride=5, padding_type="copy",
                  flip_augment=True, in_batch_augment=True,
                  flip_lr_indices=H36MOrder17P.flip_lr_indices(), mask_stride=[5, 10, 20],
                  stride_mask_align_global=False, rand_shift_stride_mask=True,
                  shuffle=True, seed=0, verbose=False)
    ours = FastH36mBatcher(H36mSequenceGenerator(p3d, p2d, **kwargs), batch_size=32).batches()
    ref = JaxBatcher(JaxGenerator(p3d, p2d, **kwargs), batch_size=32).batches()
    for i in range(3):
        for j, (a, r) in enumerate(zip(next(ours), next(ref))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(r),
                                          err_msg=f"batch {i} col {j}")
