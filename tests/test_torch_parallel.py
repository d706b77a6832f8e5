"""The port's data-parallel steps on 2 gloo ranks (CPU), against the port's
1-process step on the global batch and the JAX package's mesh steps
(tests/test_parallel.py):

  - `make_train_step(dp=)` over 3 steps with stochastic depth and EMA on, the
    stacks through their kernel ops' plain versions and the keyframe budget
    sized per rank (B=256: 1,024 of each rank's 1,152 frames, 1,792 of the
    1-process step's 2,304): losses at rtol 2e-5, params and EMA at atol 2e-4
    (`tests/test_parallel.py:77-81`), the two ranks bit-identical;
  - without stochastic depth, the same step against the JAX
    `make_train_step(mesh=make_mesh(num_devices=2))` from the same params,
    at the same bars;
  - `make_test_step(dp=)`, dense and shared (unique frames + win_idx),
    flip-TTA on and off, `fused` "none" and "full" (the kernels' plain
    versions here), against the 1-process step and the JAX
    `make_test_step(mesh=)` at 2e-5 (`tests/test_parallel.py:108-160`);
  - `run_eval(dp=)` on the synthetic S9/S11 pair, every reported metric
    against the 1-process run (the eval tests' bar: 1e-3 mm + rtol 1e-5);
  - DATA_PARALLEL_DEVICES 2 without torchrun raises ValueError in both CLIs.

Each multi-process run stays inside one test function (the suite runs on 6
xdist workers), on a `file://` store under tmp_path; torch runs on one
thread.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dp_workers import eval_run, eval_steps, spawn, train_steps
from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.data.keypoint_order import H36MOrder17P
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.parallel import make_optimizer, make_train_step
from uplift_upsample_torch.parallel.train_step import keyframe_budget
from uplift_upsample_torch.utils.weights_h5 import params_from_jax

torch.set_num_threads(1)

STEPS = 3


def _tiny(**over):
    """tests/test_parallel.py::_tiny_config, plus overrides."""
    config = UpliftUpsampleConfig()
    config.update_from(dict({
        "SEQUENCE_LENGTH": 9, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 16,
        "TEMPORAL_EMBED_DIM": 32, "SPATIAL_TRANSFORMER_BLOCKS": 1,
        "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3],
        "PADDINGS": [[0, 0], [0, 0]], "NUM_HEADS": 4, "MASK_STRIDE": [5, 10, 20],
        "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1, "BATCH_SIZE": 16,
        "DROP_PATH_RATE": 0.0, "DROP_RATE": 0.0, "TOKEN_MASK_RATE": 0.0,
        "TRAIN_MATMUL_PRECISION": "high",  # the fp32 rung, as the JAX step on the CPU
        "OPTIMIZER": "AdamW", "OPTIMIZER_PARAMS": {}, "WEIGHT_DECAY": 4e-6,
        "EMA_ENABLED": True, "EMA_DECAY": 0.999,
        "SCHEDULE": "ExponentialDecay",
        "SCHEDULE_PARAMS": {"initial_learning_rate": 1e-4, "decay_steps": 6000,
                            "decay_rate": 0.99, "staircase": True},
    }, **over))
    config.AUGM_FLIP_KEYPOINT_ORDER = H36MOrder17P.flip_lr_indices()
    return config


def _batch(config, seed):
    """Random poses and per-window stride masks from the mask-stride mix."""
    rng = np.random.default_rng(seed)
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    strides = rng.choice([1, 2, 4], size=b)  # mask strides 5, 10, 20 over stride 5
    phase = rng.integers(0, 4, size=b)
    sm = (np.arange(n)[None] + phase[:, None]) % strides[:, None] == 0
    return (rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.1,
            rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.1,
            np.ones((b, n), np.float32), np.zeros((b, 11), np.float32),
            np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, np.int32), sm)


def _jax_params(config):
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    jmodel = jax_build(config)
    return jmodel, init_model_params(jmodel, seed=0)["params"]


def _run_dp(tmp_path, config, init_state, batches):
    """The 2-rank dp step's results per rank."""
    init = str(tmp_path / "init.pt")
    torch.save(init_state, init)
    out = tmp_path / "out"
    out.mkdir()
    spawn(train_steps, 2, tmp_path, config.to_dict(), init, batches, str(out))
    return [torch.load(str(out / f"rank{r}.pt"), weights_only=True) for r in range(2)]


def _assert_ranks_identical(ranks):
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for key in ("params", "ema"):
        for name, v in ranks[0][key].items():
            assert torch.equal(v, ranks[1][key][name]), (key, name)


def _assert_close(ranks, losses, params, ema):
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=2e-5)
    np.testing.assert_allclose(ranks[0]["loss_sum"], float(np.sum(losses)), rtol=2e-5)
    for key, ref in (("params", params), ("ema", ema)):
        assert ranks[0][key].keys() == ref.keys()
        for name, v in ref.items():
            np.testing.assert_allclose(ranks[0][key][name].numpy(), np.asarray(v), atol=2e-4,
                                       err_msg=f"{key} {name}")


def test_dp_train_step_matches_single_process(tmp_path):
    config = _tiny(BATCH_SIZE=256, DROP_PATH_RATE=[0.1, 0.1, 0.0],
                   TRAIN_FUSED_SPATIAL=True, TRAIN_FUSED_TEMPORAL=True)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    assert (keyframe_budget(model, config, 128), keyframe_budget(model, config)) == (1024, 1792)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [_batch(config, seed=s) for s in range(STEPS)]
    for batch in batches:  # no rank's keyframes overflow its budget
        assert batch[-1][:128].sum() <= 1024 and batch[-1][128:].sum() <= 1024

    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    step = make_train_step(model, opt, config, device="cpu")
    losses = [float(step(state, batch)[1]) for batch in batches]

    ranks = _run_dp(tmp_path, config, init, batches)
    _assert_ranks_identical(ranks)
    _assert_close(ranks, losses, model.state_dict(), state.ema)


def test_dp_train_step_matches_jax_mesh(tmp_path):
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.parallel import TrainState as JaxState
    from uplift_upsample_tpu.parallel import make_mesh, shard_batch
    from uplift_upsample_tpu.parallel import make_optimizer as jax_optimizer
    from uplift_upsample_tpu.parallel import make_train_step as jax_step

    config = _tiny()
    jconfig = JaxConfig()
    jconfig.update_from(config.to_dict())
    jmodel, params = _jax_params(jconfig)
    init = params_from_jax({"params": params})  # the jitted step donates its state
    tx, _, _ = jax_optimizer(jconfig)
    jstate = JaxState(params=params, opt_state=tx.init(params),
                      ema_params=jax.tree.map(jnp.copy, params),
                      step=jnp.zeros([], jnp.int32))
    mesh = make_mesh(num_devices=2)
    jstep = jax_step(jmodel, tx, jconfig, mesh=mesh, rng_seed=0)
    batches = [_batch(config, seed=10 + s) for s in range(STEPS)]
    losses = []
    for batch in batches:
        jstate, loss = jstep(jstate, shard_batch(batch, mesh))
        losses.append(float(loss))

    ranks = _run_dp(tmp_path, config, init, batches)
    _assert_ranks_identical(ranks)
    _assert_close(ranks, losses,
                  params_from_jax({"params": jax.tree.map(np.asarray, jstate.params)}),
                  params_from_jax({"params": jax.tree.map(np.asarray, jstate.ema_params)}))


def _eval_inputs(config):
    """Dense inputs (x unmasked, stride mask) and the shared step's (unique
    masked frames padded to a multiple of 8, win_idx, stride mask)."""
    from uplift_upsample_torch.utils.dedup import dedup_rows
    rng = np.random.default_rng(3)
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    x = rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.3
    sm = (np.arange(n) % 3 == 0)[None].repeat(b, 0)
    sm[:, n // 2] = True
    uniq, inv = dedup_rows((x * sm[:, :, None, None]).reshape(b * n, -1))
    uq = np.zeros((-(-len(uniq) // 8) * 8, k, 2), np.float32)
    uq[:len(uniq)] = uniq.reshape(-1, k, 2)
    return (x, sm), (uq, inv.reshape(b, n).astype(np.int64), sm)


def test_dp_eval_step_matches_single_process_and_jax_mesh(tmp_path):
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.eval import make_test_step as jax_test_step
    from uplift_upsample_tpu.parallel import make_mesh

    from uplift_upsample_torch.eval import make_test_step

    config = _tiny()
    jconfig = JaxConfig()
    jconfig.update_from(config.to_dict())
    jmodel, params = _jax_params(jconfig)
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax({"params": params}))
    model.eval()
    dense, shared = _eval_inputs(config)
    flip_idx = H36MOrder17P.flip_lr_indices()
    cases = {}
    for fused in ("none", "full"):
        for flip in (False, True):
            for name, inputs in (("dense", dense), ("shared", shared)):
                kwargs = dict(flip_tta=flip, flip_lr_indices=flip_idx, fused=fused,
                              shared_spatial=name == "shared")
                cases[f"{name} fused={fused} flip={flip}"] = (kwargs, inputs)

    init = str(tmp_path / "init.pt")
    torch.save(dict(model.state_dict()), init)
    out = tmp_path / "out"
    out.mkdir()
    spawn(eval_steps, 2, tmp_path, config.to_dict(), init, cases, str(out))
    ranks = [torch.load(str(out / f"rank{r}.pt"), weights_only=False) for r in range(2)]

    mesh = make_mesh(num_devices=2)
    for name, (kwargs, inputs) in cases.items():
        seq, central = ranks[0][name]
        for got, want in zip((seq, central), ranks[1][name]):  # every rank: the whole batch
            assert (got is None and want is None) or np.array_equal(got, want), name
        ref_seq, ref_central = make_test_step(model, **kwargs)(
            *(torch.from_numpy(a) for a in inputs))
        np.testing.assert_allclose(central, ref_central.numpy(), atol=2e-5, err_msg=name)
        assert (seq is None) == (ref_seq is None), name
        if seq is not None:
            np.testing.assert_allclose(seq, ref_seq.numpy(), atol=2e-5, err_msg=name)
        jkw = dict(kwargs, fused="none")  # the JAX CPU mesh runs the XLA path
        jseq, jcentral = jax_test_step(jmodel, {"params": params}, mesh=mesh, **jkw)(
            *(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in inputs))
        np.testing.assert_allclose(central, np.asarray(jcentral), atol=2e-5,
                                   err_msg=f"{name} vs JAX")
        if seq is not None:
            np.testing.assert_allclose(seq, np.asarray(jseq), atol=2e-5,
                                       err_msg=f"{name} vs JAX")


def _metrics(result):
    """Every number run_eval reports (frame and action-wise averages, all
    frames and keyframes)."""
    return {f"{sec}/{kind}/{m}": float(v)
            for sec, part in zip(("all", "kf"), result)
            for kind, d in zip(("frame", "aw"), part[:2]) for m, v in d.items()}


def test_dp_run_eval_matches_single_process(tmp_path):
    from uplift_upsample_torch.eval import run_eval

    synth = os.path.join(os.path.dirname(__file__), "fixtures", "synth")
    data = dict(dataset_name="h36m", dataset_path=os.path.join(synth, "data_3d_h36m.npz"),
                dataset2d_path=os.path.join(synth, "data_2d_h36m_synth.npz"),
                test_subset="test", action_wise=True, verbose=False)
    config = _tiny(MASK_STRIDE=10)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    init = str(tmp_path / "init.pt")
    torch.save(dict(model.state_dict()), init)
    out = tmp_path / "out"
    out.mkdir()
    spawn(eval_run, 2, tmp_path, config.to_dict(), init, data, str(out))
    ranks = [_metrics(torch.load(str(out / f"rank{r}.pt"), weights_only=False))
             for r in range(2)]
    assert ranks[0] == ranks[1]
    ref = _metrics(run_eval(config, model=model, device="cpu", **data))
    assert ranks[0].keys() == ref.keys() and len(ref) == 12
    for key, value in ref.items():
        np.testing.assert_allclose(ranks[0][key], value, rtol=1e-5, atol=1e-3, err_msg=key)


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_data_parallel_devices_without_torchrun_raises(cli, tmp_path, monkeypatch):
    """DATA_PARALLEL_DEVICES 2 in a launch of one process: both CLIs raise
    before any data or weights are read, naming the torchrun command."""
    import importlib

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    config = UpliftUpsampleConfig()
    config.DATA_PARALLEL_DEVICES = 2
    path = str(tmp_path / "dp2.json")
    config.dump(path)
    mod = importlib.import_module(f"uplift_upsample_torch.{cli}")
    argv = (["--out_dir", str(tmp_path / "out")] if cli == "train"
            else ["--weights", str(tmp_path / "missing.h5")])
    with pytest.raises(ValueError, match=f"torchrun --nproc-per-node 2 -m "
                                         f"uplift_upsample_torch.{cli}"):
        mod.main(["--config", path, "--device", "cpu", *argv])
    assert not os.path.exists(str(tmp_path / "out"))
