"""The port's tensor parallelism on gloo ranks (CPU) in dp × mp layouts, held
against one process and the JAX package's TP mesh (tests/test_parallel.py):

  - the TP forward (`build_uplift_upsample_transformer(tp=)`, the Megatron
    modules) at mp = 2 and dp × mp = 2 × 2 against the 1-process model and
    the JAX forward with `shard_params_tp` on its 4 × 2 mesh, at 1e-5
    (`tests/test_parallel.py:103-104`);
  - 3 TP train steps at mp = 2 and 2 × 2 with stochastic depth and the
    kernel ops' plain versions on gathered weights, against one process;
    without stochastic depth against the JAX dp × mp step with
    `shard_params_tp` params: losses
    at rtol 2e-5, params and EMA at atol 2e-4 (`test_parallel.py:77-81`),
    replicated parameters bit-identical over the mp peers;
  - `make_test_step(tp=)`, fused "none" and "full", shared-spatial and
    dense, with flip-TTA, at mp = 2 and 2 × 2 against the dp step over
    every rank at 1e-4, shared-spatial also against the JAX TP step; at
    mp = 2 on the bf16 rung against one process within the rung's bar;
  - the dry run's resume (`tools/dryrun_multichip.py`) within 1e-6;
  - the dry-run tool at `--device cpu --config tiny --devices 4`: exit 0,
    MULTICHIP_CORE_OK and 9/9 stages; without a card and without
    `--device cpu` it raises;
  - the bench routes other than the default raise under mp > 1;
    USE_PALLAS_ATTENTION builds there.

Each multi-process run stays inside one test function, on a `file://` store
under tmp_path; torch runs on one thread.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torch_tp_workers import eval_steps, forward, resume_check, spawn, train_steps
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.parallel import make_optimizer, make_train_step
from uplift_upsample_torch.parallel.sharding import TensorParallel, param_spec
from uplift_upsample_torch.tools.dryrun_multichip import dry_config
from uplift_upsample_torch.utils.weights_h5 import params_from_jax, params_to_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
LAYOUTS = [(1, 2), (2, 2)]


def _tiny(**over):
    config = dry_config("tiny", 16)
    config.update_from(over)
    return config


def _jax(config):
    """The JAX config, model and params: the port's seeded weights in the
    JAX layout (`params_to_jax`), which spares the JAX init's compile."""
    import jax.numpy as jnp
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build

    jconfig = JaxConfig()
    jconfig.update_from(config.to_dict())
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    params = params_to_jax(model.state_dict(), model)["params"]
    return jconfig, jax_build(jconfig), jax.tree.map(jnp.asarray, params)


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


def _spawn(fn, tmp_path, dp, mp, *args):
    out = tmp_path / f"out_{fn.__name__}_{dp}x{mp}"
    out.mkdir()
    spawn(fn, dp * mp, tmp_path, dp, mp, *args, str(out))
    return [torch.load(str(out / f"rank{r}.pt"), weights_only=False) for r in range(dp * mp)]


def _save_init(tmp_path, state):
    init = str(tmp_path / "init.pt")
    torch.save({k: v.clone() for k, v in state.items()}, init)
    return init


@pytest.mark.parametrize("dp, mp", LAYOUTS)
def test_tp_forward_matches_single_process_and_jax(tmp_path, dp, mp):
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from uplift_upsample_tpu.parallel.sharding import shard_params_tp as jax_shard

    config = _tiny()
    _, jmodel, params = _jax(config)
    batch = _batch(config, seed=0)
    x, sm = batch[1], batch[7]
    fn = jax.jit(lambda p, x, sm: jmodel.apply({"params": p}, x, stride_mask=sm,
                                               training=False))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "mp"))
    xm = jnp.asarray(x * sm[:, :, None, None])
    j_full, j_central = fn(jax_shard(params, mesh, tp_axis="mp"),
                           jax.device_put(xm, NamedSharding(mesh, P("dp"))),
                           jax.device_put(jnp.asarray(sm), NamedSharding(mesh, P("dp"))))

    state = params_from_jax({"params": params})
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        full, central = model(torch.from_numpy(x * sm[:, :, None, None]), torch.from_numpy(sm))
    ranks = _spawn(forward, tmp_path, dp, mp, config.to_dict(), _save_init(tmp_path, state),
                   (x, sm))
    for got_full, got_central in ranks:
        np.testing.assert_allclose(got_central, central.numpy(), atol=1e-5)
        np.testing.assert_allclose(got_full, full.numpy(), atol=1e-5)
        np.testing.assert_allclose(got_central, np.asarray(j_central), atol=1e-5)
        np.testing.assert_allclose(got_full, np.asarray(j_full), atol=1e-5)


def _replicated_identical(ranks, mp):
    """Replicated parameters bit-identical over every rank, each split one
    over the ranks of one mp index."""
    for r in ranks[1:]:
        for name, v in ranks[0]["local"].items():
            if param_spec(name, v) is None:
                assert torch.equal(v, r["local"][name]), name
    for r, got in enumerate(ranks):
        for name, v in got["local"].items():
            assert torch.equal(v, ranks[r % mp]["local"][name]), name


def _assert_close(ranks, losses, params, ema):
    for got in ranks:
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
        for key, ref in (("params", params), ("ema", ema)):
            assert got[key].keys() == ref.keys()
            for name, v in ref.items():
                np.testing.assert_allclose(got[key][name].numpy(), np.asarray(v), atol=2e-4,
                                           err_msg=f"{key} {name}")


@pytest.mark.parametrize("dp, mp", LAYOUTS)
def test_tp_train_steps_match_single_process_and_jax(tmp_path, dp, mp):
    """Two runs of 3 steps on dp × mp ranks. With stochastic depth on (the
    draws follow the dp index) and every stage on its kernel op's plain
    version (K1/K4, K5 and K6 on gathered weights, strided blocks 2-3
    split), against one process. Without it (the JAX step draws from
    another RNG), against the JAX step on a dp × mp mesh with
    `shard_params_tp` params and the batch sharded on dp (the JAX dry run's
    layout)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from uplift_upsample_tpu.parallel import TrainState as JaxState
    from uplift_upsample_tpu.parallel import make_optimizer as jax_optimizer
    from uplift_upsample_tpu.parallel import make_train_step as jax_step
    from uplift_upsample_tpu.parallel.sharding import shard_params_tp as jax_shard

    config = _tiny(DROP_PATH_RATE=[0.1, 0.1, 0.0], TRAIN_FUSED_SPATIAL=True,
                   TRAIN_FUSED_TEMPORAL=True, TRAIN_FUSED_STRIDED=True)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    (tmp_path / "sd").mkdir()
    init = _save_init(tmp_path / "sd", model.state_dict())
    batches = [_batch(config, seed=s) for s in range(STEPS)]
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    step = make_train_step(model, opt, config, device="cpu")
    losses = [float(step(state, batch)[1]) for batch in batches]

    jconfig_src = _tiny()
    jconfig, jmodel, params = _jax(jconfig_src)
    (tmp_path / "jax").mkdir()
    j_init = _save_init(tmp_path / "jax", params_from_jax({"params": params}))
    mesh = Mesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp), ("dp", "mp"))
    params = jax_shard(params, mesh, tp_axis="mp")
    tx, _, _ = jax_optimizer(jconfig)
    jstate = JaxState(params=params, opt_state=tx.init(params),
                      ema_params=jax.tree.map(jnp.copy, params), step=jnp.zeros([], jnp.int32))
    jstep = jax_step(jmodel, tx, jconfig, mesh=None, rng_seed=0)
    j_batches = [_batch(jconfig_src, seed=10 + s) for s in range(STEPS)]
    j_losses = []
    for batch in j_batches:
        jstate, loss = jstep(jstate, tuple(jax.device_put(a, NamedSharding(mesh, P("dp")))
                                           for a in batch))
        j_losses.append(float(loss))

    ranks = _spawn(train_steps, tmp_path, dp, mp,
                   {"droppath": (config.to_dict(), init, batches),
                    "jax": (jconfig_src.to_dict(), j_init, j_batches)})
    for name in ("droppath", "jax"):
        _replicated_identical([r[name] for r in ranks], mp)
    _assert_close([r["droppath"] for r in ranks], losses, model.state_dict(), state.ema)
    _assert_close([r["jax"] for r in ranks], j_losses,
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


@pytest.mark.parametrize("dp, mp", LAYOUTS)
def test_tp_eval_step_matches_dp_step_and_jax(tmp_path, dp, mp):
    """make_test_step(dp=mesh, tp=) on dp × mp ranks, flip-TTA on, fused
    "none" and "full", dense and shared-spatial, against the dp step over
    every rank (the unsplit model) at 1e-4; the dp step against one process
    at 2e-5 (`tests/test_parallel.py:130-134`); the shared-spatial TP step
    against the JAX one with `shard_params_tp` params on a dp × mp mesh
    (windows on dp, the unique frames replicated: the JAX dry run's
    tp_eval) at 1e-4."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from uplift_upsample_tpu.eval import make_test_step as jax_test_step
    from uplift_upsample_tpu.parallel.sharding import shard_params_tp as jax_shard

    from uplift_upsample_torch.eval import make_test_step

    config = _tiny()
    _, jmodel, params = _jax(config)
    state = params_from_jax({"params": params})
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(state)
    dense, shared = _eval_inputs(config)
    flip = config.AUGM_FLIP_KEYPOINT_ORDER
    cases, ref = {}, {}
    for fused in ("none", "full"):
        for name, inputs in (("dense", dense), ("shared", shared)):
            kwargs = dict(flip_tta=True, flip_lr_indices=flip, fused=fused,
                          shared_spatial=name == "shared")
            cases[f"{fused}_{name}"] = (kwargs, inputs)
            ref[f"{fused}_{name}"] = make_test_step(model, **kwargs)(
                *(torch.from_numpy(a) for a in inputs))
    mesh = Mesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp), ("dp", "mp"))
    jstep = jax_test_step(jmodel, {"params": jax_shard(params, mesh, tp_axis="mp")},
                          flip_tta=True, flip_lr_indices=flip, fused="none",
                          shared_spatial=True)
    uq, idx, sm = shared
    _, j_central = jstep(jax.device_put(uq, NamedSharding(mesh, P())),
                         *(jax.device_put(a, NamedSharding(mesh, P("dp")))
                           for a in (idx.astype(np.int32), sm)))

    ranks = _spawn(eval_steps, tmp_path, dp, mp, config.to_dict(), _save_init(tmp_path, state),
                   cases)
    for got in ranks:
        for case, (seq, central) in ref.items():
            tp_out, dp_out = got[case]["tp"], got[case]["dp"]
            np.testing.assert_allclose(dp_out[1], central.numpy(), atol=2e-5, err_msg=case)
            np.testing.assert_allclose(tp_out[1], dp_out[1], atol=1e-4, err_msg=case)
            assert (seq is None) == (tp_out[0] is None), case
            if seq is not None:
                np.testing.assert_allclose(tp_out[0], dp_out[0], atol=1e-4, err_msg=case)
        np.testing.assert_allclose(got["none_shared"]["tp"][1], np.asarray(j_central),
                                   atol=1e-4)


def test_tp_eval_step_at_the_bf16_rung(tmp_path):
    """The bf16 rung (EVAL_MATMUL_PRECISION "default") split over mp = 2:
    make_test_step(tp=) with flip-TTA, fused "none" (the split modules,
    every product rounded) and "full" (K2 and K3 split: the plain versions
    of their bf16 launches at the split widths), dense and shared-spatial,
    against one process at "default". The split sums the proj, fc2 and conv
    partials over mp before their biases, which reorders fp32 sums and flips
    a later bf16 rounding now and then, so the bar is the rung's: the mean
    gap within 0.25 of the rung's mean drift from "high" and the largest
    within 0.75 of its largest (measured 0.015 / 0.18 for "full"; "none"
    gave the one-process bits at this tiny width)."""
    from uplift_upsample_torch.eval import make_test_step

    config = _tiny()
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    dense, shared = _eval_inputs(config)
    flip = config.AUGM_FLIP_KEYPOINT_ORDER
    cases, ref = {}, {}
    for fused in ("none", "full"):
        for name, inputs in (("dense", dense), ("shared", shared)):
            kwargs = dict(flip_tta=True, flip_lr_indices=flip, fused=fused,
                          shared_spatial=name == "shared")
            cases[f"{fused}_{name}"] = (dict(kwargs, precision="default"), inputs)
            ref[f"{fused}_{name}"] = [make_test_step(model, precision=rung, **kwargs)(
                *(torch.from_numpy(a) for a in inputs))[1].numpy() for rung in ("default", "high")]
    ranks = _spawn(eval_steps, tmp_path, 1, 2, config.to_dict(), _save_init(tmp_path, state),
                   cases)
    for got in ranks:
        for case, (default, high) in ref.items():
            gap, drift = np.abs(got[case]["tp"][1] - default), np.abs(default - high)
            assert drift.mean() > 0, case
            print(f"{case}: {gap.mean() / drift.mean():.4f} / {gap.max() / drift.max():.4f} "
                  "of the rung's drift")
            assert gap.mean() <= 0.25 * drift.mean() and gap.max() <= 0.75 * drift.max(), (
                case, gap.mean() / drift.mean(), gap.max() / drift.max())


def test_tp_resume_matches_in_memory(tmp_path):
    config = _tiny(DROP_PATH_RATE=[0.1, 0.1, 0.0])
    model = build_uplift_upsample_transformer(config, device="cpu", seed=2)
    ranks = _spawn(resume_check, tmp_path, 2, 2, config.to_dict(),
                   _save_init(tmp_path, model.state_dict()), _batch(config, seed=7))
    for got in ranks:
        assert abs(got["loss2"] - got["loss2_resumed"]) <= 1e-6
        for saved, restored in zip(got["saved"][:3], got["restored"][:3]):
            assert saved.keys() == restored.keys()
            assert all(torch.equal(saved[k], restored[k]) for k in saved)
        assert got["saved"][3] == got["restored"][3] == 1


def test_dryrun_tool_on_cpu_ranks():
    cmd = [sys.executable, "-m", "uplift_upsample_torch.tools.dryrun_multichip",
           "--devices", "4", "--device", "cpu", "--config", "tiny"]
    env = dict(os.environ, OMP_NUM_THREADS="1")  # one thread per rank, as the other workers
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "MULTICHIP_CORE_OK" in proc.stdout
    assert "dryrun staged summary: 9/9 checks passed" in proc.stdout
    assert "dp=2 mp=2" in proc.stdout


def test_dryrun_tool_needs_a_card_unless_asked():
    from uplift_upsample_torch.tools.dryrun_multichip import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--devices", "2", "--config", "tiny"])


def test_other_routes_raise_under_tp():
    from uplift_upsample_torch.models.bench_forward import bench_forward

    fake = TensorParallel(rank=0, size=2, backend="gloo", group=None)  # no collective runs
    config = _tiny()
    model = build_uplift_upsample_transformer(config, device="cpu", tp=fake)
    x = torch.zeros((2, config.SEQUENCE_LENGTH, 17, 2))
    sm = torch.ones((2, config.SEQUENCE_LENGTH), dtype=torch.bool)
    for route in (dict(temporal_attn="banded"), dict(temporal_impl="v2"),
                  dict(temporal_attn="banded", fuse_s2t=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            bench_forward(model, x, sm, fused_params={}, **route)
    # USE_PALLAS_ATTENTION builds under mp > 1: row 11 on the rank's heads
    # (against one process: tests/test_torch_packed_attention_tp.py)
    config.USE_PALLAS_ATTENTION = True
    model = build_uplift_upsample_transformer(config, device="cpu", tp=fake)
    attn = model.temporal_block_1.attn
    assert attn.use_pallas and attn.num_heads == config.NUM_HEADS // 2
