"""The staged multi-rank dry run (counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`).

    python -m uplift_upsample_torch.tools.dryrun_multichip --devices N \\
        [--device cuda|cpu] [--config h36m_351|tiny] [--seed 0]

It starts N ranks itself (the spawn start method, a `file://` store in a
temporary directory) in a dp × mp layout (`parallel.mesh.init_mesh`): mp = 2
when N is even, dp = N / mp. On the card, with as many cards as ranks, each
rank takes its own card over NCCL; with fewer, gloo ranks share the cards
(their collectives go through the host). It never runs on the CPU unless
`--device cpu` says so (then gloo ranks on the CPU).

The geometry is the JAX dry run's (`--config h36m_351`: N=71, C=384, 4 + 4
blocks, strides [3, 10, 3], paddings (0, 0), 8 heads, AdamW, EMA 0.999;
`tiny` is `tests/test_parallel.py::_tiny_config`'s), weights from `--seed`,
and the stages run in the JAX run's priority order:

  CORE (the run counts only if all three pass; then MULTICHIP_CORE_OK):
    1. train_step       a dp × mp train step with TP params, B = 2·dp
    2. eval_val_step    the flip-TTA val step on the TP EMA weights
    3. resume           the state after step 1 gathered (`gather_params_tp`)
                        into the training CLI's checkpoint format, step 2,
                        then the checkpoint re-sharded and step 2 again:
                        the two step-2 losses within 1e-6
  EXTENSIONS (B = 8·N windows for 4-7):
    4. dp_eval          the shared-spatial flip-TTA eval, dp over all ranks
    5. dp_vs_1dev       the same eval in one process: MPJPE within 1e-6
                        relative, the outputs within 1e-5
    6. tp_eval          TP params on the dp × mp layout, within 1e-4 of 4
    7. device_feed      a TP train step from a device-resident feed
    8. flagship_train   a TP train step at B = 512
    9. flagship_eval    the dp eval at B = 512

The evals run the kernel path on the card (EVAL_FUSED "auto") and the plain
model on the CPU. Each stage's wall time is printed. MULTICHIP_BUDGET_S
(default 480 s) is the budget: a stage whose floor exceeds what is left is
skipped (rank 0 decides for all) and printed as skipped; a watchdog in this
process stops the ranks 25 s past the budget and exits 0 if the core
stages had passed, else 3. A stage that fails makes the run exit 1.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

CORE_MARKER = "MULTICHIP_CORE_OK"
CORE = ("train_step", "eval_val_step", "resume")
FLAGSHIP_BATCH = 512


def dry_config(name: str, batch: int):
    """The dry run's configuration: the JAX run's h36m_351 geometry or the
    tests' tiny one, at global batch `batch`."""
    from ..config import UpliftUpsampleConfig
    from ..data.keypoint_order import H36MOrder17P

    common = {"SEQUENCE_STRIDE": 5, "MASK_STRIDE": [5, 10, 20],
              "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1, "BATCH_SIZE": batch,
              "OPTIMIZER": "AdamW", "OPTIMIZER_PARAMS": {}, "WEIGHT_DECAY": 4e-6,
              "EMA_ENABLED": True, "EMA_DECAY": 0.999, "EVAL_FLIP": True,
              "SCHEDULE": "ExponentialDecay",
              # the fp32 training rung: the JAX dry run on the CPU computes fp32
              # at every rung (XLA:CPU ignores DEFAULT), and its checks hold the
              # split steps to one process at fp32 tolerances
              "TRAIN_MATMUL_PRECISION": "high"}
    geometry = {
        "h36m_351": {"SEQUENCE_LENGTH": 71, "SPATIAL_EMBED_DIM": 32,
                     "TEMPORAL_EMBED_DIM": 384, "SPATIAL_TRANSFORMER_BLOCKS": 4,
                     "TEMPORAL_TRANSFORMER_BLOCKS": 4, "STRIDES": [3, 10, 3],
                     "PADDINGS": [[0, 0], [0, 0], [0, 0]], "NUM_HEADS": 8,
                     "DROP_PATH_RATE": [0.1, 0.1, 0.0],
                     "SCHEDULE_PARAMS": {"initial_learning_rate": 4e-5, "decay_steps": 6000,
                                         "decay_rate": 0.99, "staircase": True}},
        "tiny": {"SEQUENCE_LENGTH": 9, "SPATIAL_EMBED_DIM": 16, "TEMPORAL_EMBED_DIM": 32,
                 "SPATIAL_TRANSFORMER_BLOCKS": 1, "TEMPORAL_TRANSFORMER_BLOCKS": 2,
                 "STRIDES": [3, 3], "PADDINGS": [[0, 0], [0, 0]], "NUM_HEADS": 4,
                 "DROP_PATH_RATE": 0.0, "DROP_RATE": 0.0, "TOKEN_MASK_RATE": 0.0,
                 "SCHEDULE_PARAMS": {"initial_learning_rate": 1e-4, "decay_steps": 6000,
                                     "decay_rate": 0.99, "staircase": True}},
    }[name]
    config = UpliftUpsampleConfig()
    config.update_from(dict(common, **geometry))
    config.AUGM_FLIP_KEYPOINT_ORDER = H36MOrder17P.flip_lr_indices()
    return config


def layout(n: int):
    """(dp, mp) for n ranks: mp = 2 when n is even, as the JAX dry run."""
    mp = 2 if n % 2 == 0 and n >= 2 else 1
    return n // mp, mp


# ---- checkpoints under tensor parallelism ------------------------------------

def save_tp_checkpoint(checkpoint_dir, epoch: int, model, state, mesh) -> None:
    """The rank's model and TrainState gathered over mp (`gather_params_tp`)
    and written by global rank 0 in the training CLI's format
    (`train.save_checkpoint`); every rank waits for the write."""
    from ..parallel.sharding import gather_params_tp
    from ..parallel.train_step import TrainState
    from ..train import save_checkpoint

    whole = {f: None if getattr(state, f) is None else gather_params_tp(getattr(state, f),
                                                                        mesh.tp)
             for f in ("mu", "nu", "nu_max", "ema")}
    params = gather_params_tp({k: v.detach() for k, v in model.state_dict().items()},
                              mesh.tp)
    if mesh.global_rank == 0:
        os.makedirs(checkpoint_dir, exist_ok=True)

        class Whole:  # the gathered weights where save_checkpoint reads a model's
            @staticmethod
            def state_dict():
                return params

        save_checkpoint(checkpoint_dir, epoch, Whole,
                        TrainState(step=state.step, loss_sum=state.loss_sum, **whole))
    mesh.barrier()


def restore_tp_checkpoint(checkpoint_dir, epoch: int, model, state, mesh) -> None:
    """The inverse: the checkpoint's whole tensors re-sharded for the rank's
    mp index (`shard_params_tp`) into `model` and `state`, in place."""
    from ..parallel.sharding import shard_params_tp
    from ..train import checkpoint_path

    saved = torch.load(checkpoint_path(checkpoint_dir, epoch),
                       map_location=next(model.parameters()).device, weights_only=True)
    rank, size = (0, 1) if mesh.tp is None else (mesh.tp.rank, mesh.tp.size)
    model.load_state_dict(shard_params_tp(saved["model"], rank, size))
    fields = saved["state"]
    for name in ("mu", "nu", "nu_max", "ema"):
        setattr(state, name, None if fields[name] is None
                else shard_params_tp(fields[name], rank, size))
    state.step, state.loss_sum = fields["step"], fields["loss_sum"]


# ---- one rank -----------------------------------------------------------------

def check(ok: bool, what) -> None:
    """A stage's check: raise (and so fail the run) unless `ok`."""
    if not ok:
        raise RuntimeError(f"dry-run check failed: {what}")


def _batch(rng, b, n, k):
    """The JAX dry run's random train batch (seq3d, seq2d, mask, cams,
    subjects, actions, centers, stride mask)."""
    return (rng.normal(size=(b, n, k, 3)).astype(np.float32),
            rng.normal(size=(b, n, k, 2)).astype(np.float32),
            np.ones((b, n), np.float32), np.zeros((b, 11), np.float32),
            np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, np.int32),
            (rng.uniform(size=(b, n)) < 0.4) | (np.arange(n) % 5 == 0)[None])


def _shared_inputs(rng, b, n, k):
    """Unique frames (padded to a multiple of 8), win_idx of b overlapping
    windows and an all-real stride mask: the JAX dry run's eval inputs."""
    uq = np.zeros((-(-(b + n - 1) // 8) * 8, k, 2), np.float32)
    uq[:b + n - 1] = rng.normal(size=(b + n - 1, k, 2))
    win_idx = (np.arange(b)[:, None] + np.arange(n)).astype(np.int64)
    return uq, win_idx, np.ones((b, n), bool)


def _rank_main(rank, world, store, opts, run_dir):
    from ..data.device_feed import materialize_h36m
    from ..data.multihost import host_row_slice
    from ..eval import make_test_step
    from ..models import build_uplift_upsample_transformer
    from ..parallel import make_optimizer, make_train_step, make_val_step
    from ..parallel.mesh import init_mesh
    from ..utils.metrics import mpjpe

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(opts["threads"])
    t_start = time.monotonic()
    dp, mp = layout(world)
    mesh = init_mesh(dp, mp, device=opts["device"], backend=opts["backend"],
                     init_method=store)
    device, tp = mesh.device, mesh.tp
    lead = mesh.global_rank == 0
    budget = opts["budget"]

    def remaining():
        return budget - (time.monotonic() - t_start)

    def log(msg):
        if lead:
            print(f"[{time.monotonic() - t_start:6.1f}s] {msg}", flush=True)

    passed, skipped = [], []

    def stage(name, min_s, fn):
        go = torch.tensor([int(remaining() >= min_s)])
        torch.distributed.broadcast(go, 0, group=mesh.world_host_group)  # rank 0 decides
        if not int(go):
            skipped.append(name)
            log(f"SKIP {name}: {remaining():.0f} s left < {min_s:.0f} s floor")
            return None
        log(f"stage {name} (budget left {remaining():.0f} s)")
        t0 = time.monotonic()
        out = fn()
        passed.append(name)
        log(f"stage {name}: ok, wall {time.monotonic() - t0:.1f} s")
        return out

    log(f"dryrun layout: dp={dp} mp={mp} ({mesh.backend} on {device.type}, "
        f"{opts['cards']} card(s)); config {opts['config']}; budget {budget:.0f} s")
    config = dry_config(opts["config"], 2 * dp)
    seed, on_card = opts["seed"], device.type == "cuda"
    fused = "full" if on_card else "none"   # EVAL_FUSED "auto"
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    rng = np.random.default_rng(seed)
    flip = config.AUGM_FLIP_KEYPOINT_ORDER

    def tp_model():
        return build_uplift_upsample_transformer(config, device=device, seed=seed, tp=tp)

    def rows_of(batch, total):
        rows = host_row_slice(total, mesh.rank, mesh.world)
        return tuple(np.asarray(a)[rows] for a in batch)

    model = tp_model()
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    train_step = make_train_step(model, opt, config, device=device, dp=mesh, tp=tp)
    batch = rows_of(_batch(rng, b, n, k), b)

    def run_train1():
        loss = float(train_step(state, batch)[1])
        check(math.isfinite(loss), f"train step 1 loss {loss}")
        log(f"dryrun train step 1: loss={loss:.6f}")
        return loss

    loss1 = stage("train_step", 0, run_train1)

    def run_val():
        val_step = make_val_step(model, config, device=device, dp=mesh, tp=tp)
        pred, _, val_loss = val_step(state.ema, batch)
        check(tuple(pred.shape) == (b, k, 3), f"val step prediction shape {tuple(pred.shape)}")
        log(f"dryrun eval step: val_loss={float(val_loss):.6f}")

    stage("eval_val_step", 30, run_val)

    def run_resume():
        ckpt_dir = os.path.join(run_dir, "checkpoints")
        save_tp_checkpoint(ckpt_dir, 1, model, state, mesh)
        loss2 = float(train_step(state, batch)[1])
        restore_tp_checkpoint(ckpt_dir, 1, model, state, mesh)
        loss2_resumed = float(train_step(state, batch)[1])
        diff = abs(loss2 - loss2_resumed)
        check(diff <= 1e-6, f"step-2 loss {loss2} in memory, {loss2_resumed} resumed")
        log(f"dryrun resume: step-2 loss {loss2:.6f} == {loss2_resumed:.6f} "
            f"(diff {diff:.2e})")

    stage("resume", 20, run_resume)
    if set(CORE) <= set(passed):
        if lead:
            open(os.path.join(run_dir, CORE_MARKER), "w").close()
        log(f"{CORE_MARKER}: train/eval/resume green under dp={dp} mp={mp}")
    del model, state, train_step

    # ---- extensions: one geometry (B = 8·N) for stages 4-7 ----
    bm = 8 * world
    uq_m, win_idx_m, sm_m = (torch.from_numpy(a).to(device)
                             for a in _shared_inputs(rng, bm, n, k))
    full_model = build_uplift_upsample_transformer(config, device=device, seed=seed)
    everyone = mesh.data_parallel_world()

    def eval_step(m, **kw):
        return make_test_step(m, flip_tta=True, flip_lr_indices=flip, fused=fused,
                              shared_spatial=True, **kw)

    def run_dp_eval():
        central = eval_step(full_model, dp=everyone)(uq_m, win_idx_m, sm_m)[1]
        check(tuple(central.shape) == (bm, k, 3), f"dp eval shape {tuple(central.shape)}")
        log(f"dryrun dp shared-spatial eval step (B={bm}) ok")
        return central.cpu().numpy()

    central_m = stage("dp_eval", 40, run_dp_eval)

    def run_dp_vs_1dev():
        central_1 = eval_step(full_model)(uq_m, win_idx_m, sm_m)[1].cpu().numpy()
        gt = np.concatenate([rng.normal(size=(bm, k, 3)), np.ones((bm, k, 1))], axis=-1)
        m_dp = float(mpjpe(central_m.astype(np.float64), gt, root_index=0))
        m_1 = float(mpjpe(central_1.astype(np.float64), gt, root_index=0))
        check(abs(m_dp - m_1) < 1e-6 * max(abs(m_1), 1.0), f"MPJPE dp {m_dp}, one process {m_1}")
        np.testing.assert_allclose(central_m, central_1, atol=1e-5, rtol=1e-5)
        log(f"dryrun dp-vs-1dev metric equality (B={bm}): MPJPE {m_dp:.9f} == {m_1:.9f}")

    def run_tp_eval():
        central = eval_step(tp_model(), dp=mesh, tp=tp)(uq_m, win_idx_m, sm_m)[1]
        gap = float(np.abs(central.cpu().numpy() - central_m).max())
        np.testing.assert_allclose(central.cpu().numpy(), central_m, atol=1e-4, rtol=1e-4)
        log(f"dryrun mp={mp} TP shared-spatial eval step (B={bm}) ok (matches dp: largest "
            f"gap {gap:.2e})")

    for name, fn in (("dp_vs_1dev", run_dp_vs_1dev), ("tp_eval", run_tp_eval)):
        if central_m is None:
            skipped.append(name)
        else:
            stage(name, 40, fn)

    def run_device_feed():
        class Feed:  # a device-resident store and per-row window plans
            store = {key: torch.from_numpy(a).to(device) for key, a in dict(
                store3d=rng.normal(size=(200, k, 3)).astype(np.float32),
                store2d=rng.normal(size=(200, k, 2)).astype(np.float32),
                cams=np.zeros((3, 11), np.float32), subjects=np.zeros(3, np.int32),
                actions=np.zeros(3, np.int32),
                flip_perm=np.asarray(flip, np.int64)).items()}

            def materialize(self, plan):
                return materialize_h36m(self.store, tuple(torch.from_numpy(
                    np.ascontiguousarray(a)).to(device) for a in plan), False)

        plan = ((rng.integers(0, 200 - n, size=(bm, 1)) + np.arange(n)).astype(np.int64),
                np.ones((bm, n), bool), rng.integers(0, 3, size=bm).astype(np.int64),
                np.arange(bm) % 2 == 1, np.zeros(bm, np.int64),
                (np.arange(n) % 5 == 0)[None].repeat(bm, 0))
        config_m = config.copy()
        config_m.BATCH_SIZE = bm
        m = tp_model()
        opt_m, _, _ = make_optimizer(config_m)
        step = make_train_step(m, opt_m, config_m, device=device, dp=mesh, tp=tp,
                               device_feed=Feed())
        loss = float(step(opt_m.init(m, ema=True), rows_of(plan, bm))[1])
        check(math.isfinite(loss), f"device-feed train loss {loss}")
        log(f"dryrun device-feed train step under dp x mp (B={bm}, TP params): "
            f"loss={loss:.6f}")

    stage("device_feed", 40, run_device_feed)
    bf = FLAGSHIP_BATCH

    def run_flagship_train():
        config_f = config.copy()
        config_f.BATCH_SIZE = bf
        m = tp_model()
        opt_f, _, _ = make_optimizer(config_f)
        step = make_train_step(m, opt_f, config_f, device=device, dp=mesh, tp=tp)
        loss = float(step(opt_f.init(m, ema=True), rows_of(_batch(rng, bf, n, k), bf))[1])
        check(math.isfinite(loss), f"flagship train loss {loss}")
        log(f"dryrun flagship-batch train step (B={bf}): loss={loss:.6f}")

    stage("flagship_train", 60, run_flagship_train)

    def run_flagship_eval():
        inputs = (torch.from_numpy(a).to(device) for a in _shared_inputs(rng, bf, n, k))
        central = eval_step(full_model, dp=everyone)(*inputs)[1]
        check(tuple(central.shape) == (bf, k, 3) and bool(torch.isfinite(central).all()),
              f"flagship eval shape {tuple(central.shape)} or a non-finite output")
        log(f"dryrun flagship-batch dp shared-spatial eval step (B={bf}) ok")

    stage("flagship_eval", 60, run_flagship_eval)

    total = len(passed) + len(skipped)
    log(f"dryrun staged summary: {len(passed)}/{total} checks passed [{', '.join(passed)}]"
        + (f", budget-skipped: [{', '.join(skipped)}]" if skipped else ", none skipped"))
    log(f"dryrun_multichip ok: devices={world} loss={loss1:.6f}")
    mesh.barrier()
    mesh.close()


# ---- the launcher -------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, required=True, help="ranks to start")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--config", default="h36m_351", choices=("h36m_351", "tiny"))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch.multiprocessing as mp

    from ..models.build import resolve_device

    n = args.devices
    if n < 1:
        raise ValueError(f"--devices {n}: at least one rank")
    resolve_device(args.device)  # raises without a card unless --device cpu
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    backend = "nccl" if args.device == "cuda" and cards >= n else "gloo"
    budget = float(os.environ.get("MULTICHIP_BUDGET_S", "480"))
    # the ranks share the host: each takes its share of this process's threads
    # (torch's count: the cores, or OMP_NUM_THREADS where it is set)
    opts = dict(device=args.device, backend=backend, config=args.config, seed=args.seed,
                budget=budget, cards=cards, threads=max(1, torch.get_num_threads() // n))
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as run_dir:
        ctx = mp.start_processes(_rank_main, args=(n, f"file://{run_dir}/store", opts, run_dir),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = t0 + budget + 25.0  # past the ranks' own stage skipping
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    core = os.path.exists(os.path.join(run_dir, CORE_MARKER))
                    print(f"[launcher] the ranks exceeded the {budget:.0f} s budget and were "
                          f"stopped {'AFTER' if core else 'BEFORE'} the core checks "
                          f"(train/eval/resume) passed"
                          + (": staged pass" if core else ""), flush=True)
                    return 0 if core else 3
        except Exception as e:  # a rank failed: the run fails
            print(f"[launcher] dryrun failed: {type(e).__name__}: {e}", flush=True)
            return 1
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
    print(f"[launcher] dryrun_multichip: {n} ranks exited 0 in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
