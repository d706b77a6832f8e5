"""Worker processes of the port's data-parallel tests (not a test module).

`spawn` starts `world` gloo ranks on the CPU with `torch.multiprocessing`
(the spawn start method) and a `file://` store, so that tests on several
xdist workers need no TCP port. Each worker function takes (rank, world,
store, ...), joins the group through `init_data_parallel` as `torchrun`
would set it up, and saves what it computed to `<out>/rank<r>.pt`. This
module imports torch and the port only, so a worker starts without JAX.
"""

import os
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def spawn(fn, world: int, tmp_dir: str, *args, timeout: float = 240.0):
    """Run fn(rank, world, store, *args) in `world` processes; raise if one
    fails or the run outlasts `timeout` seconds (then stop them all)."""
    store = f"file://{os.path.join(str(tmp_dir), f'store_{time.monotonic_ns()}')}"
    ctx = mp.start_processes(fn, args=(world, store, *args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: {world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def _join(rank, world, store):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    from uplift_upsample_torch.parallel.mesh import init_data_parallel
    return init_data_parallel("cpu", init_method=store)


def _config(values):
    from uplift_upsample_torch.config import UpliftUpsampleConfig
    config = UpliftUpsampleConfig()
    config.update_from(values)
    return config


def gather_check(rank, world, store, out_dir):
    """gather_rows of a float tensor, int32 ids and a bool mask."""
    from uplift_upsample_torch.data.multihost import gather_rows

    dp = _join(rank, world, store)
    out = dict(t=gather_rows(dp, torch.arange(4.0) + 4 * rank),
               ids=gather_rows(dp, np.array([0, 1], np.int32) + 10 * rank),
               mask=gather_rows(dp, np.array([rank == 0, rank == 1])))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dp.close()


def train_steps(rank, world, store, config_values, init_path, batches, out_dir):
    """The dp train step from the weights in `init_path` over the global
    `batches`, each rank on its rows: per-step losses, final params, EMA."""
    from uplift_upsample_torch.data.multihost import host_row_slice
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step

    dp = _join(rank, world, store)
    config = _config(config_values)
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(torch.load(init_path, weights_only=True))
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=bool(config.EMA_ENABLED))
    step = make_train_step(model, opt, config, device="cpu", dp=dp)
    rows = host_row_slice(config.BATCH_SIZE, rank, world)
    losses = []
    for batch in batches:
        state, loss = step(state, tuple(np.asarray(a)[rows] for a in batch))
        losses.append(float(loss))
    torch.save({"losses": losses, "params": dict(model.state_dict()),
                "ema": state.ema, "loss_sum": float(state.loss_sum)},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dp.close()


def eval_steps(rank, world, store, config_values, init_path, cases, out_dir):
    """make_test_step(dp=) on the global inputs of each case: {name: outputs}."""
    from uplift_upsample_torch.eval import make_test_step
    from uplift_upsample_torch.models import build_uplift_upsample_transformer

    dp = _join(rank, world, store)
    config = _config(config_values)
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(torch.load(init_path, weights_only=True))
    model.eval()
    out = {}
    for name, (kwargs, inputs) in cases.items():
        step = make_test_step(model, dp=dp, **kwargs)
        seq, central = step(*(torch.from_numpy(a) for a in inputs))
        out[name] = (None if seq is None else seq.numpy(), central.numpy())
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dp.close()


def eval_run(rank, world, store, config_values, init_path, data, out_dir):
    """run_eval(dp=) with the weights in `init_path`: its two results."""
    from uplift_upsample_torch.eval import run_eval
    from uplift_upsample_torch.models import build_uplift_upsample_transformer

    dp = _join(rank, world, store)
    config = _config(config_values)
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(torch.load(init_path, weights_only=True))
    torch.save(run_eval(config, model=model, device="cpu", dp=dp, **data),
               os.path.join(out_dir, f"rank{rank}.pt"))
    dp.close()


def train_cli(rank, world, store, runs, out_dir, res_dir):
    """train_and_validate once per (config values, kwargs) in `runs` in one
    shared `out_dir`, recording every write this rank makes under it (an
    audit hook: opens for writing, renames, removals, new directories)."""
    from uplift_upsample_torch import train as train_mod

    writes = []
    root = os.path.realpath(out_dir)

    def hook(event, args):
        if event in ("open", "os.rename", "os.remove", "os.mkdir") and args:
            path = args[0]
            if event == "open" and not any(c in str(args[1] or "r") for c in "wax+"):
                return
            if isinstance(path, (str, bytes, os.PathLike)) and os.path.realpath(
                    os.fsdecode(path)).startswith(root):
                writes.append((event, os.fsdecode(path)))

    dp = _join(rank, world, store)
    sys.addaudithook(hook)
    histories = []
    for values, kwargs in runs:
        hist, best, last = train_mod.train_and_validate(
            config=_config(values), out_dir=out_dir, device="cpu", export_h5=False,
            dp=dp, **kwargs)
        histories.append((hist.to_dict(), best, last))
    torch.save({"histories": histories, "writes": writes},
               os.path.join(res_dir, f"rank{rank}.pt"))
    dp.close()
