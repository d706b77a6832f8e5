"""Worker processes of the port's tensor-parallel tests (not a test module).

Each worker function takes (rank, world, store, dp, mp, ...), joins a dp × mp
layout of gloo ranks on the CPU through `init_mesh` (the `file://` store
of `torch_dp_workers.spawn`), builds the model with its mp rank's shard of
the full weights in `init_path`, and saves what it computed to
`<out>/rank<r>.pt`. This module imports torch and the port only, so a worker
starts without JAX.
"""

import os

import numpy as np
import torch

from torch_dp_workers import _config, spawn  # noqa: F401  (spawn: the tests' launcher)


def _mesh(rank, world, store, dp, mp):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    from uplift_upsample_torch.parallel.mesh import init_mesh
    return init_mesh(dp, mp, device="cpu", init_method=store)


def _model(config, init_path, mesh):
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.parallel.sharding import shard_params_tp

    model = build_uplift_upsample_transformer(config, device="cpu", tp=mesh.tp)
    full = torch.load(init_path, weights_only=True)
    model.load_state_dict(full if mesh.tp is None
                          else shard_params_tp(full, mesh.tp.rank, mesh.tp.size))
    return model


def _save(out_dir, rank, value):
    torch.save(value, os.path.join(out_dir, f"rank{rank}.pt"))


def forward(rank, world, store, dp, mp, config_values, init_path, inputs, out_dir):
    """The TP model's forward (eval mode) on the rank's dp rows of (x, stride
    mask), gathered over dp: (full output, central)."""
    from uplift_upsample_torch.data.multihost import gather_rows, host_row_slice

    mesh = _mesh(rank, world, store, dp, mp)
    model = _model(_config(config_values), init_path, mesh).eval()
    x, sm = (torch.from_numpy(a) for a in inputs)
    rows = host_row_slice(x.shape[0], mesh.rank, mesh.world)
    with torch.no_grad():
        xm = x[rows] * sm[rows][:, :, None, None].float()
        full, central = model(xm, sm[rows])
    _save(out_dir, rank, (gather_rows(mesh, full).numpy(), gather_rows(mesh, central).numpy()))
    mesh.close()


def packed_forward(rank, world, store, dp, mp, config_values, init_path, inputs, out_dir):
    """`forward` with every call of the packed attention op recorded: its
    q's shape and head count per call."""
    from uplift_upsample_torch.models import primitives

    calls, op = [], primitives.packed_multihead_attention

    def recording(q, k, v, mask=None, *, num_heads, precision="high"):
        calls.append((tuple(q.shape), num_heads))
        return op(q, k, v, mask, num_heads=num_heads, precision=precision)

    primitives.packed_multihead_attention = recording
    forward(rank, world, store, dp, mp, config_values, init_path, inputs, out_dir)
    _save(out_dir, f"{rank}_calls", calls)


def train_steps(rank, world, store, dp, mp, runs, out_dir):
    """Per run {name: (config values, init_path, global batches)}, the TP
    train step on the rank's dp rows of each batch: losses, the rank's local
    parameters, the gathered parameters and EMA."""
    from uplift_upsample_torch.data.multihost import host_row_slice
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step
    from uplift_upsample_torch.parallel.sharding import gather_params_tp

    mesh = _mesh(rank, world, store, dp, mp)
    out = {}
    for name, (config_values, init_path, batches) in runs.items():
        config = _config(config_values)
        model = _model(config, init_path, mesh)
        opt, _, _ = make_optimizer(config)
        state = opt.init(model, ema=bool(config.EMA_ENABLED))
        step = make_train_step(model, opt, config, device="cpu", dp=mesh, tp=mesh.tp)
        rows = host_row_slice(config.BATCH_SIZE, mesh.rank, mesh.world)
        losses = [float(step(state, tuple(np.asarray(a)[rows] for a in batch))[1])
                  for batch in batches]
        local = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out[name] = {"losses": losses, "local": local,
                     "params": gather_params_tp(local, mesh.tp),
                     "ema": gather_params_tp(state.ema, mesh.tp)}
    _save(out_dir, rank, out)
    mesh.close()


def eval_steps(rank, world, store, dp, mp, config_values, init_path, cases, out_dir):
    """Per case, on its global inputs: make_test_step(dp=mesh, tp=mesh.tp) of
    the TP model ("tp") and the dp step over every rank of the unsplit model
    ("dp"), each (sequence output or None, central)."""
    from uplift_upsample_torch.eval import make_test_step
    from uplift_upsample_torch.models import build_uplift_upsample_transformer

    mesh = _mesh(rank, world, store, dp, mp)
    config = _config(config_values)
    model = _model(config, init_path, mesh).eval()
    whole = build_uplift_upsample_transformer(config, device="cpu")
    whole.load_state_dict(torch.load(init_path, weights_only=True))
    out = {}
    for name, (kwargs, inputs) in cases.items():
        out[name] = {}
        for key, step in (("tp", make_test_step(model, dp=mesh, tp=mesh.tp, **kwargs)),
                          ("dp", make_test_step(whole, dp=mesh.data_parallel_world(),
                                                **kwargs))):
            seq, central = step(*(torch.from_numpy(a) for a in inputs))
            out[name][key] = (None if seq is None else seq.numpy(), central.numpy())
    _save(out_dir, rank, out)
    mesh.close()


def split_stacks(rank, world, store, dp, mp, config_values, init_path, inputs, out_dir):
    """K2's and K3's split plain passes on the rank's operands (`tp=`), and
    the rank's stacked operands themselves: the local fused qkv and the
    conv operand."""
    from uplift_upsample_torch.ops.strided import stack_strided_block1_params, strided_block1
    from uplift_upsample_torch.ops.temporal import stack_temporal_params, temporal_stack

    mesh = _mesh(rank, world, store, dp, mp)
    config = _config(config_values)
    model = _model(config, init_path, mesh)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    t_ops = stack_temporal_params(state, model.temporal_depth)
    s_ops = stack_strided_block1_params(state)
    y, key_mask = (torch.from_numpy(a) for a in inputs)
    heads = model.num_heads
    t = temporal_stack(y, t_ops, key_mask, num_heads=heads, first_masked_blocks=1,
                       tp=mesh.tp)
    s = strided_block1(t, s_ops, num_heads=heads, stride=model.strides[0],
                       paddings=model.paddings[0], tp=mesh.tp)
    _save(out_dir, rank, {"temporal": t, "strided": s, "wqkv": t_ops["wqkv"],
                          "wc": s_ops["wc"]})
    mesh.close()


def shard_gather(rank, world, store, dp, mp, init_path, out_dir):
    """shard_params_tp of the full state for the rank's mp index, then
    gather_params_tp over the mp group: the whole state again."""
    from uplift_upsample_torch.parallel.sharding import gather_params_tp, shard_params_tp

    mesh = _mesh(rank, world, store, dp, mp)
    full = torch.load(init_path, weights_only=True)
    local = shard_params_tp(full, mesh.tp.rank, mesh.tp.size)
    _save(out_dir, rank, {"local": local, "whole": gather_params_tp(local, mesh.tp)})
    mesh.close()


def resume_check(rank, world, store, dp, mp, config_values, init_path, batch, out_dir):
    """The dry run's resume stage: one TP step, the state gathered into the
    training CLI's checkpoint format, step 2, the checkpoint re-sharded,
    step 2 again. Saves both step-2 losses, the checkpoint's epoch-1 state
    and the restored local state."""
    from uplift_upsample_torch.data.multihost import host_row_slice
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step
    from uplift_upsample_torch.tools.dryrun_multichip import (restore_tp_checkpoint,
                                                              save_tp_checkpoint)

    mesh = _mesh(rank, world, store, dp, mp)
    config = _config(config_values)
    model = _model(config, init_path, mesh)
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    step = make_train_step(model, opt, config, device="cpu", dp=mesh, tp=mesh.tp)
    rows = host_row_slice(config.BATCH_SIZE, mesh.rank, mesh.world)
    batch = tuple(np.asarray(a)[rows] for a in batch)
    step(state, batch)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    save_tp_checkpoint(ckpt_dir, 1, model, state, mesh)
    def snapshot():  # the step updates these tensors in place
        return ({k: v.detach().clone() for k, v in model.state_dict().items()},
                {k: v.clone() for k, v in state.mu.items()},
                {k: v.clone() for k, v in state.ema.items()}, state.step)

    saved = snapshot()
    loss2 = float(step(state, batch)[1])
    restore_tp_checkpoint(ckpt_dir, 1, model, state, mesh)
    restored = snapshot()
    loss2_resumed = float(step(state, batch)[1])
    _save(out_dir, rank, {"loss2": loss2, "loss2_resumed": loss2_resumed, "saved": saved,
                          "restored": restored})
    mesh.close()
