"""Training harness + CLI (counterpart of the JAX package's train.py; parity
with reference `train.py`).

Flow: config → datasets (H36M or AMASS) → model + optimizer + optional EMA →
epoch loop of train steps on one device or over data-parallel ranks →
periodic validation with flip-TTA
and (action-wise) float64 metrics → checkpoints of the full training state +
Keras-compatible `.h5` export of best/last weights → final test-set eval
sweep over mask strides.

The same flow, log lines, file names and flags as the JAX CLI, plus
`--device` (the card by default; without one it raises unless `--device cpu`):
  - checkpoints are `torch.save` files `<out_dir>/checkpoints/ckpt_<epoch>.pt`
    (the model's state_dict and every TrainState field, written under a
    temporary name and renamed; the newest 3 kept) in place of Orbax;
    `--continue_training` restores the newest and starts at its epoch + 1;
  - the train feed is the device feed (`data/device_feed.py`) when
    TRAIN_DEVICE_FEED is True, or "auto" on a CUDA device; else the host
    batchers through a background thread;
  - data parallelism is one process per card under `torchrun` (NCCL; gloo
    with `--device cpu`) in place of the JAX mesh: DATA_PARALLEL_DEVICES -1
    is the launch's world size (1 without torchrun), any other value must
    equal it. Each rank feeds its rows of every global batch (host or
    device feed), the gradient is summed over the ranks, validation rows
    are gathered so every rank computes the same metrics, and rank 0 alone
    writes checkpoints, `.h5` files, the history sidecar and scalars (a
    barrier follows each write) and prints the log.

Two departures: `train_and_validate(..., export_h5=False)` (`--export_h5
false`) writes no `.h5` (its best/last paths are then None; best/last
tracking and the history sidecar still run). With `export_h5=True` a machine
without h5py fails before the first step, naming h5py. And `--weights` also
takes the npz of `tools/convert_weights.py` (loaded by name, as the `.h5`).

CLI:
    python -m uplift_upsample_torch.train --config cfg.json --out_dir out/ \\
        [--dataset h36m|amass] [--weights init.h5|init.npz] [--continue_training true] \\
        [--export_h5 false] [--device cpu]
    torchrun --nproc-per-node N -m uplift_upsample_torch.train ...  (data parallel)
"""

from __future__ import annotations

import copy
import importlib.util
import itertools
import json
import os
import re
import sys
import time

import numpy as np
import torch

from .config import UpliftUpsampleConfig
from .data import h36m_splits
from .data.fast_batcher import FastAMASSBatcher, FastH36mBatcher
from .data.generator import AMASSSequenceGenerator, H36mSequenceGenerator
from .data.keypoint_order import H36MOrder17P
from .data.loading import filter_and_subsample_dataset, load_dataset_and_2d_poses
from .data.mocap import AMASSDataset
from .data.multihost import HostShardedBatcher, gather_rows, host_row_slice
from .data.pipeline import _threaded
from .models.build import build_uplift_upsample_transformer, resolve_device
from .parallel.mesh import (broadcast_params_, check_data_parallel_devices,
                            init_data_parallel, launch_world, rank0_stdout)
from .parallel.train_step import TrainState, make_optimizer, make_train_step, make_val_step
from .precision import train_rungs
from .utils import eval_protocol
from .utils.metric_history import MetricHistory
from .utils.scalar_log import ScalarLogger
from .utils.time_format import format_time
from .utils.weights_h5 import save_keras_h5
from .utils.weights_npz import load_weights_by_name

CHECKPOINTS_KEPT = 3


def log(*args):
    print(*args)
    sys.stdout.flush()


class _NoScalars:
    """The scalar logger of a rank other than 0: rank 0 writes the scalars."""

    def scalar(self, tag, value, step):
        pass

    def close(self):
        pass


def resolve_weight_selector(weight_path):
    """Resolve a weight-file prefix (e.g. '<dir>/best_weights') to a file: the
    first of its matches by name, `.h5` or `.npz`; matches of both formats
    raise, since the prefix does not say which is meant."""
    if weight_path is None:
        return None
    if os.path.splitext(weight_path)[1]:
        return weight_path
    weight_dir, selector = os.path.split(weight_path)
    candidates = sorted(s for s in os.listdir(weight_dir)
                        if s.startswith(selector) and s.endswith((".h5", ".npz")))
    if not candidates:
        raise FileNotFoundError(f"No weights matching {weight_path}*.h5|.npz")
    formats = sorted({os.path.splitext(s)[1] for s in candidates})
    if len(formats) > 1:
        raise ValueError(f"{weight_path}* matches weights of {len(formats)} formats "
                         f"({', '.join(formats)}): name the file")
    return os.path.join(weight_dir, candidates[0])


def create_h36m_generators(h36_path, dataset_2d_path, config, train_subset, val_subset,
                           shuffle_seed=0):
    """Build (train_generator, val_generator, val_batches)."""
    dataset_3d, poses_2d_all = load_dataset_and_2d_poses(
        dataset_path=h36_path, poses_2d_path=dataset_2d_path, verbose=True)
    train_gen, val_gen, val_batches = None, None, None
    for split, selection in zip(["train", "val"], [train_subset, val_subset]):
        if selection is None:
            continue
        subsample = (config.DATASET_TRAIN_3D_SUBSAMPLE_STEP if split == "train"
                     else config.DATASET_VAL_3D_SUBSAMPLE_STEP)
        subjects = h36m_splits.subjects_by_split[selection]
        cams, p3d, p2d, _, subj, act, frates = filter_and_subsample_dataset(
            dataset=dataset_3d, poses_2d=poses_2d_all, subjects=subjects,
            action_filter="*", downsample=1, image_base_path=h36_path, verbose=True)
        do_flip = split == "train" and config.AUGM_FLIP_PROB > 0
        gen = H36mSequenceGenerator(
            p3d, p2d, camera_params=cams, subjects=subj, actions=act,
            frame_rates=frates, split=split, seq_len=config.SEQUENCE_LENGTH,
            target_frame_rate=50, subsample=subsample, stride=config.SEQUENCE_STRIDE,
            padding_type=config.PADDING_TYPE, flip_augment=do_flip,
            in_batch_augment=config.IN_BATCH_AUGMENT,
            flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
            mask_stride=config.MASK_STRIDE, stride_mask_align_global=False,
            rand_shift_stride_mask=config.STRIDE_MASK_RAND_SHIFT and split == "train",
            shuffle=split == "train", seed=shuffle_seed)
        log(f"Sequences: {len(gen)}")
        if split == "train":
            train_gen = gen
        else:
            if config.VALIDATION_EXAMPLES < 0:
                config.VALIDATION_EXAMPLES = len(gen)
            assert config.VALIDATION_EXAMPLES <= len(gen)
            val_batches = int(np.ceil(config.VALIDATION_EXAMPLES / config.BATCH_SIZE))
            val_gen = gen
    return train_gen, val_gen, val_batches


def create_amass_generators(amass_path, h36_path, config, train_subset, val_subset,
                            target_frame_rate, shuffle_seed=0):
    h36m_cameras = None
    train_gen, val_gen, val_batches = None, None, None
    for split, selection in zip(["train", "val"], [train_subset, val_subset]):
        if selection is None:
            continue
        log(f"Loading AMASS dataset for split {selection}")
        amass = AMASSDataset(path=amass_path, h36m_path=h36_path, split=selection,
                             h36m_cameras=h36m_cameras)
        h36m_cameras = amass.cameras()
        subsample = (config.DATASET_TRAIN_3D_SUBSAMPLE_STEP if split == "train"
                     else config.DATASET_VAL_3D_SUBSAMPLE_STEP)
        do_flip = split == "train" and config.AUGM_FLIP_PROB > 0
        gen = AMASSSequenceGenerator(
            amass_dataset=amass, seq_len=config.SEQUENCE_LENGTH,
            target_frame_rate=target_frame_rate, subsample=subsample,
            stride=config.SEQUENCE_STRIDE, padding_type=config.PADDING_TYPE,
            flip_augment=do_flip, in_batch_augment=config.IN_BATCH_AUGMENT,
            flip_lr_indices=H36MOrder17P.flip_lr_indices(),
            mask_stride=config.MASK_STRIDE, stride_mask_align_global=False,
            rand_shift_stride_mask=config.STRIDE_MASK_RAND_SHIFT and split == "train",
            shuffle=split == "train", seed=shuffle_seed)
        log(f"Sequences: {len(gen)}")
        if split == "train":
            train_gen = gen
        else:
            if config.VALIDATION_EXAMPLES < 0:
                config.VALIDATION_EXAMPLES = len(gen)
            assert config.VALIDATION_EXAMPLES <= len(gen)
            val_batches = int(np.ceil(config.VALIDATION_EXAMPLES / config.BATCH_SIZE))
            val_gen = gen
    return train_gen, val_gen, val_batches


# ---- checkpoints -----------------------------------------------------------

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


def checkpoint_epochs(checkpoint_dir):
    """Epochs with a checkpoint in `checkpoint_dir`, ascending."""
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(checkpoint_dir)) if m)


def checkpoint_path(checkpoint_dir, epoch: int) -> str:
    return os.path.join(checkpoint_dir, f"ckpt_{epoch:04d}.pt")


def _state_fields(state: TrainState) -> dict:
    return {f: getattr(state, f) for f in ("mu", "nu", "nu_max", "ema", "step", "loss_sum")}


def save_checkpoint(checkpoint_dir, epoch: int, model, state: TrainState) -> str:
    """The model's state_dict and every TrainState field to ckpt_<epoch>.pt
    (a temporary name, then a rename); keeps the newest CHECKPOINTS_KEPT."""
    path = checkpoint_path(checkpoint_dir, epoch)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"epoch": epoch, "model": model.state_dict(), "state": _state_fields(state)},
               tmp)
    os.replace(tmp, path)
    for old in checkpoint_epochs(checkpoint_dir)[:-CHECKPOINTS_KEPT]:
        os.remove(checkpoint_path(checkpoint_dir, old))
    return path


def _same_structure(saved, current) -> bool:
    if isinstance(current, dict) or isinstance(saved, dict):
        return (isinstance(saved, dict) and isinstance(current, dict)
                and saved.keys() == current.keys()
                and all(_same_structure(saved[k], current[k]) for k in current))
    if isinstance(current, torch.Tensor) or isinstance(saved, torch.Tensor):
        return (isinstance(saved, torch.Tensor) and isinstance(current, torch.Tensor)
                and saved.shape == current.shape and saved.dtype == current.dtype)
    return type(saved) is type(current)


def restore_checkpoint(checkpoint_dir, epoch: int, model, state: TrainState) -> None:
    """Load ckpt_<epoch>.pt into `model` and `state` in place; a file whose
    structure differs from the current model and TrainState raises."""
    saved = torch.load(checkpoint_path(checkpoint_dir, epoch),
                       map_location=next(model.parameters()).device, weights_only=True)
    fields = _state_fields(state)
    if not (_same_structure(saved.get("model"), dict(model.state_dict()))
            and _same_structure(saved.get("state"), fields)):
        raise RuntimeError(
            f"Checkpoint at epoch {epoch} does not match the current TrainState "
            f"structure (model parameters, optimizer moments, amsgrad maxima, EMA "
            f"weights, step, loss_sum): it was written for another configuration. "
            f"Restart training, or export weights via the .h5 path and use --weights.")
    model.load_state_dict(saved["model"])
    for name, value in saved["state"].items():
        setattr(state, name, value)


# ---- the run ---------------------------------------------------------------

def _replicated(model, state: TrainState):
    """The tensors every rank holds alike: parameters, moments, EMA."""
    out = list(model.parameters())
    for d in (state.mu, state.nu, state.nu_max, state.ema):
        out += [] if d is None else list(d.values())
    return out


def train_and_validate(config: UpliftUpsampleConfig, out_dir, dataset_name="h36m",
                       val_dataset_name=None, h36m_path=None, amass_path=None,
                       dataset_2d_path=None, train_subset="train", val_subset="val",
                       test_subset=None, weights=None, continue_training=False,
                       amass_frame_rate=50, use_tensorboard=False, device="cuda",
                       export_h5: bool = True, dp=None):
    """Full training run; returns (MetricHistory, best_weights_path, last_weights_path).

    `export_h5=False` writes no `.h5` (both paths are then None); with True
    and no h5py the run fails here, before any data is loaded. `dp` (a
    `parallel.mesh.DataParallel`) runs it as one rank of a data-parallel
    group on the rank's device; every rank returns the same history.
    """
    if export_h5 and importlib.util.find_spec("h5py") is None:
        raise RuntimeError("the .h5 export of best/last weights needs h5py, which this "
                           "machine does not have (train_and_validate(..., "
                           "export_h5=False) trains without it)")
    check_data_parallel_devices(config, 1 if dp is None else dp.world, "train")
    device = resolve_device(device) if dp is None else dp.device
    rank0 = dp is None or dp.rank == 0

    def written():
        """After a write by rank 0: the other ranks wait until it is there."""
        if dp is not None:
            dp.barrier()

    val_dataset_name = val_dataset_name or dataset_name
    checkpoint_dir = os.path.join(out_dir, "checkpoints")
    if rank0:
        os.makedirs(checkpoint_dir, exist_ok=True)
    written()
    log(f"TRAIN_MATMUL_PRECISION={getattr(config, 'TRAIN_MATMUL_PRECISION', None)!r}: "
        f"(spatial, temporal, plain) rungs "
        f"{train_rungs(getattr(config, 'TRAIN_MATMUL_PRECISION', 'default') or 'default')}")

    # ---- datasets ---------------------------------------------------------
    val_subset_name = None if val_dataset_name != dataset_name else val_subset
    if dataset_name == "h36m":
        train_gen, val_gen, val_batches = create_h36m_generators(
            h36m_path, dataset_2d_path, config, train_subset, val_subset_name,
            shuffle_seed=config.SHUFFLE_SEED)
    else:
        train_gen, val_gen, val_batches = create_amass_generators(
            amass_path, h36m_path, config, train_subset, val_subset_name,
            target_frame_rate=amass_frame_rate, shuffle_seed=config.SHUFFLE_SEED)
    if val_dataset_name != dataset_name:
        if val_dataset_name == "h36m":
            _, val_gen, val_batches = create_h36m_generators(
                h36m_path, dataset_2d_path, config, None, val_subset,
                shuffle_seed=config.SHUFFLE_SEED)
        else:
            _, val_gen, val_batches = create_amass_generators(
                amass_path, h36m_path, config, None, val_subset,
                target_frame_rate=amass_frame_rate, shuffle_seed=config.SHUFFLE_SEED)
    log(f"val batches: {val_batches}")

    # ---- model / optimizer / state ---------------------------------------
    rows = None
    if dp is not None:
        if config.BATCH_SIZE % dp.world:
            raise ValueError(f"BATCH_SIZE {config.BATCH_SIZE} must divide over "
                             f"{dp.world} ranks")
        rows = host_row_slice(config.BATCH_SIZE, dp.rank, dp.world)
        log(f"Data-parallel training over {dp.world} ranks ({dp.backend}), "
            f"local batch {rows.stop - rows.start}")

    model = build_uplift_upsample_transformer(config, device=device, seed=config.SHUFFLE_SEED)
    if weights is not None:
        log(f"Loading weights from {weights}")
        # Name-based partial loading (reference weight_io.py:76-263): layers
        # absent from the file keep their initialization; extra file layers
        # are ignored; both are reported.
        report = load_weights_by_name(weights, model, verbose=False)
        report.log(print_fn=log)

    opt, lr_schedule, wd_schedule = make_optimizer(config)
    state = opt.init(model, ema=bool(config.EMA_ENABLED))

    initial_epoch = 1
    if continue_training:
        epochs_saved = checkpoint_epochs(checkpoint_dir)
        if not epochs_saved:
            raise FileNotFoundError(f"Cant find checkpoint to continue training in "
                                    f"{checkpoint_dir}")
        latest = epochs_saved[-1]
        log(f"Restoring checkpoint from epoch {latest}")
        restore_checkpoint(checkpoint_dir, latest, model, state)
        initial_epoch = latest + 1
        log(f"Will continue training from epoch {initial_epoch}")
    if dp is not None:  # every rank starts from rank 0's weights and state
        broadcast_params_(dp, _replicated(model, state))

    # ---- bookkeeping ------------------------------------------------------
    logger = ScalarLogger(out_dir, use_tensorboard=use_tensorboard) if rank0 else _NoScalars()
    metric_hist = MetricHistory()
    metrics = ["loss", "MPJPE", "NMPJPE", "PAMPJPE"]
    if val_dataset_name == "h36m":
        metrics += ["AW-MPJPE", "AW-NMPJPE", "AW-PAMPJPE"]
    for m in metrics:
        metric_hist.add_metric(m, higher_is_better=False)
    if config.BEST_CHECKPOINT_METRIC is not None and val_dataset_name != "h36m":
        config.BEST_CHECKPOINT_METRIC = config.BEST_CHECKPOINT_METRIC.replace("AW-", "")
    if config.BEST_CHECKPOINT_METRIC is not None:
        assert config.BEST_CHECKPOINT_METRIC in metrics

    prev_best_weights_path, last_weights_path = None, None
    # Resume completeness: the checkpoint holds only the numeric state;
    # MetricHistory and the best/last .h5 paths live in a sidecar so a resumed
    # run keeps best-checkpoint tracking instead of restarting it empty (the
    # reference loses this history on --continue_training, train.py:430-438).
    history_sidecar = os.path.join(out_dir, "train_history.json")
    if continue_training and os.path.exists(history_sidecar):
        with open(history_sidecar) as f:
            sidecar = json.load(f)
        metric_hist.restore(sidecar["metric_history"])
        prev_best_weights_path = sidecar.get("prev_best_weights_path")
        if prev_best_weights_path and not os.path.exists(prev_best_weights_path):
            prev_best_weights_path = None
        last_weights_path = sidecar.get("last_weights_path")
        if last_weights_path and not os.path.exists(last_weights_path):
            last_weights_path = None
        log(f"Restored metric history through epoch "
            f"{sidecar.get('epoch')} (best: {prev_best_weights_path})")

    root = config.ROOT_KEYTPOINT

    def make_fast_batcher(gen):
        if isinstance(gen, H36mSequenceGenerator):
            return FastH36mBatcher(gen, batch_size=config.BATCH_SIZE)
        return FastAMASSBatcher(gen, batch_size=config.BATCH_SIZE)

    train_batcher = make_fast_batcher(train_gen)
    # Device feed: pose stores resident on the card, per-step host→card
    # traffic = the window plans only (data/device_feed.py).
    tdf = getattr(config, "TRAIN_DEVICE_FEED", "auto")
    if tdf == "auto":
        tdf = device.type == "cuda"
    # Under dp every rank uploads the whole store and plans every batch, and
    # keeps its rows of each (as the host feed does).
    device_feed = None
    if tdf:
        from .data.device_feed import make_device_feed
        device_feed = make_device_feed(train_batcher, device)
        log("Device feed: pose store resident on device "
            f"({device_feed.store_bytes() / 1e6:.0f} MB), "
            "per-step transfer = window plans only")
    elif dp is not None:
        train_batcher = HostShardedBatcher(train_batcher, dp.rank, dp.world)

    train_step = make_train_step(model, opt, config, dataset_name=dataset_name, device=device,
                                 rng_seed=config.SHUFFLE_SEED, device_feed=device_feed, dp=dp)

    # Host feed produced ahead by a background thread
    train_iter = _threaded(device_feed.plan_batches(rows=rows) if device_feed is not None
                           else train_batcher.batches(), depth=4)
    val_batcher = None if val_gen is None else make_fast_batcher(val_gen)
    val_feed = None
    if val_batcher is not None and device_feed is not None:
        from .data.device_feed import make_device_feed
        val_feed = make_device_feed(val_batcher, device)
    elif val_batcher is not None and dp is not None:
        val_batcher = HostShardedBatcher(val_batcher, dp.rank, dp.world)
    val_step = make_val_step(model, config, dataset_name=val_dataset_name, device=device,
                             device_feed=val_feed, dp=dp)

    for epoch in range(initial_epoch, config.EPOCHS + 1):
        epoch_start = time.time()
        log(f"## EPOCH {epoch} / {config.EPOCHS}")
        # The epoch's train/loss is the exact all-steps mean (reference
        # train.py:505), summed on the device and fetched once.
        state.loss_sum.zero_()
        # Fetching the loss syncs the device, so log sparsely (reference logs
        # every 10; TRAIN_LOG_EVERY overrides)
        log_every = int(getattr(config, "TRAIN_LOG_EVERY", 0) or
                        max(10, config.STEPS_PER_EPOCH // 60))
        feed_wait = 0.0
        for iteration in range(config.STEPS_PER_EPOCH):
            t0 = time.perf_counter()
            batch = next(train_iter)
            feed_wait += time.perf_counter() - t0
            state, loss = train_step(state, batch)
            if iteration % log_every == 0:
                loss_val = float(loss)
                elapsed = time.time() - epoch_start
                eta = ((config.STEPS_PER_EPOCH - iteration - 1) / (iteration + 1)) * elapsed
                log(f"{iteration}/{config.STEPS_PER_EPOCH} @ Epoch {epoch} "
                    f"(ETA {format_time(eta)}): loss {loss_val:.6f}")

        if epoch % config.CHECKPOINT_INTERVAL == 0:
            if rank0:
                save_checkpoint(checkpoint_dir, epoch, model, state)
            written()
            log(f"Saved checkpoint for epoch {epoch}")

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_duration = time.time() - epoch_start
        if config.STEPS_PER_EPOCH > 0:
            step_s = epoch_duration / config.STEPS_PER_EPOCH
            log(f"Finished epoch {epoch} in {format_time(epoch_duration)}, {step_s:.3f}s/step")
            log(f"Epoch {epoch} feed wait: {1e3 * feed_wait / config.STEPS_PER_EPOCH:.3f} "
                f"ms/step")
            mean_loss = float(state.loss_sum) / config.STEPS_PER_EPOCH
            log(f"Epoch {epoch} mean train loss: {mean_loss:.6f}")
            logger.scalar("train/loss", mean_loss, epoch)
            logger.scalar("train/LR", float(lr_schedule(state.step)), epoch)
            if wd_schedule is not None:
                logger.scalar("train/WD", float(wd_schedule(state.step)), epoch)
            logger.scalar("train/step_duration", step_s, epoch)

        val_params = state.ema if config.EMA_ENABLED else None

        # ---- validation ---------------------------------------------------
        if val_gen is not None and epoch % config.VALIDATION_INTERVAL == 0:
            log(f"Running validation on {config.VALIDATION_EXAMPLES} examples")
            val_start = time.time()
            gt_list, pred_list, act_list, loss_vals = [], [], [], []
            examples = 0
            n_val_batches = int(np.ceil(config.VALIDATION_EXAMPLES / config.BATCH_SIZE))
            val_src = (val_feed.plan_batches(rows=rows) if val_feed is not None
                       else val_batcher.batches())
            for batch in itertools.islice(val_src, n_val_batches):
                if val_feed is not None:
                    _, actions = val_feed.host_ids(batch)
                else:
                    actions = batch[-3]
                # under dp: the global batch's outputs and summed loss
                pred_central, central_gt, loss = val_step(val_params, batch)
                if dp is not None:
                    actions = gather_rows(dp, np.asarray(actions))
                # Keep the outputs on the device; fetch once after the loop
                include = min(config.BATCH_SIZE, config.VALIDATION_EXAMPLES - examples)
                loss_vals.append(loss)
                gt_list.append(central_gt[:include])
                pred_list.append(pred_central[:include])
                act_list.extend(actions[:include])
                examples += include

            gt = torch.cat(gt_list).cpu().numpy().astype(np.float64)
            gt = np.concatenate([gt, np.ones(gt.shape[:-1] + (1,))], axis=-1)
            pred = torch.cat(pred_list).cpu().numpy().astype(np.float64)
            actions_arr = np.stack(act_list)
            val_loss = float(np.mean([float(v) for v in torch.stack(loss_vals).cpu()]))

            if val_dataset_name == "h36m":
                frame_results, aw_results, _ = eval_protocol.h36_action_wise_eval(
                    pred_3d=pred, gt_3d=gt, actions=actions_arr, root_index=root)
            else:
                frame_results = eval_protocol.frame_wise_eval(
                    pred_3d=pred, gt_3d=gt, root_index=root)
                aw_results = None

            log(f"Finished validation in {format_time(time.time() - val_start)}, "
                f"loss: {val_loss:.6f}, MPJPE: {frame_results['mpjpe']:.2f}, "
                f"NMPJPE: {frame_results['nmpjpe']:.2f}, "
                f"PAMPJPE: {frame_results['pampjpe']:.2f}")
            logger.scalar("val/loss", val_loss, epoch)
            metric_hist.add_data("loss", value=val_loss, step=epoch)
            for tag, key in (("MPJPE", "mpjpe"), ("NMPJPE", "nmpjpe"), ("PAMPJPE", "pampjpe")):
                logger.scalar(f"val/{tag}", frame_results[key], epoch)
                metric_hist.add_data(tag, value=frame_results[key], step=epoch)
            if aw_results is not None:
                log(f"AW-MPJPE: {aw_results['mpjpe']:.2f}, "
                    f"AW-NMPJPE: {aw_results['nmpjpe']:.2f}, "
                    f"AW-PAMPJPE: {aw_results['pampjpe']:.2f}")
                for tag, key in (("AW-MPJPE", "mpjpe"), ("AW-NMPJPE", "nmpjpe"),
                                 ("AW-PAMPJPE", "pampjpe")):
                    logger.scalar(f"val/{tag}", aw_results[key], epoch)
                    metric_hist.add_data(tag, value=aw_results[key], step=epoch)

            if config.BEST_CHECKPOINT_METRIC is not None:
                best_value, best_epoch = metric_hist.best_value(config.BEST_CHECKPOINT_METRIC)
                if best_epoch == epoch and export_h5:
                    log(f"Saving currently best checkpoint @ epoch {best_epoch} "
                        f"({config.BEST_CHECKPOINT_METRIC}: {best_value}) as .h5")
                    weights_path = os.path.join(checkpoint_dir,
                                                f"best_weights_{best_epoch:04d}.h5")
                    if rank0:
                        save_keras_h5(weights_path, val_params, model)
                        if prev_best_weights_path is not None:
                            os.remove(prev_best_weights_path)
                    written()
                    prev_best_weights_path = weights_path

        # last weights each epoch
        if export_h5:
            new_last = os.path.join(checkpoint_dir, f"last_weights_{epoch:04d}.h5")
            if rank0:
                if last_weights_path is not None:
                    os.remove(last_weights_path)
                os.makedirs(checkpoint_dir, exist_ok=True)
                save_keras_h5(new_last, val_params, model)
            written()
            last_weights_path = new_last

        if rank0:
            with open(history_sidecar, "w") as f:
                json.dump({"epoch": epoch,
                           "metric_history": metric_hist.to_dict(),
                           "prev_best_weights_path": prev_best_weights_path,
                           "last_weights_path": last_weights_path}, f)
        written()

    logger.close()
    if val_gen is not None:
        log("Best checkpoint results:")
        if config.BEST_CHECKPOINT_METRIC is not None:
            metric_hist.print_all_for_best_metric(metric=config.BEST_CHECKPOINT_METRIC)
        else:
            metric_hist.print_best()

    # ---- final test eval --------------------------------------------------
    if test_subset is not None and val_dataset_name == "h36m":
        from .eval import run_eval_multi_mask_stride
        eval_weights = prev_best_weights_path or last_weights_path
        eval_model = None
        if eval_weights is None:  # no .h5 export: the final (EMA) weights in memory
            eval_model = copy.deepcopy(model)
            if config.EMA_ENABLED:
                with torch.no_grad():
                    for name, p in eval_model.named_parameters():
                        p.copy_(state.ema[name])
        log(f"Eval {'best' if prev_best_weights_path else 'last'} weights: "
            f"{eval_weights or 'in memory'}")
        run_eval_multi_mask_stride(
            config=config, dataset_name=val_dataset_name, dataset_path=h36m_path,
            dataset2d_path=dataset_2d_path, test_subset=test_subset,
            weights_path=eval_weights, model=eval_model, action_wise=True, device=device,
            dp=dp)

    return metric_hist, prev_best_weights_path, last_weights_path


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="2D-to-3D uplifting training (PyTorch + CUDA).")
    parser.add_argument("--config", required=False, default=None)
    parser.add_argument("--dataset", required=False, default="h36m")
    parser.add_argument("--dataset_val", required=False, default=None)
    parser.add_argument("--h36m_path", required=False, default="./data/data_3d_h36m.npz")
    parser.add_argument("--amass_path", required=False, default=None)
    parser.add_argument("--amass_frame_rate", required=False, default="50")
    parser.add_argument("--dataset_2d_path", required=False,
                        default="./data/data_2d_h36m_cpn_ft_h36m_dbb.npz")
    parser.add_argument("--train_subset", required=False, default="train")
    parser.add_argument("--val_subset", required=False, default="val")
    parser.add_argument("--test_subset", required=False, default=None)
    parser.add_argument("--weights", required=False, default=None)
    parser.add_argument("--continue_training", required=False, default=False)
    parser.add_argument("--export_h5", required=False, default=True,
                        help="false: write no best/last .h5 (no h5py needed)")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    args.continue_training = args.continue_training not in [False, "False", "false", "f", "n", "0"]
    args.export_h5 = args.export_h5 not in [False, "False", "false", "f", "n", "0"]
    args.val_subset = None if args.val_subset in ["none", "None", "", 0] else args.val_subset
    args.test_subset = None if args.test_subset in ["none", "None", "", 0] else args.test_subset
    args.dataset = args.dataset.lower()
    args.dataset_val = args.dataset_val.lower() if args.dataset_val else None
    assert args.dataset in ["h36m", "amass"]

    args.weights = resolve_weight_selector(args.weights)

    from .configs import resolve_config
    config = resolve_config(args.config)
    assert config.ARCH == "UpliftUpsampleTransformer"
    config.AUGM_FLIP_KEYPOINT_ORDER = H36MOrder17P.flip_lr_indices()
    check_data_parallel_devices(config, launch_world(), "train")
    dp = init_data_parallel(args.device) if "WORLD_SIZE" in os.environ else None

    try:
        with rank0_stdout(dp):  # rank 0 prints the log
            if dp is None or dp.rank == 0:
                os.makedirs(args.out_dir, exist_ok=True)
                stem = (os.path.splitext(os.path.split(args.config)[1])[0] if args.config
                        else "config")
                config.dump(os.path.join(args.out_dir, stem + "_complete.json"))
            config.display()

            train_and_validate(
                config=config, out_dir=args.out_dir, dataset_name=args.dataset,
                val_dataset_name=args.dataset_val, h36m_path=args.h36m_path,
                amass_path=args.amass_path, dataset_2d_path=args.dataset_2d_path,
                train_subset=args.train_subset, val_subset=args.val_subset,
                test_subset=args.test_subset, weights=args.weights,
                continue_training=args.continue_training,
                amass_frame_rate=int(args.amass_frame_rate),
                use_tensorboard=args.tensorboard, device=args.device,
                export_h5=args.export_h5, dp=dp)
            log("Done.")
    finally:
        if dp is not None:
            dp.close()


if __name__ == "__main__":
    main()
