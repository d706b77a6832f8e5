"""The training step (counterpart of the JAX package's parallel/train_step.py),
on one device or data-parallel over ranks.

Optimizer parity targets (reference `train.py:404-506`):
  - Keras optimizer_v2 Adam (+amsgrad): ε sits outside the bias correction,
    update = lr · √(1−β₂ᵗ)/(1−β₁ᵗ) · m / (√v + ε) (v̂max for amsgrad).
    `torch.optim.Adam` puts ε inside, which the trajectory fixtures catch.
  - tfa.AdamW: that Adam direction plus decoupled weight decay on its *own*
    schedule (the LR schedule re-based to WEIGHT_DECAY), not multiplied by
    the learning rate.
  - Loss: central Σ‖·‖/(B·K) + sequence Σ‖·‖/(B·N·K), weighted; without
    temporal blocks, (w_c + w_s)·central.
  - EMA: ema ← ema − (1−d)(ema − w), d = min(EMA_DECAY, (1+g)/(10+g)) at the
    pre-increment step g.

The forward is the JAX package's accelerator path: the spatial stack on the
keyframes only (a static budget, keyframes first), the s2t Dense, the
strided-input token and the temporal PE, the temporal stack, then the
model's tail (strided blocks and heads) through its `temporal_input`
splice. TRAIN_FUSED_SPATIAL, TRAIN_FUSED_TEMPORAL and TRAIN_FUSED_STRIDED
(True, or "auto" on a CUDA device; chained, `fused_stages`) send the stacks
through `spatial_stack_train` (K1 forward, K4 backward) and
`temporal_stack_train` (K5), which on CPU tensors are their plain versions
under autograd, and strided block 1 through `strided_block1_train` (K6),
with head1 inline and the rest of the tail through the `strided_entry=1`
splice, as the JAX package's `parallel/train_step.py:168-211,269-286` do.
A stage whose flag is off runs its plain version; `kernels=False` runs every
stage plain on the card (a comparison path, nothing else). The s2t Dense, the tail, the loss and the
optimizer are plain PyTorch. Stochastic depth is drawn per step from a
`torch.Generator` seeded from SHUFFLE_SEED and the step: per frame for the
spatial stack, per window for the temporal stack and the tail.

AMASS batches (world-space poses and an 18-vector camera) go through
`ops/camera.world_to_cam_and_2d` inside the step, on the step's device.
`make_train_step` / `make_val_step` take a `data.device_feed` feed as
`device_feed=`; their batches are then the feed's plan tuples.

Data parallel (`dp=`, a `parallel.mesh.DataParallel`): each rank's batch is
its rows of the global batch (`data/multihost.py`). The loss still divides
by config.BATCH_SIZE, the global batch, so a rank's loss is its share of
the global loss; the flat gradient and the loss are summed over the ranks
before the optimizer, so every rank holds the same parameters, moments and
EMA. The stochastic-depth draws are the rank's rows of the 1-process
draws: spatial, temporal and the tail's DropPath each draw for the global
batch from the step's generator and keep the rank's frames or windows. The
keyframe budget is per rank, from the local batch; an overflow on one rank
poisons every rank through the summed gradient.

Tensor parallel (`tp`, mp > 1; the model built with the same `tp`, and `dp`
then a `mesh.Mesh` whose rank is the dp index): the model's blocks hold the
rank's shards. The whole-block stages read whole weights, so the spatial
and temporal stacks (K1/K4 and K5, or their plain versions) and K6 run on
their blocks' weights gathered once per step (`sharding.gather_params_tp`):
every mp peer computes the same full result, which is replicated compute
over mp, not TP (ROADMAP C). Strided blocks from 1 (2 with K6) and the
heads run split. The loss is over the global batch; the flat gradient of
the rank's local parameters is summed over the dp group only; Adam, AdamW
and the EMA act on the shards (every update is elementwise). Replicated
parameters stay bit-identical over the mp peers because their gradients
come from identical inputs: the droppath draws and the keyframe budget
follow the dp index, so mp peers drop the same rows.

Matmul precision (TRAIN_MATMUL_PRECISION, `precision.train_rungs`; the
JAX step's `sp_train_prec` / `tm_train_prec`, `train_step.py:213-224`):
  "default" (the class default): every stage on the one-pass bf16 rung: K1
            and K4, K5 and K6 through their bf16 instances, the plain
            products (the s2t Dense, head1, the tail, any stage that runs
            plain) under `matmul_precision("default")`, whose backward
            rounds its products' operands too (`precision.Bf16Matmul`);
  "mixed":  the spatial kernels at "highest" (3xTF32), the rest bf16;
  "high", "highest": fp32-level products everywhere (3xTF32 kernels, TF32
            off in the plain products).
The JAX step opens no precision context, so on the TPU its XLA products run
one bf16 pass at every rung; the port follows it at "default" and "mixed"
and keeps fp32 at "high" and "highest", the function the JAX step computes
on the CPU (ROADMAP, departures). The val step runs fp32 at every rung.
Another value raises ValueError.

Not ported (NotImplementedError): OUTPUT_BN, dropout, attention dropout and
token masking in training.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import UpliftUpsampleConfig
from ..data.multihost import gather_rows, host_row_slice
from ..models.build import resolve_device
from ..models.primitives import DropPath
from ..ops.camera import world_to_cam_and_2d
from ..ops.spatial import (make_droppath_scales, spatial_stack_plain, spatial_stack_train,
                           stack_spatial_params)
from ..ops.strided import stack_strided_block1_params
from ..ops.strided_train import strided_block1_train
from ..ops.temporal import stack_temporal_params, temporal_stack_plain
from ..ops.temporal_train import temporal_stack_train
from ..precision import matmul_precision, train_rungs
from ..utils.schedules import scheduler_by_name
from .mesh import DataParallel, all_reduce_sum_
from .sharding import TensorParallel, check_model_tp, gather_params_tp

_F32 = torch.float32


@dataclasses.dataclass
class TrainState:
    """Optimizer and EMA state; the parameters themselves live in the model.

    mu, nu, nu_max (amsgrad only) and ema (EMA_ENABLED only) are keyed like
    `model.named_parameters()`. `step` is the 0-based global step; `loss_sum`
    sums the per-step losses on the device (the reference's all-steps epoch
    mean, `train.py:505`).
    """
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    nu_max: Optional[Dict[str, torch.Tensor]]
    ema: Optional[Dict[str, torch.Tensor]]
    step: int
    loss_sum: torch.Tensor


class KerasAdam:
    """Keras Adam / tfa.AdamW, updating parameters in place.

    lr_schedule and wd_schedule (None: plain Adam) map the pre-increment
    step to a float32 value (`utils.schedules`).
    """

    def __init__(self, lr_schedule: Callable, wd_schedule: Optional[Callable] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 amsgrad: bool = False):
        self.lr_schedule, self.wd_schedule = lr_schedule, wd_schedule
        self.b1, self.b2, self.eps, self.amsgrad = b1, b2, eps, amsgrad

    def init(self, model: torch.nn.Module, ema: bool) -> TrainState:
        params = dict(model.named_parameters())
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return TrainState(
            mu=zeros(), nu=zeros(), nu_max=zeros() if self.amsgrad else None,
            ema={k: p.detach().clone() for k, p in params.items()} if ema else None,
            step=0, loss_sum=torch.zeros((), dtype=_F32,
                                         device=next(model.parameters()).device))

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: TrainState) -> None:
        """One update at step `state.step` (which the caller then advances)."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        m = [state.mu[k] for k in names]
        v = [state.nu[k] for k in names]
        t = torch.tensor(state.step + 1, dtype=_F32)
        b1, b2 = torch.tensor(self.b1, dtype=_F32), torch.tensor(self.b2, dtype=_F32)
        alpha = float(torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t))
        lr = float(self.lr_schedule(state.step))
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - self.b2)
        denom = v
        if self.amsgrad:
            denom = [state.nu_max[k] for k in names]
            torch._foreach_maximum_(denom, v)
        root = torch._foreach_sqrt(denom)
        torch._foreach_add_(root, self.eps)
        update = torch._foreach_mul(m, alpha)
        torch._foreach_div_(update, root)
        torch._foreach_mul_(update, -lr)
        if self.wd_schedule is not None:
            wd = float(self.wd_schedule(state.step))
            torch._foreach_add_(update, torch._foreach_mul(p, wd), alpha=-1.0)
        torch._foreach_add_(p, update)


def make_optimizer(config: UpliftUpsampleConfig):
    """(optimizer, lr_schedule, wd_schedule) from the config, as the JAX
    package's make_optimizer returns them (wd_schedule None for Adam)."""
    lr_schedule = scheduler_by_name(config.SCHEDULE)(**config.SCHEDULE_PARAMS)
    opt_params = dict(config.OPTIMIZER_PARAMS)
    kwargs = dict(b1=opt_params.pop("beta_1", 0.9), b2=opt_params.pop("beta_2", 0.999),
                  eps=opt_params.pop("epsilon", 1e-8),
                  amsgrad=opt_params.pop("amsgrad", False))
    if opt_params:
        raise ValueError(f"unknown OPTIMIZER_PARAMS: {opt_params}")
    if config.OPTIMIZER == "AdamW":
        wd_params = copy.deepcopy(config.SCHEDULE_PARAMS)
        wd_params["initial_learning_rate"] = config.WEIGHT_DECAY
        wd_schedule = scheduler_by_name(config.SCHEDULE)(**wd_params)
        return KerasAdam(lr_schedule, wd_schedule, **kwargs), lr_schedule, wd_schedule
    if config.OPTIMIZER == "Adam":
        return KerasAdam(lr_schedule, None, **kwargs), lr_schedule, None
    raise ValueError(config.OPTIMIZER)


def _droppath_rates(config: UpliftUpsampleConfig, stage: int, depth: int):
    rate = config.DROP_PATH_RATE
    top = rate[stage] if isinstance(rate, (list, tuple)) else rate
    return [0.0] * depth if depth <= 1 else [top * i / (depth - 1) for i in range(depth)]


def keyframe_budget(model, config: UpliftUpsampleConfig,
                    batch: Optional[int] = None) -> Optional[int]:
    """Frames the spatial stack runs per step when only keyframes need it
    (`train_step.py:290-323`): mean + 8σ of the mask-stride mix's keyframes
    per batch plus one window, aligned up to max(128, TRAIN_SPATIAL_BLOCK_F);
    None when that is not below B·N (then every frame runs). B is `batch`
    (a rank's local batch under data parallelism), else config.BATCH_SIZE."""
    if not (model.spatial_depth > 0 and model.has_strided_input
            and bool(getattr(config, "TRAIN_KEYFRAME_SPARSE", True))):
        return None
    ms = config.MASK_STRIDE
    ms_list = ms if isinstance(ms, (list, tuple)) else [ms]
    if not (ms_list and all(isinstance(m, int) and m >= 1 for m in ms_list)):
        return None
    b, n = batch or config.BATCH_SIZE, model.num_frames
    counts = [-(-n // (m // math.gcd(config.SEQUENCE_STRIDE, m))) for m in ms_list]
    mean = sum(counts) / len(counts)
    var = sum((cnt - mean) ** 2 for cnt in counts) / len(counts)
    want = mean * b + 8.0 * math.sqrt(var * b) + n
    budget_cfg = int(getattr(config, "TRAIN_KEYFRAME_BUDGET", 0) or 0)
    if budget_cfg:
        want = budget_cfg
    align = max(128, int(getattr(config, "TRAIN_SPATIAL_BLOCK_F", 128) or 128))
    budget = int(min(b * n, -(-want // align) * align))
    return budget if budget < b * n else None


def _flag(model, config: UpliftUpsampleConfig, key: str) -> bool:
    """A TRAIN_FUSED_* flag resolved: "auto" means the model is on a CUDA
    device, as the JAX package's `is_tpu_backend()`."""
    flag = getattr(config, key, "auto")
    if flag == "auto":
        return next(model.parameters()).device.type == "cuda"
    return bool(flag)


def fused_stages(model, config: UpliftUpsampleConfig, kernels: bool) -> Tuple[bool, bool, bool]:
    """Which stages run through their kernel ops: (spatial: K1/K4, temporal:
    K5, strided block 1: K6), chained as the JAX package chains them
    (`train_step.py:168-207`): TRAIN_FUSED_SPATIAL with a spatial stack;
    TRAIN_FUSED_TEMPORAL only with the spatial kernels and a temporal stack;
    TRAIN_FUSED_STRIDED only with the temporal kernels, strided blocks,
    paddings (0, 0) in block 1, head1 and no output BN. `kernels=False`
    turns all three off."""
    spatial = (kernels and model.spatial_depth > 0
               and _flag(model, config, "TRAIN_FUSED_SPATIAL"))
    temporal = (spatial and model.temporal_depth > 0
                and _flag(model, config, "TRAIN_FUSED_TEMPORAL"))
    strided = (temporal and _flag(model, config, "TRAIN_FUSED_STRIDED")
               and len(model.strides) > 0 and model.paddings is not None
               and tuple(model.paddings[0]) == (0, 0)
               and model.full_output and not model.output_bn)
    return spatial, temporal, strided


def prepare_batch(tensors, dataset_name: str):
    """(seq3d, seq2d | cam18, stride_mask) on the device → (keypoints3d in
    camera space, keypoints2d, stride_mask): AMASS windows are world-space
    poses with an 18-vector camera, transformed and projected here."""
    if dataset_name == "amass":
        seq3d_world, cam18, stride_mask = tensors
        keypoints3d, keypoints2d = world_to_cam_and_2d(seq3d_world, cam18)
        return keypoints3d, keypoints2d, stride_mask
    return tensors


def make_loss_fn(model, config: UpliftUpsampleConfig, dataset_name: str = "h36m", *,
                 kernels: bool = True, dp: Optional[DataParallel] = None,
                 tp: Optional[TensorParallel] = None):
    """loss_fn((seq3d, seq2d | cam18, stride_mask), generator) → scalar loss
    (with graph); AMASS batches carry the camera in place of the 2D poses.
    `generator` draws the stochastic depth, the model's DropPath included.
    With `dp` the batch is the rank's rows of the global batch and the loss
    is their share of the global loss; with `tp` the stacks read gathered
    weights (module docstring)."""
    if dataset_name not in ("h36m", "amass"):
        raise ValueError(f"unknown dataset {dataset_name!r}")
    tp = check_model_tp(model, tp)
    for key in ("DROP_RATE", "ATTENTION_DROP_RATE", "TOKEN_MASK_RATE"):
        if getattr(config, key, 0):
            raise NotImplementedError(f"training with {key} > 0 is not ported")
    if config.OUTPUT_BN:
        raise NotImplementedError("training with OUTPUT_BN is not ported")
    sp_rung, tm_rung, plain_rung = train_rungs(
        getattr(config, "TRAIN_MATMUL_PRECISION", "default") or "default")
    root = config.ROOT_KEYTPOINT
    mid = config.SEQUENCE_LENGTH // 2
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    heads = model.num_heads
    rates_s = _droppath_rates(config, 0, model.spatial_depth)
    rates_t = _droppath_rates(config, 1, model.temporal_depth)
    fmb = model.first_strided_token_attention_layer if model.has_strided_input else 0
    fused_spatial, fused_temporal, fused_strided = fused_stages(model, config, kernels)
    rows = None if dp is None else host_row_slice(b, dp.rank, dp.world)
    # only the spatial kernels take a keyframe budget; the plain path applies
    # the model to every frame (the JAX package's `train_step.py:302-304`).
    # Under dp it is the rank's, from its local batch.
    budget = (keyframe_budget(model, config, None if rows is None else rows.stop - rows.start)
              if fused_spatial else None)
    if fused_strided:
        # top·i/(depth-1) at i = 0: K6 has no stochastic depth to apply
        assert model.strided_temporal_block_1.drop_path.rate == 0.0
    whole = ("spatial_block_", "temporal_block_") + (
        ("strided_temporal_block_1.",) if fused_strided else ())
    if tp is not None and tp.rank == 0 and (dp is None or dp.rank == 0):
        print(f"tensor parallel, mp={tp.size}: the spatial and temporal stacks"
              f"{' and strided block 1' if fused_strided else ''} run on weights gathered "
              f"once per step (replicated compute over mp); strided blocks "
              f"{2 if fused_strided else 1}+ and the heads run split", flush=True)

    def spatial(x, ops, scales):
        if fused_spatial:
            return spatial_stack_train(x, ops, scales, num_heads=heads, precision=sp_rung)
        return spatial_stack_plain(x, ops, num_heads=heads, droppath_scales=scales,
                                   precision=plain_rung, attention_precision=plain_rung)

    def temporal(y, ops, key_mask, scales):
        if fused_temporal:
            return temporal_stack_train(y, ops, key_mask, scales, num_heads=heads,
                                        first_masked_blocks=fmb, precision=tm_rung)
        return temporal_stack_plain(y, ops, key_mask, num_heads=heads,
                                    first_masked_blocks=fmb, droppath=scales,
                                    precision=plain_rung)

    def draws(generator, rates, per_window, bb):
        """Stochastic-depth scales (2L, bb·per_window): under dp the rank's
        columns of the global batch's draws."""
        if rows is None:
            return make_droppath_scales(generator, rates, bb * per_window)
        assert bb == rows.stop - rows.start, (bb, rows)
        full = make_droppath_scales(generator, rates, b * per_window)
        return full[:, rows.start * per_window:rows.stop * per_window]

    @matmul_precision(plain_rung)
    def apply_model(x, stride_mask, generator):
        params = dict(model.named_parameters())
        if tp is not None:
            params.update(gather_params_tp(
                {k: v for k, v in params.items() if k.startswith(whole)}, tp))
        bb, nn_, pp, cc = x.shape
        frames = bb * nn_
        if model.spatial_depth > 0:
            ops = stack_spatial_params(params, model.spatial_depth)
            scales = draws(generator, rates_s, nn_, bb).to(x.device)
            xf = x.reshape(frames, pp, cc)
            if budget is not None:
                flat_sm = stride_mask.reshape(frames).bool()
                ids = torch.arange(frames, device=x.device)
                # keyframes first (ascending), then the rest: the first
                # `budget` rows hold every keyframe unless the batch overflows
                order = torch.argsort(torch.where(flat_sm, ids, frames + ids))[:budget]
                y = spatial(xf[order].contiguous(), ops, scales[:, order].contiguous())
                inv = (torch.cumsum(flat_sm.long(), 0) - 1).clamp(0, budget - 1)
                sp = y[inv]
                # a dropped keyframe would read a wrong row: poison the loss
                sp = torch.where(flat_sm.sum() > budget, torch.full_like(sp, math.nan), sp)
            else:
                sp = spatial(xf.contiguous(), ops, scales)
            sp = sp.reshape(bb, nn_, -1)
        else:
            sp = x.reshape(bb, nn_, pp * cc)
        y = model.spatial_to_temporal_fc(sp)
        key_mask = None
        if model.has_strided_input:
            sm = stride_mask.to(y.dtype)[..., None]
            y = sm * y + (1.0 - sm) * model.strided_input_token
            key_mask = 1.0 - stride_mask.to(_F32)
        y = y + model.temporal_pe
        if model.temporal_depth > 0:
            scales_t = draws(generator, rates_t, 1, bb).reshape(
                model.temporal_depth, 2, bb).to(x.device)
            y = temporal(y, stack_temporal_params(
                params, model.temporal_depth,
                precision=tm_rung if fused_temporal else plain_rung), key_mask, scales_t)
        if fused_strided:
            full = model.temporal_fc(y).reshape(bb, nn_, model.num_keypoints, 3)
            y2 = strided_block1_train(y, stack_strided_block1_params(params, precision=tm_rung),
                                      num_heads=heads, stride=model.strides[0],
                                      paddings=model.paddings[0], precision=tm_rung)
            _, central = model(y2, stride_mask, temporal_input=True, strided_entry=1)
            return full, central
        return model(y, stride_mask, temporal_input=True)

    def loss_fn(batch, generator: torch.Generator) -> torch.Tensor:
        set_droppath_generator(model, generator,
                               None if rows is None else (rows.start, b))
        seq3d, seq2d, stride_mask = prepare_batch(batch, dataset_name)
        keypoints3d = seq3d - seq3d[:, :, root:root + 1, :]
        central_gt = keypoints3d[:, mid]
        x = seq2d
        if model.has_strided_input:
            x = x * stride_mask[:, :, None, None].to(x.dtype)
        pred_seq, pred_central = apply_model(x, stride_mask, generator)
        central = torch.linalg.vector_norm(central_gt - pred_central, dim=-1).sum() / (b * k)
        if config.TEMPORAL_TRANSFORMER_BLOCKS > 0:
            sequence = torch.linalg.vector_norm(keypoints3d - pred_seq,
                                                dim=-1).sum() / (b * n * k)
            return (config.LOSS_WEIGHT_CENTER * central
                    + config.LOSS_WEIGHT_SEQUENCE * sequence)
        return (config.LOSS_WEIGHT_CENTER + config.LOSS_WEIGHT_SEQUENCE) * central

    return loss_fn


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's random draws (stochastic depth)."""
    return torch.Generator().manual_seed(int(seed) * (1 << 32) + int(step))


def set_droppath_generator(model: torch.nn.Module, generator: torch.Generator,
                           rows: Optional[Tuple[int, int]] = None) -> None:
    """The model's DropPath draws: from `generator`; with rows = (start,
    total), for a rank's rows of a global batch (`DropPath`)."""
    for module in model.modules():
        if isinstance(module, DropPath):
            module.generator = generator
            module.rows = rows


def batch_to_device(batch, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A generator batch → its three columns the step reads, on `device`:
    (seq3d, seq2d, stride_mask) of an H36M batch (seq3d, seq2d, mask, cams,
    subjects, actions, centers, stride_mask), or (seq3d_world, cam18,
    stride_mask) of an AMASS batch (seq3d_world, cam18, mask, subjects,
    actions, centers, stride_mask)."""
    seq3d, seq2d, stride_mask = batch[0], batch[1], batch[-1]

    def put(a, dtype):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype)

    return put(seq3d, _F32), put(seq2d, _F32), put(stride_mask, torch.bool)


def make_train_step(model, opt: KerasAdam, config: UpliftUpsampleConfig, *,
                    dataset_name: str = "h36m", device="cuda", kernels: bool = True,
                    rng_seed: Optional[int] = None, device_feed=None,
                    dp: Optional[DataParallel] = None, tp: Optional[TensorParallel] = None):
    """step(state, batch) → (state, loss): forward, backward, the optimizer
    update, the EMA update; state is updated in place and returned.

    `model` must already be on `device`; batches are generator tuples (numpy
    or tensors), or with `device_feed` the feed's plan tuples, materialized
    on the card from its resident store. rng_seed defaults to
    config.SHUFFLE_SEED. With `dp` the batch is the rank's rows of the
    global batch; the gradient and the loss are summed over the ranks in one
    all-reduce, and the loss returned is the global one. With `tp` (the
    model's own; `dp` a `mesh.Mesh` or None) the gradient of the rank's
    local parameters is summed over the dp group only (module docstring).
    """
    device = resolve_device(device)
    loss_fn = make_loss_fn(model, config, dataset_name, kernels=kernels, dp=dp, tp=tp)
    seed = config.SHUFFLE_SEED if rng_seed is None else rng_seed
    params = dict(model.named_parameters())
    ema_enabled = bool(config.EMA_ENABLED)
    ema_cap = torch.tensor(config.EMA_DECAY if ema_enabled else 0.0, dtype=_F32)

    def step(state: TrainState, batch):
        model.train()
        generator = step_generator(seed, state.step)
        for p in params.values():
            p.grad = None
        if device_feed is not None:
            batch = device_feed.materialize(batch)
        loss = loss_fn(batch_to_device(batch, device), generator)
        loss.backward()
        loss = loss.detach()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if dp is not None:
            all_reduce_sum_(dp, [*grads.values(), loss])
        opt.apply(params, grads, state)
        if ema_enabled:
            g = torch.tensor(state.step, dtype=_F32)
            decay = torch.minimum(ema_cap, (1.0 + g) / (10.0 + g))
            with torch.no_grad():
                names = list(params)
                ema = [state.ema[k] for k in names]
                diff = torch._foreach_sub(ema, [params[k] for k in names])
                torch._foreach_mul_(diff, float(1.0 - decay))
                torch._foreach_sub_(ema, diff)
        state.step += 1
        state.loss_sum += loss
        return state, loss

    return step


def make_val_step(model, config: UpliftUpsampleConfig, dataset_name: str = "h36m", *,
                  device="cuda", device_feed=None, dp: Optional[DataParallel] = None,
                  tp: Optional[TensorParallel] = None):
    """val_step(params, batch) → (pred_central, central_gt, loss), on the device.

    The plain model in eval mode, as the JAX step applies the flax model
    (`train_step.py:450-505`); `params` (e.g. the EMA weights, keyed like
    `model.named_parameters()`) replace the model's own for the call, or None
    keeps them. The loss is the unweighted central + sequence loss of the
    unflipped pass; with EVAL_FLIP the central prediction is the average with
    the flipped input's, unflipped. With `device_feed`, batches are its plans.
    With `dp` the batch is the rank's rows of the global batch; the loss is
    summed over the ranks and the predictions and ground truth gathered, so
    every rank returns the global batch's. With `tp` (the model's own) the
    model runs split over mp and `params` are the rank's shards.
    """
    device = resolve_device(device)
    check_model_tp(model, tp)
    root = config.ROOT_KEYTPOINT
    mid = config.SEQUENCE_LENGTH // 2
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    flip_idx = torch.as_tensor(config.AUGM_FLIP_KEYPOINT_ORDER, dtype=torch.long, device=device)

    def forward(params, keypoints2d, stride_mask):
        x = keypoints2d
        args = (x,)
        if model.has_strided_input:
            args = (x * stride_mask[:, :, None, None].to(x.dtype), stride_mask)
        if params is None:
            return model(*args)
        return torch.func.functional_call(model, params, args)

    @torch.no_grad()
    def step(params, batch):
        model.eval()
        if device_feed is not None:
            batch = device_feed.materialize(batch)
        keypoints3d, keypoints2d, stride_mask = prepare_batch(
            batch_to_device(batch, device), dataset_name)
        keypoints3d = keypoints3d - keypoints3d[:, :, root:root + 1, :]
        central_gt = keypoints3d[:, mid]
        pred_seq, pred_central = forward(params, keypoints2d, stride_mask)
        loss = torch.linalg.vector_norm(central_gt - pred_central, dim=-1).sum() / (b * k)
        if config.TEMPORAL_TRANSFORMER_BLOCKS > 0:
            loss = loss + torch.linalg.vector_norm(keypoints3d - pred_seq,
                                                   dim=-1).sum() / (b * n * k)
        if config.EVAL_FLIP:
            flipped_in = torch.cat([-keypoints2d[..., :1], keypoints2d[..., 1:]],
                                   dim=-1)[:, :, flip_idx]
            _, f_central = forward(params, flipped_in, stride_mask)
            f_central = torch.cat([-f_central[..., :1], f_central[..., 1:]],
                                  dim=-1)[:, flip_idx]
            pred_central = (pred_central + f_central) / 2.0
        if dp is not None:
            all_reduce_sum_(dp, [loss])
            pred_central, central_gt = gather_rows(dp, pred_central), gather_rows(dp, central_gt)
        return pred_central, central_gt, loss

    return step
