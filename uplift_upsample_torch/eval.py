"""Evaluation harness + CLI (counterpart of uplift_upsample_tpu/eval.py).

Protocol: one window per test frame (subsample = DATASET_TEST_3D_SUBSAMPLE_STEP,
global stride-mask alignment, no shuffle), central-frame prediction per window,
optional flip-TTA (one forward on the concatenated batch), linear
interpolation of keyframe predictions to all frames, float64 metrics on the
host. Window-sparse: only the windows whose prediction the interpolation
reads are computed; the shared spatial stage runs K1 once per unique frame.

CLI:
    python -m uplift_upsample_torch.eval --weights w.h5 --config h36m_351 \\
        --dataset data_3d_h36m.npz --dataset_2d data_2d_h36m_cpn_ft_h36m_dbb.npz \\
        [--pallas] [--device cuda|cpu]

On the card (the default) the step runs the kernel path: K1 on the unique
frames, the s2t Dense, K2, K3 and the plain tail (with `--pallas`, the tail's
attention through row 11). `--device cpu` runs the plain model.
EVAL_MATMUL_PRECISION "default" (the TPU's one-pass bf16 rung) runs the
kernels' bf16 instances and the plain products on bf16-rounded operands
(`precision.py`); "high" and "highest" run fp32-level products. `--weights`
takes a Keras `.h5` (needs h5py) or the npz of `tools/convert_weights.py`.

Data parallel, one process per card (rank 0 prints the results):
    torchrun --nproc-per-node N -m uplift_upsample_torch.eval ...
Every rank runs the same host-side protocol; the windows of each padded
batch split over the ranks, and the predictions are gathered back before
the float64 metrics, which every rank computes alike.
"""

from __future__ import annotations

import itertools
import math
import os
import sys
import time

import numpy as np
import torch

from .config import UpliftUpsampleConfig
from .data import h36m_splits
from .data.fast_batcher import FastH36mBatcher
from .data.generator import H36mSequenceGenerator
from .data.loading import filter_and_subsample_dataset, load_dataset_and_2d_poses
from .data.multihost import gather_rows, host_row_slice
from .models import build_uplift_upsample_transformer
from .parallel.mesh import (broadcast_params_, check_data_parallel_devices,
                            init_data_parallel, launch_world, rank0_stdout)
from .parallel.sharding import check_model_tp, gather_params_tp
from .precision import check_rung, matmul_precision
from .utils.dedup import dedup_rows
from .utils.eval_protocol import compute_and_log_metrics, interpolate_between_keyframes
from .utils.time_format import format_time
from .utils.weights_npz import load_weights


def log(*args):
    print(*args)
    sys.stdout.flush()


def resolve_temporal_wpt(wpt, num_frames: int) -> int:
    """The TPU temporal kernel's windows per tile (config EVAL_TEMPORAL_WPT).

    "auto"/None: 8 when R = wpt*ceil(N/8)*8 aligns to the TPU's 128-lane
    register width at wpt=8 but not at wpt=4, else 4. This is a tiling of the
    TPU kernel only: the port's kernels lay windows out as rows and take no
    windows-per-tile, so `run_eval` reads the key and logs the value, and
    nothing else depends on it."""
    if wpt not in (None, "auto"):
        return int(wpt)
    s_pad = -(-num_frames // 8) * 8
    if (8 * s_pad) % 128 == 0 and (4 * s_pad) % 128 != 0:
        return 8
    return 4


def make_test_step(model, flip_tta: bool, flip_lr_indices, fused: str = "none",
                   precision: str = "high", max_keyframes: int = None,
                   assume_dense_mask: bool = False, shared_spatial: bool = False,
                   tta_batched: bool = True, temporal_wpt=None, strided_sel: bool = False,
                   dp=None, tp=None):
    """Forward step with optional flip-TTA.

    `fused` selects the compute path:
      - "full": the kernel path of `models.bench_forward` (K1 spatial stack,
        s2t Dense, K2 temporal stack, K3 strided block 1, plain tail). Central
        prediction only. Needs a spatial and a temporal stack.
      - "spatial": K1 at "high" whatever the rung (as the JAX step runs
        it), then the model from the s2t Dense on (`spatial_input` splice)
        at the rung.
      - "none": the plain model.
    At "highest", "full" runs "none" (the JAX step's switch).
    On CPU tensors the kernels' plain versions run. `precision` is checked by
    `precision.check_rung`: "high" (TF32 off, set where the package
    initialises) and "highest" run the same code; "default" the bf16 rung,
    the step inside `precision.matmul_precision("default")` and the kernels'
    bf16 instances (their plain versions on the CPU).
    `max_keyframes`, `assume_dense_mask`, `strided_sel`: see `bench_forward`
    ("full" path). `temporal_wpt` (EVAL_TEMPORAL_WPT) is resolved by
    `resolve_temporal_wpt` and handed on; it changes no launch.
    `tta_batched`: run flip-TTA as ONE forward on the concatenated
    [unflipped; flipped] batch instead of two forwards (the same math,
    batched).
    `shared_spatial`: the eval protocol's shared spatial stage ("full" or
    "none" with a spatial stack). The step then takes (unique2d (U, K, 2)
    masked, deduplicated frames, win_idx (B, N) integer, stride_mask (B, N)):
    the caller masks and deduplicates frames on the host. Flip-TTA flips the
    unique frames (the flip is per frame, so the dedup structure holds).

    Returns fn(keypoints2d (B,N,K,2) unmasked, stride_mask (B,N) bool) — or
    the shared signature above — → (pred_sequence (B,N,K,3) | None,
    pred_central (B,K,3)).

    `dp` (a `parallel.mesh.DataParallel`): the step still takes and returns
    the global batch, but each rank runs its rows of the windows (the unique
    frames, replicated, whole) and the outputs are gathered in rank order.
    B must divide over the ranks.

    `tp` (a `parallel.sharding.TensorParallel`, the model's own: the model
    is built with it): tensor parallelism over the mp ranks, "none" and
    "full" ("spatial" too). The mp peers of a dp rank run the same windows
    (with `dp` a `parallel.mesh.Mesh`, its rows follow the dp index); "none"
    runs the model's split modules, "full" K1 on gathered spatial weights,
    K2 and K3 split over mp and the split tail (`bench_forward`).
    """
    check_rung(precision, use_pallas=model.use_pallas, tp=model.tp)
    check_model_tp(model, tp)
    if precision == "highest" and fused == "full":
        # the strictest rung runs the plain model, as the JAX step switches
        # "full" to "none" there (uplift_upsample_tpu/eval.py:105-109)
        fused = "none"
    device = next(model.parameters()).device
    flip_idx = torch.as_tensor(np.asarray(flip_lr_indices, dtype=np.int64),
                               device=device)
    if shared_spatial:
        assert (model.spatial_depth > 0
                and (fused == "none"
                     or (fused == "full" and model.temporal_depth > 0))), \
            "shared_spatial needs the fused-full or plain path + a spatial stack"

    def masked(keypoints2d, stride_mask):
        if model.has_strided_input:
            return keypoints2d * stride_mask[:, :, None, None].to(keypoints2d.dtype)
        return keypoints2d

    if fused == "full" and model.spatial_depth > 0 and model.temporal_depth > 0:
        from .models.bench_forward import (bench_forward, prepare_fused_params,
                                           shared_spatial_forward)
        fused_params = prepare_fused_params(model, precision)
        route = dict(temporal_wpt=resolve_temporal_wpt(temporal_wpt, model.num_frames),
                     strided_sel=strided_sel, precision=precision)
        if shared_spatial:
            def forward(unique2d, win_idx, stride_mask):
                return None, shared_spatial_forward(
                    model, unique2d, win_idx, stride_mask, fused_params,
                    assume_dense_mask=assume_dense_mask, **route)
        else:
            def forward(keypoints2d, stride_mask):
                return None, bench_forward(
                    model, masked(keypoints2d, stride_mask), stride_mask, fused_params,
                    max_keyframes=max_keyframes, assume_dense_mask=assume_dense_mask,
                    **route)
    elif fused in ("full", "spatial") and model.spatial_depth > 0:
        from .ops.spatial import (pack_spatial_params, spatial_stack_apply,
                                  stack_spatial_params)
        state = gather_params_tp({k: v.detach() for k, v in model.state_dict().items()},
                                 model.tp)
        sp_ops = stack_spatial_params(state, model.spatial_depth)
        sp_packed = pack_spatial_params(sp_ops)

        def forward(keypoints2d, stride_mask):
            # K1 at "high" on every rung (the JAX step's kernel_precision,
            # HIGH3); the model from the s2t Dense on follows the rung
            sp = spatial_stack_apply(sp_ops, masked(keypoints2d, stride_mask),
                                     num_heads=model.num_heads, packed=sp_packed,
                                     precision="high")
            return model(sp, stride_mask, spatial_input=True)
    elif shared_spatial:
        # The plain shared path through the model's s2t splices
        def forward(unique2d, win_idx, stride_mask):
            y_u = model(unique2d[:, None], s2t_output=True)       # (U, 1, C)
            return model(y_u[:, 0][win_idx], stride_mask, s2t_input=True)
    elif fused in ("full", "spatial", "none"):
        def forward(keypoints2d, stride_mask):
            return model(masked(keypoints2d, stride_mask), stride_mask)
    else:
        raise ValueError(f"fused must be 'full', 'spatial' or 'none', got {fused!r}")

    def flip_in(frames):
        """x-negate + L/R joint swap; frames is (..., K, 2)."""
        flipped = torch.cat([-frames[..., :1], frames[..., 1:]], dim=-1)
        return flipped.index_select(-2, flip_idx)

    def unflip_central(f_central):
        return torch.cat([-f_central[..., :1], f_central[..., 1:]],
                         dim=-1)[:, flip_idx]

    def unflip_seq(f_seq):
        return torch.cat([-f_seq[..., :1], f_seq[..., 1:]], dim=-1)[:, :, flip_idx]

    def average(pred, flipped):
        """Mean of a pass and the un-flipped flipped pass."""
        seq, central = pred
        f_seq, f_central = flipped
        central = (central + unflip_central(f_central)) / 2.0
        if seq is not None:
            seq = (seq + unflip_seq(f_seq)) / 2.0
        return seq, central

    def halves(pred, b):
        seq, central = pred
        return ((None if seq is None else seq[:b], central[:b]),
                (None if seq is None else seq[b:], central[b:]))

    @torch.inference_mode()
    @matmul_precision(precision)
    def step(keypoints2d, stride_mask):
        if flip_tta and tta_batched:
            both = torch.cat([keypoints2d, flip_in(keypoints2d)], dim=0)
            sm2 = torch.cat([stride_mask, stride_mask], dim=0)
            return average(*halves(forward(both, sm2), keypoints2d.shape[0]))
        pred = forward(keypoints2d, stride_mask)
        if flip_tta:
            return average(pred, forward(flip_in(keypoints2d), stride_mask))
        return pred

    @torch.inference_mode()
    @matmul_precision(precision)
    def step_shared(unique2d, win_idx, stride_mask):
        if flip_tta and tta_batched:
            # [uniques; flipped uniques] through one spatial pass,
            # [windows; flipped windows] (gathering from the second half)
            # through one temporal chain
            u = unique2d.shape[0]
            both_u = torch.cat([unique2d, flip_in(unique2d)], dim=0)
            both_idx = torch.cat([win_idx, win_idx + u], dim=0)
            both_sm = torch.cat([stride_mask, stride_mask], dim=0)
            return average(*halves(forward(both_u, both_idx, both_sm), win_idx.shape[0]))
        pred = forward(unique2d, win_idx, stride_mask)
        if flip_tta:
            return average(pred, forward(flip_in(unique2d), win_idx, stride_mask))
        return pred

    inner = step_shared if shared_spatial else step
    if dp is None:
        return inner

    def dp_step(*args):
        rows = host_row_slice(args[-1].shape[0], dp.rank, dp.world)
        shared = args[:1] if shared_spatial else ()  # the unique frames, whole
        seq, central = inner(*shared, *(a[rows] for a in args[len(shared):]))
        return (None if seq is None else gather_rows(dp, seq)), gather_rows(dp, central)

    return dp_step


def sparse_rows_to_compute(frame_indices, kf_stride, state):
    """Rows the window-sparse strided eval must run the model on.

    Keyframe-centered rows (index % kf_stride == 0) — the only rows the
    interpolation pass reads — PLUS any row before the first keyframe of its
    sequence (restart = non-increasing index), which the interpolation pass
    leaves untouched and whose raw prediction therefore reaches the metrics.
    `state` is a mutable [prev_index, seen_keyframe] carried across batches;
    start with [None, False].
    """
    rows = []
    prev_f, seen_kf = state
    for r, f in enumerate(frame_indices):
        f = int(f)
        if prev_f is not None and f <= prev_f:
            seen_kf = False  # sequence restart
        prev_f = f
        if f % kf_stride == 0:
            seen_kf = True
            rows.append(r)
        elif not seen_kf:
            rows.append(r)
    state[0], state[1] = prev_f, seen_kf
    return rows


def scatter_parts(pred_parts, num_examples: int, num_keypoints: int) -> np.ndarray:
    """Per-call predictions → (num_examples, K, 3) float64 on the host.

    pred_parts: [(rows (n_i, K, 3) tensor, example positions (n_i,))]. One
    device→host copy for the whole run; each part is placed by its own row
    count, and the total must match.
    """
    out = np.zeros((num_examples, num_keypoints, 3), np.float64)
    if not pred_parts:
        return out
    counts = [len(positions) for _, positions in pred_parts]
    for (rows, _), count in zip(pred_parts, counts):
        assert rows.shape[0] == count, (rows.shape, count)
    all_pred = torch.cat([rows for rows, _ in pred_parts]).cpu().numpy()
    assert all_pred.shape[0] == sum(counts), (all_pred.shape, sum(counts))
    start = 0
    for (_, positions), count in zip(pred_parts, counts):
        out[positions] = all_pred[start:start + count].astype(np.float64)
        start += count
    return out


def build_eval_generator(config: UpliftUpsampleConfig, dataset_path, dataset2d_path,
                         test_subset, verbose=True):
    selected_subjects = h36m_splits.subjects_by_split[test_subset]
    dataset_3d, poses_2d = load_dataset_and_2d_poses(
        dataset_path=dataset_path, poses_2d_path=dataset2d_path, verbose=verbose)
    camera_params, poses_3d, poses_2d, _, subjects, actions, frame_rates = \
        filter_and_subsample_dataset(
            dataset=dataset_3d, poses_2d=poses_2d, subjects=selected_subjects,
            action_filter="*", downsample=1, image_base_path=dataset_path,
            verbose=verbose)
    return H36mSequenceGenerator(
        poses_3d, poses_2d, camera_params=camera_params, subjects=subjects,
        actions=actions, frame_rates=frame_rates, split=test_subset,
        seq_len=config.SEQUENCE_LENGTH, target_frame_rate=50,
        subsample=config.DATASET_TEST_3D_SUBSAMPLE_STEP, stride=config.SEQUENCE_STRIDE,
        padding_type=config.PADDING_TYPE, mask_stride=config.MASK_STRIDE,
        stride_mask_align_global=True, rand_shift_stride_mask=False,
        flip_augment=False, shuffle=False, verbose=verbose)


def _packed_upload(shared_step, u_max: int, batch: int, n: int, k: int, device):
    """EVAL_PACKED_UPLOAD: one flat byte buffer per flush instead of three
    host→card copies — unique frames as raw f32 bytes, window indices as
    int16 (u_max < 2^15), stride masks bit-packed (little bit order) — and
    its unpacking on the card with views. Returns (pack_host, packed_step);
    the results are bit-equal to the three-array path."""
    a = u_max * k * 2 * 4                 # uq f32 bytes
    b = a + batch * n * 2                 # idx int16 bytes
    nbits = -(-batch * n // 8)            # packbits bytes
    shifts = torch.arange(8, dtype=torch.uint8, device=device)

    def pack_host(uq, idx, smb):
        return np.concatenate([
            uq.astype(np.float32, copy=False).view(np.uint8).ravel(),
            idx.astype(np.int16).view(np.uint8).ravel(),
            np.packbits(np.asarray(smb, bool).ravel(), bitorder="little")])

    def packed_step(flat_u8):
        uq = flat_u8[:a].view(torch.float32).reshape(u_max, k, 2)
        idx = flat_u8[a:b].view(torch.int16).to(torch.int64).reshape(batch, n)
        bits = flat_u8[b:b + nbits]
        smb = ((bits[:, None] >> shifts) & 1).reshape(-1)[:batch * n].reshape(batch, n) > 0
        return shared_step(uq, idx, smb)

    return pack_host, packed_step


def run_eval(config: UpliftUpsampleConfig, dataset_name, dataset_path, dataset2d_path,
             test_subset, weights_path=None, model=None, action_wise=True,
             verbose=True, device="cuda", dp=None):
    """Run H3.6M evaluation; returns (all-frames results, keyframes results or None),
    each as (frame_results, average_results, per_action_results).

    The model is built on `device` (the card unless the caller asks for the
    CPU) from the config and `weights_path`, or passed in as `model` (its
    weights are used, or replaced by `weights_path` when that is given).
    With `dp` (a `parallel.mesh.DataParallel`) the model is built on the
    rank's device and rank 0's weights are broadcast; every rank returns the
    same results. DATA_PARALLEL_DEVICES must be -1 or the world size.
    """
    assert dataset_name == "h36m", "Invalid dataset"
    assert not (weights_path is None and model is None)
    check_data_parallel_devices(config, 1 if dp is None else dp.world, "eval")

    if model is None:
        model = build_uplift_upsample_transformer(
            config, device=device if dp is None else dp.device)
    if weights_path is not None:
        log(f"Loading weights from {weights_path}")
        load_weights(weights_path, model)
    model.eval()
    dev = next(model.parameters()).device
    if dp is not None:
        broadcast_params_(dp, list(model.parameters()))

    generator = build_eval_generator(config, dataset_path, dataset2d_path,
                                     test_subset, verbose=verbose)
    num_examples = len(generator)
    log(f"Sequences: {num_examples}")

    fused_mode = getattr(config, "EVAL_FUSED", "auto")
    if fused_mode == "auto":
        # The kernels on the card; the plain model on the CPU (the JAX
        # package's TPU / non-TPU rule, eval.py:347-358)
        if dev.type == "cuda":
            fused_mode = "full"
        else:
            fused_mode = ("spatial" if getattr(config, "USE_PALLAS_SPATIAL", False)
                          else "none")
    # Keyframe-sparse spatial stage: window tokens sit at global frames
    # i + (t-mid)·stride, and the aligned eval mask marks tokens with global
    # frame ≡ 0 (mod ms), so real-input tokens recur with token period
    # ms/gcd(stride, ms) — at most ceil(N/period) per window.
    max_kf = None
    period = None
    ms = config.MASK_STRIDE
    if isinstance(ms, int) and ms > 1:
        period = ms // math.gcd(config.SEQUENCE_STRIDE, ms)
        if period > 1:
            max_kf = -(-config.SEQUENCE_LENGTH // period)

    # Window-sparse strided eval: the interpolation pass overwrites every
    # prediction whose frame index is not a multiple of the keyframe stride
    # (reference eval.py:209-222 + action_wise_eval.py:76-100), and the
    # KEYFRAMES report reads only index % MASK_STRIDE == 0 rows, so only the
    # keyframe-centered windows are computed, for identical metrics. Gated on
    # MASK_STRIDE % keyframe_stride == 0 so the KEYFRAMES subset stays inside
    # the computed set.
    strided_eval = config.SEQUENCE_STRIDE > 1 and config.TEST_STRIDED_EVAL
    kf_stride = config.SEQUENCE_STRIDE
    if config.EVAL_DISABLE_LEARNED_UPSAMPLING and config.MASK_STRIDE is not None:
        kf_stride = config.MASK_STRIDE
    window_sparse = (
        strided_eval and isinstance(kf_stride, int) and kf_stride > 1
        and (ms is None or (isinstance(ms, int) and ms % kf_stride == 0))
        and bool(getattr(config, "EVAL_SKIP_INTERPOLATED_WINDOWS", True)))

    # With token period 1 every COMPUTED window's mask is all-ones, so the
    # first-block key mask is inert: K2 runs without it.
    assume_dense = bool(window_sparse and period == 1)
    eval_precision = getattr(config, "EVAL_MATMUL_PRECISION", "high") or "high"
    eval_wpt = getattr(config, "EVAL_TEMPORAL_WPT", "auto")
    if verbose:
        log(f"EVAL_TEMPORAL_WPT resolves to "
            f"{resolve_temporal_wpt(eval_wpt, config.SEQUENCE_LENGTH)} (a TPU tiling; "
            f"the port's kernels do not use it)")

    if dp is not None and config.BATCH_SIZE % dp.world:
        log(f"BATCH_SIZE {config.BATCH_SIZE} does not divide over {dp.world} ranks — "
            f"single-device eval")
        dp = None
    elif dp is not None:
        log(f"Data-parallel eval over {dp.world} ranks ({dp.backend})")

    tta_batched = bool(getattr(config, "EVAL_TTA_BATCHED", True))
    step_kwargs = dict(flip_tta=config.EVAL_FLIP,
                       flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                       fused=fused_mode, precision=eval_precision,
                       assume_dense_mask=assume_dense, tta_batched=tta_batched,
                       temporal_wpt=eval_wpt, dp=dp)
    test_step = make_test_step(model, max_keyframes=max_kf, **step_kwargs)

    # Cross-window shared spatial stage: consecutive computed windows overlap
    # in N-1 frames and the spatial stage is frame-independent, so features
    # are computed once per unique masked frame (host dedup, exact) and
    # gathered into windows.
    shared_cfg = getattr(config, "EVAL_SHARED_SPATIAL", "auto")
    if shared_cfg == "auto":
        shared = bool(window_sparse and fused_mode == "full"
                      and model.spatial_depth > 0 and model.temporal_depth > 0)
    else:
        shared = bool(shared_cfg and window_sparse
                      and fused_mode in ("full", "none")
                      and model.spatial_depth > 0)
    shared_step, u_max = None, 0
    if shared:
        shared_step = make_test_step(model, shared_spatial=True, **step_kwargs)
        u_extra = int(getattr(config, "EVAL_SHARED_UMAX_EXTRA", 1024))
        u_max = min(config.BATCH_SIZE * config.SEQUENCE_LENGTH,
                    max(config.BATCH_SIZE + u_extra, config.SEQUENCE_LENGTH))
        u_max = -(-u_max // 8) * 8

    pack_host = packed_step = None
    if (shared and dp is None and u_max < 2 ** 15
            and bool(getattr(config, "EVAL_PACKED_UPLOAD", True))):
        pack_host, packed_step = _packed_upload(
            shared_step, u_max, config.BATCH_SIZE, config.SEQUENCE_LENGTH,
            config.NUM_KEYPOINTS, dev)

    log(f"Running evaluation on '{test_subset}' with {num_examples} examples")
    start = time.time()
    root = config.ROOT_KEYTPOINT

    if window_sparse:
        log(f"Window-sparse strided eval: computing only every "
            f"{kf_stride}-th window (others are interpolation-only)"
            + (f"; shared spatial stage (capacity {u_max} unique frames)"
               if shared else ""))

    gt_central = []
    gt_actions, gt_indices = [], []
    examples = 0
    # Packed keyframe-window batches: rows accumulate across incoming batches
    # and run through the step when a full batch is ready; predictions stay
    # on the card until the end and are scattered back by example row.
    pend_x, pend_sm, pend_pos = [], [], []
    pred_parts = []  # (rows on the card, example positions)
    sparse_state = [None, False]  # sparse_rows_to_compute carry
    shared_fallbacks = [0]
    # Wall-time attribution of the eval loop's phases (one line at the end).
    # The card runs asynchronously: upload_dispatch is the host's copy and
    # launch time, and fetch_scatter includes waiting for the card.
    timing = {"batcher": 0.0, "sparse_pack": 0.0, "dedup": 0.0,
              "upload_dispatch": 0.0, "gt_extract": 0.0, "fetch_scatter": 0.0,
              "interp": 0.0, "metrics": 0.0}

    def to_dev(a):
        return torch.from_numpy(a).to(dev)

    def flush(force=False):
        bs = config.BATCH_SIZE
        while len(pend_pos) >= bs or (force and pend_pos):
            take = min(bs, len(pend_pos))
            xb = np.stack(pend_x[:take])
            smb = np.stack(pend_sm[:take])
            if take < bs:  # pad the final partial batch
                rep = (0, bs - take)
                xb = np.pad(xb, (rep, (0, 0), (0, 0), (0, 0)), mode="edge")
                smb = np.pad(smb, (rep, (0, 0)), mode="edge")
            pred = None
            if shared_step is not None:
                n_seq = xb.shape[1]
                xm = xb * smb[:, :, None, None].astype(xb.dtype)
                t0 = time.perf_counter()
                uniq, inv = dedup_rows(xm.reshape(bs * n_seq, -1))
                timing["dedup"] += time.perf_counter() - t0
                if len(uniq) <= u_max:
                    uq = np.zeros((u_max,) + xm.shape[2:], xm.dtype)
                    uq[:len(uniq)] = uniq.reshape((-1,) + xm.shape[2:])
                    idx = inv.reshape(bs, n_seq).astype(np.int64)
                    t0 = time.perf_counter()
                    if packed_step is not None:
                        _, pred = packed_step(to_dev(pack_host(uq, idx, smb)))
                    else:
                        _, pred = shared_step(to_dev(uq), to_dev(idx), to_dev(smb))
                    timing["upload_dispatch"] += time.perf_counter() - t0
                else:
                    # more unique frames than the step's capacity (many
                    # sequence restarts in one batch) — the dense step
                    shared_fallbacks[0] += 1
            if pred is None:
                t0 = time.perf_counter()
                _, pred = test_step(to_dev(xb), to_dev(smb))
                timing["upload_dispatch"] += time.perf_counter() - t0
            pred_parts.append((pred[:take], np.asarray(pend_pos[:take])))
            del pend_x[:take], pend_sm[:take], pend_pos[:take]
            if not force:
                break

    # Chained deterministic epochs == the reference's repeat(2) → batch →
    # take(ceil) protocol. central_3d_only: the loop reads only the
    # central-frame 3D ground truth.
    num_batches = int(np.ceil(num_examples / config.BATCH_SIZE))
    fast = FastH36mBatcher(generator, batch_size=config.BATCH_SIZE,
                           central_3d_only=True)
    batch_iter = iter(itertools.islice(fast.batches(), num_batches))
    while True:
        t0 = time.perf_counter()
        batch = next(batch_iter, None)
        timing["batcher"] += time.perf_counter() - t0
        if batch is None:
            break
        seq3d, seq2d, _, _, _, actions, indices, stride_masks = batch

        include = min(config.BATCH_SIZE, num_examples - examples)
        if window_sparse:
            # Host-side check of the keyframe-sparse bound: a window with
            # more real-input frames than max_kf would be mis-gathered by
            # bench_forward — catch protocol drift here instead.
            if max_kf is not None:
                counts = np.asarray(stride_masks[:include]).sum(axis=1)
                assert counts.max(initial=0) <= max_kf, (
                    f"stride mask has {int(counts.max())} keyframes, "
                    f"bound {max_kf} — MASK_STRIDE/window derivation "
                    f"out of sync with the generator")
            t0 = time.perf_counter()
            rows = sparse_rows_to_compute(indices[:include], kf_stride,
                                          sparse_state)
            for r in rows:
                pend_x.append(seq2d[r])
                pend_sm.append(stride_masks[r])
                pend_pos.append(examples + int(r))
            timing["sparse_pack"] += time.perf_counter() - t0
            flush()
        else:
            t0 = time.perf_counter()
            _, pred = test_step(to_dev(seq2d), to_dev(stride_masks))
            timing["upload_dispatch"] += time.perf_counter() - t0
            pred_parts.append((pred[:include], np.arange(examples, examples + include)))
        t0 = time.perf_counter()
        # Only the central frame feeds the metrics (both 3D widths: full N
        # or the batcher's central_3d_only single row).
        central3d = seq3d[:include, seq3d.shape[1] // 2]
        gt_central.append(central3d - central3d[:, root:root + 1, :])
        gt_actions.append(np.asarray(actions[:include]))
        gt_indices.append(np.asarray(indices[:include]))
        timing["gt_extract"] += time.perf_counter() - t0
        examples += include
    if window_sparse:
        flush(force=True)
    if shared_fallbacks[0]:
        log(f"Shared-spatial: {shared_fallbacks[0]} batch(es) exceeded the "
            f"{u_max}-unique-frame capacity and used the dense step")

    gt_central = np.concatenate(gt_central, axis=0).astype(np.float64)
    gt_central = np.concatenate(
        [gt_central, np.ones(gt_central.shape[:-1] + (1,))], axis=-1)
    t0 = time.perf_counter()
    pred_central = scatter_parts(pred_parts, num_examples, config.NUM_KEYPOINTS)
    timing["fetch_scatter"] += time.perf_counter() - t0
    gt_actions = np.concatenate(gt_actions, axis=0)
    gt_indices = np.concatenate(gt_indices, axis=0)

    full_pred = np.copy(pred_central)
    if config.SEQUENCE_STRIDE > 1 and config.TEST_STRIDED_EVAL:
        log("Performing strided eval: Interpolating between keyframes")
        strides = np.tile([config.SEQUENCE_STRIDE], reps=(gt_indices.shape[0]))
        if config.EVAL_DISABLE_LEARNED_UPSAMPLING and config.MASK_STRIDE is not None:
            strides[:] = config.MASK_STRIDE
        t0 = time.perf_counter()
        interp_pred, _ = interpolate_between_keyframes(
            pred3d=full_pred, frame_indices=gt_indices, keyframe_stride=strides)
        timing["interp"] += time.perf_counter() - t0
        eval_pred = interp_pred
    else:
        eval_pred = full_pred

    log("\n### Evaluation on ALL FRAMES ####\n")
    t0 = time.perf_counter()
    all_frames = compute_and_log_metrics(
        pred3d=eval_pred, gt3d=gt_central, actions=gt_actions,
        root_index=root, action_wise=action_wise)
    timing["metrics"] += time.perf_counter() - t0

    keyframes_results = None
    if (config.SEQUENCE_STRIDE > 1
            or (config.MASK_STRIDE is not None and np.ndim(config.MASK_STRIDE) == 0
                and config.MASK_STRIDE > 1)) and config.TEST_STRIDED_EVAL:
        log("\n### Evaluation on KEYFRAMES ####\n")
        input_stride = config.SEQUENCE_STRIDE if config.MASK_STRIDE is None else config.MASK_STRIDE
        keyframes = np.equal(np.mod(gt_indices, input_stride), 0)
        keyframes_results = compute_and_log_metrics(
            pred3d=full_pred[keyframes], gt3d=gt_central[keyframes],
            actions=gt_actions[keyframes], root_index=root, action_wise=action_wise)

    total = time.time() - start
    attributed = sum(timing.values())
    log("Eval wall attribution: "
        + " ".join(f"{k}={v:.1f}s" for k, v in timing.items())
        + f" other={total - attributed:.1f}s total={total:.1f}s "
        f"gather=native(up to {torch.get_num_threads()} threads)")
    log(f"Finished evaluation in {format_time(total)}")
    return all_frames, keyframes_results


def run_eval_multi_mask_stride(config: UpliftUpsampleConfig, *args, **kwargs):
    """Evaluate once per configured mask-stride value; returns {stride: results}."""
    config = config.copy()
    mask_stride_values = config.MASK_STRIDE
    if not isinstance(mask_stride_values, list):
        mask_stride_values = [mask_stride_values]
    results = {}
    for msv in mask_stride_values:
        config.MASK_STRIDE = msv
        if len(mask_stride_values) > 1:
            log(f"### Running evaluation for mask stride value: {msv} ###")
        results[msv] = run_eval(config, *args, **kwargs)
        if len(mask_stride_values) > 1:
            log(f"### Finished evaluation for mask stride value: {msv} ###")
    return results


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="3D evaluation on H36m (PyTorch + CUDA).")
    parser.add_argument("--weights", required=True, help="Path to .h5 or .npz weights")
    parser.add_argument("--config", required=False, default=None)
    parser.add_argument("--batch_size", required=False, default=None, type=int)
    parser.add_argument("--dataset", required=False, default="./data/data_3d_h36m.npz")
    parser.add_argument("--dataset_2d", required=False,
                        default="./data/data_2d_h36m_cpn_ft_h36m_dbb.npz")
    parser.add_argument("--test_subset", required=False, default="test")
    parser.add_argument("--action_wise", dest="action_wise", action="store_true")
    parser.add_argument("--frame_wise", dest="action_wise", action="store_false")
    parser.set_defaults(action_wise=True)
    parser.add_argument("--forced_mask_stride", required=False, default=None, type=int)
    parser.add_argument("--no_learned_upsampling", dest="disable_learned_upsampling",
                        action="store_true")
    parser.set_defaults(disable_learned_upsampling=False)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 activations, COMPUTE_DTYPE (not ported: raises; "
                             "the bf16 matmul rung is EVAL_MATMUL_PRECISION 'default')")
    parser.add_argument("--pallas", action="store_true",
                        help="the packed attention kernel in every attention layer "
                             "(USE_PALLAS_ATTENTION)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from .configs import resolve_config
    config = resolve_config(args.config)
    assert config.ARCH == "UpliftUpsampleTransformer"
    if args.forced_mask_stride is not None:
        log(f"Setting mask stride to fixed value: {args.forced_mask_stride}")
        config.MASK_STRIDE = args.forced_mask_stride
    if args.batch_size is not None:
        config.BATCH_SIZE = int(args.batch_size)
    if args.disable_learned_upsampling and config.MASK_STRIDE is not None:
        log("WARNING: Disabling learned upsampling. Will use pure bi-linear upsampling.")
        config.EVAL_DISABLE_LEARNED_UPSAMPLING = True
    if args.bf16:
        config.COMPUTE_DTYPE = "bfloat16"
    if args.pallas:
        config.USE_PALLAS_ATTENTION = True

    check_data_parallel_devices(config, launch_world(), "eval")
    dp = init_data_parallel(args.device) if "WORLD_SIZE" in os.environ else None
    try:
        with rank0_stdout(dp):  # rank 0 prints the results
            config.display()
            return run_eval_multi_mask_stride(
                config, dataset_name="h36m", dataset_path=args.dataset,
                dataset2d_path=args.dataset_2d, test_subset=args.test_subset,
                weights_path=args.weights, action_wise=args.action_wise,
                device=args.device, dp=dp)
    finally:
        if dp is not None:
            dp.close()


if __name__ == "__main__":
    main()
