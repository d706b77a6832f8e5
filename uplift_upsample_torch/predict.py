"""Inference CLI: 2D keypoint sequences → 3D pose sequences, on the card.

Takes normalized 2D keypoints ((T, 17, 2), VideoPose3D 17-point order or the
canonical order) and produces per-frame 3D poses using the eval protocol:
sliding windows at SEQUENCE_STRIDE, central-frame predictions at keyframes,
linear interpolation in between, optional flip-TTA.

    python -m uplift_upsample_torch.predict --weights w.h5 --config h36m_351 \
        --input keypoints_2d.npz --output poses_3d.npz [--input_order vp3d] \
        [--device cuda|cpu]

Input npz: either a raw (T, 17, 2) array under 'positions_2d' (single
sequence) or a dict {name: (T, 17, 2)}. On CUDA the step runs the K1-K3
kernels; `--device cpu` runs the plain model. `--weights` takes a Keras `.h5`
(needs h5py) or the npz of `tools/convert_weights.py`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .config import UpliftUpsampleConfig
from .configs import resolve_config
from .data.fast_batcher import FastH36mBatcher
from .data.generator import H36mSequenceGenerator
from .data.keypoint_order import H36MOrder17POriginalOrder
from .eval import make_test_step
from .models import build_uplift_upsample_transformer
from .utils.eval_protocol import interpolate_between_keyframes
from .utils.weights_npz import load_weights


def make_predict_step(model, config: UpliftUpsampleConfig, flip_tta: bool = True):
    """ONE step for all sequences of a run. On CUDA it takes the kernel path
    (K1-K3 + plain tail); on the CPU the plain model, as the JAX package does
    off the TPU. EVAL_MATMUL_PRECISION is read as the eval CLI reads it
    ("default": the one-pass bf16 rung)."""
    on_card = next(model.parameters()).device.type == "cuda"
    return make_test_step(
        model, flip_tta=flip_tta, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
        fused="full" if on_card else "none",
        precision=getattr(config, "EVAL_MATMUL_PRECISION", "high") or "high",
        tta_batched=bool(getattr(config, "EVAL_TTA_BATCHED", True)))


def predict_sequence(model, config: UpliftUpsampleConfig,
                     keypoints_2d: np.ndarray, flip_tta: bool = True,
                     step=None) -> np.ndarray:
    """(T, K, 2) normalized 2D → (T, K, 3) root-relative 3D (meters).

    Window-sparse: when the strided protocol interpolates between keyframes
    (SEQUENCE_STRIDE > 1 + TEST_STRIDED_EVAL, reference eval.py:209-222),
    non-keyframe windows' predictions are overwritten by
    `interpolate_between_keyframes` (a pure function of the keyframe rows,
    and frame 0 is always a keyframe here), so only every stride-th window is
    computed. Batches are edge-padded to the static BATCH_SIZE, and the
    predictions come back to the host in one copy per sequence.
    """
    t, k, _ = keypoints_2d.shape
    if t == 0:
        return np.zeros((0, k, 3), np.float32)
    device = next(model.parameters()).device
    generator = H36mSequenceGenerator(
        [np.zeros((t, k, 3), dtype=np.float32)], [keypoints_2d.astype(np.float32)],
        camera_params=[np.zeros(11, np.float32)], subjects=[0], actions=[0],
        frame_rates=[50], split="predict", seq_len=config.SEQUENCE_LENGTH,
        subsample=1, stride=config.SEQUENCE_STRIDE, padding_type=config.PADDING_TYPE,
        mask_stride=config.MASK_STRIDE, stride_mask_align_global=True,
        rand_shift_stride_mask=False, flip_augment=False, shuffle=False,
        verbose=False)
    if step is None:
        step = make_predict_step(model, config, flip_tta=flip_tta)

    # One window per frame, through the vectorized batcher (central-only 3D:
    # the dummy 3D is never read).
    n_rows = len(generator)
    fast = FastH36mBatcher(generator, batch_size=n_rows, central_3d_only=True)
    _, rows_2d, _, _, _, _, indices, rows_sm = next(fast.batches())

    interp = config.SEQUENCE_STRIDE > 1 and config.TEST_STRIDED_EVAL
    compute = (np.flatnonzero(indices % config.SEQUENCE_STRIDE == 0)
               if interp else np.arange(n_rows))

    bs = int(config.BATCH_SIZE)
    centrals = []
    for lo in range(0, len(compute), bs):
        sel = compute[lo: lo + bs]
        x, sm = rows_2d[sel], rows_sm[sel]
        if len(sel) < bs:  # pad the tail to the one static batch shape
            rep = (0, bs - len(sel))
            x = np.pad(x, (rep, (0, 0), (0, 0), (0, 0)), mode="edge")
            sm = np.pad(sm, (rep, (0, 0)), mode="edge")
        _, central = step(torch.from_numpy(x).to(device),
                          torch.from_numpy(sm).to(device))
        centrals.append(central[: len(sel)])
    # one device→host copy for the whole sequence
    pred = np.zeros((n_rows, k, 3), np.float64)
    pred[compute] = torch.cat(centrals).float().cpu().numpy().astype(np.float64)

    if interp:
        pred, _ = interpolate_between_keyframes(
            pred, indices, np.full(n_rows, config.SEQUENCE_STRIDE))
    return pred.astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description="2D→3D pose inference")
    parser.add_argument("--weights", required=True, help="Path to .h5 or .npz weights")
    parser.add_argument("--config", required=False, default="h36m_351")
    parser.add_argument("--input", required=True, help="npz with 'positions_2d'")
    parser.add_argument("--output", required=True)
    parser.add_argument("--input_order", choices=["ours", "vp3d"], default="ours")
    parser.add_argument("--forced_mask_stride", type=int, default=None)
    parser.add_argument("--no_flip_tta", dest="flip_tta", action="store_false")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.set_defaults(flip_tta=True)
    args = parser.parse_args(argv)

    config = resolve_config(args.config)
    if args.forced_mask_stride is not None:
        config.MASK_STRIDE = args.forced_mask_stride
    elif isinstance(config.MASK_STRIDE, list):
        config.MASK_STRIDE = config.MASK_STRIDE[0]

    model = build_uplift_upsample_transformer(config, device=args.device)
    load_weights(args.weights, model)
    # ONE step shared by every sequence of the run
    step = make_predict_step(model, config, flip_tta=args.flip_tta)

    data = np.load(args.input, allow_pickle=True)
    raw = data["positions_2d"]
    sequences = raw.item() if raw.dtype == object and raw.shape == () else {"sequence": raw}

    out = {}
    for name, kps in sequences.items():
        kps = np.asarray(kps, dtype=np.float32)
        if kps.ndim != 3 or kps.shape[1:] != (17, 2):
            raise ValueError(f"{name}: expected (T, 17, 2) keypoints, got {kps.shape}")
        if args.input_order == "vp3d":
            kps = kps[:, H36MOrder17POriginalOrder.to_our_17p_order()]
        out[name] = predict_sequence(model, config, kps, flip_tta=args.flip_tta,
                                     step=step)
        print(f"{name}: {kps.shape[0]} frames -> 3D {out[name].shape}")
        sys.stdout.flush()

    np.savez_compressed(args.output, **out)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
