#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases (one line each; any failure ends the run with a non-zero exit):
  1. the card's name and power limit; build the CUDA kernels of
     uplift_upsample_torch/csrc with nvcc for sm_90a, one nvcc per source,
     all started together;
  2. each kernel against its plain PyTorch version on the card at h36m_351
     width (K1 on 72,704 frames, K2 and K3 on 1,024 windows of 71 tokens,
     K3 also at the h36m_81 geometry), with its time from CUDA events, the
     plain version's time, a PyTorch library call's time where one computes
     the same function, and the least time the card could take (bound);
  3. the serving path end to end: a seeded full-width h36m_351 model, flip-TTA
     on, seeded synthetic 2D sequences through `predict_sequence` on the
     kernel path, the launch counts of that run, and the same sequences
     through the plain model on the card for comparison;
  4. one JSON line of per-kernel numbers, the card line again, and the last
     line `{"ok": true, "device": {...}}`.

It needs a CUDA card and the repository checkout around it; without either it
exits non-zero before printing any result. Weights are random (from --seed):
the card's machine has no h5py to read a checkpoint.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SEQUENCES, FRAMES = 3, 3000  # synthetic 2D sequences of the predict phase

# H100 SXM peaks (NVIDIA data sheet): fp32 on CUDA cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, ref) -> float:
    return float((got - ref).abs().max())


def tolerance(ref) -> float:
    # fp32 sums over K <= 2304 taken in another order than the plain version
    return 2e-4 * max(1.0, float(ref.abs().max()))


def ops_bytes(ops) -> int:
    return sum(v.numel() for v in ops.values()) * F32


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from uplift_upsample_torch.configs import get_config
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from uplift_upsample_torch.eval import make_test_step
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import prepare_fused_params
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.spatial import spatial_stack, spatial_stack_plain
    from uplift_upsample_torch.ops.strided import (output_length, strided_block1,
                                                   strided_block1_plain)
    from uplift_upsample_torch.ops.temporal import (gemm, layernorm,
                                                    temporal_stack,
                                                    temporal_stack_plain,
                                                    window_attention,
                                                    window_attention_plain)
    from uplift_upsample_torch.predict import make_predict_step, predict_sequence

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_lib.build(verbose=True)
    log(f"phase 1 build: {len(cuda_lib.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in cuda_lib.SOURCES:
        for line in built[f"{name}.log"].splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- phase 2: each kernel against its plain version ----------------------
    config = get_config("h36m_351")
    config.MASK_STRIDE = config.MASK_STRIDE[0]
    model = build_uplift_upsample_transformer(config, device="cuda", seed=args.seed)
    fp = prepare_fused_params(model)
    heads = model.num_heads
    rng = np.random.default_rng(args.seed)
    windows = 2 * config.BATCH_SIZE            # flip-TTA doubles the batch
    n, c = config.SEQUENCE_LENGTH, config.TEMPORAL_EMBED_DIM
    hid = int(c * config.MLP_RATIO)
    frames = windows * n
    p, cs = config.NUM_KEYPOINTS, config.SPATIAL_EMBED_DIM

    def rand(*shape, scale=0.5):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    results = {}
    failed = []

    def record(name, route, source, replaces, got, ref, ms, plain_ms, flops, nbytes,
               library_ms=None, counter=None, listed=True):
        err, tol = max_err(got, ref), tolerance(ref)
        b_ms, b_by = bound_ms(flops, nbytes)
        entry = dict(name=name, route=route, source=source, replaces=replaces,
                     launches=0, counter=counter or name, max_abs_err=err, tol=tol,
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=library_ms)
        if listed:  # a second geometry of a kernel is checked but not listed
            results[name] = entry
        ok = err <= tol and bool(torch.isfinite(got).all())
        if not ok:
            failed.append(name)
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        log(f"phase 2 {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"{'ok' if ok else 'FAILED'}; ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {lib} bound_ms {b_ms:.4f} ({b_by})")

    # K1: the spatial stack on every frame of a flip-TTA batch
    x_sp = rand(frames, p, 2)
    sp_ops = fp["spatial"]
    sp_fn = lambda: spatial_stack(x_sp, sp_ops, num_heads=heads,
                                  packed=fp["spatial_packed"])
    sp_plain = lambda: spatial_stack_plain(x_sp, sp_ops, num_heads=heads)
    got, ref = sp_fn(), sp_plain()
    per_frame = (p * 2 * cs * 2 + model.spatial_depth
                 * (2 * p * cs * cs * 4 + 2 * p * cs * 2 * cs * 2 + 4 * p * p * cs))
    record("spatial_stack", "cuda", "uplift_upsample_torch/csrc/spatial.cu",
           "uplift_upsample_tpu/ops/pallas_spatial.py:398", got, ref,
           time_ms(torch, sp_fn, 10), time_ms(torch, sp_plain, 3),
           frames * per_frame,
           (x_sp.numel() + got.numel() + fp["spatial_packed"].numel()) * F32)
    del got, ref

    # K2: the temporal stack, key mask from a mask stride of 10 at random phases
    x_tm = rand(windows, n, c)
    phase = rng.integers(0, 10, size=(windows, 1))
    km = torch.from_numpy(((np.arange(n)[None] + phase) % 10 != 0)
                          .astype(np.float32)).to(dev)
    tm_ops = fp["temporal"]
    fmb = model.first_strided_token_attention_layer
    tm_fn = lambda: temporal_stack(x_tm, tm_ops, km, num_heads=heads,
                                   first_masked_blocks=fmb)
    tm_plain = lambda: temporal_stack_plain(x_tm, tm_ops, km, num_heads=heads,
                                            first_masked_blocks=fmb)
    got, ref = tm_fn(), tm_plain()
    rows = windows * n
    block_flops = rows * 2 * c * (3 * c + c + 2 * hid) + windows * 4 * n * n * c
    record("temporal_stack", "cuda", "uplift_upsample_torch/csrc/temporal.cu",
           "uplift_upsample_tpu/ops/pallas_temporal_v3.py:343", got, ref,
           time_ms(torch, tm_fn, 5), time_ms(torch, tm_plain, 3),
           model.temporal_depth * block_flops,
           (2 * x_tm.numel() + km.numel()) * F32 + ops_bytes(tm_ops))
    del got, ref

    # K3: strided block 1 at h36m_351 (0,0) and at the h36m_81 geometry (1,1)
    def strided_case(name, ops, x, stride, pads, listed=True):
        fn = lambda: strided_block1(x, ops, num_heads=heads, stride=stride,
                                    paddings=pads)
        plain = lambda: strided_block1_plain(x, ops, num_heads=heads, stride=stride,
                                             paddings=pads)
        got, ref = fn(), plain()
        b, nn_, _ = x.shape
        n_out = output_length(nn_, stride, pads)
        flops = (b * nn_ * 2 * c * (3 * c + c + hid) + b * 4 * nn_ * nn_ * c
                 + b * n_out * 2 * 3 * hid * c)
        record(name, "cuda", "uplift_upsample_torch/csrc/strided.cu",
               "uplift_upsample_tpu/ops/pallas_strided.py:231", got, ref,
               time_ms(torch, fn, 5), time_ms(torch, plain, 3), flops,
               (x.numel() + got.numel()) * F32 + ops_bytes(ops),
               counter="strided_block1", listed=listed)

    strided_case("strided_block1", fp["strided"], x_tm, model.strides[0],
                 model.paddings[0])
    config81 = get_config("h36m_81")
    config81.MASK_STRIDE = config81.MASK_STRIDE[0]
    model81 = build_uplift_upsample_transformer(config81, device="cuda", seed=args.seed)
    strided_case("strided_block1_h36m_81", prepare_fused_params(model81)["strided"],
                 rand(2 * config81.BATCH_SIZE, config81.SEQUENCE_LENGTH, c),
                 model81.strides[0], model81.paddings[0], listed=False)
    del model81

    # The pieces K2 and K3 are made of, each beside the one PyTorch call that
    # computes the same function (timed here only; the port never calls them).
    y = rand(rows, c)
    wqkv, bqkv = tm_ops["wqkv"][0], tm_ops["bqkv"][0]
    g_fn = lambda: gemm(y, wqkv, bqkv, counter="probe")
    got = g_fn()
    ref = y @ wqkv + bqkv
    record("gemm", "cuda", "uplift_upsample_torch/csrc/gemm.cuh",
           "uplift_upsample_tpu/ops/pallas_temporal_v3.py:174", got, ref,
           time_ms(torch, g_fn, 10), time_ms(torch, lambda: y @ wqkv + bqkv, 10),
           rows * 2 * c * 3 * c, (y.numel() + wqkv.numel() + got.numel()) * F32,
           library_ms=time_ms(torch, lambda: torch.addmm(bqkv, y, wqkv), 10),
           counter="gemm_f32")
    qkv = got
    a_fn = lambda: window_attention(qkv, km, windows=windows, n=n, num_heads=heads,
                                    counter="probe")
    got = a_fn()
    a_plain = lambda: window_attention_plain(qkv.reshape(windows, n, 3 * c), km, heads)
    ref = a_plain().reshape(rows, c)
    q, k, v = (t.reshape(windows, n, heads, c // heads).transpose(1, 2)
               for t in qkv.reshape(windows, n, 3 * c).split(c, dim=-1))
    add_mask = (km * -1e9)[:, None, None, :]
    record("window_attention", "cuda", "uplift_upsample_torch/csrc/temporal.cu",
           "uplift_upsample_tpu/ops/pallas_temporal_v3.py:248", got, ref,
           time_ms(torch, a_fn, 10), time_ms(torch, a_plain, 5),
           windows * 4 * n * n * c, (qkv.numel() + km.numel() + got.numel()) * F32,
           library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=add_mask), 10),
           counter="window_attention_f32")
    g1, b1 = tm_ops["ln1_g"][0], tm_ops["ln1_b"][0]
    ln_fn = lambda: layernorm(y, g1, b1, 1e-5, counter="probe")
    ln_plain = lambda: F.layer_norm(y, (c,), g1, b1, 1e-5)
    got, ref = ln_fn(), ln_plain()
    record("layernorm", "cuda", "uplift_upsample_torch/csrc/temporal.cu",
           "uplift_upsample_tpu/ops/pallas_temporal_v3.py:128", got, ref,
           time_ms(torch, ln_fn, 10), time_ms(torch, ln_plain, 10),
           rows * c * 8, 2 * y.numel() * F32, library_ms=time_ms(torch, ln_plain, 10),
           counter="layernorm_f32")
    del y, qkv, got, ref, q, k, v
    torch.cuda.empty_cache()

    # ---- phase 3: the serving path end to end --------------------------------
    seqs = []
    for _ in range(SEQUENCES):
        walk = np.cumsum(rng.normal(size=(FRAMES, p, 2)) * 0.01, axis=0)
        seqs.append((walk + rng.normal(size=(1, p, 2)) * 0.3).astype(np.float32))
    total = sum(len(s) for s in seqs)

    step = make_predict_step(model, config, flip_tta=True)
    predict_sequence(model, config, seqs[0][:400], step=step)  # warm the allocator
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    preds = [predict_sequence(model, config, s, step=step) for s in seqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cuda_lib.LAUNCHES)

    plain_step = make_test_step(
        model, flip_tta=True, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
        fused="none")
    t1 = time.perf_counter()
    plain_preds = [predict_sequence(model, config, s, step=plain_step) for s in seqs]
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t1
    windows_run = [math.ceil(len(s) / config.SEQUENCE_STRIDE) for s in seqs]
    calls = sum(math.ceil(w / config.BATCH_SIZE) for w in windows_run)
    e2e_err = max(float(np.abs(a - b).max()) for a, b in zip(preds, plain_preds))
    e2e_tol = 2e-4 * max(1.0, max(float(np.abs(b).max()) for b in plain_preds))
    shapes_ok = all(a.shape == (len(s), p, 3) and np.isfinite(a).all()
                    for a, s in zip(preds, seqs))
    log(f"phase 3 predict: {SEQUENCES} sequences x {FRAMES} frames, flip-TTA, "
        f"{sum(windows_run)} computed windows in {calls} calls of "
        f"{2 * config.BATCH_SIZE} windows: kernel path {wall:.3f} s = "
        f"{total / wall:.1f} frames/s, plain model {plain_wall:.3f} s = "
        f"{total / plain_wall:.1f} frames/s; max_abs_err vs plain {e2e_err:.3e} "
        f"(tol {e2e_tol:.3e}); launches {counts}")
    # One step alone (card work and launches of one call, no host windowing
    # or copies), to split the wall time above.
    xb = rand(config.BATCH_SIZE, n, p, 2, scale=0.3)
    smb = torch.ones((config.BATCH_SIZE, n), dtype=torch.bool, device=dev)
    log(f"phase 3 step: one call {time_ms(torch, lambda: step(xb, smb), 5):.3f} ms "
        f"on the kernel path, {time_ms(torch, lambda: plain_step(xb, smb), 3):.3f} ms "
        f"on the plain model; predict wall per call {1e3 * wall / calls:.3f} ms")
    if not shapes_ok:
        failed.append("predict_shapes")
    if e2e_err > e2e_tol:
        failed.append("predict_vs_plain")
    for key in ("spatial_stack", "temporal_stack", "strided_block1"):
        if counts.get(key, 0) == 0:
            failed.append(f"no_launch_{key}")
    for r in results.values():
        r["launches"] = counts.get(r.pop("counter"), 0)
        r.pop("tol")

    # ---- phase 4: report -----------------------------------------------------
    if failed:
        log(f"FAILED: {failed}")
        return 1
    log(json.dumps({"kernels": list(results.values())}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
