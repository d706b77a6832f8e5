"""uplift_upsample_torch — PyTorch + CUDA port of uplift_upsample_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package mirrors its module
names so that each counterpart is easy to find. Plain tensor code is PyTorch;
the Pallas kernels of the serving, training and eval paths are CUDA C++ kernels
written for sm_90a (`csrc/`), built with nvcc at first use and bound with
ctypes (`ops/cuda_lib.py`). On a CPU tensor every kernel wrapper runs its
plain PyTorch version instead, which the CPU tests use.

Layout:
  config, configs — layered config system and the bundled configurations (copied)
  precision       — the matmul rungs: "high"/"highest" (fp32-level) and "default",
                    the TPU's one-pass bf16 dot, with the context the plain modules read
  models/         — UpliftUpsampleTransformer (nn.Module), its primitives, the fused eval forward
  ops/            — attention; the spatial (K1), temporal (K2) and strided-block-1 (K3)
                    kernels; the spatial backward (K4), the temporal stack (K5) and
                    strided block 1 (K6) in training; the packed attention behind
                    USE_PALLAS_ATTENTION (row 11); the s2t prologue of the tiled eval
                    route; camera projection (AMASS)
  parallel/       — the training and validation steps: losses, Keras Adam/AdamW, EMA;
                    data parallelism over torch.distributed, tensor parallelism
                    over a dp × mp layout
  data/           — window generators and batchers (H3.6M, AMASS), loaders, cameras
                    (numpy, copied); the device-resident train feed; the host pipeline
  utils/          — Keras .h5 reading and writing, float64 metrics and the eval
                    protocol, row dedup, LR schedules, metric history, scalar logs
  eval, predict,  — the eval harness and CLI (test step with flip-TTA, shared
  train, bench      spatial stage, run_eval), the serving CLI, the training CLI and
                    the benchmark CLI
"""

import torch

# Parity rung: true fp32. Matmuls default to full fp32 already, but cuDNN
# convolutions (strided blocks 2-3 run nn.Conv1d) default to TF32, which keeps
# only ~3 decimal digits. Turn both off where the package initialises.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
