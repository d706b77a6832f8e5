"""Scalar logging: JSONL always; TensorBoard event files when available
(counterpart of the JAX package's utils/scalar_log.py).

The reference logs train/val scalars to TensorBoard (`train.py:585-590,
679-687`). Every scalar goes to `<out_dir>/scalars.jsonl` (one JSON per line:
{tag, value, step}), and is mirrored to TensorBoard through
`torch.utils.tensorboard` when that imports (it needs the `tensorboard`
package); otherwise a line says so, as the JAX package does without
TensorFlow.
"""

from __future__ import annotations

import json
import os


class ScalarLogger:
    def __init__(self, out_dir: str, use_tensorboard: bool = False, run_name: str = "tb"):
        os.makedirs(out_dir, exist_ok=True)
        self._file = open(os.path.join(out_dir, "scalars.jsonl"), "a", buffering=1)
        self._tb_writer = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb_writer = SummaryWriter(os.path.join(out_dir, run_name))
            except ImportError:
                print("TensorBoard logging requested but tensorboard not available")

    def scalar(self, tag: str, value, step: int):
        self._file.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        if self._tb_writer is not None:
            self._tb_writer.add_scalar(tag, float(value), global_step=int(step))

    def close(self):
        self._file.close()
        if self._tb_writer is not None:
            self._tb_writer.close()
