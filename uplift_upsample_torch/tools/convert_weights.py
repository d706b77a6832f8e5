"""Checkpoint conversion CLI: Keras-legacy `.h5` ↔ npz (counterpart of
`tools/convert_weights.py`).

    python -m uplift_upsample_torch.tools.convert_weights --config h36m_351 \\
        --input models/h36m_351.h5 --output out/h36m_351.npz
    python -m uplift_upsample_torch.tools.convert_weights --config h36m_351 \\
        --input out/h36m_351.npz --output out/h36m_351.h5

Formats are inferred from the extensions (.h5 / .npz). The npz holds the flax
variables flattened to '/'-joined paths (`utils/weights_npz.py`), the JAX
tool's layout: a file either tool writes loads in both packages. Reading or
writing `.h5` needs h5py; the npz needs numpy alone, so a checkpoint converted
on a machine with h5py loads on one without (`--weights w.npz` in the CLIs).
The model is built on the CPU: this is a file tool.
"""

from __future__ import annotations

import argparse
import os

from ..configs import resolve_config
from ..models import build_uplift_upsample_transformer
from ..utils.weights_h5 import load_keras_h5, save_keras_h5
from ..utils.weights_npz import load_npz, save_npz


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="bundled name or JSON path")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    config = resolve_config(args.config)
    model = build_uplift_upsample_transformer(config, device="cpu")

    in_ext = os.path.splitext(args.input)[1]
    out_ext = os.path.splitext(args.output)[1]
    readers = {".h5": load_keras_h5, ".npz": load_npz}
    writers = {".h5": save_keras_h5, ".npz": save_npz}
    if in_ext not in readers:
        raise ValueError(f"Unsupported input format {in_ext}")
    if out_ext not in writers:
        raise ValueError(f"Unsupported output format {out_ext}")
    readers[in_ext](args.input, model)
    writers[out_ext](args.output, None, model)

    n = sum(p.numel() for p in model.parameters())
    print(f"converted {args.input} -> {args.output} ({n:,} params)")


if __name__ == "__main__":
    main()
