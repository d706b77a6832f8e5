#!/usr/bin/env python3
"""What bounds the tensor-core window attention (csrc/attention.cuh) on the card.

    python3 kernel_probe.py [--seed 0]

Builds five versions of `csrc/attention.cu` from a patched copy of
`csrc/` under `uplift_upsample_torch/_build/probe/`: the kernel as it is;
"products only" (no copies into shared memory: the products run on whatever
shared memory holds); "copies only" (no products: the block stages q, k and
v and writes the context); "no splits" (every operand passed to the three
mma.sync unsplit: the splits' cost); "one pass, no splits" (one mma.sync per
product: the cost of the other two). Each is timed with CUDA events on row
11's 71-token shapes (1,024 sequences x 8 heads of 48, with and without a
key mask) and at 23 tokens, beside SDPA, and prints one line each. The
patched versions compute nothing meaningful; only the first is checked
against the plain version. Needs a CUDA card and the repository checkout
around it.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# (file in csrc/, text, replacement)
NO_SPLITS = [("tf32.cuh", "  big = tf32_round(x);\n  small = __float_as_uint(x - __uint_as_float(big));",
              "  big = __float_as_uint(x);\n  small = big;")]
VARIANTS = {
    "kernel": [],
    "products only": [("attention.cuh", f"  stage_head({t}s", f"  if (n < 0) stage_head({t}s")
                      for t in "qkv"],
    "copies only": [("attention.cuh", "nt = nk / 8;", "nt = nk / 8 - 100;")],
    "no splits": NO_SPLITS,
    "one pass, no splits": NO_SPLITS + [
        ("tf32.cuh", "  mma_tf32(d, a_small, b_big);\n  mma_tf32(d, a_big, b_small);\n", "")],
}


def build(cuda_lib, name, reps):
    """csrc/ copied, `reps` applied, attention.cu built."""
    out = cuda_lib.BUILD_DIR / "probe" / name.replace(" ", "_").replace(",", "")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC_DIR, out)
    for fname, old, new in reps:
        path = out / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"probe patch {old!r} no longer matches {fname}")
        path.write_text(text.replace(old, new))
    lib = out / "libattention.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib),
                    str(out / "attention.cu")], check=True)
    fn = ctypes.CDLL(str(lib)).packed_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device; this run needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, time_ms
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.packed_attention import packed_attention_plain

    print(f"card: {card_line()}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    heads, c = 8, 384
    cases = []
    for s, masked in ((71, True), (71, False), (23, False)):
        q, k, v = (torch.from_numpy(rng.normal(size=(1024, s, c)).astype(np.float32)).to(dev)
                   for _ in range(3))
        km = (torch.from_numpy((rng.uniform(size=(1024, s)) < 0.5).astype(np.float32)).to(dev)
              if masked else None)
        split = lambda t: t.reshape(1024, s, heads, c // heads).transpose(1, 2)
        add_mask = None if km is None else (km * -1e9)[:, None, None, :]
        sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=add_mask), 10)
        cases.append((s, masked, q, k, v, km, sdpa))
    for name, reps in VARIANTS.items():
        fn = build(cuda_lib, name, reps)
        for s, masked, q, k, v, km, sdpa in cases:
            out = torch.empty_like(q)
            call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              None if km is None else km.data_ptr(), out.data_ptr(),
                              1024, s, c, heads, torch.cuda.current_stream().cuda_stream)
            if call() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            err = ""
            if name == "kernel":
                ref = packed_attention_plain(q, k, v, km, num_heads=heads)
                err = f" max_abs_err {float((out - ref).abs().max()):.3e};"
            print(f"probe {name}: 1024 x {s} x {c}, key mask {masked}:{err} "
                  f"ms {time_ms(torch, call, 20):.4f} (SDPA {sdpa:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
