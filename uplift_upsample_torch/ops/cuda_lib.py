"""Build the CUDA sources in `csrc/` with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and becomes its own shared
library, compiled for sm_90a into `_build/` (listed in .gitignore) at first
use. The file name carries a hash of the sources, so an edited kernel is
rebuilt. `build()` starts one nvcc per source, all at once.

Every C entry takes device pointers and the stream as `void*` and returns the
`cudaError_t` of its launch; `launch()` raises if it is not 0. Nothing here
touches CUDA or nvcc until a kernel is first launched, so the CPU tests can
import every module.

`LAUNCHES` counts kernel launches per wrapper (K1 "spatial_stack",
K2 "temporal_stack", K3 "strided_block1", K4 "spatial_bwd",
K5 "temporal_train_fwd" and "temporal_train_bwd", row 11
"packed_attention", the s2t prologue "s2t_prologue") and per C entry
("gemm_f32", ...): each launch of a CUDA kernel adds one to both, and
nothing else does. K6 ("strided_train_fwd", "strided_train_bwd") counts
calls: its wrappers name their counter on the last launch of a call only,
so each forward and each backward adds one (its other launches count per
C entry).

The one-pass bf16 rung (EVAL_MATMUL_PRECISION "default", and the training
rungs "default" and "mixed") launches its own C entries, each the bf16
instance of a kernel above under the same wrapper counter:
"spatial_stack_bf16" (K1), "gemm_bf16" and "window_attention_bf16" (K2,
K3), "strided_conv_bf16" (K3), "s2t_prologue_bf16"; in training
"spatial_bwd_bf16" (K4), "gemm_branch_bf16", "window_attention_train_bf16",
"gemm_dx_bf16", "gemm_dw_bf16", "window_attention_bwd_bf16" (K5, K6) and
"strided_dh1_bf16", "strided_dwc_bf16", "sum_rows_bf16" (K6).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("spatial", "temporal", "strided", "spatial_bwd", "temporal_bwd", "attention",
           "strided_bwd", "s2t")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES: Dict[str, int] = collections.Counter()

# C signatures: "p" = pointer or stream (c_void_p), "i" = int, "f" = float.
_SIGNATURES = {
    "spatial": {"spatial_stack_f32": "ppppiiiip", "spatial_stack_bf16": "ppppiiiip"},
    "temporal": {
        "gemm_f32": "pppppiiiip",
        "gemm_bf16": "pppppiiiip",
        "tf32_halves_f32": "ppiiiip",
        "layernorm_f32": "ppppppiiifp",
        "window_attention_f32": "pppiiiip",
        "window_attention_bf16": "pppiiiip",
    },
    "strided": {"strided_conv_f32": "pppppiiiiiiip", "strided_conv_bf16": "pppppiiiiiiip"},
    "spatial_bwd": {
        "spatial_bwd_workers": "iiii",
        "spatial_bwd_scratch_floats": "ii",
        "spatial_bwd_f32": "ppppppppiiiiip",
        "spatial_bwd_bf16": "ppppppppiiiiip",
        "sum_rows_f32": "ppiip",
    },
    "temporal_bwd": {
        "gemm_branch_f32": "ppppipppiiiip",
        "gemm_branch_bf16": "ppppipppiiiip",
        "gemm_dx_f32": "ppipppiiip",
        "gemm_dx_bf16": "ppipppiiip",
        "gemm_dw_f32": "pppipiiiip",
        "gemm_dw_bf16": "pppipiiiip",
        "colsum_f32": "ppipiip",
        "layernorm_bwd_f32": "ppppppiifip",
        "window_dot_f32": "pppiiip",
        "window_attention_bwd_f32": "ppppiiiip",
        "window_attention_bwd_bf16": "ppppiiiip",
        "window_attention_train_bf16": "pppiiiip",
        "sum_rows_f32": "ppiip",
    },
    "attention": {"packed_attention_f32": "pppppiiiip"},
    "strided_bwd": {
        "strided_dh1_f32": "ppppiiiiiiip",
        "strided_dh1_bf16": "ppppiiiiiiip",
        "strided_dwc_f32": "pppiiiiiiiip",
        "strided_dwc_bf16": "pppiiiiiiiip",
        "sum_rows_bf16": "ppiip",
        "crop_residual_add_f32": "ppiiiiiip",
    },
    "s2t": {"s2t_prologue_f32": "pppppppiiiip", "s2t_prologue_bf16": "pppppppiiiip"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda/bin)")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all nvcc at once.

    `verbose` adds `-Xptxas -v` and returns the compiler's report on stderr
    per source under the key "<name>.log". Raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists() and not verbose:
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), tmp)
    out: Dict[str, Path] = dict(paths)
    failures = []
    for name, (proc, tmp) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, paths[name])
        if verbose:
            out[f"{name}.log"] = stdout + stderr
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, sig in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = [_CTYPES[c] for c in sig]
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


def launch(lib_name: str, fn: str, counter: Optional[str], *args) -> None:
    """Call a C entry with tensors as device pointers and the current stream
    appended; count its one kernel launch for `counter` (unless None) and
    for `fn`."""
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            cargs.append(ctypes.c_void_p(a.data_ptr()))
        elif a is None:
            cargs.append(ctypes.c_void_p(0))
        else:
            cargs.append(a)
    cargs.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    err = getattr(library(lib_name), fn)(*cargs)
    if err != 0:
        raise RuntimeError(f"{lib_name}.{fn}: CUDA error {err} at launch")
    if counter is not None:
        LAUNCHES[counter] += 1
    LAUNCHES[fn] += 1


def check_cuda(name: str, t: torch.Tensor, shape=None, device=None) -> None:
    """Raise unless `t` is a contiguous float32 CUDA tensor of `shape`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
