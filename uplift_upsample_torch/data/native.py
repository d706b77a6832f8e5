"""ctypes binding of the host's window gather (`csrc/gather_windows.cc`), the
counterpart of the JAX package's `data/native.py`.

Both batchers of `data/fast_batcher.py` materialise every batch through
`gather_windows`: the gather of (B, N) frame rows from the concatenated pose
store, the zero-fill of padded rows and the left/right flip, multithreaded in
C++. The source is built with g++ at first use into `_build/` (listed in
.gitignore), under a name that carries a hash of the source and the flags, so
an edited source is rebuilt; a build writes a temporary file and renames it,
so processes that build at once do not clash. A failed build raises with the
compiler's output: there is no numpy fallback. `gather_windows_plain` is the
numpy version of the same function, the tests' reference.

The flags leave out `native/build.sh`'s `-march=native`: the library is
built on whichever host runs it, and one build serves every CPU model.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "gather_windows.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the gather into `build_dir` unless it is built; returns the
    library's path. Raises RuntimeError with g++'s output if the build fails."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    path = build_dir / f"libgather_windows-{digest.hexdigest()[:12]}.so"
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the window gather (csrc/gather_windows.cc) is "
                           "built with it at first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.gather_windows_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int]
            lib.gather_windows_f32.restype = None
            _LIB = lib
        return _LIB


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype)) if arr is not None else None


def default_threads(nbytes: int) -> int:
    """The gather's thread count for `nbytes` written: 1.65 sqrt(MiB),
    rounded, at least 1 and at most torch's intra-op thread count.

    The threads start anew each call, so the start-up cost grows with the
    count while the copy's share shrinks: the best count grows as the
    square root of the bytes. The factor fits the gather's times on 1-8
    threads on the card's 8-core host (chip_smoke phase 9 (a), PERF.md §5):
    the best counts were 4 at 4.7 and 7.1 MiB (the train batch), 6-8 at
    23.3 MiB (the eval's 2D windows) and 1 at 0.1 MiB (its central 3D rows).
    """
    wanted = round(1.65 * math.sqrt(nbytes / 2 ** 20))
    return max(1, min(torch.get_num_threads(), wanted))


def gather_windows(src: np.ndarray, indices: np.ndarray,
                   zero_mask: Optional[np.ndarray] = None,
                   do_flip: Optional[np.ndarray] = None,
                   flip_perm: Optional[np.ndarray] = None,
                   n_threads: int = 0) -> np.ndarray:
    """Gather (B, N, K, C) windows from the concatenated (T, K, C) pose store.

    zero_mask (B, N): True rows are zero-filled (zeros-padding mode).
    do_flip (B) + flip_perm (K): flipped examples get the joint permutation
    and x (channel 0) negation. `n_threads` 0: `default_threads` of the
    bytes written, within torch's intra-op thread count (a data-parallel
    rank or a test sets it to its share of the cores).
    """
    src = np.ascontiguousarray(src, dtype=np.float32)
    t, k, c = src.shape
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    b, n = indices.shape
    if indices.size and (indices.min() < 0 or indices.max() >= t):
        raise IndexError(f"window indices span [{indices.min()}, {indices.max()}], "
                         f"outside the store's {t} frames")
    zm = None if zero_mask is None else np.ascontiguousarray(zero_mask, np.uint8)
    df = None if do_flip is None else np.ascontiguousarray(do_flip, np.uint8)
    fp = None if flip_perm is None else np.ascontiguousarray(flip_perm, np.int32)
    if zm is not None and zm.shape != (b, n):
        raise ValueError(f"zero_mask {zm.shape} does not match indices {(b, n)}")
    if df is not None and df.shape != (b,):
        raise ValueError(f"do_flip {df.shape} does not match the batch {b}")
    if fp is not None and (fp.shape != (k,) or fp.min() < 0 or fp.max() >= k):
        raise ValueError(f"flip_perm must be a permutation of the {k} joints")
    dst = np.empty((b, n, k, c), dtype=np.float32)
    if not n_threads:
        n_threads = default_threads(dst.nbytes)
    _library().gather_windows_f32(
        _ptr(src, ctypes.c_float), _ptr(indices, ctypes.c_int64),
        _ptr(zm, ctypes.c_uint8), _ptr(df, ctypes.c_uint8),
        _ptr(fp, ctypes.c_int32), _ptr(dst, ctypes.c_float),
        b, n, k, c, n_threads)
    return dst


def gather_windows_plain(src: np.ndarray, indices: np.ndarray,
                         zero_mask: Optional[np.ndarray] = None,
                         do_flip: Optional[np.ndarray] = None,
                         flip_perm: Optional[np.ndarray] = None) -> np.ndarray:
    """`gather_windows` in numpy (the JAX binding's fallback): equal in value.
    It writes -0.0 where the C++ writes +0.0, in channel 0 of the zero-filled
    rows of flipped windows (it zero-fills, then negates)."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    dst = src[np.asarray(indices, dtype=np.int64)]
    if zero_mask is not None:
        dst[zero_mask.astype(bool)] = 0.0
    if do_flip is not None and flip_perm is not None:
        sel = do_flip.astype(bool)
        flipped = dst[sel][:, :, flip_perm]
        flipped[..., 0] *= -1
        dst[sel] = flipped
    return dst
