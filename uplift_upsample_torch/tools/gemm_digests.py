"""Digests and times of every caller of the tensor-core GEMMs (`csrc/gemm_tc.cuh`).

    python -m uplift_upsample_torch.tools.gemm_digests [--parent DIR] [--seed 0]
                                                      [--rounds 3]

`gemm_tc_kernel` serves eleven C entries, each in 3xTF32 and in the bf16
mode: K2's four dense products at serving (`gemm_f32`: qkv, proj + residual,
fc1 + relu, fc2 + a residual that aliases the output; 1,024 windows x 71),
K5's scaled branch (`gemm_branch_f32`) and dX with its row scale and relu
mask (`gemm_dx_f32`; the bf16 mode scales A's rows before their rounding)
at the train step's 512 windows x 71, the strided conv with its taps read
from h1 by TMA at h36m_351's stride 3, paddings (0, 0), 1,024 windows, and
at h36m_81's stride 4, paddings (1, 1), 512 windows (`strided_conv_f32`),
its dH1 at strides 3 and 2 (one launch each, h1's rows phase by phase), and
the s2t prologue (`s2t_prologue_f32`,
72,704 x 544 -> 384 with the stride mask). Each case's inputs come from
numpy with a fixed seed; the weights' TF32 halves and bf16 planes are made
on the host (`tf32_halves_plain`, `round_bf16`), so they do not depend on
the build under test; every bf16 case hands its plane over as
torch.bfloat16 (`fp32_args`: in fp32 to a build from before native bf16
reached its entry, `fp32_plane_libs`).

`gemm_atb_kernel` (the backward's weight gradients, split over the rows and
summed in a fixed order) serves two more C entries, each in both modes: K5's
dW (`gemm_dw_f32`) of qkv, proj, fc1 and fc2 at the train step's 36,352
rows, proj's and fc2's dY with the per-window row scale as the step passes
them, and K6's dWc (`strided_dwc_f32`, the taps gathered from h1) at
h36m_351's stride 3, paddings (0, 0), 512 windows, and at h36m_81's stride
4, paddings (1, 1), 256 windows. Their splits are `dw_splits`' and their
digest is that of the summed gradient (`sum_rows_f32` after the launch).

A case's digest is the sha256 of its outputs' bytes. `GEMM_DIGESTS` holds
the digests of gemm_tc_kernel's callers from the build before its pipeline
(NVIDIA H100 80GB HBM3, nvcc 12.9, sm_90a): a redesign that keeps every
output's sum in the same order gives the same bits. `DW_DIGESTS` holds
those of gemm_atb_kernel's callers (see there). `PARENT_MS` holds each
case's time in the build before that kernel's redesign, on the same card at
700 W (CUDA events, 10 launches after 2).

Prints one line per case (digest, equal to `GEMM_DIGESTS` or not, a second
call bit-identical or not, ms) and, with `--parent DIR` (a copy of an
earlier `csrc/`), the parent build's digest and time beside them, taken in
turn (parent, kernel, kernel, parent) for `--rounds` rounds. Exit 1 if a
digest differs or a repeat is not bit-identical. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

# sha256 of each case's outputs from the build before the pipelined kernel
# (NVIDIA H100 80GB HBM3, nvcc 12.9, sm_90a), except those re-taken when a
# redesign changed their sums by design: "dh1 s2" (each h1 row's taps now
# sum in one accumulator in tap order, where a launch per tap added each
# tap's finished product into dH1), and every bf16 case (native bf16: two
# k16 products per 32-deep stage on the bf16 plane, where one TF32 pass
# took four k8 products; the same exact products summed in another order),
# the conv's and dH1's with the strided conv's redesign, the seven dense
# ones ("gemm *_bf16", "branch fc2_bf16", "dx fc2_bf16", "s2t_bf16") with
# the dense callers' move to native bf16. The conv's and "dh1 s3"'s 3xTF32
# bits are the earlier ones: reading T by TMA changes no operand.
GEMM_DIGESTS: Dict[str, str] = {
    "gemm qkv":
        "911fbd98f40bd03ab3392aebbcb3d36d24d40aa75eaa859707ff1698ee4c7d33",
    "gemm proj":
        "e879be4ebce71a8e9217bea6f3cb0407177e3e80baf8d1a7064a4ebc723027fb",
    "gemm fc1":
        "bbd4e15d7a374e3597207be49dc1445b9a184815e8e6159100ecb0d83441326e",
    "gemm fc2":
        "48f4a34b9371ed598dcc21e6e8f8acb2b52c874b5ea68c3bba6b17ef9d9dbb8a",
    "branch fc2":
        "cdd9e68b19680b5c2955c9b8fc21f28c200be331a63f03adf0e657343a977677",
    "dx fc2":
        "2a2b19900cb7cac66d2d152187eb392862515ba5167387e2866e2de14260eeb9",
    "conv 351":
        "80afc29c424e546975ad6eab6cfe1574d61aee2ce8b3de0862fcb53799d8f058",
    "conv 81":
        "2bd30c9de2b42b53920effb33c2f16312261a066d541ffd24525054985375b5c",
    "dh1 s3":
        "874c23288bfb1898c1a38e8b697819159e8c81f4d578432fb1800f4e559daaf3",
    "dh1 s2":
        "ba9e48ed04bd44cb6f6829dc4f218de8a6c404fe9a6c68d9c6e9f944e162146b",
    "s2t":
        "96e50ab69b1312f7d6c4bcd0197aaa323a2a4f76b86b4ee931cd2636a4c260a4",
    "gemm qkv_bf16":
        "d5a1fa0b6e9f8836a974a170fcc9f2366f8421bb313299784f3152c726c513ef",
    "gemm proj_bf16":
        "e62da11fd7fef979717b70afe6addb7ed37963ae28c904f2085fefb3724d6fff",
    "gemm fc1_bf16":
        "dbca9f503e563953d609de82573a138cbee73d6ca44cbce08e09d04b6642ca3f",
    "gemm fc2_bf16":
        "c45ae7f612adc5d90bc2eee055b57ea6d372f7b46e1af68dc7b36cb9b39a35e5",
    "branch fc2_bf16":
        "3dbc27115310e8533ab6e385bfee4d8a4eaba35c1fc9c4a1f8f1168b1cd9ea38",
    "dx fc2_bf16":
        "76558dc824370ed458f623c08b616837e53c163ee5dcfbbb90c09a616d7980a6",
    "conv 351_bf16":
        "0483c8adb80320d3e02d60bb910c0ea9280348bd3db1fc3a55121e8a96c29fed",
    "conv 81_bf16":
        "a5c0860f8fa4dfff2bb2414113e5f9bec920abc47b263b1f7fc423a39e1e88c9",
    "dh1 s3_bf16":
        "0ba990a85c9b9af26297bd83bbf26ecbfd96267d5be0bbe356b7f5e501056417",
    "dh1 s2_bf16":
        "cc85000391e0601c359b713f9f8dfecfd4a45281ab1f6ff5dd712e3eb8311626",
    "s2t_bf16":
        "1ff4b597d9b599cc3dcd696f66a1481797e6b834b45c658298eeee1acf5eb60a",
}

# that build's ms per case (CUDA events), NVIDIA H100 80GB HBM3, 700.00 W;
# the conv's and dH1's: the build before their redesign (the gathered taps, a
# launch per tap at s0 < 3, the TF32 pass at bf16), timed in turn with it;
# the seven dense bf16 cases: the build before their native bf16 (the TF32
# pass on an fp32 plane), timed in turn with it
PARENT_MS: Dict[str, float] = {
    "gemm qkv": 0.8605,
    "gemm proj": 0.3928,
    "gemm fc1": 0.5513,
    "gemm fc2": 0.5467,
    "branch fc2": 0.4033,
    "dx fc2": 0.5392,
    "conv 351": 0.7296,
    "conv 81": 0.1531,
    "dh1 s3": 0.4699,
    "dh1 s2": 0.7716,
    "s2t": 0.4653,
    "gemm qkv_bf16": 0.3623,
    "gemm proj_bf16": 0.2011,
    "gemm fc1_bf16": 0.2416,
    "gemm fc2_bf16": 0.2347,
    "branch fc2_bf16": 0.1781,
    "dx fc2_bf16": 0.1838,
    "conv 351_bf16": 0.6222,
    "conv 81_bf16": 0.1392,
    "dh1 s3_bf16": 0.4037,
    "dh1 s2_bf16": 0.6755,
    "s2t_bf16": 0.2453,
    # gemm_atb_kernel's callers: the mma.sync build
    "dw qkv": 0.6772,
    "dw proj": 0.2275,
    "dw fc1": 0.4447,
    "dw fc2": 0.4484,
    "dwc 351": 0.5665,
    "dwc 81": 0.1482,
    "dw qkv_bf16": 0.3962,
    "dw proj_bf16": 0.1407,
    "dw fc1_bf16": 0.2601,
    "dw fc2_bf16": 0.2637,
    "dwc 351_bf16": 0.3672,
    "dwc 81_bf16": 0.0989,
}

# sha256 of each gemm_atb_kernel caller's summed gradient from the wgmma build
# (NVIDIA H100 80GB HBM3, nvcc 12.9, sm_90a). Both modes' sums differ from the
# mma.sync build's by design: a partial per 32-deep stage, not per 8-deep
# step (3xTF32), and bf16 k16 products (bf16); `PARENT_MS` and PERF.md keep
# that build's times and digests.
DW_DIGESTS: Dict[str, str] = {
    "dw qkv":
        "aa436d8d14a3dfa39e116af772c7ac19f29ba4d427df0b2eeb920e18b3f6bf41",
    "dw proj":
        "4b59e726d189381b11a6298bf4b2d6b7eb71edd894985fb9514a3af766472e3f",
    "dw fc1":
        "90f328a0779c9358a01a4d2561d6cc87a79e526d5f0f7eeb171ba91ef83f8173",
    "dw fc2":
        "135303314cf04cb11691a4e7d4ff619aa6beba23a283e55862525a0ea0f72ee8",
    "dwc 351":
        "3c0f2796c9ea38271477ee7044db024450989121492299d305f8c37203f1cbbe",
    "dwc 81":
        "8f99ba97cd5a54c3cbf4df968a07d37c2510103de1be4b4f7966360222444401",
    "dw qkv_bf16":
        "7cbc8420891af7f4e7901cb0ba8068d6f2a8f5ecb5437fef2f728173a34f1ae4",
    "dw proj_bf16":
        "bc3805e23a847ad348c195d38e5da576642fe8a19fc32d61b4557d89d438ee4f",
    "dw fc1_bf16":
        "ee048b4b9d6a9d6a0869687f618e446ff92097dfc9e1179e07e4f87e8b6c645d",
    "dw fc2_bf16":
        "b3fb0e1a308b714b79a95391a9d2dc18f08aad225117efe6b306af2309a1153d",
    "dwc 351_bf16":
        "25724b075e4e61882188dc1966bb253bd4195da22fbd4f0b2b2d836ff4eaadf4",
    "dwc 81_bf16":
        "f27b8e0d677ee05032651b4c88d96711e5132d79f0536065c4a67544edbe3e44",
}

DIGESTS: Dict[str, str] = {**GEMM_DIGESTS, **DW_DIGESTS}

LIBS = ("temporal", "temporal_bwd", "strided", "strided_bwd", "s2t")
SERVING, TRAIN = 1024 * 71, 512 * 71  # rows: serving's 1,024 windows, training's 512
CONV_WINDOWS = (1024, 512)            # the conv at h36m_351's and h36m_81's geometry
DH1_WINDOWS = 512
DWC_WINDOWS = (512, 256)              # dWc at h36m_351's and h36m_81's train batch
C, HID = 384, 768


class Case(NamedTuple):
    name: str
    lib: str
    fn: str
    args: list          # tensors, ints and None, in the C entry's order (the stream appended)
    outputs: list       # tensors hashed after the launch
    reset: Callable     # restores inputs a launch overwrites (the aliased residual)
    then: tuple = ()    # (lib, fn, args) launched after it: dW's fixed-order sum
    fp32_args: Optional[list] = None  # args for a build whose entry reads an fp32 bf16 plane


def _halves(w: np.ndarray, bf16: bool, transpose: bool = True) -> torch.Tensor:
    """What the kernels read of W (K, N): its TF32 halves (2, N, K), or at
    bf16 its bf16-rounded plane (N, K) in fp32 (`_native` hands it over in
    bf16); `transpose` False keeps W as stored."""
    from ..ops.temporal import tf32_halves_plain
    from ..precision import round_bf16
    t = torch.from_numpy(w)
    if bf16:
        plane = round_bf16(t)
        return (plane.t() if transpose else plane).contiguous()
    return tf32_halves_plain(t, transpose=transpose)


def _native(args: list, i: int, bf16: bool) -> list:
    """args with the bf16 plane args[i] as the torch.bfloat16 tensor the
    native bf16 instances read (the fp32 plane holds bf16 values: exact)."""
    return args if not bf16 else args[:i] + [args[i].to(torch.bfloat16)] + args[i + 1:]


def fp32_plane_libs(csrc: Path) -> tuple:
    """The libraries whose bf16 instances the build of `csrc` runs as a TF32
    pass on an fp32 plane: every one before native bf16, the dense callers'
    (temporal, temporal_bwd, s2t) while only the strided conv's had it."""
    text = (Path(csrc) / "gemm_tc.cuh").read_text()
    if "TC_BF16" not in text:
        return LIBS
    return ("temporal", "temporal_bwd", "s2t") if "TC_BF16_TF32" in text else ()


def cases(seed: int, bf16: bool, dev) -> List[Case]:
    """Every caller's case (names end in "_bf16" in the bf16 mode)."""
    rng = np.random.default_rng(seed + (1000 if bf16 else 0))

    def rand(*shape, scale=0.5):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def w_of(k, n, transpose=True):
        return _halves(rand(k, n, scale=0.05), bf16, transpose).to(dev)

    sfx = "_bf16" if bf16 else "_f32"
    out: List[Case] = []
    none = lambda: None
    m = SERVING
    for name, k, n, relu, residual in (("qkv", C, 3 * C, 0, None), ("proj", C, C, 0, "res"),
                                       ("fc1", C, HID, 1, None), ("fc2", HID, C, 0, "alias")):
        a, w, bias = cuda(rand(m, k)), w_of(k, n), cuda(rand(n, scale=0.1))
        o = torch.empty((m, n), device=dev)
        res, reset = None, none
        if residual == "res":
            res = cuda(rand(m, n))
        elif residual == "alias":  # the fc2 sublayer: gemm(..., residual=h, out=h)
            h0 = cuda(rand(m, n))
            res, reset = o, (lambda o=o, h0=h0: o.copy_(h0))
        args = [a, w, bias, res, o, m, n, k, relu]
        out.append(Case(f"gemm {name}" + "_bf16" * bf16, "temporal", "gemm" + sfx,
                        _native(args, 1, bf16), [o], reset, fp32_args=args if bf16 else None))

    m, per = TRAIN, 71
    scale = cuda(np.where(rng.uniform(size=m // per) < 0.9, 1 / 0.9, 0.0).astype(np.float32))
    a, w, bias, res = cuda(rand(m, HID)), w_of(HID, C), cuda(rand(C, scale=0.1)), cuda(rand(m, C))
    branch, o = torch.empty((m, C), device=dev), torch.empty((m, C), device=dev)
    args = [a, w, bias, scale, per, res, branch, o, m, C, HID, 0]
    out.append(Case("branch fc2" + "_bf16" * bf16, "temporal_bwd", "gemm_branch" + sfx,
                    _native(args, 1, bf16), [branch, o], none,
                    fp32_args=args if bf16 else None))
    # dX of fc2: (s · g) · w2ᵀ with w2 (HID, C) as stored, relu mask of h1
    g, w2 = cuda(rand(m, C, scale=1.0)), w_of(HID, C, transpose=False)
    mask, o = cuda(np.maximum(rand(m, HID), 0)), torch.empty((m, HID), device=dev)
    args = [g, scale, per, w2, mask, o, m, HID, C]
    out.append(Case("dx fc2" + "_bf16" * bf16, "temporal_bwd", "gemm_dx" + sfx,
                    _native(args, 3, bf16), [o], none, fp32_args=args if bf16 else None))

    for label, b, n, stride, p0 in (("351", CONV_WINDOWS[0], 71, 3, 0),
                                    ("81", CONV_WINDOWS[1], 41, 4, 1)):
        n_out = (n + 2 * p0 - 3) // stride + 1
        h1, x = cuda(np.maximum(rand(b * n, HID), 0)), cuda(rand(b * n, C))
        wc, bc = w_of(3 * HID, C), cuda(rand(C, scale=0.1))
        o = torch.empty((b * n_out, C), device=dev)
        args = [h1, x, wc, bc, o, b, n, HID, C, stride, p0, n_out]
        out.append(Case(f"conv {label}" + "_bf16" * bf16, "strided", "strided_conv" + sfx,
                        _native(args, 2, bf16), [o], none, fp32_args=args if bf16 else None))
    b, n = DH1_WINDOWS, 71
    for stride in (3, 2):
        n_out = (n - 3) // stride + 1
        g, h1 = cuda(rand(b * n_out, C, scale=1.0)), cuda(np.maximum(rand(b * n, HID), 0))
        wc = w_of(3 * HID, C, transpose=False)
        o = torch.empty((b * n, HID), device=dev)
        args = [g, wc, h1, o, b, n, HID, C, stride, 0, n_out]
        out.append(Case(f"dh1 s{stride}" + "_bf16" * bf16, "strided_bwd", "strided_dh1" + sfx,
                        _native(args, 1, bf16), [o], none, fp32_args=args if bf16 else None))

    m, k, pe_rows = SERVING, 17 * 32, 71
    sp, w, bias = cuda(rand(m, k)), w_of(k, C), cuda(rand(C, scale=0.1))
    smask = cuda((rng.uniform(size=m) < 0.3).astype(np.float32))
    token, pe = cuda(rand(C)), cuda(rand(pe_rows, C))
    o = torch.empty((m, C), device=dev)
    args = [sp, w, bias, smask, token, pe, o, m, C, k, pe_rows]
    out.append(Case("s2t" + "_bf16" * bf16, "s2t", "s2t_prologue" + sfx,
                    _native(args, 1, bf16), [o], none, fp32_args=args if bf16 else None))
    return out


def dw_cases(seed: int, bf16: bool, dev) -> List[Case]:
    """gemm_atb_kernel's callers (names end in "_bf16" in the bf16 mode):
    the launch into (splits, m, n) partials, then `sum_rows_f32` into dW."""
    from ..ops.temporal_train import dw_splits
    rng = np.random.default_rng(seed + (3000 if bf16 else 2000))

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)

    def summed(part, m, n):
        out = torch.empty((m, n), device=dev)
        return out, (("temporal_bwd", "sum_rows_f32", [part, out, part.shape[0], m * n]),)

    sfx = "_bf16" if bf16 else "_f32"
    out: List[Case] = []
    rows, per = TRAIN, 71
    scale = cuda(np.where(rng.uniform(size=rows // per) < 0.9, 1 / 0.9, 0.0))
    for name, m, n, scaled in (("qkv", C, 3 * C, False), ("proj", C, C, True),
                               ("fc1", C, HID, False), ("fc2", HID, C, True)):
        x = cuda(rng.standard_normal((rows, m), dtype=np.float32) * np.float32(0.5))
        dy = cuda(rng.standard_normal((rows, n), dtype=np.float32))
        splits = dw_splits(rows, m, n)
        part = torch.empty((splits, m, n), device=dev)
        dw, then = summed(part, m, n)
        out.append(Case(f"dw {name}" + "_bf16" * bf16, "temporal_bwd", "gemm_dw" + sfx,
                        [x, dy, scale if scaled else None, per, part, m, n, rows, splits],
                        [dw], lambda: None, then))
    for label, b, n, stride, p0 in (("351", DWC_WINDOWS[0], 71, 3, 0),
                                    ("81", DWC_WINDOWS[1], 41, 4, 1)):
        n_out = (n + 2 * p0 - 3) // stride + 1
        h1 = cuda(np.maximum(rng.standard_normal((b * n, HID), dtype=np.float32), 0) * 0.5)
        g = cuda(rng.standard_normal((b * n_out, C), dtype=np.float32))
        splits = dw_splits(b * n_out, 3 * HID, C)
        part = torch.empty((splits, 3 * HID, C), device=dev)
        dwc, then = summed(part, 3 * HID, C)
        out.append(Case(f"dwc {label}" + "_bf16" * bf16, "strided_bwd", "strided_dwc" + sfx,
                        [h1, g, part, b, n, HID, C, stride, p0, n_out, splits], [dwc],
                        lambda: None, then))
    return out


def all_cases(seed: int, dev) -> List[Case]:
    return [case for bf16 in (False, True)
            for case in cases(seed, bf16, dev) + dw_cases(seed, bf16, dev)]


def port_libs() -> Dict[str, ctypes.CDLL]:
    """The checkout's own builds (`ops/cuda_lib.py`)."""
    from ..ops import cuda_lib
    return {name: cuda_lib.library(name) for name in LIBS}


def build_libs(csrc: Path, out_dir: Path) -> Dict[str, ctypes.CDLL]:
    """LIBS built from another `csrc/` into out_dir (all nvcc at once), bound
    with the port's C signatures."""
    from ..ops import cuda_lib
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(csrc, out_dir)
    procs = {name: subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                                     str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
                                    stderr=subprocess.PIPE, text=True) for name in LIBS}
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent build of {name}.cu failed:\n{err}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, sig in cuda_lib._SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = [cuda_lib._CTYPES[ch] for ch in sig]
            f.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(libs: Dict[str, ctypes.CDLL], case: Case,
             fp32_libs: tuple = ()) -> Callable[[], None]:
    """One launch of the case's C entry from `libs` (`fp32_libs`: the
    libraries of a build that read the bf16 plane in fp32), then its `then`
    launches; raises on a launch error."""
    args = case.fp32_args if case.fp32_args is not None and case.lib in fp32_libs else case.args
    steps = [(libs[case.lib], case.fn, args)]
    steps += [(libs[lib], fn, args) for lib, fn, args in case.then]
    bound = [(getattr(lib, fn), fn, [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
                                     else ctypes.c_void_p(0) if a is None else a for a in args])
             for lib, fn, args in steps]

    def call():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for fn, name, cargs in bound:
            err = fn(*cargs, stream)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return call


def digest(libs: Dict[str, ctypes.CDLL], case: Case, fp32_libs: tuple = ()) -> str:
    """The case's outputs' sha256 after one launch from its reset inputs."""
    case.reset()
    launcher(libs, case, fp32_libs)()
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in case.outputs:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def time_ms(call: Callable[[], None], iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(libs, parent_libs=None, seed: int = 0, rounds: int = 3, log=print,
          parent_fp32_libs: tuple = (), select=None) -> List[str]:
    """Every case: its digest against GEMM_DIGESTS, a second call bit for
    bit, its time beside PARENT_MS (and beside the parent build's digest and
    time, taken in turn, with `parent_libs`; `parent_fp32_libs`: the
    libraries where that build reads the bf16 plane in fp32,
    `fp32_plane_libs`; `select`: only the cases it holds true); returns the
    failed cases."""
    failed = []
    for case in all_cases(seed, torch.device("cuda")):
        if select is not None and not select(case):
            continue
        first = digest(libs, case)
        again = digest(libs, case)
        want = DIGESTS.get(case.name)
        line = (f"gemm_digests {case.name} ({case.fn}): {first} "
                f"{'no recorded digest' if want is None else 'equals the recorded digest' if first == want else 'DIFFERS FROM THE RECORDED DIGEST'}"
                f", repeat {'bit-identical' if again == first else 'DIFFERS'}")
        if (want is not None and first != want) or again != first:
            failed.append(case.name)
        call = launcher(libs, case)
        if parent_libs is None:
            ms = min(time_ms(call) for _ in range(rounds))
            line += f"; ms {ms:.4f}"
        else:
            parent_first = digest(parent_libs, case, parent_fp32_libs)
            pcall = launcher(parent_libs, case, parent_fp32_libs)
            mine, theirs = [], []
            for _ in range(rounds):
                theirs.append(time_ms(pcall))
                mine.append(time_ms(call))
                mine.append(time_ms(call))
                theirs.append(time_ms(pcall))
            ms = min(mine)
            line += (f"; parent build {parent_first} "
                     f"({'same bits' if parent_first == first else 'OTHER BITS'}); ms "
                     f"{ms:.4f} against the parent's {min(theirs):.4f} in turn "
                     f"({ms / min(theirs):.3f}x)")
            if parent_first != first and want is None:
                failed.append(case.name + " vs parent")
        if case.name in PARENT_MS:
            line += f"; recorded parent {PARENT_MS[case.name]:.4f} ({ms / PARENT_MS[case.name]:.3f}x)"
        log(line)
        del case, call
    torch.cuda.empty_cache()
    return failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--parent", default=None, help="a copy of an earlier csrc/")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_digests: no CUDA device; this run needs a card", file=sys.stderr)
        return 2
    from ..ops import cuda_lib
    parent = None
    if args.parent:
        parent = build_libs(Path(args.parent).resolve(), cuda_lib.BUILD_DIR / "parent_gemm")
    failed = check(port_libs(), parent, args.seed, args.rounds,
                   log=lambda s: print(s, flush=True),
                   parent_fp32_libs=fp32_plane_libs(args.parent) if args.parent else ())
    if failed:
        print(f"gemm_digests: FAILED {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
