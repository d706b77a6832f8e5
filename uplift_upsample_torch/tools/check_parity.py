"""The drift matrix of the port's eval rungs (counterpart of the JAX package's
`tools/check_tpu_parity.py`).

The parity bar is MPJPE within 0.1 mm of the reference, and the matmul
rung is the lever that can silently break it: EVAL_MATMUL_PRECISION
"default" runs every product as one bf16 pass. This tool measures the
central-output drift of each eval configuration on the card against a
float64 truth: the port's plain model in float64 on the CPU, computed in a
subprocess, on random weights (from --seed), which drift more than trained
ones, so a configuration that passes here is safe.

Variants (the port's names for the JAX tool's):
  rung_<r>[_kf]     `make_test_step(fused="full", precision=r)`, the kernel
                    path; "_kf" adds the keyframe-sparse spatial gather
                    (max_keyframes 15, the fixture's %5 mask)
  shared_<r>        the shared-spatial eval step (host dedup, K1 per unique frame)
  xla_<r>           the plain model on the card under `matmul_precision(r)`
  fused_<r>         K1 at r ("high": the JAX tool's fused_high3), then the
                    plain model from the s2t Dense at "default", as the JAX
                    tool's XLA tail runs with no precision context on the
                    TPU; built directly with `spatial_stack_apply`
  h81_<variant>     the h36m_81 geometry (padded strided block 1) against its
                    own truth
with r "high" or "default" ("highest" too for xla_).

Reported per variant: mean and max per-joint distance to the truth in
milli-units ("mm" once outputs are metres). With --assert-bounds the JAX
tool's on-chip bounds (ASSERT_BOUNDS) are held, and rung_default's drift must
lie within SIM_RATIO of the CPU simulator's (`tools/sim_drift.py`, every
site bf16 but the spatial attention, q's scale folded into K2's and K3's
weights as the eval kernels fold it: `FUSED_FOLDED`) on the same weights
and inputs: the rung computes the TPU's one-pass bf16 function, not merely
something near fp32. The ratio to the unfolded map (the JAX simulator's
own, `FUSED_DEFAULT`) is printed beside it. Exit 1 if any bound fails.

Usage: python -m uplift_upsample_torch.tools.check_parity [--batch 64]
           [--variants a,b,...] [--assert-bounds] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BATCH = 64
VARIANTS = ("rung_high", "rung_default", "rung_high_kf", "rung_default_kf",
            "shared_high", "shared_default", "xla_default", "xla_high", "xla_highest",
            "fused_default", "fused_high", "h81_shared_high", "h81_shared_default")

# The JAX tool's bounds (random weights, output scale ~4.6), in milli-units;
# its "fused_high3" (the spatial kernel at HIGH3, then a bf16 tail) is the
# port's "fused_high".
ASSERT_BOUNDS = {
    "rung_high": 0.5,
    "rung_high_kf": 0.5,
    "rung_default": 120.0,
    "fused_high": 50.0,
    "shared_high": 0.5,
    "h81_shared_high": 0.5,
}
SIM_RATIO = (0.75, 1.33)  # rung_default's mean drift over the simulator's

_TRUTH_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from uplift_upsample_torch.tools import sim_drift
from uplift_upsample_torch.tools.check_parity import build_model_and_inputs
batch, geometry, seed = int(sys.argv[3]), sys.argv[4], int(sys.argv[5])
model, x, sm = build_model_and_inputs(batch, geometry, seed=seed, device="cpu")
out = {}
if geometry == "h36m_351":  # the simulator's geometry: the bf16 rung's CPU oracle
    params, cfg = sim_drift.params_tree(model), sim_drift.sim_config(model)
    out["sim_default"] = sim_drift.run(params, x, sm, cfg, sim_drift.FUSED_FOLDED)
    out["sim_unfolded"] = sim_drift.run(params, x, sm, cfg, sim_drift.FUSED_DEFAULT)
with torch.inference_mode():
    _, central = model.double()(x.double(), sm)
out["central"] = central.numpy()
np.savez(sys.argv[2], **out)
print("truth ok", central.shape)
"""


def build_model_and_inputs(batch, geometry="h36m_351", seed=0, device="cpu"):
    """The JAX tool's h36m_351 (or h36m_81) geometry at full width, seeded
    weights, and its inputs: normals x 0.3, masked where the stride mask
    (every 5th frame; h36m_81 every 2nd) is off."""
    from ..config import UpliftUpsampleConfig
    from ..models import build_uplift_upsample_transformer

    config = UpliftUpsampleConfig()
    config.update_from({
        "SEQUENCE_LENGTH": 71, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 32,
        "TEMPORAL_EMBED_DIM": 384, "SPATIAL_TRANSFORMER_BLOCKS": 4,
        "TEMPORAL_TRANSFORMER_BLOCKS": 4, "STRIDES": [3, 10, 3],
        "PADDINGS": [[0, 0], [0, 0], [0, 0]], "NUM_HEADS": 8,
        "MASK_STRIDE": [5, 10, 20], "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1,
        "DROP_PATH_RATE": [0.1, 0.1, 0.0],
    })
    token_period = 5
    if geometry == "h36m_81":
        config.update_from({
            "SEQUENCE_LENGTH": 41, "SEQUENCE_STRIDE": 2,
            "STRIDES": [4, 4, 3], "PADDINGS": [[1, 1], [0, 0], [0, 0]],
            "MASK_STRIDE": [4, 10, 20],
        })
        token_period = 2
    n = config.SEQUENCE_LENGTH
    model = build_uplift_upsample_transformer(config, device=device, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, n, 17, 2)).astype(np.float32) * 0.3
    sm = (np.arange(n) % token_period == 0)[None].repeat(batch, axis=0)
    x = x * sm[:, :, None, None].astype(x.dtype)
    return model, torch.from_numpy(x).to(device), torch.from_numpy(sm).to(device)


def compute_truth(batch, geometry, seed, directory):
    """The float64 truth (and on h36m_351 the simulator's rung) from a
    subprocess on the CPU."""
    path = os.path.join(directory, f"truth_{geometry}.npz")
    subprocess.run([sys.executable, "-c", _TRUTH_SCRIPT, REPO, path, str(batch), geometry,
                    str(seed)], check=True, stdout=subprocess.DEVNULL)
    return dict(np.load(path))


def run_variant(name, model, x, sm):
    """The central output (B, 17, 3) of the named configuration."""
    from ..data.keypoint_order import H36MOrder17P
    from ..eval import make_test_step

    kind, rung = name.split("_", 1)
    if kind == "fused":
        return fused_variant(rung, model, x, sm)
    max_kf = None
    if rung.endswith("_kf"):
        rung, max_kf = rung[:-3], 15
    fused = {"rung": "full", "shared": "full", "xla": "none", "fused": "spatial"}[kind]
    step = make_test_step(model, flip_tta=False, flip_lr_indices=H36MOrder17P.flip_lr_indices(),
                          fused=fused, precision=rung, max_keyframes=max_kf,
                          shared_spatial=kind == "shared")
    if kind != "shared":
        return step(x, sm)[1]
    from ..utils.dedup import dedup_rows
    b, n = x.shape[:2]
    uniq, inv = dedup_rows(x.cpu().numpy().reshape(b * n, -1))  # x is masked already
    uq = np.zeros((-(-len(uniq) // 8) * 8, 17, 2), np.float32)
    uq[:len(uniq)] = uniq.reshape(-1, 17, 2)
    idx = torch.from_numpy(inv.reshape(b, n).astype(np.int64)).to(x.device)
    return step(torch.from_numpy(uq).to(x.device), idx, sm)[1]


def fused_variant(rung, model, x, sm):
    """K1 at `rung`, then the model from the s2t Dense under
    `matmul_precision("default")` (the JAX tool's `fused_<r>`: the spatial
    kernel at its precision, then the XLA tail at the TPU's DEFAULT)."""
    from ..ops.spatial import pack_spatial_params, spatial_stack_apply, stack_spatial_params
    from ..precision import matmul_precision

    ops = stack_spatial_params({k: v.detach() for k, v in model.state_dict().items()},
                               model.spatial_depth)
    with torch.inference_mode(), matmul_precision("default"):
        sp = spatial_stack_apply(ops, x, num_heads=model.num_heads,
                                 packed=pack_spatial_params(ops), precision=rung)
        return model(sp, sm, spatial_input=True)[1]


def drift_mm(got, truth):
    dist = np.linalg.norm(np.asarray(got, np.float64) - truth, axis=-1)  # (B, 17) per joint
    return float(dist.mean() * 1000.0), float(dist.max() * 1000.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--assert-bounds", action="store_true",
                    help="hold ASSERT_BOUNDS and rung_default's ratio to the simulator; "
                         "exit 1 if any fails")
    ap.add_argument("--seed", type=int, default=0, help="weights and inputs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..models.build import resolve_device
    device = resolve_device(args.device)
    name_of = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    ctx = {}  # geometry -> (truth dict, output scale, model, x, sm)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.variants.split(","):
            geometry, vname = (("h36m_81", name[4:]) if name.startswith("h81_")
                               else ("h36m_351", name))
            if geometry not in ctx:
                truth = compute_truth(args.batch, geometry, args.seed, tmp)
                ctx[geometry] = (truth, float(np.std(truth["central"])),
                                 *build_model_and_inputs(args.batch, geometry, args.seed,
                                                         device))
            truth, scale, model, x, sm = ctx[geometry]
            got = run_variant(vname, model, x, sm).cpu().numpy()
            mean_mm, max_mm = drift_mm(got, truth["central"])
            rec = dict(variant=name, mean_mm=mean_mm, max_mm=max_mm, out_std=scale,
                       device=name_of)
            if args.assert_bounds and name in ASSERT_BOUNDS:
                rec.update(bound_mm=ASSERT_BOUNDS[name], ok=mean_mm <= ASSERT_BOUNDS[name])
            if name == "rung_default" and "sim_default" in truth:
                sim_mean, _ = drift_mm(truth["sim_default"], truth["central"])
                unfolded, _ = drift_mm(truth["sim_unfolded"], truth["central"])
                ratio = mean_mm / sim_mean
                rec.update(sim_mean_mm=sim_mean, sim_ratio=ratio, sim_unfolded_mean_mm=unfolded,
                           sim_unfolded_ratio=mean_mm / unfolded)
                if args.assert_bounds:
                    rec.update(sim_ratio_bounds=list(SIM_RATIO),
                               ok=rec.get("ok", True)
                               and SIM_RATIO[0] <= ratio <= SIM_RATIO[1])
            if rec.get("ok") is False:
                failures.append(name)
            print(json.dumps(rec), flush=True)
    if args.assert_bounds:
        if failures:
            print(f"REGRESSION: {failures} exceeded drift bounds", flush=True)
            return 1
        print("drift bounds OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
