"""Per-site matmul-precision drift attribution in plain PyTorch (counterpart
of the JAX package's `tools/sim_drift.py`).

The TPU's DEFAULT-precision f32 dot is one bf16 pass (operands rounded to
bf16, f32 accumulate); HIGH3 is the 3-pass bf16 hi/lo split. Both are
bit-simulable on any device: round operands to bf16, contract in f32. This
tool reimplements the fused eval forward (models/bench_forward.py path) with
EVERY product routed through a site-keyed precision map, so the drift of any
mixed-precision assignment can be measured against the f32 truth. It is the
CPU oracle of the port's bf16 rung (EVAL_MATMUL_PRECISION "default"): all
sites "bf16" but `sp_attn` is what the fused path computes (the spatial
attention stays f32 in K1, as on the TPU's vector unit); all sites "bf16"
is the plain model under `precision.matmul_precision("default")`.

Sites (matching the kernel structure):

  sp_emb sp_qkv sp_attn sp_proj sp_mlp   spatial kernel products
  s2t                                    spatial->temporal Dense
  tm_qkv tm_attn tm_proj tm_mlp          temporal kernel products
  st_qkv st_attn st_proj st_mlp          strided block 1 (K3)
  tail                                   strided blocks 2+, head2 (plain)

A qkv site's mode may end in "+fold" ("bf16+fold"): q's columns of the
block's weights and its bias are multiplied by fp32(1/sqrt(D)) before the
product and the logits take no factor after it, the operands of the TPU's
eval kernels (`pallas_temporal_v3._transposed_operands(q_scale=)`,
`pallas_strided.stack_strided_block1_params(fold_q_scale=True)`). On the
bf16 rung that rounds q·1/sqrt(D) where the unfolded map rounds q; the
port's K2 and K3 fold (ROADMAP C7), so FUSED_FOLDED ("tm_qkv" and "st_qkv"
folded) is the function the card computes, FUSED_DEFAULT the JAX
simulator's own map.

Usage:
  python -m uplift_upsample_torch.tools.sim_drift --mode validate   # sim vs the model, f32
  python -m uplift_upsample_torch.tools.sim_drift --mode ladder     # per-site table
  python -m uplift_upsample_torch.tools.sim_drift --mode greedy     # minimal-bf16x3 search
  python -m uplift_upsample_torch.tools.sim_drift --mode config --sites tm_qkv=bf16x3,...
  [--batch 128] [--seed 0] [--device cpu|cuda]

Weights come from `--seed` (the port's seeded init; `params_tree` takes any
model's, e.g. one loaded through `utils.weights_h5.params_from_jax`), inputs
from a numpy seed as the JAX tool's (`check_parity.build_model_and_inputs`).
The truth is the plain model in fp32 ("highest") on the same device.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from ..precision import round_bf16
from ..utils.weights_h5 import params_to_jax

SITES = ["sp_emb", "sp_qkv", "sp_attn", "sp_proj", "sp_mlp", "s2t",
         "tm_qkv", "tm_attn", "tm_proj", "tm_mlp",
         "st_qkv", "st_attn", "st_proj", "st_mlp", "tail"]

# The port's bf16 rung on the fused path: every site rounds but the spatial
# attention (`sp_attn`, fp32 inside K1).
FUSED_DEFAULT = {s: ("f32" if s == "sp_attn" else "bf16") for s in SITES}
FOLD = "+fold"
# ... with q's scale folded into K2's and K3's weights, as the kernels take it
FUSED_FOLDED = {**FUSED_DEFAULT, "tm_qkv": "bf16" + FOLD, "st_qkv": "bf16" + FOLD}


def _bf16(a):
    return round_bf16(a)


def make_sdot(prec_map):
    """site-keyed matmul: f32 accumulate, operands per the site's mode."""

    def sdot(a, b, site):
        mode = prec_map[site].removesuffix(FOLD)
        if mode == "f32":
            return torch.matmul(a, b)
        if mode == "bf16":
            return torch.matmul(_bf16(a), _bf16(b))
        if mode == "bf16x3":
            a_hi, b_hi = _bf16(a), _bf16(b)
            a_lo, b_lo = _bf16(a - a_hi), _bf16(b - b_hi)
            return (torch.matmul(a_hi, b_hi)
                    + torch.matmul(a_hi, b_lo)
                    + torch.matmul(a_lo, b_hi))
        if mode == "bf16x2w":
            # 2-pass candidate rung: weights (b operand) split hi/lo,
            # activations rounded ONCE — error is the activations' bf16
            # rounding alone (~1/sqrt(2) of 1-pass, NOT squared like x3).
            b_hi = _bf16(b)
            b_lo = _bf16(b - b_hi)
            a_r = _bf16(a)
            return torch.matmul(a_r, b_hi) + torch.matmul(a_r, b_lo)
        if mode == "bf16x2a":
            # symmetric candidate: activations split, weights rounded once
            a_hi = _bf16(a)
            a_lo = _bf16(a - a_hi)
            b_r = _bf16(b)
            return torch.matmul(a_hi, b_r) + torch.matmul(a_lo, b_r)
        raise ValueError(mode)

    return sdot


def _ln(x, scale, bias, eps):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _attention(sdot, y, blk, num_heads, site_qkv, site_attn, key_mask=None, fold=False):
    """Pre-LN MHA on y (B, S, C) with separate wq/wk/wv (flax param layout);
    `fold`: 1/sqrt(D) folded into wq and its bias (the "+fold" modes)."""
    b, s, c = y.shape
    depth = c // num_heads
    a = blk["attn"]
    wq, bq = a["wq"]["kernel"], a["wq"]["bias"]
    if fold:
        qs = torch.tensor(1.0 / np.sqrt(depth), dtype=torch.float32, device=wq.device)
        wq, bq = wq * qs, bq * qs
    q = sdot(y, wq, site_qkv) + bq
    k = sdot(y, a["wk"]["kernel"], site_qkv) + a["wk"]["bias"]
    v = sdot(y, a["wv"]["kernel"], site_qkv) + a["wv"]["bias"]
    split = lambda t: t.reshape(b, s, num_heads, depth).permute(0, 2, 1, 3)
    q, k, v = split(q), split(k), split(v)
    logits = sdot(q, k.permute(0, 1, 3, 2), site_attn)
    if not fold:
        logits = logits / np.sqrt(depth)
    if key_mask is not None:  # (B, S), 1 = blocked key
        logits = logits + key_mask[:, None, None, :] * -1e9
    w = torch.softmax(logits, dim=-1)
    ctx = sdot(w, v, site_attn)
    return ctx.permute(0, 2, 1, 3).reshape(b, s, c)


def sim_forward(params, x2d, stride_mask, prec_map, cfg):
    """Mirror of the fused eval path with per-site product precision."""
    sdot = make_sdot(prec_map)
    b, n, p, _ = x2d.shape
    heads = cfg["num_heads"]

    # ---- spatial stack (frame-independent over joints) ---------------------
    x = x2d.reshape(b * n, p, 2)
    x = sdot(x, params["keypoint_embedding"]["kernel"], "sp_emb") \
        + params["keypoint_embedding"]["bias"]
    x = x + params["spatial_pe"]
    for i in range(cfg["spatial_depth"]):
        blk = params[f"spatial_block_{i + 1}"]
        y = _ln(x, blk["norm1"]["scale"], blk["norm1"]["bias"], 1e-5)
        ctx = _attention(sdot, y, blk, heads, "sp_qkv", "sp_attn")
        x = x + sdot(ctx, blk["attn"]["proj"]["kernel"], "sp_proj") \
            + blk["attn"]["proj"]["bias"]
        z = _ln(x, blk["norm2"]["scale"], blk["norm2"]["bias"], 1e-5)
        z = sdot(z, blk["mlp"]["fc1"]["kernel"], "sp_mlp") + blk["mlp"]["fc1"]["bias"]
        z = 0.5 * z * (1.0 + torch.erf(z / np.sqrt(2.0)))
        z = sdot(z, blk["mlp"]["fc2"]["kernel"], "sp_mlp") + blk["mlp"]["fc2"]["bias"]
        x = x + z
    x = _ln(x, params["spatial_norm"]["scale"], params["spatial_norm"]["bias"], 1e-6)
    x = x.reshape(b, n, p * cfg["spatial_d"])

    # ---- s2t + token substitution + PE ------------------------------------
    x = sdot(x, params["spatial_to_temporal_fc"]["kernel"], "s2t") \
        + params["spatial_to_temporal_fc"]["bias"]
    sm = stride_mask.to(torch.float32)[..., None]
    x = sm * x + (1.0 - sm) * params["strided_input_token"][None, None, :]
    x = x + params["temporal_pe"]
    inv_mask = 1.0 - stride_mask.to(torch.float32)

    # ---- temporal stack ----------------------------------------------------
    for i in range(cfg["temporal_depth"]):
        blk = params[f"temporal_block_{i + 1}"]
        km = inv_mask if i < cfg["first_masked_blocks"] else None
        y = _ln(x, blk["norm1"]["scale"], blk["norm1"]["bias"], 1e-5)
        ctx = _attention(sdot, y, blk, heads, "tm_qkv", "tm_attn", key_mask=km,
                         fold=prec_map["tm_qkv"].endswith(FOLD))
        x = x + sdot(ctx, blk["attn"]["proj"]["kernel"], "tm_proj") \
            + blk["attn"]["proj"]["bias"]
        z = _ln(x, blk["norm2"]["scale"], blk["norm2"]["bias"], 1e-5)
        z = sdot(z, blk["mlp"]["fc1"]["kernel"], "tm_mlp") + blk["mlp"]["fc1"]["bias"]
        z = torch.clamp(z, min=0.0)
        z = sdot(z, blk["mlp"]["fc2"]["kernel"], "tm_mlp") + blk["mlp"]["fc2"]["bias"]
        x = x + z

    # ---- strided stack (block 1 = K3; 2+ = the plain tail) -----------------
    # This simulator targets the flagship geometry: stride>1 blocks with
    # padding (0,0) (k3 VALID conv + crop-both-ends residual). A stride-1
    # block would need the padded-conv variant — assert rather than drift.
    assert all(s > 1 for s in cfg["strides"]), cfg["strides"]
    for i, s in enumerate(cfg["strides"]):
        blk = params[f"strided_temporal_block_{i + 1}"]
        sq, sa, sp_, sm_ = (("st_qkv", "st_attn", "st_proj", "st_mlp") if i == 0
                            else ("tail", "tail", "tail", "tail"))
        x = x + params[f"strided_temporal_pe_{i + 1}"]
        y = _ln(x, blk["norm1"]["scale"], blk["norm1"]["bias"], 1e-5)
        ctx = _attention(sdot, y, blk, heads, sq, sa, fold=prec_map[sq].endswith(FOLD))
        x = x + sdot(ctx, blk["attn"]["proj"]["kernel"], sp_) \
            + blk["attn"]["proj"]["bias"]
        z = _ln(x, blk["norm2"]["scale"], blk["norm2"]["bias"], 1e-5)
        z = sdot(z, blk["mlp"]["fc1"]["kernel"], sm_) + blk["mlp"]["fc1"]["bias"]
        z = torch.clamp(z, min=0.0)
        # conv k3/stride s VALID with padding (0,0) as 3 shifted products
        w = blk["mlp"]["fc2"]["kernel"]  # (3, hidden, C)
        n_in = z.shape[1]
        n_out = (n_in - 3) // s + 1
        zc = None
        for j in range(3):
            piece = sdot(z[:, j: j + (n_out - 1) * s + 1: s], w[j], sm_)
            zc = piece if zc is None else zc + piece
        zc = zc + blk["mlp"]["fc2"]["bias"]
        ident = x[:, 1:-1][:, ::s] if s > 1 else x
        x = ident + zc

    x = sdot(x, params["strided_temporal_fc"]["kernel"], "tail") \
        + params["strided_temporal_fc"]["bias"]
    return x.reshape(b, cfg["num_keypoints"], 3)


def params_tree(model, device="cpu") -> Dict:
    """The model's weights as the flax parameter tree `sim_forward` reads
    (Dense kernels (in, out), Conv1D kernels (3, in, out)), fp32 tensors."""
    tree = params_to_jax(model.state_dict(), model)["params"]

    def to(node):
        if isinstance(node, dict):
            return {k: to(v) for k, v in node.items()}
        return torch.as_tensor(node, dtype=torch.float32, device=device)

    return to(tree)


def sim_config(model) -> Dict:
    return dict(num_heads=model.num_heads, spatial_depth=model.spatial_depth,
                temporal_depth=model.temporal_depth,
                first_masked_blocks=model.first_strided_token_attention_layer,
                strides=tuple(model.strides), spatial_d=model.spatial_d_model,
                num_keypoints=model.num_keypoints)


def setup(batch, seed=0, device="cpu"):
    from .check_parity import build_model_and_inputs
    model, x, sm = build_model_and_inputs(batch, seed=seed, device=device)
    return model, params_tree(model, device), x, sm, sim_config(model)


def drift(central, truth):
    d = np.linalg.norm(np.asarray(central, np.float64) - truth, axis=-1)
    return float(d.mean() * 1e3), float(d.max() * 1e3)


@torch.inference_mode()
def run(params, x, sm, cfg, assign):
    prec_map = {s: assign.get(s, "f32") for s in SITES}
    return sim_forward(params, x, sm, prec_map, cfg).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--mode", default="ladder",
                    choices=["validate", "ladder", "greedy", "config"])
    ap.add_argument("--sites", default="",
                    help="config mode: comma list "
                         "site=f32|bf16|bf16x3|bf16x2w|bf16x2a, a qkv site's mode "
                         "with '+fold' (q's scale folded into its weights); "
                         "'all=<mode>' sets every site")
    ap.add_argument("--target", type=float, default=0.5,
                    help="greedy mode: target mean drift (mm at fixture scale)")
    ap.add_argument("--seed", type=int, default=0, help="weights and inputs")
    ap.add_argument("--device", default="cpu", help="cpu (default) or cuda")
    args = ap.parse_args(argv)

    model, params, x, sm, cfg = setup(args.batch, args.seed, args.device)

    with torch.inference_mode():
        _, truth = model(x, sm)
    truth = truth.cpu().numpy().astype(np.float64)

    if args.mode == "validate":
        got = run(params, x, sm, cfg, {})
        mean, mx = drift(got, truth)
        print(json.dumps({"sim_vs_model_mean_mm": mean, "max_mm": mx,
                          "out_std": float(np.std(truth))}))
        # f32 reduction-order noise floor (~0.005 mm at fixture scale) — far
        # below the 0.5+ mm signals this tool attributes.
        assert mean < 0.05, "simulator diverges from the model"
        return

    if args.mode == "config":
        assign = dict(kv.split("=") for kv in args.sites.split(",") if kv)
        if "all" in assign:
            mode_all = assign.pop("all")
            assign = {**{s: mode_all for s in SITES}, **assign}
        mean, mx = drift(run(params, x, sm, cfg, assign), truth)
        print(json.dumps({"sites": assign, "mean_mm": round(mean, 4),
                          "max_mm": round(mx, 4)}))
        return

    if args.mode == "ladder":
        # all-DEFAULT baseline, then each single site upgraded / isolated
        for label, assign in [
            ("all_bf16", {s: "bf16" for s in SITES}),
            ("all_bf16x3", {s: "bf16x3" for s in SITES}),
        ]:
            mean, mx = drift(run(params, x, sm, cfg, assign), truth)
            print(json.dumps({"config": label, "mean_mm": round(mean, 4),
                              "max_mm": round(mx, 4)}), flush=True)
        for site in SITES:
            # isolate: ONLY this site at bf16, rest exact → its own contribution
            solo = {s: ("bf16" if s == site else "f32") for s in SITES}
            m1, _ = drift(run(params, x, sm, cfg, solo), truth)
            # upgrade: this site bf16x3, rest bf16 → what fixing only it buys
            up = {s: ("bf16x3" if s == site else "bf16") for s in SITES}
            m2, _ = drift(run(params, x, sm, cfg, up), truth)
            print(json.dumps({"site": site, "solo_bf16_mean_mm": round(m1, 4),
                              "upgraded_alone_mean_mm": round(m2, 4)}),
                  flush=True)
        return

    # greedy: start all-bf16, repeatedly upgrade the site with the largest
    # drift reduction until mean <= target
    assign = {s: "bf16" for s in SITES}
    mean, _ = drift(run(params, x, sm, cfg, assign), truth)
    print(json.dumps({"start_mean_mm": round(mean, 4)}), flush=True)
    while mean > args.target:
        best_site, best_mean = None, mean
        for site in SITES:
            if assign[site] != "bf16":
                continue
            trial = dict(assign, **{site: "bf16x3"})
            m, _ = drift(run(params, x, sm, cfg, trial), truth)
            if m < best_mean:
                best_site, best_mean = site, m
        if best_site is None:
            print(json.dumps({"stuck_at_mean_mm": round(mean, 4)}))
            break
        assign[best_site] = "bf16x3"
        mean = best_mean
        print(json.dumps({"upgraded": best_site, "mean_mm": round(mean, 4)}),
              flush=True)
    print(json.dumps({"final": {k: v for k, v in assign.items()
                                if v != "bf16"},
                      "mean_mm": round(mean, 4)}))


if __name__ == "__main__":
    main()
