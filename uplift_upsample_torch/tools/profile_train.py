"""The training step taken apart on the card (the JAX package's
`tools/profile_train.py`, in torch).

Times pieces of the training step (forward, backward and AdamW on the
config's geometry, h36m_351 at B=512 by default, the bench's `--train`
configuration) as the slope between chains of M = 4 and M = 16 calls,
each call fed by the last (`utils.profiling.device_timer`: CUDA events on
the card, the host clock on the CPU). Variants:

  full           the whole step (`make_train_step`: loss, backward, Keras
                 AdamW; EMA off, as the bench)
  grad           the loss and its backward, no optimizer
  fwd            the loss's forward alone (no autograd graph)
  opt            the optimizer update alone, on one step's gradients
  spatial        the spatial stack's training op alone (K1 forward, K4
                 backward) at the keyframe budget the step gathers;
                 `spatial_dense` at every frame of the batch
  temporal       the temporal stack's training op alone (K5), no key mask

and then `card_busy`: one full step under `utils.profiling.trace`, the
card's busy time (the union of its kernels) against the step's wall time
(the best of three synchronised steps), so the host's share shows, with
the kernels that took most of it. One JSON line per variant on stdout.

    python -m uplift_upsample_torch.tools.profile_train [--variants full,grad]
        [--batch 512] [--precision default] [--device cpu] [--config h36m_351]

It runs on the card unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

VARIANTS = ("full", "grad", "fwd", "opt", "spatial", "spatial_dense", "temporal")


def build(args, device):
    import torch

    from ..configs import resolve_config
    from ..models import build_uplift_upsample_transformer
    from ..parallel import make_optimizer

    config = resolve_config(args.config)
    config.update_from({
        "BATCH_SIZE": args.batch,
        "OPTIMIZER": "AdamW", "OPTIMIZER_PARAMS": {}, "WEIGHT_DECAY": 4e-6,
        "EMA_ENABLED": False, "SCHEDULE": "ExponentialDecay",
        "SCHEDULE_PARAMS": {"initial_learning_rate": 4e-5, "decay_steps": 6000,
                            "decay_rate": 0.99, "staircase": True},
        "TRAIN_MATMUL_PRECISION": args.precision,
    })
    model = build_uplift_upsample_transformer(config, device=device, seed=0)
    opt, _, _ = make_optimizer(config)
    b, n, k = args.batch, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    ms = config.MASK_STRIDE
    ms0 = (ms[0] if isinstance(ms, (list, tuple)) else ms) or 1
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.1,
             rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.1,
             (np.arange(n) % ms0 == 0)[None].repeat(b, 0))
    batch = tuple(torch.from_numpy(a).to(device) for a in batch)
    return config, model, opt, batch


def _leaves(ops: dict) -> dict:
    """Stacked operands as leaves that take gradients (the stacking is not
    timed, as the JAX tool times its kernels on stacked parameters)."""
    import torch

    return {k: v.detach().requires_grad_(v.is_floating_point())
            if isinstance(v, torch.Tensor) else v for k, v in ops.items()}


def variant_fn(name, config, model, opt, batch, device):
    """(fn, its first argument) for `device_timer`."""
    import torch

    from ..ops.spatial import make_droppath_scales, spatial_stack_train, stack_spatial_params
    from ..ops.temporal import stack_temporal_params
    from ..ops.temporal_train import temporal_stack_train
    from ..parallel import make_train_step
    from ..parallel.train_step import (_droppath_rates, keyframe_budget, make_loss_fn,
                                       step_generator)
    from ..precision import config_train_rungs

    seq3d, seq2d, sm = batch
    params = dict(model.named_parameters())
    sp_rung, tm_rung, _ = config_train_rungs(config)
    heads = model.num_heads
    model.train()
    if name == "full":
        state = opt.init(model, ema=False)
        step = make_train_step(model, opt, config, device=device)
        return (lambda x: step(state, (seq3d, x, sm))[1]), seq2d
    loss_fn = make_loss_fn(model, config)
    if name in ("grad", "opt"):
        def grad(x):
            for p in params.values():
                p.grad = None
            loss = loss_fn((seq3d, x, sm), step_generator(0, 0))
            loss.backward()
            return loss.detach()
        if name == "grad":
            return grad, seq2d
        grad(seq2d)
        grads = {k: p.grad.clone() for k, p in params.items()}
        state = opt.init(model, ema=False)

        def update(carry):
            opt.apply(params, grads, state)
            state.step += 1
            return next(iter(params.values())).detach() + carry
        return update, torch.zeros((), device=device)
    if name == "fwd":
        def fwd(x):
            with torch.no_grad():
                return loss_fn((seq3d, x, sm), step_generator(0, 0))
        return fwd, seq2d
    if name.startswith("spatial"):
        frames = seq2d.shape[0] * seq2d.shape[1]
        if name == "spatial":
            frames = keyframe_budget(model, config) or frames
        x = (torch.randn(frames, model.num_keypoints, 2, generator=torch.Generator().manual_seed(0))
             * 0.3).to(device).requires_grad_()
        ops = _leaves(stack_spatial_params(params, model.spatial_depth))
        scales = make_droppath_scales(torch.Generator().manual_seed(1),
                                      _droppath_rates(config, 0, model.spatial_depth),
                                      frames).to(device)

        def spatial(x):
            y = spatial_stack_train(x, ops, scales, num_heads=heads, precision=sp_rung)
            (y * 1e-3).sum().backward()
            return y.detach()
        return spatial, x
    if name == "temporal":
        b, n = seq2d.shape[:2]
        y0 = (torch.randn(b, n, model.temporal_d_model,
                          generator=torch.Generator().manual_seed(0)) * 0.3
              ).to(device).requires_grad_()
        ops = _leaves(stack_temporal_params(params, model.temporal_depth, precision=tm_rung))
        dp_all = torch.ones((model.temporal_depth, 2, b), device=device)
        fmb = model.first_strided_token_attention_layer if model.has_strided_input else 0

        def temporal(y):
            out = temporal_stack_train(y, ops, None, dp_all, num_heads=heads,
                                       first_masked_blocks=fmb, precision=tm_rung)
            (out * 1e-3).sum().backward()
            return out.detach()
        return temporal, y0
    raise ValueError(f"unknown variant {name!r}; expected one of {VARIANTS}")


def card_busy_line(config, model, opt, batch, device, logdir: str) -> dict:
    """One full step under `trace`: the card's busy time against the step's
    wall time (the best of three synchronised steps)."""
    import torch

    from ..parallel import make_train_step
    from ..utils.profiling import card_busy, trace

    state = opt.init(model, ema=False)
    step = make_train_step(model, opt, config, device=device)
    cuda = device.type == "cuda"

    def one():
        t0 = time.perf_counter()
        step(state, batch)
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    one()
    wall = min(one() for _ in range(3))
    with trace(logdir, strict=False) as prof:
        step(state, batch)
    busy, kernels, by_name = card_busy(prof.trace_file)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"variant": "card_busy", "step_ms": 1e3 * wall, "card_busy_ms": 1e3 * busy,
            "busy_share": busy / wall, "kernels": kernels, "lost_kernels": prof.lost_kernels,
            "top": [[name, 1e3 * s, count] for name, (s, count) in top]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS) + ",card_busy")
    parser.add_argument("--config", default="h36m_351",
                        help="a bundled config name or a JSON file")
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--precision", default="default",
                        help="TRAIN_MATMUL_PRECISION (default, mixed, high, highest)")
    parser.add_argument("--m-small", type=int, default=4)
    parser.add_argument("--m-large", type=int, default=16)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--logdir", default=None, help="default: <tmp>/profile_train")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from ..models.build import resolve_device
    from ..utils.profiling import device_timer

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    config, model, opt, batch = build(args, device)
    common = {"batch": args.batch, "precision": args.precision, "device": name}
    for variant in (v.strip() for v in args.variants.split(",")):
        if variant == "card_busy":
            logdir = args.logdir or os.path.join(tempfile.gettempdir(), "profile_train")
            line = card_busy_line(config, model, opt, batch, device, logdir)
        else:
            fn, x = variant_fn(variant, config, model, opt, batch, device)
            sec = device_timer(fn, x, m_small=args.m_small, m_large=args.m_large,
                               reps=args.reps)
            line = {"variant": variant, "ms": 1e3 * sec, "windows_per_s": args.batch / sec}
        print(json.dumps({**line, **common}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
