"""The port's training kernels' modules against the JAX package.

CPU tests: the plain versions that the training kernels stand beside —
K1 with stochastic-depth scales (`spatial_stack_plain`), K4 (its autograd,
`spatial_stack_bwd` on a CPU tensor) and K5 (`temporal_stack_train` on a CPU
tensor, forward and autograd) — against the JAX package's references:
`pallas_spatial._xla_spatial_stack` (the plain reference of the TPU's
spatial forward and backward kernels) and `fused_temporal_stack_train` run
in interpret mode. Inputs and weights are made with numpy and handed to both.

Tolerances: outputs 2e-5 abs (fp32 sums in another order); gradients per
leaf atol 2e-4 × max(max|ref|, 1e-3), rtol 2e-3, the repo's grad bar
(tests/test_train.py:448-451); losses rtol 1e-5.

`gpu` tests: each training kernel against its plain version on the card.
They decide inside the test whether there is a card and skip without one;
JAX is imported inside the CPU tests only.
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.spatial import (PARAM_ORDER, make_droppath_scales,
                                               spatial_stack, spatial_stack_plain,
                                               spatial_stack_train, stack_spatial_params)
from uplift_upsample_torch.ops.spatial_bwd import spatial_stack_bwd, spatial_stack_bwd_plain
from uplift_upsample_torch.ops.temporal import stack_temporal_params
from uplift_upsample_torch.ops.temporal_train import (ORDER, saved_relu_masks,
                                                      temporal_stack_bwd_plain,
                                                      temporal_stack_train,
                                                      temporal_train_bwd,
                                                      temporal_train_fwd)
from uplift_upsample_torch.utils.weights_h5 import params_from_jax

try:  # the card's machine has no JAX: its tests below still collect there
    from tests.test_torch_kernels import _spatial_tree, _state, _temporal_tree
except ImportError:  # pragma: no cover - tests/ not a package on that machine
    from test_torch_kernels import _spatial_tree, _state, _temporal_tree


def assert_grad_close(got, ref, what, zero_at=None):
    """The grad bar. `zero_at`: the leaf's true gradient is exactly 0 (the key
    bias shifts a softmax row by a constant), so both sides hold float
    cancellation noise; hold that to 2e-4 of the `zero_at` gradient's scale."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if zero_at is not None:
        bar = 2e-4 * max(float(np.abs(np.asarray(zero_at)).max()), 1e-3)
        assert np.abs(got).max() <= bar and np.abs(ref).max() <= bar, what
        return
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=2e-3, err_msg=what)


def _keep_scales(rng, rows, frames, keep=0.75):
    return ((rng.uniform(size=(rows, frames)) < keep).astype(np.float32) / keep)


def _spatial_case(seed=0, f=256, c=16, heads=4, blocks=2):
    rng = np.random.default_rng(seed)
    params = _spatial_tree(rng, c, blocks)
    x = (rng.normal(size=(f, 17, 2)) * 0.5).astype(np.float32)
    scales = _keep_scales(rng, 2 * blocks, f)
    g = rng.normal(size=(f, 17 * c)).astype(np.float32)
    return params, x, scales, g, heads, blocks


def test_spatial_plain_with_scales_matches_jax():
    """K1's plain version with droppath scales vs `_xla_spatial_stack`,
    F=256, C=16, 2 blocks, keep 0.75."""
    jnp = pytest.importorskip("jax").numpy
    from uplift_upsample_tpu.ops.pallas_spatial import _xla_spatial_stack
    from uplift_upsample_tpu.ops.pallas_spatial import stack_spatial_params as jax_stack

    params, x, scales, _, heads, blocks = _spatial_case()
    ref = _xla_spatial_stack(jax_stack(params, blocks), jnp.asarray(x.transpose(1, 2, 0)),
                             jnp.asarray(scales), heads)
    ref = np.asarray(ref).transpose(2, 0, 1).reshape(x.shape[0], -1)
    ops = stack_spatial_params(_state(params), blocks)
    got = spatial_stack(torch.from_numpy(x), ops, num_heads=heads,
                        droppath_scales=torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_spatial_bwd_plain_matches_jax_vjp():
    """K4's CPU path (autograd of the plain version) vs jax.vjp of
    `_xla_spatial_stack`: every operand's gradient, dx and dscales."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from uplift_upsample_tpu.ops.pallas_spatial import _xla_spatial_stack
    from uplift_upsample_tpu.ops.pallas_spatial import stack_spatial_params as jax_stack

    params, x, scales, g, heads, blocks = _spatial_case(seed=1)
    f, c = x.shape[0], g.shape[1] // 17
    _, vjp = jax.vjp(lambda s, xt, d: _xla_spatial_stack(s, xt, d, heads),
                     jax_stack(params, blocks), jnp.asarray(x.transpose(1, 2, 0)),
                     jnp.asarray(scales))
    ref_ops, ref_dx, ref_ddp = vjp(jnp.asarray(g.reshape(f, 17, c).transpose(1, 2, 0)))

    ops = stack_spatial_params(_state(params), blocks)
    dparams, dx, ddp = spatial_stack_bwd(torch.from_numpy(x), ops, torch.from_numpy(scales),
                                         torch.from_numpy(g), num_heads=heads)
    assert set(dparams) == set(PARAM_ORDER) == set(ref_ops)
    for name in PARAM_ORDER:
        assert_grad_close(dparams[name].numpy(), ref_ops[name], name,
                          zero_at=ref_ops["bq"] if name == "bk" else None)
    assert_grad_close(dx.numpy(), np.asarray(ref_dx).transpose(2, 0, 1), "dx")
    assert_grad_close(ddp.numpy(), ref_ddp, "ddp")


def test_spatial_train_reaches_module_parameters():
    """spatial_stack_train on a CPU tensor launches nothing, and its
    gradients reach the tensors the operands were stacked from."""
    params, x, scales, g, heads, blocks = _spatial_case(seed=2, f=7)
    state = {k: v.requires_grad_(True) for k, v in _state(params).items()}
    ops = stack_spatial_params(state, blocks)
    cuda_lib.reset_launches()
    out = spatial_stack_train(torch.from_numpy(x), ops, torch.from_numpy(scales),
                              num_heads=heads)
    out.backward(torch.from_numpy(g))
    assert sum(cuda_lib.LAUNCHES.values()) == 0
    want, _, _ = spatial_stack_bwd_plain(torch.from_numpy(x), ops, torch.from_numpy(scales),
                                         torch.from_numpy(g), num_heads=heads)
    torch.testing.assert_close(state["spatial_block_2.attn.wq.weight"].grad,
                               want["wq"][1].t(), rtol=0, atol=0)
    torch.testing.assert_close(state["keypoint_embedding.weight"].grad, want["emb_w"].t(),
                               rtol=0, atol=0)


def test_droppath_scales_law():
    """Over 10^5 draws the kept fraction is within 1 % of keep, every scale is
    0 or 1/keep, and a rate of 0 gives ones."""
    gen = torch.Generator().manual_seed(0)
    scales = make_droppath_scales(gen, [0.0, 0.1, 0.3], 100_000)
    assert scales.shape == (6, 100_000)
    assert torch.equal(scales[:2], torch.ones(2, 100_000))
    for row, rate in zip(scales[2:], (0.1, 0.1, 0.3, 0.3)):
        keep = 1.0 - rate
        assert set(np.unique(row.numpy()).tolist()) <= {0.0, np.float32(1.0 / keep)}
        assert abs(float((row > 0).float().mean()) - keep) <= 0.01 * keep


def _temporal_case(seed=7, b=4, s=9, c=32, heads=4, blocks=3):
    rng = np.random.default_rng(seed)
    params = _temporal_tree(rng, c, blocks)
    x = (rng.normal(size=(b, s, c)) * 0.5).astype(np.float32)
    key_mask = (rng.uniform(size=(b, s)) < 0.4).astype(np.float32)
    key_mask[:, 0] = 0.0  # one real key per window
    dp = _keep_scales(rng, blocks * 2, b).reshape(blocks, 2, b)
    cot = rng.normal(size=(b, s, c)).astype(np.float32)
    return params, x, key_mask, dp, cot, heads, blocks


def test_temporal_train_plain_matches_jax():
    """K5's CPU path (the plain stack with per-window scales, under autograd)
    vs `fused_temporal_stack_train` in interpret mode, as
    tests/test_fused_temporal_train.py runs it: b=4, s=9, c=32, 4 heads,
    3 blocks, key mask in block 1; the loss sum(out · cot), dx, every
    parameter gradient and ddp."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_temporal_bwd import fused_temporal_stack_train

    params, x, key_mask, dp, cot, heads, blocks = _temporal_case()
    fmb = 1
    ptuple = tuple(params[f"temporal_block_{i + 1}"] for i in range(blocks))
    ptuple = jax.tree.map(jnp.asarray, ptuple)

    def fused_loss(pt, xx, dd):
        out = fused_temporal_stack_train(xx, pt, jnp.asarray(key_mask), dd, heads, 4,
                                         jnp.float32, fmb, 2)
        return jnp.sum(out * jnp.asarray(cot))

    with pltpu.force_tpu_interpret_mode():
        ref_val, (ref_p, ref_dx, ref_dp) = jax.value_and_grad(fused_loss, argnums=(0, 1, 2))(
            ptuple, jnp.asarray(x), jnp.asarray(dp))

    state = {k: v.requires_grad_(True) for k, v in _state(params).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    dpt = torch.from_numpy(dp).requires_grad_(True)
    out = temporal_stack_train(xt, stack_temporal_params(state, blocks),
                               torch.from_numpy(key_mask), dpt, num_heads=heads,
                               first_masked_blocks=fmb)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_val), rtol=1e-5)
    assert_grad_close(xt.grad.numpy(), ref_dx, "dx")
    assert_grad_close(dpt.grad.numpy(), ref_dp, "ddp")
    ref_state = params_from_jax({f"temporal_block_{i + 1}": jax.tree.map(np.asarray, p)
                                 for i, p in enumerate(ref_p)})
    assert set(ref_state) == set(state)
    for key, ref in ref_state.items():
        zero_at = (ref_state[key.replace("wk", "wq")] if key.endswith("attn.wk.bias")
                   else None)
        assert_grad_close(state[key].grad.numpy(), ref.numpy(), key, zero_at=zero_at)


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tol(ref):
    return 2e-4 * max(1.0, float(ref.abs().max()))


def _grad_ok(got, ref, zero_at=None):
    if zero_at is not None:  # see assert_grad_close
        bar = 2e-4 * max(float(zero_at.abs().max()), 1e-3)
        return float(got.abs().max()) <= bar and float(ref.abs().max()) <= bar
    scale = max(float(ref.abs().max()), 1e-3)
    return bool(((got - ref).abs() <= 2e-4 * scale + 2e-3 * ref.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("c,heads", [(32, 8), (16, 4)])
def test_spatial_train_kernels_match_plain(c, heads):
    """K1 with scales and K4 against the plain version and its autograd."""
    dev = _card()
    params, x, scales, g, _, blocks = _spatial_case(seed=3, f=1031, c=c, heads=heads,
                                                    blocks=4)
    ops = {k: v.to(dev) for k, v in stack_spatial_params(_state(params), blocks).items()}
    x, scales, g = (torch.from_numpy(a).to(dev) for a in (x, scales, g))
    cuda_lib.reset_launches()
    got = spatial_stack(x, ops, num_heads=heads, droppath_scales=scales)
    ref = spatial_stack_plain(x, ops, num_heads=heads, droppath_scales=scales)
    assert float((got - ref).abs().max()) <= _tol(ref)
    dparams, dx, ddp = spatial_stack_bwd(x, ops, scales, g, num_heads=heads)
    again, _, _ = spatial_stack_bwd(x, ops, scales, g, num_heads=heads)
    want, want_dx, want_ddp = spatial_stack_bwd_plain(x, ops, scales, g, num_heads=heads)
    torch.cuda.synchronize()
    assert all(torch.equal(again[k], dparams[k]) for k in PARAM_ORDER)  # fixed-order sums
    assert cuda_lib.LAUNCHES["spatial_stack"] == 1 and cuda_lib.LAUNCHES["spatial_bwd"] == 4
    for name in PARAM_ORDER:
        zero_at = want["bq"] if name == "bk" else None
        assert _grad_ok(dparams[name], want[name], zero_at), name
    assert _grad_ok(dx, want_dx) and _grad_ok(ddp, want_ddp)


@pytest.mark.gpu
@pytest.mark.parametrize("blocks,fmb", [(2, 1), (1, 0)])
def test_temporal_train_kernels_match_plain(blocks, fmb):
    """K5 forward and backward against the plain stack and its autograd."""
    dev = _card()
    params, x, key_mask, dp, cot, heads, _ = _temporal_case(seed=8, b=5, s=71, c=128,
                                                            heads=8, blocks=blocks)
    ops = {k: v.to(dev) for k, v in stack_temporal_params(_state(params), blocks).items()}
    x, km, dp, cot = (torch.from_numpy(a).to(dev) for a in (x, key_mask, dp, cot))
    kw = dict(num_heads=heads, first_masked_blocks=fmb)
    cuda_lib.reset_launches()
    out, saved = temporal_train_fwd(x, ops, km, dp, **kw)
    dx, grads, ddp = temporal_train_bwd(saved, cot, ops, km, dp, **kw)
    _, again, _ = temporal_train_bwd(saved, cot, ops, km, dp, **kw)
    assert all(torch.equal(again[k], grads[k]) for k in ORDER)  # no float atomics
    from uplift_upsample_torch.ops.temporal import temporal_stack_plain
    ref = temporal_stack_plain(x, ops, km, droppath=dp, **kw)
    # with K5's relu decisions: a pre-activation within rounding of 0 takes
    # the same side of the kink in both
    want_dx, want, want_ddp = temporal_stack_bwd_plain(x, ops, km, dp, cot,
                                                       relu_masks=saved_relu_masks(saved),
                                                       **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["temporal_train_fwd"] > 0
    assert cuda_lib.LAUNCHES["temporal_train_bwd"] > 0
    assert float((out - ref).abs().max()) <= _tol(ref)
    c = x.shape[-1]
    for name in ORDER:
        if name == "bqkv":  # the key bias's third: see assert_grad_close
            assert _grad_ok(grads[name][:, c:2 * c], want[name][:, c:2 * c],
                            want[name][:, :c])
            keep = torch.ones(3 * c, dtype=torch.bool, device=dev)
            keep[c:2 * c] = False
            assert _grad_ok(grads[name][:, keep], want[name][:, keep]), name
            continue
        assert _grad_ok(grads[name], want[name]), name
    assert _grad_ok(dx, want_dx) and _grad_ok(ddp, want_ddp)
