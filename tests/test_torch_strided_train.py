"""K6 — strided block 1 in training — against the JAX package.

CPU tests: `strided_block1_train_plain` (the plain version K6 stands beside)
against the flax `StridedTransformerBlock` of the JAX test's `_setup` (b=4,
n=27, c=128, 8 heads; tests/test_fused_strided_train.py:14-23) at strides 2,
3 and 4 (at stride 1 the flax block crops no frame from its residual, so with
paddings (0, 0) it cannot add its branches): the forward at atol 2e-5 / rtol 1e-4 (that test's bar), and dx, dpe
and every parameter gradient against `jax.vjp` under the grad bar (per leaf
atol 2e-4 × max(max|ref|, 1e-3), rtol 2e-3; tests/test_train.py:448-451).
The forward is also held against the interpret-mode Pallas
`fused_strided_block1_train` followed by its caller's slice, run under
`jax.jit` (an eagerly applied interpret-mode kernel can deadlock, ROADMAP C).
On CPU tensors the wrapper is the plain version, and the CUDA path refuses
them.

`gpu` tests: K6's forward and backward against the plain version and its
autograd on the card (relu decisions replayed), a bit-identical second
backward, and one count per call. JAX is imported inside the CPU tests only.
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.strided import DENSE, output_length, stack_strided_block1_params
from uplift_upsample_torch.ops.strided_train import (ORDER, saved_relu_mask,
                                                     strided_block1_bwd_plain,
                                                     strided_block1_train,
                                                     strided_block1_train_plain,
                                                     strided_train_bwd, strided_train_fwd)
from uplift_upsample_torch.ops.temporal import add_tf32_halves
from uplift_upsample_torch.utils.weights_h5 import params_from_jax

torch.set_num_threads(1)  # six xdist workers share the CPU cores


def assert_grad_close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-3)
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=2e-3, err_msg=what)


def _ops_of(params, pe, device="cpu"):
    """Flax block params and PE → the port's operands (numpy → torch)."""
    import jax
    state = params_from_jax({"strided_temporal_block_1": jax.tree.map(np.asarray, params),
                             "strided_temporal_pe_1": np.asarray(pe)})
    return {k: v.to(device) for k, v in stack_strided_block1_params(state).items()}


def _setup(stride):
    try:
        from tests.test_fused_strided_train import _setup as jax_setup
    except ImportError:  # tests/ not on the import path as a package
        from test_fused_strided_train import _setup as jax_setup
    return jax_setup(stride=stride)


def _op_grads_to_flax(grads, c):
    """The port's operand grads → the flax block's parameter paths."""
    hidden = grads["w1"].shape[1]
    gq = grads["wqkv"].numpy()
    bq = grads["bqkv"].numpy()
    wc = grads["wc"].numpy().reshape(3, hidden, c)
    return {
        "norm1/scale": grads["ln1_g"], "norm1/bias": grads["ln1_b"],
        "attn/wq/kernel": gq[:, :c], "attn/wk/kernel": gq[:, c:2 * c],
        "attn/wv/kernel": gq[:, 2 * c:], "attn/wq/bias": bq[:c],
        "attn/wk/bias": bq[c:2 * c], "attn/wv/bias": bq[2 * c:],
        "attn/proj/kernel": grads["wp"], "attn/proj/bias": grads["bp"],
        "norm2/scale": grads["ln2_g"], "norm2/bias": grads["ln2_b"],
        "mlp/fc1/kernel": grads["w1"], "mlp/fc1/bias": grads["b1"],
        "mlp/fc2/kernel": wc, "mlp/fc2/bias": grads["bc"],
    }


@pytest.mark.parametrize("stride", [2, 3, 4])
def test_plain_matches_flax_block(stride):
    """Forward and the full VJP of the plain version against the flax block."""
    import jax
    import jax.numpy as jnp

    block, params, x, pe, _ = _setup(stride)
    b, n, c = x.shape
    n_out = output_length(n, stride, (0, 0))
    cot = np.random.default_rng(9).normal(size=(b, n_out, c)).astype(np.float32)

    def apply(p, xx, pp):
        return block.apply({"params": p}, xx, pos_encoding=pp, deterministic=True)[0]

    def fwd_bwd(p, xx, pp, ct):
        out, vjp = jax.vjp(apply, p, xx, pp)
        return out, vjp(ct)

    ref, (ref_p, ref_dx, ref_dpe) = jax.jit(fwd_bwd)(params, x, pe, jnp.asarray(cot))

    ops = {k: v.requires_grad_(True) for k, v in _ops_of(params, pe).items()}
    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    out = strided_block1_train_plain(xt, ops, num_heads=8, stride=stride)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    out.backward(torch.from_numpy(cot))
    assert_grad_close(xt.grad.numpy(), ref_dx, "dx")
    assert_grad_close(ops["pe"].grad.numpy(), ref_dpe, "dpe")
    ours = _op_grads_to_flax({k: v.grad for k, v in ops.items()}, c)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(ref_p)[0]}
    assert set(flat) == set(ours)
    for key, ref_g in flat.items():
        if key == "attn/wk/bias":  # true gradient 0 (softmax shift invariance)
            bar = 2e-4 * max(float(np.abs(flat["attn/wq/bias"]).max()), 1e-3)
            assert np.abs(np.asarray(ours[key])).max() <= bar
            assert np.abs(np.asarray(ref_g)).max() <= bar
            continue
        assert_grad_close(np.asarray(ours[key]), ref_g, key)


def test_plain_matches_interpret_kernel():
    """The plain forward against the interpret-mode Pallas kernel followed by
    its caller's slice (`train_step.py:280-282`), at s0 = 3."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_strided_bwd import fused_strided_block1_train

    _, params, x, pe, stride = _setup(3)
    n = x.shape[1]
    n_out = output_length(n, stride, (0, 0))
    with pltpu.force_tpu_interpret_mode():
        pre = jax.jit(lambda xx: fused_strided_block1_train(xx, (params, pe), 8, 4, n))(x)
        ref = np.asarray(pre[:, :(n_out - 1) * stride + 1:stride])
    got = strided_block1_train_plain(torch.from_numpy(np.array(x)), _ops_of(params, pe),
                                     num_heads=8, stride=stride)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors `strided_block1_train` is the plain version, forward and
    gradients bit for bit; the CUDA path refuses CPU tensors."""
    rng = np.random.default_rng(4)
    b, n, c, hidden = 3, 11, 16, 32
    ops = {"pe": rng.normal(size=(n, c)) * 0.1, "ln1_g": 1 + rng.normal(size=c) * 0.1,
           "ln1_b": rng.normal(size=c) * 0.1, "wqkv": rng.normal(size=(c, 3 * c)) * 0.2,
           "bqkv": rng.normal(size=3 * c) * 0.1, "wp": rng.normal(size=(c, c)) * 0.2,
           "bp": rng.normal(size=c) * 0.1, "ln2_g": 1 + rng.normal(size=c) * 0.1,
           "ln2_b": rng.normal(size=c) * 0.1, "w1": rng.normal(size=(c, hidden)) * 0.2,
           "b1": rng.normal(size=hidden) * 0.1, "wc": rng.normal(size=(3 * hidden, c)) * 0.1,
           "bc": rng.normal(size=c) * 0.1}
    ops = {k: torch.tensor(v, dtype=torch.float32) for k, v in ops.items()}
    x = torch.tensor(rng.normal(size=(b, n, c)), dtype=torch.float32)
    g = torch.tensor(rng.normal(size=(b, output_length(n, 2, (0, 0)), c)), dtype=torch.float32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in ops.items()}
    xg = x.clone().requires_grad_(True)
    out = strided_block1_train(xg, leaves, num_heads=4, stride=2)
    out.backward(g)
    ref = strided_block1_train_plain(x, ops, num_heads=4, stride=2)
    dx, grads = strided_block1_bwd_plain(x, ops, g, num_heads=4, stride=2)
    assert torch.equal(out.detach(), ref) and torch.equal(xg.grad, dx)
    for name in ORDER:
        assert torch.equal(leaves[name].grad, grads[name]), name
    with pytest.raises(ValueError, match="CUDA"):
        strided_train_fwd(x, ops, num_heads=4, stride=2)


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _grad_ok(got, ref, zero_at=None):
    if zero_at is not None:  # a true gradient of 0: both sides are float noise
        bar = 2e-4 * max(float(zero_at.abs().max()), 1e-3)
        return float(got.abs().max()) <= bar and float(ref.abs().max()) <= bar
    scale = max(float(ref.abs().max()), 1e-3)
    return bool(((got - ref).abs() <= 2e-4 * scale + 2e-3 * ref.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,hidden,stride,pads", [
    (64, 71, 384, 768, 3, (0, 0)),   # h36m_351's strided block 1
    (5, 27, 128, 256, 2, (0, 0)),    # taps overlap (s0 < 3)
    (7, 41, 128, 256, 4, (1, 1)),    # h36m_81's padded geometry
])
def test_strided_train_kernels_match_plain(b, n, c, hidden, stride, pads):
    """K6 forward and backward against the plain version and its autograd,
    with the kernel forward's relu decisions replayed on the plain side."""
    dev = _card()
    rng = np.random.default_rng(b + n)

    def rand(*shape, scale=0.1):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    ops = add_tf32_halves(dict(
        pe=rand(n, c), ln1_g=1 + rand(c), ln1_b=rand(c), wqkv=rand(c, 3 * c, scale=0.05),
        bqkv=rand(3 * c), wp=rand(c, c, scale=0.05), bp=rand(c), ln2_g=1 + rand(c),
        ln2_b=rand(c), w1=rand(c, hidden, scale=0.05), b1=rand(hidden),
        wc=rand(3 * hidden, c, scale=0.03), bc=rand(c)), DENSE)
    x = rand(b, n, c, scale=0.5)
    g = rand(b, output_length(n, stride, pads), c, scale=1.0)
    kw = dict(num_heads=8, stride=stride, paddings=pads)
    cuda_lib.reset_launches()
    out, saved = strided_train_fwd(x, ops, **kw)
    dx, grads = strided_train_bwd(saved, g, ops, **kw)
    dx2, again = strided_train_bwd(saved, g, ops, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["strided_train_fwd"] == 1
    assert cuda_lib.LAUNCHES["strided_train_bwd"] == 2
    assert torch.equal(dx, dx2) and all(torch.equal(again[k], grads[k]) for k in ORDER)
    mask = saved_relu_mask(saved)
    ref = strided_block1_train_plain(x, ops, **kw)
    assert float((out - ref).abs().max()) <= 2e-4 * max(1.0, float(ref.abs().max()))
    want_dx, want = strided_block1_bwd_plain(x, ops, g, relu_mask=mask, **kw)
    assert _grad_ok(dx, want_dx)
    for name in ORDER:
        if name == "bqkv":  # the key bias's third has a true gradient of 0
            assert _grad_ok(grads[name][c:2 * c], want[name][c:2 * c], want[name][:c])
            keep = torch.ones(3 * c, dtype=torch.bool, device=dev)
            keep[c:2 * c] = False
            assert _grad_ok(grads[name][keep], want[name][keep]), name
            continue
        assert _grad_ok(grads[name], want[name]), name


@pytest.mark.gpu
def test_strided_train_autograd_function_on_card():
    """`strided_block1_train` on CUDA tensors runs K6 under autograd and its
    gradients reach the operands."""
    dev = _card()
    rng = np.random.default_rng(0)
    b, n, c, hidden = 4, 27, 64, 128
    ops = {k: torch.tensor(v, dtype=torch.float32, device=dev).requires_grad_(True) for k, v in dict(
        pe=rng.normal(size=(n, c)) * 0.1, ln1_g=np.ones(c), ln1_b=np.zeros(c),
        wqkv=rng.normal(size=(c, 3 * c)) * 0.1, bqkv=np.zeros(3 * c),
        wp=rng.normal(size=(c, c)) * 0.1, bp=np.zeros(c), ln2_g=np.ones(c), ln2_b=np.zeros(c),
        w1=rng.normal(size=(c, hidden)) * 0.1, b1=np.zeros(hidden),
        wc=rng.normal(size=(3 * hidden, c)) * 0.1, bc=np.zeros(c)).items()}
    ops = add_tf32_halves(ops, DENSE)  # the TF32 halves K6's products read
    x = torch.tensor(rng.normal(size=(b, n, c)), dtype=torch.float32, device=dev,
                     requires_grad=True)
    cuda_lib.reset_launches()
    strided_block1_train(x, ops, num_heads=8, stride=3).square().sum().backward()
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["strided_train_fwd"] == 1
    assert cuda_lib.LAUNCHES["strided_train_bwd"] == 1
    assert x.grad is not None and all(ops[k].grad is not None for k in ORDER)
