"""The training rungs (TRAIN_MATMUL_PRECISION) on the CPU.

The JAX package has no CPU oracle at DEFAULT: XLA:CPU ignores it, so the
JAX step computes fp32 at every rung there. Its anchor stays the step at
"high" against the JAX step (`test_torch_train.py`, `test_torch_train_cli.py`,
`test_torch_parallel.py`, `test_torch_tensor_parallel.py`, which pin
"high"). Here, at small widths:

  - the rung map: each rung hands each stage the precision of
    `precision.train_rungs` (the JAX step's `sp_train_prec` /
    `tm_train_prec`; the plain products bf16 at "default" and "mixed"), on
    the kernels' path and on the plain stages; unknown values raise, in the
    step, the train CLI and the bench;
  - "high" and "highest" give the same bits and never reach a bf16 product;
  - every bf16 product site of the spatial stack, one K5 block and one K6
    block, forward and backward, takes two bf16-exact operands and sums
    them within fp32's accumulation bound of the float64 sum of the same
    operands; K6's PE gradient is the sum of the rounded input gradient;
  - under autograd the bf16 product's backward is the TPU's DEFAULT
    transpose: dX = round(g)·round(W)ᵀ and dW = round(X)ᵀ·round(g) with
    fp32 sums, for the model's Dense and conv and `precision.mm`;
  - the CLI and the bench put the rung into the step's config.
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch import precision
from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.parallel import make_optimizer, make_train_step
from uplift_upsample_torch.parallel import train_step as ts
from uplift_upsample_torch.precision import (Bf16Matmul, matmul_precision, mm, round_bf16,
                                             rung_conv1d, rung_linear, train_rungs)

_SMALL = dict(
    SEQUENCE_LENGTH=9, SEQUENCE_STRIDE=5, SPATIAL_EMBED_DIM=16, TEMPORAL_EMBED_DIM=32,
    SPATIAL_TRANSFORMER_BLOCKS=2, TEMPORAL_TRANSFORMER_BLOCKS=2, STRIDES=[3, 3],
    PADDINGS=[[0, 0], [0, 0]], NUM_HEADS=4, BATCH_SIZE=4, MASK_STRIDE=3,
    FIRST_STRIDED_TOKEN_ATTENTION_LAYER=1, DROP_PATH_RATE=[0.1, 0.1, 0.0],
    ROOT_KEYTPOINT=0, EMA_ENABLED=False)
TABLE = {"default": ("default", "default", "default"),
         "mixed": ("highest", "default", "default"),
         "high": ("high", "high", "high"),
         "highest": ("highest", "highest", "highest")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(**over):
    config = UpliftUpsampleConfig()
    config.update_from(dict(_SMALL, **over))
    return config


def _batch(seed=0, b=4, n=9):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 17, 3)).astype(np.float32) * 0.1,
            rng.normal(size=(b, n, 17, 2)).astype(np.float32) * 0.1,
            (np.arange(n) % 3 == 0)[None].repeat(b, 0))


def _steps(config, steps=2, seed=1):
    model = build_uplift_upsample_transformer(config, device="cpu", seed=seed)
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=False)
    step = make_train_step(model, opt, config, device="cpu")
    losses = [step(state, _batch(i))[1] for i in range(steps)]
    return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}


# -- the rung map -------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rung", ["default", "mixed", "high", "highest"])
def test_rung_map(monkeypatch, rung, fused):
    """Each stage receives the rung of section 1's table: the spatial kernels
    (K1 / K4) the first, K5 and K6 the second, the plain products (the s2t
    Dense, head1, the tail) and the stages that run plain the third."""
    seen = _rungs_seen(monkeypatch, rung, fused)
    sp, tm, plain = TABLE[rung]
    assert train_rungs(rung) == TABLE[rung]
    assert seen["plain"] == {plain}
    if fused:
        assert seen["spatial"] == {sp} and seen["temporal"] == {tm} and seen["strided"] == {tm}
        assert "spatial_plain" not in seen and "temporal_plain" not in seen
    else:
        assert seen["spatial_plain"] == {plain} and seen["spatial_attention"] == {plain}
        assert seen["temporal_plain"] == {plain}
        assert not {"spatial", "temporal", "strided"} & set(seen)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("unset", [None, ""])
def test_unset_rung_is_mixed(monkeypatch, capsys, tmp_path, unset, fused):
    """C8: a null or empty TRAIN_MATMUL_PRECISION (`Config.load` reads a JSON
    null as None) trains at "mixed", as the JAX step reads it
    (`uplift_upsample_tpu/parallel/train_step.py:218`): every stage gets
    "mixed"'s rung, and the CLI's log line names that map."""
    from uplift_upsample_torch import train

    assert _rungs_seen(monkeypatch, unset, fused) == _rungs_seen(monkeypatch, "mixed", fused)
    with pytest.raises(Exception):  # no dataset: it stops after the log line
        train.train_and_validate(config=_config(TRAIN_MATMUL_PRECISION=unset),
                                 out_dir=str(tmp_path), device="cpu", export_h5=False)
    assert f"rungs {TABLE['mixed']}" in capsys.readouterr().out


def _rungs_seen(monkeypatch, rung, fused):
    """{stage: the rungs it ran at} over one step at TRAIN_MATMUL_PRECISION
    `rung`, with the three kernel stages on (`fused`) or plain."""
    seen = {}

    def record(name, fn):
        def wrapper(*args, **kwargs):
            seen.setdefault(name, set()).add(kwargs.get("precision", "high"))
            if name == "spatial_plain":
                seen.setdefault("spatial_attention", set()).add(
                    kwargs.get("attention_precision", "highest"))
            return fn(*args, **kwargs)
        return wrapper

    for name, attr in (("spatial", "spatial_stack_train"),
                       ("spatial_plain", "spatial_stack_plain"),
                       ("temporal", "temporal_stack_train"),
                       ("temporal_plain", "temporal_stack_plain"),
                       ("strided", "strided_block1_train")):
        monkeypatch.setattr(ts, attr, record(name, getattr(ts, attr)))
    config = _config(TRAIN_MATMUL_PRECISION=rung, TRAIN_FUSED_SPATIAL=fused,
                     TRAIN_FUSED_TEMPORAL=fused, TRAIN_FUSED_STRIDED=fused)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=1)
    for module in (model.spatial_to_temporal_fc, model.temporal_fc):
        module.register_forward_hook(
            lambda m, i, o: seen.setdefault("plain", set()).add(precision.current()))
    opt, _, _ = make_optimizer(config)
    make_train_step(model, opt, config, device="cpu")(opt.init(model, ema=False), _batch())
    monkeypatch.undo()
    return seen


def test_unknown_rungs_raise(monkeypatch, tmp_path):
    """In the step, the train CLI (before any data is read) and the bench."""
    from uplift_upsample_torch import bench, train

    config = _config(TRAIN_MATMUL_PRECISION="bf16")
    model = build_uplift_upsample_transformer(config, device="cpu", seed=1)
    opt, _, _ = make_optimizer(config)
    with pytest.raises(ValueError, match="TRAIN_MATMUL_PRECISION 'bf16'"):
        make_train_step(model, opt, config, device="cpu")
    with pytest.raises(ValueError, match="TRAIN_MATMUL_PRECISION"):
        train.train_and_validate(config=config, out_dir=str(tmp_path), device="cpu",
                                 export_h5=False)
    with pytest.raises(SystemExit):
        bench.parse_args(["--train", "--train-precision", "bf16"])
    with pytest.raises(ValueError, match="TRAIN_MATMUL_PRECISION"):
        train_rungs("DEFAULT")


def test_class_default_is_the_bf16_rung():
    assert UpliftUpsampleConfig().TRAIN_MATMUL_PRECISION == "default"
    assert train_rungs("default") == ("default", "default", "default")


def test_fp32_rungs_same_bits_and_no_bf16_product(monkeypatch):
    """"high" and "highest" run the same code, bit for bit, on the kernels'
    path and the plain one, and no bf16 product is reached."""
    def forbidden(*args, **kwargs):
        raise AssertionError("a bf16 product at an fp32 rung")

    monkeypatch.setattr(precision, "bf16_product", forbidden)
    for fused in (True, False):
        flags = dict(TRAIN_FUSED_SPATIAL=fused, TRAIN_FUSED_TEMPORAL=fused,
                     TRAIN_FUSED_STRIDED=fused)
        (l_high, p_high), (l_highest, p_highest) = (
            _steps(_config(TRAIN_MATMUL_PRECISION=r, **flags)) for r in ("high", "highest"))
        assert all(torch.equal(a, b) for a, b in zip(l_high, l_highest))
        assert all(torch.equal(p_high[k], p_highest[k]) for k in p_high)


@pytest.mark.parametrize("rung", ["default", "mixed"])
def test_bf16_rungs_train_near_high(rung):
    """The bf16 rungs compute another function (the step moves) that stays
    near "high": losses within 2 % over two steps."""
    (l_rung, p_rung), (l_high, p_high) = (_steps(_config(TRAIN_MATMUL_PRECISION=r))
                                          for r in (rung, "high"))
    assert any(not torch.equal(p_rung[k], p_high[k]) for k in p_high)
    for a, b in zip(l_rung, l_high):
        assert abs(float(a) - float(b)) <= 0.02 * abs(float(b))


# -- every bf16 product site against float64 sums -----------------------------

def _capture(monkeypatch):
    sites = []

    def product(a, b):
        out = a @ b
        sites.append((a.detach().clone(), b.detach().clone(), out.detach().clone()))
        return out

    monkeypatch.setattr(precision, "bf16_product", product)
    return sites


def _check_sites(sites, least):
    """Both operands bf16-exact; the fp32 sum within γ_K of the float64 sum
    of the same operands (|fl(Σ) − Σ| ≤ K·u/(1 − K·u) · Σ|a·b|, u = 2^-24)."""
    assert len(sites) >= least, len(sites)
    for a, b, out in sites:
        assert torch.equal(round_bf16(a), a) and torch.equal(round_bf16(b), b)
        k = a.shape[-1]
        exact = a.double() @ b.double()
        bound = (k * 2.0 ** -24 / (1 - k * 2.0 ** -24)) * (a.double().abs() @ b.double().abs())
        assert bool(((out.double() - exact).abs() <= bound + 1e-30).all()), k


def _grads(out, leaves, seed=3):
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=out.shape).astype(np.float32))
    return torch.autograd.grad(out, leaves, g)


def test_spatial_stack_sites(monkeypatch):
    """K1 / K4's plain version at "default": the embedding and the dense
    layers, forward and backward (the 17-token attention stays fp32)."""
    from uplift_upsample_torch.ops.spatial import PARAM_ORDER, spatial_stack_train
    from uplift_upsample_torch.ops.spatial_bwd import spatial_stack_bwd_plain

    try:
        from tests.test_torch_spatial_bwd_tc import _spatial_case
    except ImportError:  # pragma: no cover
        from test_torch_spatial_bwd_tc import _spatial_case
    ops, x, scales, g, heads = _spatial_case(2, 21, 16, 4, 2)
    sites = _capture(monkeypatch)
    leaves = {k: ops[k].clone().requires_grad_(True) for k in PARAM_ORDER}
    out = spatial_stack_train(x, leaves, scales, num_heads=heads, precision="default")
    _grads(out, list(leaves.values()))
    # per block forward q, k, v, proj, fc1, fc2 and the embedding; backward dX
    # and dW of each (x takes no gradient here: not the embedding's dX)
    _check_sites(sites, 2 * 6 + 1 + 2 * (2 * 6 + 1) - 1)
    dparams, dx, dscales = spatial_stack_bwd_plain(x, ops, scales, g, num_heads=heads,
                                                   precision="default")
    assert all(torch.isfinite(t).all() for t in (*dparams.values(), dx, dscales))


def test_k5_block_sites(monkeypatch):
    """One K5 block at "default" (the key mask, droppath scales): qkv, the
    logits on q·1/sqrt(D), P·V, proj, fc1, fc2, and their backward."""
    from uplift_upsample_torch.ops.temporal import stack_temporal_params
    from uplift_upsample_torch.ops.temporal_train import ORDER, temporal_stack_train

    try:
        from tests.test_torch_train_rung_kernels import temporal_case
    except ImportError:  # pragma: no cover
        from test_torch_train_rung_kernels import temporal_case
    state, x, km, dp, _ = temporal_case(1, 3, 11, 32, 1)
    ops = stack_temporal_params(state, 1, precision="default")
    leaves = {k: ops[k].clone().requires_grad_(True) for k in ORDER}
    sites = _capture(monkeypatch)
    out = temporal_stack_train(x, leaves, km, dp, num_heads=4, first_masked_blocks=1,
                               precision="default")
    _grads(out, list(leaves.values()))
    _check_sites(sites, 6 + 2 * 6)
    # the logits' q operand is q·1/sqrt(D), rounded (the training kernel's)
    logits_a = sites[1][0]
    y = torch.nn.functional.layer_norm(x, (32,), ops["ln1_g"][0], ops["ln1_b"][0], 1e-5)
    qkv = round_bf16(y) @ round_bf16(ops["wqkv"][0]) + ops["bqkv"][0]
    q = qkv[..., :32].reshape(3, 11, 4, 8).transpose(1, 2)
    assert torch.equal(logits_a, round_bf16(q * (1.0 / 8 ** 0.5)))


def test_k6_block_sites(monkeypatch):
    """One K6 block at "default": its products and the conv's, and the PE's
    gradient as the sum over windows of the bf16-rounded input gradient."""
    from uplift_upsample_torch.ops.strided import DENSE
    from uplift_upsample_torch.ops.strided_train import ORDER, strided_block1_train
    from uplift_upsample_torch.ops.temporal import add_weight_operands

    rng = np.random.default_rng(5)
    b, n, c, hidden = 3, 11, 32, 64

    def rand(*shape, scale=0.1):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32)

    ops = add_weight_operands(dict(
        pe=rand(n, c), ln1_g=1 + rand(c), ln1_b=rand(c), wqkv=rand(c, 3 * c), bqkv=rand(3 * c),
        wp=rand(c, c), bp=rand(c), ln2_g=1 + rand(c), ln2_b=rand(c), w1=rand(c, hidden),
        b1=rand(hidden), wc=rand(3 * hidden, c), bc=rand(c)), DENSE, "default")
    leaves = {k: ops[k].clone().requires_grad_(True) for k in ORDER}
    x = rand(b, n, c, scale=0.5).requires_grad_(True)
    sites = _capture(monkeypatch)
    out = strided_block1_train(x, leaves, num_heads=4, stride=3, precision="default")
    dx, dpe = _grads(out, [x, leaves["pe"]])
    _check_sites(sites, 6 + 2 * 6)
    assert torch.allclose(dpe, round_bf16(dx).sum(0), rtol=0, atol=1e-6)
    assert not torch.allclose(dpe, dx.sum(0), rtol=0, atol=1e-6)


# -- the bf16 product under autograd -------------------------------------------

def test_bf16_gradients_are_the_tpu_transpose():
    """The gradient of the bf16 Dense: dX = round(g)·round(W)ᵀ and dW =
    round(X)ᵀ·round(g), fp32 sums (autograd of rounding casts would round
    dX's result instead); the same for `precision.mm` and the conv."""
    from uplift_upsample_torch.models.primitives import dense

    torch.manual_seed(0)
    layer = dense(24, 40, generator=torch.Generator().manual_seed(1))
    x = torch.randn(5, 7, 24, requires_grad=True)
    g = torch.randn(5, 7, 40)
    with matmul_precision("default"):
        y = layer(x)
    assert torch.equal(y, torch.nn.functional.linear(round_bf16(x), round_bf16(layer.weight),
                                                     layer.bias))
    y.backward(g)
    r = round_bf16
    assert torch.equal(x.grad, r(g) @ r(layer.weight))
    assert torch.equal(layer.weight.grad,
                       r(g).reshape(-1, 40).t() @ r(x).reshape(-1, 24))
    assert torch.allclose(layer.bias.grad, g.reshape(-1, 40).sum(0))
    assert not torch.equal(x.grad, r(g @ r(layer.weight)))  # the cast's backward

    a = torch.randn(3, 4, 6, 8, requires_grad=True)
    w = torch.randn(3, 4, 8, 5, requires_grad=True)
    h = torch.randn(3, 4, 6, 5)
    mm(a, w, "default").backward(h)
    assert torch.equal(a.grad, r(h) @ r(w).transpose(-1, -2))
    assert torch.equal(w.grad, r(a).transpose(-1, -2) @ r(h))

    xc = torch.randn(2, 6, 13, requires_grad=True)
    wc = torch.randn(4, 6, 3, requires_grad=True)
    gc = torch.randn(2, 4, 6)
    with matmul_precision("default"):
        rung_conv1d(xc, wc, None, 2).backward(gc)
    assert torch.equal(xc.grad, torch.nn.grad.conv1d_input(xc.shape, r(wc), r(gc), 2))
    assert torch.equal(wc.grad, torch.nn.grad.conv1d_weight(r(xc), wc.shape, r(gc), 2))
    with matmul_precision("high"):  # off the bf16 rung: the library's own product
        assert torch.equal(rung_linear(x, layer.weight), x @ layer.weight.t())
    assert Bf16Matmul.apply(a, w).shape == (3, 4, 6, 5)


# -- the CLI and the bench read the rung -----------------------------------------

class _Stop(Exception):
    pass


def test_bench_and_cli_put_the_rung_in_the_config(monkeypatch, capsys, tmp_path):
    """`bench --train --train-precision r` and the train CLI's log: the
    step's config carries the rung."""
    from uplift_upsample_torch import bench, parallel, train

    seen = []

    def capture(model, opt, config, **kwargs):
        seen.append(config.TRAIN_MATMUL_PRECISION)
        raise _Stop

    monkeypatch.setattr(parallel, "make_train_step", capture)
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    for rung in ("mixed", "default"):
        with pytest.raises(_Stop):
            bench.main(["--device", "cpu", "--train", "--batch", "2", "--iters", "4",
                        "--train-precision", rung])
    assert seen == ["mixed", "default"]
    assert "the port trains in fp32" not in capsys.readouterr().err

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(train, "create_h36m_generators", stop)
    with pytest.raises(_Stop):
        train.train_and_validate(config=_config(TRAIN_MATMUL_PRECISION="mixed"),
                                 out_dir=str(tmp_path), device="cpu", export_h5=False)
    out = capsys.readouterr().out
    assert "TRAIN_MATMUL_PRECISION='mixed': (spatial, temporal, plain) rungs " \
           "('highest', 'default', 'default')" in out
