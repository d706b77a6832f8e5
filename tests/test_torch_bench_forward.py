"""The eval-forward routes of the port against the JAX package's Pallas kernels.

CPU tests, one per TPU kernel row of the table in PERF.md that this module
group closes, each against the Pallas kernel in interpret mode (HIGHEST dots)
with the same numpy-made weights and inputs:
  - row 4 `fused_spatial_stack_tiled` (un-tiled, valid frames) against K1's
    plain version, 2e-5 (the spatial kernel's bar);
  - row 5 `fused_temporal_stack_v3_tiled` with the s2t prologue and the
    banded-selection epilogue against the s2t prologue, K2 and K3's plain
    versions; row 6 (banded v3 + banded epilogue); row 7 (the selection
    epilogue); row 8 `fused_strided_block1` at rows s0·t, strides 2-4; row 9
    `fused_temporal_block` through `temporal_stack_apply`, with and without a
    key mask; row 10, v2 `fused_temporal_stack`: 3e-5, the temporal and
    strided kernels' bar;
  - each `bench_forward` route of the port against the JAX `bench_forward`
    with the same keywords (the flagship geometry of tests/test_bench_forward.py
    and the h36m_81 kind), 5e-5 / 1e-4 (tests/test_bench_forward.py:113), and
    the ops each route reaches (the tiled route: one s2t prologue; no K3 on
    v2 or on h36m_81 banded).
The JAX side runs under `jax.jit` inside `force_tpu_interpret_mode`.

`gpu` tests: the s2t kernel against its plain version on the card, with and
without a stride mask. JAX is imported inside the CPU tests only, so this
file also runs where JAX is not installed (the card's machine).
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.s2t import (add_s2t_operands, s2t_prologue,
                                          s2t_prologue_plain)
from uplift_upsample_torch.ops.spatial import spatial_stack_apply, stack_spatial_params
from uplift_upsample_torch.ops.strided import (output_length, stack_strided_block1_params,
                                               strided_block1)
from uplift_upsample_torch.ops.temporal import (stack_temporal_params, temporal_stack,
                                                temporal_stack_apply)
from uplift_upsample_torch.utils.weights_h5 import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(**overrides):
    config = UpliftUpsampleConfig()
    config.update_from(overrides)
    return config


def _small(**overrides):
    """A narrow h36m_351-shaped model for the row tests: N=13, C 16/32."""
    return _config(**{
        "SEQUENCE_LENGTH": 13, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 16,
        "TEMPORAL_EMBED_DIM": 32, "SPATIAL_TRANSFORMER_BLOCKS": 1,
        "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3], "PADDINGS": [[0, 0], [0, 0]],
        "NUM_HEADS": 4, "MASK_STRIDE": 2, "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1,
        **overrides})


def _flagship_small(**overrides):
    """tests/test_bench_forward.py::_flagship_small: N=27, C=128, 2+2 blocks."""
    return _config(**{
        "SEQUENCE_LENGTH": 27, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 32,
        "TEMPORAL_EMBED_DIM": 128, "SPATIAL_TRANSFORMER_BLOCKS": 2,
        "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3, 3],
        "PADDINGS": [[0, 0], [0, 0], [0, 0]], "NUM_HEADS": 8, "MASK_STRIDE": 5,
        "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1, **overrides})


def _h36m_81_kind():
    """The h36m_81 geometry at the flagship's widths: paddings (1,1) in block 1
    (tests/test_bench_forward.py:262-264)."""
    return _flagship_small(STRIDES=[4, 4, 3], PADDINGS=[[1, 1], [0, 0], [0, 0]],
                           SEQUENCE_LENGTH=41, MASK_STRIDE=4)


def _models(config, seed):
    """The JAX model and params (every leaf moved off its initial value, so
    zero biases and unit LayerNorm scales are exercised too) and the port's
    model with the same weights."""
    import jax
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params

    jmodel = jax_build(config)
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(size=np.shape(a)) * 0.05).astype(np.float32),
        init_model_params(jmodel, seed=seed))
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax(variables))
    return jmodel, variables, model


def _stride_mask(rng, b, n, ms):
    """Per-window stride masks at random phases; frame 0 stays real so every
    window keeps a real key."""
    sm = (np.arange(n)[None] + rng.integers(0, ms, size=(b, 1))) % ms == 0
    sm[:, 0] = True
    return sm


def _tile(a, s_pad, wpt):
    """(B, N, ...) → (n_tiles, ..., wpt·s_pad): the TPU kernels' tile layout."""
    b, n = a.shape[:2]
    a = np.pad(a, [(0, 0), (0, s_pad - n)] + [(0, 0)] * (a.ndim - 2))
    a = a.reshape(b // wpt, wpt * s_pad, *a.shape[2:])
    return np.moveaxis(a, 1, -1)


# -- rows 4-10 against their Pallas kernels --------------------------------------

def test_row4_spatial_tiled_matches_k1():
    """fused_spatial_stack_tiled's (n_tiles, P·C, wpt·s_pad) output, un-tiled
    and cut to the valid frames, against K1's plain version on the B·N frames."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_spatial import fused_spatial_stack_tiled
    from uplift_upsample_tpu.ops.pallas_spatial import stack_spatial_params as jax_stack

    config = _small()
    _, variables, model = _models(config, 40)
    rng = np.random.default_rng(40)
    b, n, wpt = 4, config.SEQUENCE_LENGTH, 2
    s_pad = -(-n // 8) * 8
    x = (rng.normal(size=(b, n, 17, 2)) * 0.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out = fused_spatial_stack_tiled(
            _tile(x, s_pad, wpt), jax_stack(variables["params"], 1), num_blocks=1,
            num_heads=4, precision=jax.lax.Precision.HIGHEST)
    ref = np.moveaxis(np.asarray(out), 1, 2).reshape(b, s_pad, -1)[:, :n]
    state = model.state_dict()
    got = spatial_stack_apply(stack_spatial_params(state, 1), torch.from_numpy(x), num_heads=4)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


def _strided_ops_jax(params, n, heads, wpt, s_pad, tile_pe):
    from uplift_upsample_tpu.ops.pallas_strided import _OP_ORDER, stack_strided_block1_params

    sops = stack_strided_block1_params(params, n, weights_dtype=np.float32, num_heads=heads)
    ops = [sops[name] for name in _OP_ORDER]
    if tile_pe:  # the banded epilogues take the PE pre-tiled (C, wpt·s_pad)
        ops[-1] = np.tile(np.asarray(ops[-1]), (1, wpt))
    return ops


def test_row5_tiled_temporal_matches_s2t_k2_k3():
    """fused_temporal_stack_v3_tiled with the s2t prologue (Dense, token,
    PE), banded attention, the key mask in block 1 and the banded-selection
    epilogue against s2t_prologue_plain → temporal_stack_plain →
    strided_block1_plain; 4 windows in 2 tiles."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_strided import (make_strided_b1_epilogue_banded_sel,
                                                        make_strided_sel)
    from uplift_upsample_tpu.ops.pallas_temporal import stack_temporal_params as jax_stack
    from uplift_upsample_tpu.ops.pallas_temporal_v3 import fused_temporal_stack_v3_tiled

    config = _small()
    _, variables, model = _models(config, 50)
    params = variables["params"]
    rng = np.random.default_rng(50)
    b, n, c, heads, wpt, s0 = 4, config.SEQUENCE_LENGTH, 32, 4, 2, 3
    s_pad, n_out = -(-n // 8) * 8, output_length(n, s0, (0, 0))
    k = 17 * config.SPATIAL_EMBED_DIM
    sp = (rng.normal(size=(b, n, k)) * 0.5).astype(np.float32)
    sm = _stride_mask(rng, b, n, 2)
    fc = params["spatial_to_temporal_fc"]
    pe = np.pad(np.asarray(params["temporal_pe"]), ((0, s_pad - n), (0, 0)))
    s2t_ops = (np.asarray(fc["kernel"]).T, np.asarray(fc["bias"])[:, None],
               np.asarray(params["strided_input_token"])[:, None], np.tile(pe.T, (1, wpt)))
    ep_ops = tuple(_strided_ops_jax(params, n, heads, wpt, s_pad, True)) + tuple(
        make_strided_sel(wpt, s_pad, s0, n_out, shift=j) for j in range(3))
    with pltpu.force_tpu_interpret_mode():
        out = fused_temporal_stack_v3_tiled(
            _tile(sp, s_pad, wpt), jax_stack(params, 2), 1.0 - sm.astype(np.float32),
            num_blocks=2, num_heads=heads, s_in=n, first_masked_blocks=1,
            windows_per_tile=wpt, weights_dtype=np.float32,
            precision=jax.lax.Precision.HIGHEST, s2t_ops=s2t_ops,
            stride_mask=sm.astype(np.float32),
            epilogue=make_strided_b1_epilogue_banded_sel(heads, wpt, s_pad, c),
            epilogue_ops=ep_ops, out_width=wpt * n_out)
    ref = np.moveaxis(np.asarray(out), 1, 2).reshape(b, n_out, c)

    state = model.state_dict()
    s2t = dict(w=state["spatial_to_temporal_fc.weight"].t(),
               bias=state["spatial_to_temporal_fc.bias"],
               token=state["strided_input_token"], pe=state["temporal_pe"])
    smt = torch.from_numpy(sm)
    y = s2t_prologue_plain(torch.from_numpy(sp), s2t, smt)
    y = temporal_stack(y, stack_temporal_params(state, 2), 1.0 - smt.float(),
                       num_heads=heads, first_masked_blocks=1)
    got = strided_block1(y, stack_strided_block1_params(state), num_heads=heads,
                         stride=s0, paddings=(0, 0))
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("epilogue", ["banded", "sel"])
def test_rows6_7_temporal_epilogues_match_k2_k3(epilogue):
    """fused_temporal_stack_v3 with banded attention and the banded strided
    epilogue (row 6; the caller's row selection u = s0·t), or with full
    attention and the selection epilogue (row 7; the kernel selects), key
    mask in block 1, odd batch, against K2 → K3's plain versions."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_strided import (make_strided_b1_epilogue_banded,
                                                        make_strided_b1_epilogue_sel,
                                                        make_strided_sel)
    from uplift_upsample_tpu.ops.pallas_temporal import stack_temporal_params as jax_stack
    from uplift_upsample_tpu.ops.pallas_temporal_v3 import fused_temporal_stack_v3

    config = _small()
    _, variables, model = _models(config, 60)
    params = variables["params"]
    rng = np.random.default_rng(60)
    b, n, c, heads, s0 = 3, config.SEQUENCE_LENGTH, 32, 4, 3
    wpt = 1  # b = 3 is odd: the kernel halves windows_per_tile 4 → 1
    s_pad, n_out = -(-n // 8) * 8, output_length(n, s0, (0, 0))
    x = (rng.normal(size=(b, n, c)) * 0.5).astype(np.float32)
    km = 1.0 - _stride_mask(rng, b, n, 2).astype(np.float32)
    ops = _strided_ops_jax(params, n, heads, wpt, s_pad, epilogue == "banded")
    if epilogue == "banded":
        kw = dict(attn_mode="banded",
                  epilogue=make_strided_b1_epilogue_banded(heads, wpt, s_pad, c),
                  epilogue_ops=tuple(ops))
    else:
        kw = dict(epilogue=make_strided_b1_epilogue_sel(heads, wpt, s_pad, c),
                  epilogue_ops=tuple(ops) + tuple(make_strided_sel(wpt, s_pad, s0, n_out, j)
                                                  for j in range(3)),
                  out_width=wpt * n_out)
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(fused_temporal_stack_v3(
            x, jax_stack(params, 2), km, num_blocks=2, num_heads=heads,
            first_masked_blocks=1, windows_per_tile=4, weights_dtype=np.float32,
            precision=jax.lax.Precision.HIGHEST, **kw))
    ref = out[:, : (n_out - 1) * s0 + 1: s0] if epilogue == "banded" else out
    state = model.state_dict()
    y = temporal_stack(torch.from_numpy(x), stack_temporal_params(state, 2),
                       torch.from_numpy(km), num_heads=heads, first_masked_blocks=1)
    got = strided_block1(y, stack_strided_block1_params(state), num_heads=heads,
                         stride=s0, paddings=(0, 0))
    assert got.shape == ref.shape == (b, n_out, c)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("stride", [2, 3, 4])
def test_row8_strided_block1_pass_matches_k3(stride):
    """fused_strided_block1 (strided block 1 as its own pass, pre-selection
    (B, N_pad, C)) at rows s0·t against K3's plain version, which returns
    only those rows."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_strided import (fused_strided_block1,
                                                        stack_strided_block1_params as jax_sops)

    config = _small()
    _, variables, model = _models(config, 70 + stride)
    rng = np.random.default_rng(70 + stride)
    b, n, heads = 3, config.SEQUENCE_LENGTH, 4
    x = (rng.normal(size=(b, n, 32)) * 0.5).astype(np.float32)
    n_out = output_length(n, stride, (0, 0))
    with pltpu.force_tpu_interpret_mode():
        out = fused_strided_block1(
            x, jax_sops(variables["params"], n, weights_dtype=np.float32, num_heads=heads),
            num_heads=heads, weights_dtype=np.float32, precision=jax.lax.Precision.HIGHEST)
    ref = np.asarray(out)[:, : (n_out - 1) * stride + 1: stride]
    got = strided_block1(torch.from_numpy(x), stack_strided_block1_params(model.state_dict()),
                         num_heads=heads, stride=stride, paddings=(0, 0))
    assert got.shape == ref.shape == (b, n_out, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_row9_temporal_block_matches_k2(masked):
    """pallas_temporal.temporal_stack_apply, one fused_temporal_block per
    block, the key mask in both blocks or in none, against the port's
    temporal_stack_apply (K2 over one block at a time)."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_temporal import temporal_stack_apply as jax_apply

    config = _small()
    _, variables, model = _models(config, 80)
    rng = np.random.default_rng(80)
    b, n, heads = 3, config.SEQUENCE_LENGTH, 4
    x = (rng.normal(size=(b, n, 32)) * 0.5).astype(np.float32)
    km = 1.0 - _stride_mask(rng, b, n, 2).astype(np.float32) if masked else None
    fmb = 2 if masked else 0
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda p, a, m: jax_apply(
            p, a, m, num_blocks=2, num_heads=heads, first_masked_blocks=fmb,
            precision=jax.lax.Precision.HIGHEST))(variables["params"], x, km)
    got = temporal_stack_apply(stack_temporal_params(model.state_dict(), 2),
                               torch.from_numpy(x), None if km is None else torch.from_numpy(km),
                               num_heads=heads, first_masked_blocks=fmb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("fmb", [0, 1])
def test_row10_temporal_v2_matches_k2(fmb):
    """The v2 fused_temporal_stack (windows padded to 16 tokens, the pad
    token blocked; attn_mode "batched" as bench_forward runs it) with the key
    mask on the first `fmb` blocks, odd batch, against K2's plain version."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_temporal import fused_temporal_stack
    from uplift_upsample_tpu.ops.pallas_temporal import stack_temporal_params as jax_stack

    config = _small()
    _, variables, model = _models(config, 90 + fmb)
    rng = np.random.default_rng(90 + fmb)
    b, n, heads = 3, config.SEQUENCE_LENGTH, 4
    x = (rng.normal(size=(b, n, 32)) * 0.5).astype(np.float32)
    km = 1.0 - _stride_mask(rng, b, n, 2).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = fused_temporal_stack(x, jax_stack(variables["params"], 2), km, num_blocks=2,
                                   num_heads=heads, first_masked_blocks=fmb,
                                   precision=jax.lax.Precision.HIGHEST, attn_mode="batched")
    got = temporal_stack(torch.from_numpy(x), stack_temporal_params(model.state_dict(), 2),
                         torch.from_numpy(km), num_heads=heads, first_masked_blocks=fmb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


# -- the bench_forward routes ---------------------------------------------------

ROUTES = {  # name: (geometry, keywords, ops the port's route must reach)
    "default": (_flagship_small, {}, {"temporal_stack", "strided_block1"}),
    "strided_sel": (_flagship_small, dict(strided_sel=True),
                    {"temporal_stack", "strided_block1"}),
    "banded": (_flagship_small, dict(temporal_attn="banded"),
               {"temporal_stack", "strided_block1"}),
    "v2": (_flagship_small, dict(temporal_impl="v2"), {"temporal_stack"}),
    "tiled": (_flagship_small, dict(temporal_attn="banded", fuse_s2t=True),
              {"s2t_prologue", "temporal_stack", "strided_block1"}),
    "h36m_81_banded": (_h36m_81_kind, dict(temporal_attn="banded"), {"temporal_stack"}),
    "h36m_81_v2": (_h36m_81_kind, dict(temporal_impl="v2"), {"temporal_stack"}),
}


def _count_ops(monkeypatch, calls):
    import uplift_upsample_torch.models.bench_forward as bf

    for name in ("s2t_prologue", "temporal_stack", "strided_block1"):
        real = getattr(bf, name)
        monkeypatch.setattr(bf, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append(_n) or _r(*a, **kw))


@pytest.mark.parametrize("route", list(ROUTES))
def test_bench_forward_route_matches_jax(route, monkeypatch):
    """The port's bench_forward on a route against the JAX bench_forward with
    the same keywords (its Pallas kernels in interpret mode, HIGHEST dots),
    2 windows at mask stride 5 (h36m_81 kind: 4) with random phases; the
    route reaches exactly the ops listed (one call each)."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.models.bench_forward import bench_forward as jax_bench_forward

    from uplift_upsample_torch.models.bench_forward import bench_forward

    geometry, kw, expected = ROUTES[route]
    config = geometry()
    jmodel, variables, model = _models(config, 100 + len(route))
    rng = np.random.default_rng(100 + len(route))
    b, n = 2, config.SEQUENCE_LENGTH
    sm = _stride_mask(rng, b, n, config.MASK_STRIDE)
    xm = (rng.normal(size=(b, n, 17, 2)) * 0.3).astype(np.float32) * sm[:, :, None, None]
    hi = jax.lax.Precision.HIGHEST
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda v, x, m: jax_bench_forward(
            jmodel, v, x, m, spatial_precision=hi, temporal_precision=hi, **kw))(
                variables, xm, sm)
    calls = []
    _count_ops(monkeypatch, calls)
    got = bench_forward(model, torch.from_numpy(xm), torch.from_numpy(sm), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-4)
    assert sorted(calls) == sorted(expected), calls


def test_shared_spatial_routes_reach_their_ops(monkeypatch):
    """shared_spatial_forward takes the same routes (no tiled one): v2 runs
    no K3, strided_sel the same ops as the default, and all agree with the
    dense default route (2e-5, tests/test_bench_forward.py:203)."""
    from uplift_upsample_torch.models.bench_forward import bench_forward, shared_spatial_forward
    from uplift_upsample_torch.utils.dedup import dedup_rows

    config = _small()
    model = build_uplift_upsample_transformer(config, device="cpu", seed=3)
    rng = np.random.default_rng(3)
    b, n = 4, config.SEQUENCE_LENGTH
    stream = (rng.normal(size=(b + n - 1, 17, 2)) * 0.3).astype(np.float32)
    sm = np.zeros((b, n), bool)
    sm[:, ::2] = True
    xm = stream[np.arange(b)[:, None] + np.arange(n)] * sm[:, :, None, None]
    uniq, inv = dedup_rows(xm.reshape(b * n, -1))
    uq, idx = torch.from_numpy(uniq.reshape(-1, 17, 2)), torch.from_numpy(inv.reshape(b, n))
    smt = torch.from_numpy(sm)
    dense = bench_forward(model, torch.from_numpy(xm), smt)
    calls = []
    _count_ops(monkeypatch, calls)
    for kw, expected in ((dict(strided_sel=True), ["strided_block1", "temporal_stack"]),
                         (dict(temporal_attn="banded"), ["strided_block1", "temporal_stack"]),
                         (dict(temporal_impl="v2"), ["temporal_stack"])):
        calls.clear()
        got = shared_spatial_forward(model, uq, idx, smt, **kw)
        assert sorted(calls) == expected, (kw, calls)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="temporal_impl"):
        shared_spatial_forward(model, uq, idx, smt, temporal_impl="v1")


def test_s2t_wrapper_takes_plain_path_on_cpu():
    """A CPU tensor runs the plain version and launches nothing; a stride
    mask without the token raises."""
    rng = np.random.default_rng(5)
    sp = torch.from_numpy(rng.normal(size=(3, 7, 20)).astype(np.float32))
    ops = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for k, s in (("w", (20, 8)), ("bias", (8,)), ("token", (8,)), ("pe", (7, 8)))}
    sm = torch.from_numpy(rng.uniform(size=(3, 7)) < 0.5)
    cuda_lib.reset_launches()
    got = s2t_prologue(sp, ops, sm)
    torch.testing.assert_close(got, s2t_prologue_plain(sp, ops, sm), rtol=0, atol=0)
    assert sum(cuda_lib.LAUNCHES.values()) == 0
    # the model's order: Dense, then the token where the mask is 0, then the PE
    y = sp @ ops["w"] + ops["bias"]
    want = torch.where(sm[..., None], y, ops["token"]) + ops["pe"]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="token"):
        s2t_prologue(sp, dict(ops, token=None), sm)


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("b", [37, 1000])
def test_s2t_kernel_matches_plain(masked, b):
    """The s2t kernel against its plain version at the h36m_351 widths
    (K = 17·32, C = 384) on 37 and 1,000 windows of 71 frames (2,627 and
    71,000 rows, neither a multiple of the 128-row tile): fp32 sums over
    K = 544 in another order, 2e-4 of the output scale; and against a float64
    reference at most 4x the fp32 plain version's error plus 1e-6 of the
    output scale (3xTF32; one TF32 pass would miss). One launch."""
    dev = _card()
    rng = np.random.default_rng(7)
    n, k, c = 71, 544, 384
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
    ops = add_s2t_operands(dict(w=t(k, c) * 0.05, bias=t(c), token=t(c), pe=t(n, c)))
    sp = t(b, n, k)
    sm = torch.from_numpy(rng.uniform(size=(b, n)) < 0.5).to(dev) if masked else None
    cuda_lib.reset_launches()
    got = s2t_prologue(sp, ops, sm)
    ref = s2t_prologue_plain(sp, ops, sm)
    ref64 = s2t_prologue_plain(sp.double(), {key: v.double() for key, v in ops.items()}, sm)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["s2t_prologue"] == 1
    assert float((got - ref).abs().max()) <= 2e-4 * max(1.0, float(ref.abs().max()))
    err = float((got.double() - ref64).abs().max())
    err_plain = float((ref.double() - ref64).abs().max())
    assert err <= 4 * err_plain + 1e-6 * float(ref64.abs().max()), (err, err_plain)
