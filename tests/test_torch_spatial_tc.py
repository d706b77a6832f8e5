"""K1 on the tensor cores (`csrc/spatial.cu`).

K1 walks tiles of 7 frames (119 token rows, padded to 128: eight m16 tiles,
one per warp of a group of 8 warps); two tiles per thread block, one per
group, share one block's weights staged as TF32 halves. Every dense product
(q|k|v, proj, fc1, fc2) runs on mma.sync in 3xTF32 with the warp's 16 rows
as M and K = C or 2C, each output one running sum in the tensor cores; the
LayerNorm statistics take two lanes per row, the attention one thread per
(frame, head, query).

CPU tests: a float64 emulation of K1's four products at C = 32 (K = 32, 64)
and C = 16, one running sum per output, held to the float64 criterion; the
kernel's partition of the frames (tiles of 7, two per thread block, the
blocks' grid-stride walk, the tail tile) run with the plain version per
tile, against the plain version on all frames; and the plain version with droppath scales against
the JAX package's `fused_spatial_stack` in interpret mode.

`gpu` tests: K1 at the serving call's 72,704 frames and at 1,031 (C = 32,
16; with and without droppath scales) against its plain version (2e-4 of the
output scale), float64 (at most 4x the plain version's error + 1e-6 of the
scale) and itself (bit for bit). JAX is not imported at the top, so the file
also runs on the card's machine:

    python -m pytest --noconftest -m gpu tests/test_torch_spatial_tc.py
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.ops import cuda_lib
from uplift_upsample_torch.ops.spatial import (make_droppath_scales, spatial_stack,
                                               spatial_stack_plain, stack_spatial_params)

try:  # the card's machine collects tests/ without the package's conftest
    from tests.test_torch_gemm_tc import _emulate_3xtf32, _f64_ok
    from tests.test_torch_kernels import _spatial_tree, _state
except ImportError:  # pragma: no cover
    from test_torch_gemm_tc import _emulate_3xtf32, _f64_ok
    from test_torch_kernels import _spatial_tree, _state

TF, PADDED, GROUPS = 7, 128, 2  # frames per tile, rows padded; tiles per block
SMS = 132


# -- CPU --------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(32, 96), (32, 32), (32, 64), (64, 32),
                                 (16, 48), (16, 16), (16, 32), (32, 16)])
def test_k1_products_emulation_meets_float64_criterion(k, n):
    """q|k|v (C -> 3C), proj (C -> C), fc1 (C -> 2C) and fc2 (2C -> C) at
    C = 32 and 16 as K1 computes them: per 8-deep step three TF32 products
    added by the tensor cores into one running sum per output (rounding
    toward zero), no fp32 partials. Over the rows of 8 tiles, LN-like
    inputs and the tests' weight scale, the error against float64 is at most
    4x the fp32 plain version's plus 1e-6 of the scale; so it is with a fresh
    partial per step (K4's accumulation)."""
    rng = np.random.default_rng(k * n)
    a = rng.normal(size=(8 * PADDED, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    plain = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy().astype(np.float64)
    for promote in (None, 1):  # K1's running sum; K4's fresh partials
        got = _emulate_3xtf32(a, b, k, promote).astype(np.float64)
        ok, err, err_plain = _f64_ok(got, plain, ref64)
        assert ok, (promote, err, err_plain)


def _spatial_case(seed, f, c, heads, blocks, scaled):
    rng = np.random.default_rng(seed)
    ops = stack_spatial_params(_state(_spatial_tree(rng, c, blocks)), blocks)
    x = torch.from_numpy((rng.normal(size=(f, 17, 2)) * 0.5).astype(np.float32))
    scales = None
    if scaled:
        gen = torch.Generator().manual_seed(seed)
        scales = make_droppath_scales(gen, [0.1 * (i + 1) for i in range(blocks)], f).float()
    return ops, x, scales, heads


@pytest.mark.parametrize("f", [1, 6, 7, 8, 15, 1031])
def test_k1_tile_partition_matches_plain(f):
    """The kernel's partition: tiles of 7 frames (the last one short), tile
    pairs (2b, 2b + 1) on thread block b of min(132, ceil(tiles / 2)),
    stepping by twice the grid; each frame is taken once, and the plain
    version per tile (its scales' columns with it) gives the plain version on
    all frames."""
    c, heads, blocks = 16, 4, 2
    ops, x, scales, heads = _spatial_case(3, f, c, heads, blocks, scaled=True)
    tiles = -(-f // TF)
    grid = min(SMS, -(-tiles // GROUPS))
    got = torch.full((f, 17 * c), float("nan"))
    taken = np.zeros(f, int)
    for b in range(grid):
        for base in range(GROUPS * b, tiles, GROUPS * grid):
            for tile in range(base, min(base + GROUPS, tiles)):
                f0 = tile * TF
                nf = min(TF, f - f0)
                assert 0 < nf and nf * 17 <= PADDED
                sl = slice(f0, f0 + nf)
                taken[sl] += 1
                got[sl] = spatial_stack_plain(x[sl], ops, num_heads=heads,
                                              droppath_scales=scales[:, sl])
    assert (taken == 1).all()
    if f == 1031:
        assert tiles == 148 and f - (tiles - 1) * TF == 2
    want = spatial_stack_plain(x, ops, num_heads=heads, droppath_scales=scales)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-6 * max(1.0, float(want.abs().max())))


def test_spatial_plain_with_scales_matches_pallas():
    """K1's plain version with droppath scales (keep 0.75) against the JAX
    package's `fused_spatial_stack` with droppath scales (the forward of
    `fused_spatial_train`), interpret mode under jit, HIGHEST dots: 128
    frames (one TPU block), C = 16, 2 blocks; the TPU kernel's approximate
    erf is within 1.5e-7 of the exact one, so 2e-5 holds."""
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.ops.pallas_spatial import fused_spatial_stack
    from uplift_upsample_tpu.ops.pallas_spatial import stack_spatial_params as jax_stack

    rng = np.random.default_rng(21)
    c, heads, blocks, f = 16, 4, 2, 128
    params = _spatial_tree(rng, c, blocks)
    x = (rng.normal(size=(f, 17, 2)) * 0.5).astype(np.float32)
    scales = ((rng.uniform(size=(2 * blocks, f)) < 0.75) / 0.75).astype(np.float32)
    run = jax.jit(lambda st, xt, sc: fused_spatial_stack(
        xt, st, num_blocks=blocks, num_heads=heads, droppath_scales=sc,
        precision=jax.lax.Precision.HIGHEST))
    with pltpu.force_tpu_interpret_mode():
        ref = run(jax_stack(params, blocks), jax.numpy.asarray(x.transpose(1, 2, 0)),
                  jax.numpy.asarray(scales))
    ref = np.asarray(ref).transpose(2, 0, 1).reshape(f, -1)
    ops = stack_spatial_params(_state(params), blocks)
    got = spatial_stack(torch.from_numpy(x), ops, num_heads=heads,
                        droppath_scales=torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


# -- gpu --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("c,heads", [(32, 8), (16, 4)])
@pytest.mark.parametrize("f", [72704, 1031])
def test_k1_kernel_matches_plain_float64_and_itself(f, c, heads, scaled):
    """K1 at four blocks against its plain version (2e-4 of the output
    scale), float64 (at most 4x the plain version's error + 1e-6 of the
    scale) and a second call (bit for bit); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    ops, x, scales, heads = _spatial_case(7, f, c, heads, 4, scaled)
    ops = {k: v.to(dev) for k, v in ops.items()}
    x = x.to(dev)
    scales = None if scales is None else scales.to(dev)
    cuda_lib.reset_launches()
    got = spatial_stack(x, ops, num_heads=heads, droppath_scales=scales)
    again = spatial_stack(x, ops, num_heads=heads, droppath_scales=scales)
    assert cuda_lib.LAUNCHES["spatial_stack"] == 2
    ref = spatial_stack_plain(x, ops, num_heads=heads, droppath_scales=scales)
    ref64 = spatial_stack_plain(x.double(), {k: v.double() for k, v in ops.items()},
                                num_heads=heads,
                                droppath_scales=None if scales is None else scales.double())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 2e-4 * max(1.0, float(ref.abs().max()))
    ok, err, err_plain = _f64_ok(got.double().cpu().numpy(), ref.double().cpu().numpy(),
                                 ref64.cpu().numpy())
    assert ok, (err, err_plain)
