"""The port's tensor-parallel layout (`parallel/sharding.py`) against the JAX
package's (`uplift_upsample_tpu/parallel/sharding.py`):

  - `param_spec` splits the same dim of every parameter of h36m_351, h36m_81
    and the tiny config as the JAX `param_spec`, through the JAX model's own
    parameter paths (`params_to_jax`'s names; flax kernels are the
    transposes of torch's weights);
  - `shard_params_tp` then `gather_params_tp` over 2 gloo ranks gives the
    full state back bit for bit;
  - the two traps: an mp rank's fused q|k|v matrix is its q, k and v shards
    side by side, and its conv operand the hidden shard inside every tap,
    both equal to those built from the JAX package's shards on a 1 x 2
    mesh of the 8 CPU devices;
  - K2's and K3's split passes (plain versions here, `tp=`) on 2 ranks
    against the unsplit ones at 1e-5;
  - mp that does not divide the heads or the hidden width raises.
"""

import numpy as np
import pytest
import torch

from torch_tp_workers import shard_gather, spawn, split_stacks
from uplift_upsample_torch.configs import get_config
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.ops.strided import stack_strided_block1_params, strided_block1
from uplift_upsample_torch.ops.temporal import stack_temporal_params, temporal_stack
from uplift_upsample_torch.parallel.sharding import (TensorParallel, param_spec,
                                                     shard_params_tp)
from uplift_upsample_torch.tools.dryrun_multichip import dry_config
from uplift_upsample_torch.utils.weights_h5 import params_from_jax, params_to_jax

torch.set_num_threads(1)


def _config(name):
    return dry_config("tiny", 16) if name == "tiny" else get_config(name)


def _jax_params(config):
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params

    jconfig = JaxConfig()
    jconfig.update_from(config.to_dict())
    jmodel = jax_build(jconfig)
    return jmodel, init_model_params(jmodel, seed=0)["params"]


def _flat(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from _flat(value, path)
        else:
            yield path, value


@pytest.mark.parametrize("name", ["h36m_351", "h36m_81", "tiny"])
def test_param_spec_matches_jax(name):
    import jax
    from uplift_upsample_tpu.parallel.sharding import param_spec as jax_spec

    config = _config(name)
    model = build_uplift_upsample_transformer(config, device="cpu")
    jax_tree = jax.eval_shape(lambda: _jax_params_shapes(config))
    jax_leaves = dict(_flat(jax_tree))
    ours = dict(_flat(params_to_jax(model.state_dict(), model)["params"]))
    assert ours.keys() == jax_leaves.keys()
    # each port state_dict entry, renamed as params_to_jax renames it
    names = {k: _flax_path(model, k) for k in model.state_dict()}
    assert set(names.values()) == set(ours)
    split = 0
    for key, path in names.items():
        leaf = jax_leaves[path]
        spec = tuple(jax_spec(path, leaf, "mp"))
        axis = spec.index("mp") if "mp" in spec else None
        # flax kernels are torch weights transposed: (in, out), (3, hidden, C)
        want = None if axis is None else leaf.ndim - 1 - axis if leaf.ndim > 1 else axis
        assert param_spec(key, model.state_dict()[key]) == want, (key, spec)
        split += want is not None
    assert split > 0


def _jax_params_shapes(config):
    return _jax_params(config)[1]


def _flax_path(model, key):
    *path, leaf = key.split(".")
    if path and leaf == "weight":
        module = model.get_submodule(".".join(path))
        leaf = "kernel" if isinstance(module, (torch.nn.Linear, torch.nn.Conv1d)) else "scale"
    return "/".join(path + [leaf])


def test_h36m_351_split_count():
    """10,073,856 of h36m_351's 10,404,902 parameters are split; an mp = 2
    rank holds half of each: q 192 of 384 rows, the conv 384 of 768 hidden
    channels."""
    model = build_uplift_upsample_transformer(get_config("h36m_351"), device="cpu")
    state = model.state_dict()
    split = sum(v.numel() for k, v in state.items() if param_spec(k, v) is not None)
    assert (split, sum(v.numel() for v in state.values())) == (10_073_856, 10_404_902)
    local = shard_params_tp(state, 1, 2)
    assert sum(v.numel() for v in local.values()) == 10_404_902 - split // 2
    assert local["temporal_block_1.attn.wq.weight"].shape == (192, 384)
    assert local["strided_temporal_block_1.mlp.fc2.weight"].shape == (384, 384, 3)


def test_shard_then_gather_is_bit_exact(tmp_path):
    model = build_uplift_upsample_transformer(dry_config("tiny", 16), device="cpu", seed=3)
    full = {k: v.clone() for k, v in model.state_dict().items()}
    init = str(tmp_path / "init.pt")
    torch.save(full, init)
    out = tmp_path / "out"
    out.mkdir()
    spawn(shard_gather, 2, tmp_path, 1, 2, init, str(out))
    ranks = [torch.load(str(out / f"rank{r}.pt"), weights_only=True) for r in range(2)]
    for r, got in enumerate(ranks):
        assert got["whole"].keys() == full.keys()
        for k, v in full.items():
            assert torch.equal(got["whole"][k], v), k
            assert torch.equal(got["local"][k], shard_params_tp(full, r, 2)[k]), k
    assert ranks[0]["local"]["temporal_block_1.attn.wq.weight"].shape == (16, 32)


def test_local_operands_are_the_jax_shards():
    """The traps of the fused operands: rank j's (C, 3·C/mp) qkv matrix and
    (3·hidden/mp, C) conv operand, from its shard of the state, equal the
    matrices built from the JAX package's shards of mp index j."""
    import jax
    from jax.sharding import Mesh
    from uplift_upsample_tpu.parallel.sharding import shard_params_tp as jax_shard

    config = dry_config("tiny", 16)
    rng = np.random.default_rng(2)  # values on the JAX model's parameter tree
    params = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                          jax.eval_shape(lambda: _jax_params_shapes(config)))
    state = params_from_jax({"params": params})
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "mp"))
    sharded = jax_shard(params, mesh, tp_axis="mp")

    def shard_of(leaf, j):
        dev = mesh.devices[0, j]
        return next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == dev)

    for j in range(2):
        t_ops = stack_temporal_params(shard_params_tp(state, j, 2), 2)
        s_ops = stack_strided_block1_params(shard_params_tp(state, j, 2))
        for blk in range(2):
            attn = sharded[f"temporal_block_{blk + 1}"]["attn"]
            want = np.concatenate([shard_of(attn[w]["kernel"], j)
                                   for w in ("wq", "wk", "wv")], axis=1)
            assert want.shape == (32, 48)
            np.testing.assert_array_equal(t_ops["wqkv"][blk].numpy(), want)
        kernel = shard_of(sharded["strided_temporal_block_1"]["mlp"]["fc2"]["kernel"], j)
        assert kernel.shape == (3, 32, 32)  # (taps, hidden / mp, C)
        np.testing.assert_array_equal(s_ops["wc"].numpy(), kernel.reshape(-1, 32))
        # a contiguous third of the whole fused matrix would differ
        whole = stack_temporal_params(state, 2)["wqkv"][0]
        assert not torch.equal(t_ops["wqkv"][0], whole[:, j * 48:(j + 1) * 48])


@pytest.mark.parametrize("mp", [2, 4])
def test_split_stacks_match_unsplit(tmp_path, mp):
    """K2 (2 blocks, key mask in block 1) and K3 split over mp ranks on their
    shards' operands against the unsplit passes at 1e-5; every rank returns
    the whole result."""
    config = dry_config("tiny", 16)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=1)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    init = str(tmp_path / "init.pt")
    torch.save(state, init)
    rng = np.random.default_rng(4)
    y = rng.normal(size=(6, 9, 32)).astype(np.float32)
    key_mask = (rng.uniform(size=(6, 9)) < 0.5).astype(np.float32)
    key_mask[:, 4] = 0.0
    t = temporal_stack(torch.from_numpy(y), stack_temporal_params(state, 2),
                       torch.from_numpy(key_mask), num_heads=4, first_masked_blocks=1)
    s = strided_block1(t, stack_strided_block1_params(state), num_heads=4, stride=3,
                       paddings=(0, 0))
    out = tmp_path / "out"
    out.mkdir()
    spawn(split_stacks, mp, tmp_path, 1, mp, config.to_dict(), init, (y, key_mask), str(out))
    for r in range(mp):
        got = torch.load(str(out / f"rank{r}.pt"), weights_only=True)
        assert got["wqkv"].shape == (2, 32, 3 * 32 // mp)
        np.testing.assert_allclose(got["temporal"].numpy(), t.numpy(), atol=1e-5)
        np.testing.assert_allclose(got["strided"].numpy(), s.numpy(), atol=1e-5)


@pytest.mark.parametrize("mp, what", [(3, "heads"), (2, "hidden")])
def test_mp_must_divide_heads_and_hidden(mp, what):
    config = dry_config("tiny", 16)
    if what == "hidden":  # the spatial stack's hidden width int(16 · 1.0625) = 17
        config.MLP_RATIO = 1.0625
    with pytest.raises(ValueError, match="does not divide the spatial stack"):
        build_uplift_upsample_transformer(config, device="cpu",
                                          tp=TensorParallel(0, mp, "gloo", None))


def test_shard_params_tp_raises_on_an_uneven_dim():
    state = {"temporal_block_1.mlp.fc1.weight": torch.zeros(6, 4)}
    with pytest.raises(ValueError, match="temporal_block"):
        shard_params_tp(state, 0, 4)
