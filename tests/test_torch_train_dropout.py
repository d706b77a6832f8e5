"""Dropout and token masking in the port's training step, on the CPU.

The JAX step trains DROP_RATE, ATTENTION_DROP_RATE and TOKEN_MASK_RATE on
its plain path (any of them above 0 turns its kernels off,
`uplift_upsample_tpu/parallel/train_step.py:174-179`), and so does the
port (`parallel/train_step.py`: the model applied whole, its Dropout sites
in `models/primitives.py`). At a small config:

  - one step's loss (rtol 1e-5) and every gradient (the grad bar of
    `tests/test_train.py:448-451`) against the JAX `make_loss_fn` with all
    three knobs above 0. The flax model's keep masks are read back from
    `capture_intermediates` (a kept element is a non-zero output; where the
    input is zero the output and gradient are the same either way) and its
    token mask is recorded by wrapping `jax.random.uniform` with
    monkeypatch on an eager apply; both are fed to the port's sites through
    the test hooks `Dropout.fixed_keep` and `fixed_token_mask`;
  - USE_PALLAS_ATTENTION with ATTENTION_DROP_RATE > 0 takes the split-head
    path, as the JAX gate does (`models/primitives.py:95`): its step equals
    the use_pallas=False model's under the same draws, bit for bit;
  - the port's own draws: each site's keep share, and the token mask's
    share, within 4σ of 1 - rate (the central frame never masked); the
    same seed gives the same masks, another step other ones, and the three
    streams (stochastic depth, dropout, token mask) differ;
  - data parallel: 2 gloo ranks reproduce one process's steps (each site
    draws for the global batch and keeps the rank's rows), and so do
    dp x mp = 2 x 2 ranks (a site on a split tensor keeps the rank's
    block), within the bars of `tests/test_torch_parallel.py`;
  - OUTPUT_BN and token masking with LEARNABLE_MASKED_TOKEN raise in
    training, naming the JAX step's own failure (there is no function to
    match).
"""

import math

import numpy as np
import pytest
import torch

from torch_dp_workers import spawn, train_steps
from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.models.primitives import Dropout
from uplift_upsample_torch.parallel import make_optimizer, make_train_step
from uplift_upsample_torch.parallel.train_step import (batch_to_device, fused_stages,
                                                       make_loss_fn, stream_generator,
                                                       step_generator)
from uplift_upsample_torch.utils.weights_h5 import params_from_jax

_SMALL = {
    "SEQUENCE_LENGTH": 9, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 16,
    "TEMPORAL_EMBED_DIM": 32, "SPATIAL_TRANSFORMER_BLOCKS": 2,
    "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3],
    "PADDINGS": [[0, 0], [0, 0]], "NUM_HEADS": 4, "BATCH_SIZE": 8,
    "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1, "MASK_STRIDE": 3,
    "DROP_PATH_RATE": [0.0, 0.0, 0.0], "ROOT_KEYTPOINT": 0,
    "LOSS_WEIGHT_CENTER": 1.0, "LOSS_WEIGHT_SEQUENCE": 2.0,
    "DROP_RATE": 0.1, "ATTENTION_DROP_RATE": 0.15, "TOKEN_MASK_RATE": 0.3,
    "TRAIN_MATMUL_PRECISION": "high",  # fp32, as the JAX step on the CPU
    "OPTIMIZER": "AdamW", "OPTIMIZER_PARAMS": {}, "WEIGHT_DECAY": 4e-6,
    "EMA_ENABLED": True, "EMA_DECAY": 0.999, "SCHEDULE": "ExponentialDecay",
    "SCHEDULE_PARAMS": {"initial_learning_rate": 1e-4, "decay_steps": 6000,
                        "decay_rate": 0.99, "staircase": True},
}


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


def _batch(config, seed=0):
    """Random poses and per-window stride masks (8 columns, a generator's)."""
    rng = np.random.default_rng(seed)
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    phase = rng.integers(0, 3, size=b)
    sm = (np.arange(n)[None] + phase[:, None]) % 3 == 0
    return (rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.1,
            rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.1,
            np.ones((b, n), np.float32), np.zeros((b, 11), np.float32),
            np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, np.int32), sm)


def _sites(model):
    """{name: Dropout} of the sites whose rate is above 0."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, Dropout) and m.rate > 0}


def _loss_and_grads(config, model, batch, generator=None):
    for p in model.parameters():
        p.grad = None
    model.train()
    loss = make_loss_fn(model, config)(batch_to_device(batch, "cpu"),
                                       generator or step_generator(0, 0))
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


def _flax_draws(jmodel, params, batch, rngs, monkeypatch):
    """The flax model's keep masks, {port module path: [masks in creation
    order]}, and its token mask (B, N), from an eager training apply with
    the JAX step's rngs."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    sm = batch[-1]
    x = jnp.asarray(batch[1] * sm[:, :, None, None])
    uniform, draws = jax.random.uniform, []

    def record(key, shape=(), *args, **kwargs):
        out = uniform(key, shape, *args, **kwargs)
        draws.append((tuple(shape), np.asarray(out)))
        return out

    monkeypatch.setattr(jax.random, "uniform", record)
    _, state = jmodel.apply({"params": params}, x, stride_mask=jnp.asarray(sm), training=True,
                            rngs=rngs, mutable=["intermediates"],
                            capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
    monkeypatch.undo()
    masks = {}

    def walk(tree, path):
        for name, sub in tree.items():
            if name.startswith("Dropout_"):
                out = np.asarray(sub["__call__"][0])
                masks.setdefault(".".join(path), {})[int(name.split("_")[1])] = out != 0
            else:
                walk(sub, path + [name])

    walk(state["intermediates"], [])
    token = [a for shape, a in draws if shape == sm.shape]
    assert len(token) == 1, [shape for shape, _ in draws]
    return ({path: [by_index[i] for i in sorted(by_index)] for path, by_index in masks.items()},
            token[0])


def _feed(model, masks, token_uniform, rate):
    """The flax draws into the port's sites; every site is fed."""
    fed = set()
    for path, keeps in masks.items():
        parent = model.get_submodule(path) if path else model
        sites = [m for _, m in parent.named_children() if isinstance(m, Dropout) and m.rate > 0]
        assert len(sites) == len(keeps), path
        for site, keep in zip(sites, keeps):
            site.fixed_keep = torch.from_numpy(keep)
            fed.add(id(site))
    assert fed == {id(m) for m in _sites(model).values()}
    model.fixed_token_mask = torch.from_numpy(token_uniform < rate)


def test_step_matches_jax_with_dropout_and_token_mask(monkeypatch):
    import jax
    import jax.numpy as jnp
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.parallel.train_step import make_loss_fn as jax_loss_fn

    config = _config()
    jmodel = jax_build(config)
    params = init_model_params(jmodel, seed=0)["params"]
    batch = _batch(config, seed=1)
    rngs = {name: jax.random.PRNGKey(7 + i)
            for i, name in enumerate(("dropout", "droppath", "token_mask"))}
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(jmodel, config)))(
        params, tuple(jnp.asarray(a) for a in batch), rngs)
    masks, token = _flax_draws(jmodel, params, batch, rngs, monkeypatch)
    assert 0 < int((token < config.TOKEN_MASK_RATE).sum())

    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax({"params": params}))
    assert fused_stages(model, config, kernels=True) == (False, False, False)
    _feed(model, masks, token, config.TOKEN_MASK_RATE)
    loss, grads = _loss_and_grads(config, model, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = params_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    assert set(grads) == set(ref) and len(ref) > 20
    for key, g in grads.items():
        r = ref[key].numpy()
        scale = max(float(np.abs(r).max()), 1e-3)
        np.testing.assert_allclose(g.numpy(), r, atol=2e-4 * scale, rtol=2e-3, err_msg=key)
    # the masks matter: without them (the port's own draws) the loss moves
    for site in _sites(model).values():
        site.fixed_keep = None
    model.fixed_token_mask = None
    assert abs(float(_loss_and_grads(config, model, batch)[0]) - float(jloss)) > 1e-4


def test_pallas_with_attention_dropout_takes_the_split_path():
    """USE_PALLAS_ATTENTION trains with ATTENTION_DROP_RATE > 0 through the
    split-head path: loss and gradients equal to the use_pallas=False
    model's under the same seed."""
    config = _config(DROP_RATE=0.0, TOKEN_MASK_RATE=0.0, DROP_PATH_RATE=[0.1, 0.1, 0.0])
    runs = []
    for pallas in (True, False):
        config.USE_PALLAS_ATTENTION = pallas
        model = build_uplift_upsample_transformer(config, device="cpu", seed=2)
        assert model.spatial_block_1.attn.use_pallas == pallas
        runs.append(_loss_and_grads(config, model, _batch(config), step_generator(3, 5)))
    (loss_p, grads_p), (loss, grads) = runs
    assert torch.equal(loss_p, loss)
    assert all(torch.equal(grads_p[k], g) for k, g in grads.items())


def _draw_stats(model, config, generator):
    """{site: (kept, drawn)} and the token mask's (masked, drawn) of one
    training forward with the port's own draws."""
    for site in _sites(model).values():
        site.stats = []
    masked = []
    real = model._token_mask

    def token_mask(x):
        out = real(x)
        masked.append((out == 0).all(-1))
        return out

    model._token_mask = token_mask
    _loss_and_grads(config, model, _batch(config), generator)
    model._token_mask = real
    stats = {}
    for name, site in _sites(model).items():
        (kept, drawn), = site.stats
        stats[name] = (int(kept), drawn)
        site.stats = None
    return stats, masked[0]


def test_port_draws():
    """Keep shares within 4σ of 1 - rate at every site and the token mask's
    share within 4σ of its rate (never the central frame); the same seed and
    step give the same draws, another step other ones; the streams differ."""
    config = _config(BATCH_SIZE=64)
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    stats, masked = _draw_stats(model, config, step_generator(0, 4))
    assert len(stats) == 1 + 2 * 3 + 2 * 4 + 2 * 4  # embedding; spatial; temporal; strided
    for name, (kept, drawn) in stats.items():
        p = 1.0 - _sites(model)[name].rate
        assert abs(kept / drawn - p) <= 4 * math.sqrt(p * (1 - p) / drawn), (name, kept, drawn)
    mid = config.SEQUENCE_LENGTH // 2
    assert not masked[:, mid].any()
    others = torch.cat([masked[:, :mid], masked[:, mid + 1:]], 1)
    rate, count = config.TOKEN_MASK_RATE, others.numel()
    assert abs(others.float().mean() - rate) <= 4 * math.sqrt(rate * (1 - rate) / count)
    again, masked_again = _draw_stats(model, config, step_generator(0, 4))
    assert again == stats and torch.equal(masked_again, masked)
    other, masked_other = _draw_stats(model, config, step_generator(0, 5))
    assert other != stats and not torch.equal(masked_other, masked)
    g = step_generator(0, 4)
    first = [torch.rand(8, generator=gen) for gen in
             (step_generator(0, 4), stream_generator(g, 1, "cpu"), stream_generator(g, 2, "cpu"))]
    assert not any(torch.equal(a, b) for i, a in enumerate(first) for b in first[i + 1:])


def test_dp_ranks_reproduce_one_process(tmp_path):
    """3 steps on 2 gloo ranks against one process, dropout and token masking
    on (the ranks keep their rows of the global draws)."""
    config = _config(BATCH_SIZE=16, DROP_PATH_RATE=[0.1, 0.1, 0.0])
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [_batch(config, seed=s) for s in range(3)]
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    step = make_train_step(model, opt, config, device="cpu")
    losses = [float(step(state, batch)[1]) for batch in batches]
    torch.save(init, str(tmp_path / "init.pt"))
    out = tmp_path / "out"
    out.mkdir()
    spawn(train_steps, 2, tmp_path, config.to_dict(), str(tmp_path / "init.pt"), batches,
          str(out))
    ranks = [torch.load(str(out / f"rank{r}.pt"), weights_only=True) for r in range(2)]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for key in ("params", "ema"):
        for name, v in ranks[0][key].items():
            assert torch.equal(v, ranks[1][key][name]), (key, name)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=2e-5)
    for key, ref in (("params", model.state_dict()), ("ema", state.ema)):
        for name, v in ref.items():
            np.testing.assert_allclose(ranks[0][key][name].numpy(), v.detach().numpy(),
                                       atol=2e-4, err_msg=f"{key} {name}")


def test_tp_ranks_reproduce_one_process(tmp_path):
    """3 steps on dp x mp = 2 x 2 gloo ranks against one process, dropout and
    token masking on: a site on a split tensor (the attention weights' heads,
    the MLP's hidden channels) keeps the rank's block of the global draw,
    the others the rank's rows; the bars of
    `tests/test_torch_tensor_parallel.py`."""
    from torch_tp_workers import train_steps as tp_train_steps
    from uplift_upsample_torch.tools.dryrun_multichip import dry_config

    config = dry_config("tiny", 16)
    config.update_from(dict(DROP_RATE=0.1, ATTENTION_DROP_RATE=0.15, TOKEN_MASK_RATE=0.3,
                            DROP_PATH_RATE=[0.1, 0.1, 0.0]))
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    init = str(tmp_path / "init.pt")
    torch.save({k: v.clone() for k, v in model.state_dict().items()}, init)
    batches = [_batch(config, seed=s) for s in range(3)]
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    step = make_train_step(model, opt, config, device="cpu")
    losses = [float(step(state, batch)[1]) for batch in batches]
    out = tmp_path / "out"
    out.mkdir()
    spawn(tp_train_steps, 4, tmp_path, 2, 2, {"dropout": (config.to_dict(), init, batches)},
          str(out))
    for r in range(4):
        got = torch.load(str(out / f"rank{r}.pt"), weights_only=False)["dropout"]
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
        for key, ref in (("params", model.state_dict()), ("ema", state.ema)):
            for name, v in ref.items():
                np.testing.assert_allclose(got[key][name].numpy(), v.detach().numpy(),
                                           atol=2e-4, err_msg=f"rank {r} {key} {name}")


@pytest.mark.parametrize("over,match", [
    (dict(OUTPUT_BN=True), "ScopeCollectionNotFound"),
    (dict(LEARNABLE_MASKED_TOKEN=True), "ScopeParamNotFoundError"),
])
def test_what_the_jax_step_cannot_train_raises(over, match):
    """OUTPUT_BN and the learnable masked token raise in the step and in the
    model's training forward; eval still runs them."""
    config = _config(**over)
    model = build_uplift_upsample_transformer(config, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        make_loss_fn(model, config)
    x = torch.zeros(2, config.SEQUENCE_LENGTH, 17, 2)
    sm = torch.ones(2, config.SEQUENCE_LENGTH, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match=match):
        model.train()(x, sm)
    with torch.no_grad():
        assert model.eval()(x, sm)[1].shape == (2, 17, 3)
