"""bf16 activations in the port's training step against the JAX step, on the CPU.

The JAX step trains the flax model's bf16 modules (COMPUTE_DTYPE bfloat16):
on its plain path the whole model at bf16 under `value_and_grad`; with
TRAIN_FUSED_* its kernels keep fp32 operands (K1, the s2t Dense, the
temporal stack, strided block 1 and head1 in fp32) and only the tail
(strided blocks 2+ and head2) runs at bf16
(`uplift_upsample_tpu/parallel/train_step.py:226-288`). The port does the
same (`parallel/train_step.py`), its kernel stages through their plain
versions here.

Two bf16 computations that sum in another order part by about their whole
drift (`tests/test_torch_bf16_model.py`), so the port is held by its own
drift from the flax model at float32, in units of flax bf16's drift: within
[0.6, 1.6], as that file holds the forward, for the loss (the mean over the
batches of |loss - flax fp32 loss|) and for the gradients (the mean over
the batches and every element of |grad - flax fp32 grad| / the leaf's
largest fp32 gradient). Both paths in one test function: the plain path against the
flax model's, and the fused composition against the JAX step with
TRAIN_FUSED_SPATIAL, _TEMPORAL and _STRIDED on, its Pallas kernels in
interpret mode. 8 batches of 24 windows of an h36m_351-shaped model cut to
two blocks a stack (27 frames, C 32 spatial and 96 temporal, 8 heads), no
stochastic depth (the two packages draw it from different generators).
Measured on the CPU: plain 1.03 (loss) and 1.02 (gradients), fused 0.84
and 1.08; one batch alone scatters the loss's ratio from 0.004 to 14.
"""

import numpy as np
import pytest
import torch

from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.parallel.train_step import (batch_to_device, fused_stages,
                                                       make_loss_fn, step_generator)
from uplift_upsample_torch.utils.weights_h5 import params_from_jax

OVERRIDES = {
    "SEQUENCE_LENGTH": 27, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 32,
    "TEMPORAL_EMBED_DIM": 96, "SPATIAL_TRANSFORMER_BLOCKS": 2,
    "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3, 3],
    "PADDINGS": [[0, 0], [0, 0], [0, 0]], "NUM_HEADS": 8, "MASK_STRIDE": 5,
    "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1, "DROP_PATH_RATE": [0.0, 0.0, 0.0],
    "BATCH_SIZE": 24, "ROOT_KEYTPOINT": 6, "TRAIN_MATMUL_PRECISION": "high",
}
FUSED = dict(TRAIN_FUSED_SPATIAL=True, TRAIN_FUSED_TEMPORAL=True, TRAIN_FUSED_STRIDED=True)
BATCHES = 8
OWN = (0.6, 1.6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches():
    b, n = OVERRIDES["BATCH_SIZE"], OVERRIDES["SEQUENCE_LENGTH"]
    out = []
    for seed in range(BATCHES):
        rng = np.random.default_rng(seed)
        sm = (np.arange(n) % 5 == 0)[None].repeat(b, 0)
        sm[1] = np.roll(sm[1], 2)
        out.append((rng.normal(size=(b, n, 17, 3)).astype(np.float32) * 0.3,
                    (rng.normal(size=(b, n, 17, 2)) * 0.3).astype(np.float32),
                    np.ones((b, n), np.float32), np.zeros((b, 11), np.float32),
                    np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, np.int32), sm))
    return out


def _grad_dist(grads, ref):
    """Mean over the batches and every element of |g - ref| over the leaf's
    largest |ref|."""
    return float(np.mean([
        np.concatenate([((g[k] - r[k]).abs() / max(float(r[k].abs().max()), 1e-3))
                        .numpy().ravel() for k in r]).mean()
        for g, r in zip(grads, ref)]))


def test_bf16_training_held_by_its_drift():
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params
    from uplift_upsample_tpu.parallel.train_step import make_loss_fn as jax_loss_fn

    batches = _batches()
    jconfig = JaxConfig()
    jconfig.update_from(OVERRIDES)
    params = init_model_params(jax_build(jconfig), seed=0)["params"]
    rngs = {name: jax.random.PRNGKey(i)
            for i, name in enumerate(("dropout", "droppath", "token_mask"))}

    def flax(**over):
        """(losses, gradients) of the JAX step's loss over the batches."""
        config = JaxConfig()
        config.update_from({**OVERRIDES, **over})
        fn = jax.jit(jax.value_and_grad(jax_loss_fn(jax_build(config), config)))
        with pltpu.force_tpu_interpret_mode():
            out = [fn(params, tuple(jnp.asarray(a) for a in batch), rngs) for batch in batches]
        return (np.array([float(loss) for loss, _ in out]),
                [{k: v.double() for k, v in params_from_jax(
                    {"params": jax.tree.map(np.asarray, g)}).items()} for _, g in out])

    def port(**over):
        config = UpliftUpsampleConfig()
        config.update_from({**OVERRIDES, **over})
        model = build_uplift_upsample_transformer(config, device="cpu")
        model.load_state_dict(params_from_jax({"params": params}))
        assert model.dtype == torch.bfloat16
        assert fused_stages(model, config, kernels=True) == ((True,) * 3 if over.get(
            "TRAIN_FUSED_STRIDED") else (False,) * 3)
        loss_fn, losses, grads = make_loss_fn(model.train(), config), [], []
        for batch in batches:
            for p in model.parameters():
                p.grad = None
            loss = loss_fn(batch_to_device(batch, "cpu"), step_generator(0, 0))
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({k: p.grad.double() for k, p in model.named_parameters()})
        return np.array(losses), grads

    loss32, grads32 = flax()
    for label, over in (("plain", {}), ("fused", FUSED)):
        f_loss, f_grads = flax(COMPUTE_DTYPE="bfloat16", **over)
        p_loss, p_grads = port(COMPUTE_DTYPE="bfloat16", **over)
        own_loss = np.abs(p_loss - loss32).mean() / np.abs(f_loss - loss32).mean()
        own_grad = _grad_dist(p_grads, grads32) / _grad_dist(f_grads, grads32)
        print(f"{label}: own drift {own_loss:.3f} (loss), {own_grad:.3f} (gradients) of "
              f"flax bf16's")
        assert OWN[0] <= own_loss <= OWN[1] and OWN[0] <= own_grad <= OWN[1], (
            label, own_loss, own_grad)


def test_spatial_kernels_alone_at_bf16(monkeypatch):
    """TRAIN_FUSED_SPATIAL alone at COMPUTE_DTYPE bfloat16: the spatial op
    (K1 / K4; its plain version here) on fp32 keypoints, then the model from
    the spatial stack's output at bf16, as the JAX step's
    `tail.apply(spatial_input=True)`: the s2t Dense and the temporal blocks
    see bf16, the temporal op is not called, the loss is finite."""
    from uplift_upsample_torch.parallel import train_step as ts

    seen = {}

    def recording(name, fn):
        def wrapper(x, *args, **kwargs):
            seen[name] = x.dtype
            return fn(x, *args, **kwargs)
        return wrapper

    for name in ("spatial_stack_train", "temporal_stack_train", "temporal_stack_plain"):
        monkeypatch.setattr(ts, name, recording(name, getattr(ts, name)))
    config = UpliftUpsampleConfig()
    config.update_from({**OVERRIDES, "COMPUTE_DTYPE": "bfloat16", "BATCH_SIZE": 4,
                        "TRAIN_FUSED_SPATIAL": True, "TRAIN_FUSED_TEMPORAL": False})
    model = build_uplift_upsample_transformer(config, device="cpu").train()
    assert fused_stages(model, config, kernels=True) == (True, False, False)
    for name in ("spatial_to_temporal_fc", "temporal_block_1"):
        model.get_submodule(name).register_forward_pre_hook(
            lambda m, args, name=name: seen.__setitem__(name, args[0].dtype))
    batch = [a[:4] for a in _batches()[0]]
    loss = make_loss_fn(model, config)(batch_to_device(batch, "cpu"), step_generator(0, 0))
    loss.backward()
    assert torch.isfinite(loss) and seen == {
        "spatial_stack_train": torch.float32, "spatial_to_temporal_fc": torch.bfloat16,
        "temporal_block_1": torch.bfloat16}
