"""Config → model factory (parity with reference
`uplift_upsample_transformer_constructor.py:14-50`)."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import UpliftUpsampleConfig
from ..parallel.sharding import TensorParallel, active, shard_params_tp
from .uplift_upsample import UpliftUpsampleTransformer


def resolve_device(device="cuda") -> torch.device:
    """Entry points default to the card; without one they raise instead of
    quietly running on the CPU. A caller that wants the CPU says so."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU through the kernels' plain versions")
    return device


def config_has_strided_input(config: UpliftUpsampleConfig) -> bool:
    ms = config.MASK_STRIDE
    if ms is None:
        return False
    if isinstance(ms, int) and ms == 1:
        return False
    if isinstance(ms, list) and ms[0] == 1:
        return False
    return True


def model_kwargs(config: UpliftUpsampleConfig) -> dict:
    """The model's constructor arguments from a config."""
    dtype = getattr(config, "COMPUTE_DTYPE", "float32")
    if dtype != "float32":
        raise ValueError(f"COMPUTE_DTYPE {dtype!r}: the port runs float32 only")
    spatial_dtype = getattr(config, "SPATIAL_COMPUTE_DTYPE", None)
    if spatial_dtype not in (None, "float32"):
        raise ValueError(f"SPATIAL_COMPUTE_DTYPE {spatial_dtype!r}: the port runs float32 only")
    return dict(
        full_output=not config.USE_REFINE,
        num_frames=config.SEQUENCE_LENGTH,
        num_keypoints=config.NUM_KEYPOINTS,
        spatial_d_model=config.SPATIAL_EMBED_DIM,
        temporal_d_model=config.TEMPORAL_EMBED_DIM,
        spatial_depth=config.SPATIAL_TRANSFORMER_BLOCKS,
        temporal_depth=config.TEMPORAL_TRANSFORMER_BLOCKS,
        strides=tuple(config.STRIDES),
        paddings=None if config.PADDINGS is None else tuple(map(tuple, config.PADDINGS)),
        num_heads=config.NUM_HEADS,
        mlp_ratio=config.MLP_RATIO,
        qkv_bias=config.QKV_BIAS,
        drop_path_rate=(tuple(config.DROP_PATH_RATE)
                        if isinstance(config.DROP_PATH_RATE, list) else config.DROP_PATH_RATE),
        output_bn=config.OUTPUT_BN,
        has_strided_input=config_has_strided_input(config),
        first_strided_token_attention_layer=config.FIRST_STRIDED_TOKEN_ATTENTION_LAYER,
        token_mask_rate=config.TOKEN_MASK_RATE,
        learnable_masked_token=config.LEARNABLE_MASKED_TOKEN,
        use_pallas=bool(getattr(config, "USE_PALLAS_ATTENTION", False)),
    )


def build_uplift_upsample_transformer(config: UpliftUpsampleConfig,
                                      device="cuda", seed: int = 0,
                                      tp: Optional[TensorParallel] = None,
                                      **overrides) -> UpliftUpsampleTransformer:
    """Build the model in eval mode on `device`, initialised from `seed`.

    Glorot-uniform kernels, zero biases and truncated-normal(0.02) PEs and
    tokens, drawn from a seeded CPU `torch.Generator` (the same seed gives the
    same weights on every device; not the JAX package's numbers, which come
    from jax.random).

    With `tp` (mp > 1) the model holds mp rank tp.rank's shard of the same
    seeded weights (`parallel.sharding.shard_params_tp`); its
    `load_state_dict` takes such shards.
    """
    device = resolve_device(device)
    kwargs = model_kwargs(config)
    kwargs.update(overrides)
    generator = torch.Generator().manual_seed(seed)
    model = UpliftUpsampleTransformer(generator=generator, **kwargs)
    tp = active(tp)
    if tp is not None:
        full = model.state_dict()
        model = UpliftUpsampleTransformer(generator=torch.Generator().manual_seed(seed),
                                          tp=tp, **kwargs)
        model.load_state_dict(shard_params_tp(full, tp.rank, tp.size))
    return model.to(device).eval()
