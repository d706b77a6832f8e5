"""Bundled experiment configurations (parity with reference `config/*.json`).

Expressed as override dicts on top of the UpliftUpsampleConfig defaults;
`get_config(name)` builds a resolved config. The train/eval CLIs accept these
names directly in place of a JSON path, and `dump_json` writes the equivalent
standalone file.

Derived sequence-length chains (PE shapes, `uplift_upsample.strided_sequence_lengths`):
  h36m_351 : 71 →(s3,p0)→ 23 →(s10,p0)→ 3 →(s3,p0)→ 1   (351-frame receptive field)
  h36m_81  : 41 →(s4,p[1,1])→ 11 →(s4,p0)→ 3 →(s3,p0)→ 1 (81-frame field)
"""

from __future__ import annotations

import json

from .config import UpliftUpsampleConfig

_FLIP_ORDER = [5, 4, 3, 2, 1, 0, 6, 7, 8, 9, 10, 16, 15, 14, 13, 12, 11]

_COMMON_351 = dict(
    ARCH="UpliftUpsampleTransformer",
    SEQUENCE_LENGTH=71, SEQUENCE_STRIDE=5,
    SPATIAL_EMBED_DIM=32, TEMPORAL_EMBED_DIM=384,
    SPATIAL_TRANSFORMER_BLOCKS=4, TEMPORAL_TRANSFORMER_BLOCKS=4,
    STRIDES=[3, 10, 3], PADDINGS=[[0, 0], [0, 0], [0, 0]],
    NUM_HEADS=8, MLP_RATIO=2, QKV_BIAS=True,
    DROP_PATH_RATE=[0.1, 0.1, 0.0], DROP_RATE=0.0, ATTENTION_DROP_RATE=0.0,
    OUTPUT_BN=False, USE_REFINE=False,
    TOKEN_MASK_RATE=0.0, LEARNABLE_MASKED_TOKEN=False,
    MASK_STRIDE=[5, 10, 20], STRIDE_MASK_RAND_SHIFT=True,
    FIRST_STRIDED_TOKEN_ATTENTION_LAYER=1,
    NUM_KEYPOINTS=17, PADDING_TYPE="copy", TEST_STRIDED_EVAL=True,
    LOSS_WEIGHT_CENTER=0.5, LOSS_WEIGHT_SEQUENCE=0.5,
    ROOT_KEYTPOINT=6, AUGM_FLIP_KEYPOINT_ORDER=_FLIP_ORDER, AUGM_FLIP_PROB=0.5,
    IN_BATCH_AUGMENT=True, BATCH_SIZE=512,
    STEPS_PER_EPOCH=6000,
    DATASET_TRAIN_3D_SUBSAMPLE_STEP=1, DATASET_VAL_3D_SUBSAMPLE_STEP=4,
    DATASET_TEST_3D_SUBSAMPLE_STEP=1,
    VALIDATION_INTERVAL=1, VALIDATION_EXAMPLES=-1, EVAL_FLIP=True,
    EVAL_DISABLE_LEARNED_UPSAMPLING=False,
    OPTIMIZER="AdamW", OPTIMIZER_PARAMS={},
    SCHEDULE="ExponentialDecay",
    EMA_ENABLED=False, EMA_DECAY=None,
    CHECKPOINT_INTERVAL=10, BEST_CHECKPOINT_METRIC="AW-MPJPE",
    SHUFFLE_SEED=0, GPU_ID=0,
)

CONFIGS = {
    # H36M from scratch, N=71 @ stride 5 (351-frame receptive field)
    "h36m_351": dict(_COMMON_351, EPOCHS=120, WEIGHT_DECAY=4e-6, SCHEDULE_PARAMS={
        "initial_learning_rate": 4e-5, "decay_steps": 6000,
        "decay_rate": 0.99, "staircase": True}),
    # AMASS→H36M fine-tune: same model, 3 epochs at halved LR/WD
    "h36m_351_pt": dict(_COMMON_351, EPOCHS=3, WEIGHT_DECAY=2e-6, SCHEDULE_PARAMS={
        "initial_learning_rate": 2e-5, "decay_steps": 6000,
        "decay_rate": 0.99, "staircase": True}),
    # AMASS pre-training config (same architecture; no action-wise metric)
    "amass_351": dict(_COMMON_351, EPOCHS=100, WEIGHT_DECAY=4e-6, SCHEDULE_PARAMS={
        "initial_learning_rate": 4e-5, "decay_steps": 6000,
        "decay_rate": 0.99, "staircase": True},
        BEST_CHECKPOINT_METRIC="MPJPE", DATASET_VAL_3D_SUBSAMPLE_STEP=8,
        VALIDATION_INTERVAL=2),
    # H36M, N=41 @ stride 2 (81-frame receptive field), EMA enabled
    "h36m_81": dict(_COMMON_351, SEQUENCE_LENGTH=41, SEQUENCE_STRIDE=2,
                    STRIDES=[4, 4, 3], PADDINGS=[[1, 1], [0, 0], [0, 0]],
                    MASK_STRIDE=[4, 10, 20], BATCH_SIZE=256,
                    IN_BATCH_AUGMENT=False, EMA_ENABLED=True, EMA_DECAY=0.999,
                    VALIDATION_INTERVAL=2, EPOCHS=120, WEIGHT_DECAY=4e-6,
                    SCHEDULE_PARAMS={"initial_learning_rate": 4e-5,
                                     "decay_steps": 6000, "decay_rate": 0.99,
                                     "staircase": True}),
}


def get_config(name: str) -> UpliftUpsampleConfig:
    if name not in CONFIGS:
        raise KeyError(f"Unknown config {name!r}; available: {sorted(CONFIGS)}")
    config = UpliftUpsampleConfig()
    config.update_from(CONFIGS[name])
    return config


def resolve_config(name_or_path) -> UpliftUpsampleConfig:
    """Accept either a bundled config name or a JSON/txt file path."""
    if name_or_path is None:
        return UpliftUpsampleConfig()
    if name_or_path in CONFIGS:
        return get_config(name_or_path)
    return UpliftUpsampleConfig(config_file=name_or_path)


def dump_json(name: str, path: str) -> None:
    with open(path, "w") as f:
        json.dump(CONFIGS[name], f, indent=4, sort_keys=True)
