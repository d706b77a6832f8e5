"""The port's config registry and bundled configs against the JAX package's."""

import os

import pytest

from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.configs import CONFIGS, get_config, resolve_config

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("name", ["h36m_351", "h36m_351_pt", "amass_351", "h36m_81"])
def test_bundled_config_matches_jax(name):
    from uplift_upsample_tpu.configs import get_config as jax_get_config

    ours, ref = get_config(name).to_dict(), jax_get_config(name).to_dict()
    assert list(ours) == list(ref)
    assert ours == ref


def test_registry_matches_jax():
    """Same keys and defaults, the ROOT_KEYTPOINT typo included."""
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.configs import CONFIGS as JAX_CONFIGS

    assert UpliftUpsampleConfig().to_dict() == JaxConfig().to_dict()
    assert UpliftUpsampleConfig.ROOT_KEYTPOINT == 6
    assert sorted(CONFIGS) == sorted(JAX_CONFIGS)


def test_fixture_config_loads():
    from uplift_upsample_tpu.configs import resolve_config as jax_resolve

    path = os.path.join(FIXTURE_DIR, "eval_small_config.json")
    config = resolve_config(path)
    assert config.SEQUENCE_LENGTH == 9 and config.MASK_STRIDE == [5, 10, 20]
    assert config.to_dict() == jax_resolve(path).to_dict()


def test_model_kwargs_match_jax_build():
    """The port's config → model mapping agrees with the JAX factory on every
    bundled config (dtype and dropout fields excepted: the port is fp32 and
    eval-only)."""
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build

    from uplift_upsample_torch.models.build import model_kwargs

    for name in CONFIGS:
        config = get_config(name)
        if isinstance(config.MASK_STRIDE, list):
            config.MASK_STRIDE = config.MASK_STRIDE[0]
        ref = jax_build(config)
        for key, value in model_kwargs(config).items():
            assert getattr(ref, key) == value, (name, key)
