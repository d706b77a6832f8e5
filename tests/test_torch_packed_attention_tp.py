"""USE_PALLAS_ATTENTION under tensor parallelism (mp > 1), on gloo ranks (CPU).

Under mp > 1 each rank's q, k and v hold whole heads (`num_heads // mp` of
them), so the packed attention op (row 11; its plain version on the CPU)
runs on the rank's heads with no collective, and the split proj and its
`reduce_from_tp` follow, as on the split-head path. The TP model's eval
forward at mp = 2 and dp × mp = 2 × 2 is held against the one-process
`use_pallas` model at 1e-5 × max |ref|, as `tests/test_torch_tensor_parallel.py`
holds the other split paths, with every attention layer calling the op on
the rank's heads.
"""

import numpy as np
import pytest
import torch

from torch_tp_workers import packed_forward, spawn
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.tools.dryrun_multichip import dry_config

torch.set_num_threads(1)


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)])
def test_pallas_split_matches_one_process(tmp_path, dp, mp):
    config = dry_config("tiny", 8)
    config.USE_PALLAS_ATTENTION = True
    model = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    init = str(tmp_path / "init.pt")
    torch.save(model.state_dict(), init)
    rng = np.random.default_rng(0)
    b, n = 8, config.SEQUENCE_LENGTH
    sm = (np.arange(n)[None] + rng.integers(0, 5, size=(b, 1))) % 5 == 0
    x = (rng.normal(size=(b, n, 17, 2)) * 0.3).astype(np.float32)
    with torch.no_grad():
        xm = torch.from_numpy(x) * torch.from_numpy(sm)[:, :, None, None].float()
        ref_full, ref_central = model(xm, torch.from_numpy(sm))
    out = tmp_path / "out"
    out.mkdir()
    spawn(packed_forward, dp * mp, tmp_path, dp, mp, config.to_dict(), init, (x, sm), str(out))
    heads = config.NUM_HEADS // mp
    layers = (config.SPATIAL_TRANSFORMER_BLOCKS + config.TEMPORAL_TRANSFORMER_BLOCKS
              + len(config.STRIDES))
    for r in range(dp * mp):
        full, central = torch.load(str(out / f"rank{r}.pt"), weights_only=False)
        for got, ref in ((full, ref_full), (central, ref_central)):
            tol = 1e-5 * float(ref.abs().max())
            np.testing.assert_allclose(got, ref.numpy(), atol=tol, rtol=0)
        calls = torch.load(str(out / f"rank{r}_calls.pt"), weights_only=False)
        assert len(calls) == layers and all(h == heads for _, h in calls)
        assert all(shape[-1] % heads == 0 for shape, _ in calls)
