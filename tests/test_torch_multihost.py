"""The port's data-parallel feed and training CLI on the CPU (gloo).

  - `HostShardedBatcher` (FastH36mBatcher, FastAMASSBatcher) and the device
    feed's `plan_batches(rows=)` at world sizes 2 and 4: the ranks' rows of
    3 batches that straddle an epoch boundary concatenate bit for bit to the
    1-process batches, and equal the JAX package's `HostShardedBatcher` and
    device-feed plans on the same generator (tests/test_multihost.py:68-87);
  - `gather_rows` puts rows, tensors and numpy ids, back in rank order;
  - one 2-process run of `train_and_validate` (1 epoch on the host feed, then
    a resume to epoch 2 on the device feed, stochastic depth on): both
    ranks' metric histories are equal exactly, only rank 0 wrote under the
    run's directory, and the final weights and EMA meet the train bars of
    tests/test_torch_train.py against the same two runs in one process.

Torch runs on one thread: six xdist workers share the cores.
"""

import copy
import os

import numpy as np
import pytest
import torch

from torch_dp_workers import spawn, train_cli
from uplift_upsample_torch.data.multihost import HostShardedBatcher, host_row_slice

torch.set_num_threads(1)

SYNTH_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "synth")
H36M_3D = os.path.join(SYNTH_DIR, "data_3d_h36m.npz")
H36M_2D = os.path.join(SYNTH_DIR, "data_2d_h36m_synth.npz")
AMASS_DIR = os.path.join(SYNTH_DIR, "amass")


def _tiny(**over):
    """tests/test_train.py::_tiny_config (as tests/test_torch_train_cli.py)."""
    from uplift_upsample_torch.config import UpliftUpsampleConfig
    from uplift_upsample_torch.data.keypoint_order import H36MOrder17P
    config = UpliftUpsampleConfig()
    config.update_from(dict({
        "SEQUENCE_LENGTH": 9, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 16,
        "TEMPORAL_EMBED_DIM": 32, "SPATIAL_TRANSFORMER_BLOCKS": 1,
        "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3],
        "PADDINGS": [[0, 0], [0, 0]], "NUM_HEADS": 4, "MASK_STRIDE": [5, 10, 20],
        "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1, "BATCH_SIZE": 16,
        "DROP_PATH_RATE": [0.1, 0.1, 0.0], "EPOCHS": 1, "STEPS_PER_EPOCH": 3,
        "VALIDATION_INTERVAL": 1, "CHECKPOINT_INTERVAL": 1, "VALIDATION_EXAMPLES": 24,
        "OPTIMIZER": "AdamW", "OPTIMIZER_PARAMS": {}, "WEIGHT_DECAY": 4e-6,
        "SCHEDULE": "ExponentialDecay",
        "SCHEDULE_PARAMS": {"initial_learning_rate": 4e-5, "decay_steps": 6000,
                            "decay_rate": 0.99, "staircase": True},
        "EMA_ENABLED": True, "EMA_DECAY": 0.999,
        "STRIDE_MASK_RAND_SHIFT": True, "IN_BATCH_AUGMENT": True,
        "DATASET_VAL_3D_SUBSAMPLE_STEP": 10,
        "TRAIN_MATMUL_PRECISION": "high",  # the fp32 rung, as the JAX step on the CPU
    }, **over))
    config.AUGM_FLIP_KEYPOINT_ORDER = H36MOrder17P.flip_lr_indices()
    return config


def _generators(kind):
    """(the port's train generator, the JAX package's), from one config."""
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu import train as jax_train

    from uplift_upsample_torch import train as train_mod
    config = _tiny()
    jconfig = JaxConfig()
    jconfig.update_from(config.to_dict())
    if kind == "amass":
        return tuple(mod.create_amass_generators(AMASS_DIR, H36M_3D, cfg, "train_debug", None,
                                                 target_frame_rate=50, shuffle_seed=7)[0]
                     for mod, cfg in ((train_mod, config), (jax_train, jconfig)))
    return tuple(mod.create_h36m_generators(H36M_3D, H36M_2D, cfg, "train", None,
                                            shuffle_seed=7)[0]
                 for mod, cfg in ((train_mod, config), (jax_train, jconfig)))


def _same_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(want).tobytes(), what


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["h36m", "amass", "h36m_feed", "amass_feed"])
def test_host_sharded_rows_match_single_process(kind, world):
    from uplift_upsample_tpu.data import fast_batcher as jax_fb
    from uplift_upsample_tpu.data.device_feed import make_device_feed as jax_feed
    from uplift_upsample_tpu.data.multihost import HostShardedBatcher as JaxSharded

    from uplift_upsample_torch.data import fast_batcher
    from uplift_upsample_torch.data.device_feed import make_device_feed

    gen, jgen = _generators(kind.split("_")[0])
    name = "FastAMASSBatcher" if kind.startswith("amass") else "FastH36mBatcher"
    ours, theirs = getattr(fast_batcher, name), getattr(jax_fb, name)
    # 3 batches hold 1.2 epochs: the second crosses the boundary
    m = ours(copy.deepcopy(gen), batch_size=1)._epoch_plan()["m"]
    b = 4 * -(-int(0.4 * m) // 4)
    n_batches = 3

    def take(it):
        return [next(it) for _ in range(n_batches)]

    if kind.endswith("feed"):
        def stream(rank=None):
            rows = None if rank is None else host_row_slice(b, rank, world)
            return make_device_feed(ours(copy.deepcopy(gen), b), "cpu").plan_batches(rows)

        def jstream(rank):
            feed = jax_feed(theirs(copy.deepcopy(jgen), b))
            return feed.plan_batches(rows=host_row_slice(b, rank, world))
    else:
        def stream(rank=None):
            batcher = ours(copy.deepcopy(gen), b)
            if rank is None:
                return batcher.batches()
            sharded = HostShardedBatcher(batcher, rank, world)
            assert sharded.batch_size == b // world and len(sharded) == len(batcher)
            return sharded.batches()

        def jstream(rank):
            return JaxSharded(theirs(copy.deepcopy(jgen), b), process_index=rank,
                              process_count=world).batches()

    full = take(stream())
    ranks = [take(stream(r)) for r in range(world)]
    jranks = [take(jstream(r)) for r in range(world)]
    for k in range(n_batches):
        for col, want in enumerate(full[k]):
            for r in range(world):
                got, jgot = ranks[r][k][col], jranks[r][k][col]
                assert len(got) == b // world
                if kind.endswith("feed"):  # the JAX plans hold int32 indices
                    np.testing.assert_array_equal(got, np.asarray(jgot).astype(got.dtype),
                                                  err_msg=f"batch {k} col {col} rank {r} JAX")
                else:
                    _same_bits(got, jgot, f"batch {k} col {col} rank {r} vs JAX")
            _same_bits(np.concatenate([ranks[r][k][col] for r in range(world)]), want,
                       f"batch {k} col {col}")


def test_gather_rows_rank_order(tmp_path):
    """gather_rows on 2 gloo ranks: float tensors, int and bool numpy rows."""
    from torch_dp_workers import gather_check
    spawn(gather_check, 2, tmp_path, str(tmp_path))
    for r in range(2):
        got = torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
        np.testing.assert_array_equal(got["t"].numpy(), np.arange(8, dtype=np.float32))
        np.testing.assert_array_equal(got["ids"], np.array([0, 1, 10, 11], np.int32))
        np.testing.assert_array_equal(got["mask"], np.array([True, False, False, True]))


def _assert_weights_close(ours, ref, steps, lr0, what):
    """tests/test_torch_train.py::_assert_weights_close."""
    assert set(ours) == set(ref) and len(ref) > 20
    for key, w in ours.items():
        w, r = w.detach().numpy(), ref[key].numpy()
        if key.endswith("attn.wk.bias"):  # a noise walk: bound its reach
            np.testing.assert_allclose(w, r, atol=steps * lr0, err_msg=f"{what} {key}")
            continue
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(w, r, atol=1e-3 * scale, rtol=2e-3, err_msg=f"{what} {key}")


def test_two_rank_train_and_validate(tmp_path):
    """train_and_validate on 2 gloo ranks (local batch 8): epoch 1 on the host
    feed, then a resume to epoch 2 on the device feed, against the same two
    runs in one process."""
    from uplift_upsample_torch import train as train_mod

    data = dict(dataset_name="h36m", h36m_path=H36M_3D, dataset_2d_path=H36M_2D,
                train_subset="train", val_subset="val", test_subset=None)
    first = _tiny(TRAIN_DEVICE_FEED=False).to_dict()
    resume = _tiny(TRAIN_DEVICE_FEED=True, EPOCHS=2).to_dict()
    runs = [(first, data), (resume, dict(data, continue_training=True))]
    dp_dir, res_dir, one_dir = (str(tmp_path / d) for d in ("dp", "res", "one"))
    os.makedirs(res_dir)
    spawn(train_cli, 2, tmp_path, runs, dp_dir, res_dir)
    ranks = [torch.load(os.path.join(res_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    assert ranks[0]["histories"] == ranks[1]["histories"]
    assert ranks[1]["writes"] == [] and ranks[0]["writes"]
    assert train_mod.checkpoint_epochs(os.path.join(dp_dir, "checkpoints")) == [1, 2]

    hists = []
    for values, kwargs in runs:
        config = _tiny()
        config.update_from(values)
        hist, _, _ = train_mod.train_and_validate(config=config, out_dir=one_dir,
                                                  device="cpu", export_h5=False, **kwargs)
        hists.append(hist.to_dict())
    for (hist, _, _), ref in zip(ranks[0]["histories"], hists):
        assert hist["metrics"] == ref["metrics"]
        for name, series in ref["history"].items():
            got = np.asarray(hist["history"][name])
            want = np.asarray(series)
            np.testing.assert_array_equal(got[:, 0], want[:, 0], err_msg=name)
            if name == "loss":
                np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5, err_msg=name)
            else:  # mm: the eval tests' bar
                np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5, atol=1e-3,
                                           err_msg=name)
    saved = [torch.load(os.path.join(d, "checkpoints", "ckpt_0002.pt"), weights_only=True)
             for d in (dp_dir, one_dir)]
    steps, lr0 = 2 * 3, 4e-5
    _assert_weights_close(saved[0]["model"], saved[1]["model"], steps, lr0, "weights")
    _assert_weights_close(saved[0]["state"]["ema"], saved[1]["state"]["ema"], steps, lr0,
                          "EMA")
    assert saved[0]["state"]["step"] == saved[1]["state"]["step"] == steps
