"""`uplift_upsample_torch.tools.fullscale_eval` at a cut volume on the CPU:
the eval CLI's loaders read the data it writes, its npz weights load into
the flagship model, and its parser reads the eval CLI's per-stride lines.
The full volume (~2.18 M eval samples) runs on the card."""

import pytest
import torch

from uplift_upsample_torch.configs import get_config
from uplift_upsample_torch.data import h36m_splits
from uplift_upsample_torch.eval import build_eval_generator
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.tools import fullscale_eval
from uplift_upsample_torch.utils.weights_npz import load_npz


def test_cut_volume_data_and_weights_load(tmp_path):
    test_frames = fullscale_eval.make_data(frames=(40, 70), data_dir=str(tmp_path))
    path_3d, path_2d, path_w = fullscale_eval.paths(str(tmp_path))
    config = get_config("h36m_351")
    config.MASK_STRIDE = 5
    gen = build_eval_generator(config, path_3d, path_2d, "test", verbose=False)
    assert h36m_splits.subjects_by_split["test"] == ["S9", "S11"]
    assert len(gen) == 4 * test_frames  # one eval sample per frame and camera
    # S9 has 15 actions x 2 variants, S11 lacks "Directions" (the real gap)
    assert len(gen.poses_3d) == 4 * (30 + 28)

    model = load_npz(path_w, build_uplift_upsample_transformer(config, device="cpu"))
    seeded = build_uplift_upsample_transformer(config, device="cpu", seed=0)
    for (name, a), b in zip(model.state_dict().items(), seeded.state_dict().values()):
        assert torch.equal(a, b), name

    with pytest.raises(FileNotFoundError, match="--make-data"):
        fullscale_eval.run(data_dir=str(tmp_path / "none"))


def test_parse_strides_reads_the_eval_cli_lines():
    lines = ["### Running evaluation for mask stride value: 5 ###",
             "Running evaluation on 'test' with 2181116 examples",
             "Eval wall attribution: batcher=20.1s other=1.0s total=80.0s gather=native(up to 8 threads)",
             "### Running evaluation for mask stride value: 10 ###",
             "Running evaluation on 'test' with 2181116 examples",
             "Eval wall attribution: batcher=19.0s other=1.0s total=100.0s gather=native(up to 8 threads)"]
    strides = fullscale_eval.parse_strides(lines)
    assert [s["mask_stride"] for s in strides] == ["5", "10"]
    assert [s["eval_samples"] for s in strides] == [2181116, 2181116]
    assert [s["protocol_frames_per_s"] for s in strides] == [2181116 / 80.0, 2181116 / 100.0]
    assert strides[1]["attribution"] == lines[-1]


def test_card_busy_profiles_one_stride(tmp_path, monkeypatch, capsys):
    """`--card-busy`'s run, on the CPU with run_eval stood in for
    (the model at full width is for the card): the JSON line's numbers come
    from the trace of that run."""
    import json

    import uplift_upsample_torch.eval as eval_mod

    calls = []

    def fake_run_eval(config, name, path_3d, path_2d, subset, weights_path, device):
        calls.append((config.MASK_STRIDE, name, subset, weights_path, device))
        torch.randn(32, 32) @ torch.randn(32, 32)
        print("Eval wall attribution: batcher=0.1s other=0.1s total=0.2s")

    monkeypatch.setattr(eval_mod, "run_eval", fake_run_eval)
    out = fullscale_eval.card_busy(data_dir=str(tmp_path), device="cpu")
    assert calls == [(10, "h36m", "test", fullscale_eval.paths(str(tmp_path))[2], "cpu")]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["card_busy_mask_stride"] == 10 and out["wall_s"] > 0
    assert (out["card_busy_s"], out["kernels"], out["lost_kernels"]) == (0.0, 0, 0)
    assert out["eval_loop_s"] == 0.2 and out["attribution"].endswith("total=0.2s")
    assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1
