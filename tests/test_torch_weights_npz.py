"""The port's npz weights (`utils/weights_npz.py`, `tools/convert_weights.py`)
against the JAX package's conversion tool, the `.h5` reader and the goldens,
and `--weights x.npz` in the eval and predict CLIs. All on the CPU.

The JAX tool is imported by path (`tools/convert_weights.py` is a script).
"""

import importlib.util
import os
import pathlib
import re

import h5py
import numpy as np
import pytest
import torch

from test_torch_model import MODEL_KWARGS
from uplift_upsample_torch.configs import resolve_config
from uplift_upsample_torch.models import (UpliftUpsampleTransformer,
                                          build_uplift_upsample_transformer)
from uplift_upsample_torch.tools import convert_weights
from uplift_upsample_torch.utils.weights_h5 import load_keras_h5
from uplift_upsample_torch.utils.weights_npz import (load_npz, load_npz_by_name,
                                                     load_weights, load_weights_by_name,
                                                     read_npz, save_npz)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE_DIR = REPO / "tests" / "fixtures"
SYNTH_DIR = FIXTURE_DIR / "synth"
SMALL_H5 = str(FIXTURE_DIR / "small_strided.h5")
SMALL_CONFIG = str(FIXTURE_DIR / "eval_small_config.json")
CONFIGS = {"small_strided": SMALL_CONFIG, "h36m_351": "h36m_351"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores (the
    eval and CLI files do the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_convert_weights",
                                                  REPO / "tools" / "convert_weights.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_tool(monkeypatch, *argv):
    monkeypatch.setattr("sys.argv", ["convert_weights.py", *argv])
    _jax_tool().main()


def _model(name):
    return UpliftUpsampleTransformer(num_keypoints=17, **MODEL_KWARGS[name]).eval()


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


def _weightless_layers(path):
    """Layers of a reference `.h5` that hold no weight (dropouts): an npz,
    holding weights only, has no trace of them."""
    with h5py.File(path, "r") as f:
        names = [n.decode() if isinstance(n, bytes) else n for n in f.attrs["layer_names"]]
        return {n for n in names if not len(f[n].attrs["weight_names"])}


def _h5_datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("name", ["small_strided", "h36m_351"])
def test_jax_tool_npz_loads_bit_for_bit(name, tmp_path, monkeypatch):
    """A reference `.h5` converted by the JAX tool loads into the port equal
    to `load_keras_h5` of the `.h5`, bit for bit; the full-width h36m_351 then
    meets the reference TF goldens at the model bar (2e-5)."""
    npz = str(tmp_path / f"{name}.npz")
    _run_jax_tool(monkeypatch, "--config", CONFIGS[name], "--input",
                  str(FIXTURE_DIR / f"{name}.h5"), "--output", npz)
    from_h5 = load_keras_h5(str(FIXTURE_DIR / f"{name}.h5"), _model(name))
    from_npz = load_npz(npz, _model(name))
    _assert_same_state(from_npz, from_h5)
    if name == "h36m_351":
        data = np.load(FIXTURE_DIR / f"{name}.npz")
        with torch.inference_mode():
            full, central = from_npz(torch.from_numpy(data["x_masked"]),
                                     torch.from_numpy(data["stride_mask"]))
        np.testing.assert_allclose(central.numpy(), data["central"], atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(full.numpy(), data["full"], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["small_strided", "no_qkv_bias_bn"])
def test_port_npz_runs_in_the_jax_model(name, tmp_path, monkeypatch):
    """`save_npz` of seeded weights (random BatchNorm statistics included),
    read with the JAX tool's `unflatten`, gives the JAX model the port's
    output within 2e-5; the JAX tool turns the same npz into an `.h5` that
    the port reads back bit for bit."""
    import jax

    from uplift_upsample_tpu.models import UpliftUpsampleTransformer as JaxModel

    torch.manual_seed(5)
    model = _model(name)
    for module in model.modules():
        if isinstance(module, torch.nn.BatchNorm1d):
            module.running_mean.uniform_(-0.5, 0.5)
            module.running_var.uniform_(0.5, 1.5)
    npz = str(tmp_path / "w.npz")
    save_npz(npz, None, model)

    tool = _jax_tool()
    with np.load(npz) as data:
        flat = dict(data)
    variables = {"params": tool.unflatten({k.split("||", 1)[1]: v for k, v in flat.items()
                                           if k.startswith("params||")})}
    stats = {k.split("||", 1)[1]: v for k, v in flat.items() if k.startswith("batch_stats||")}
    assert bool(stats) == (name == "no_qkv_bias_bn")
    if stats:
        variables["batch_stats"] = tool.unflatten(stats)
    jmodel = JaxModel(num_keypoints=17, **MODEL_KWARGS[name])
    rng = np.random.default_rng(5)
    n = jmodel.num_frames
    x = (rng.normal(size=(3, n, 17, 2)) * 0.3).astype(np.float32)
    sm = (np.arange(n) % 3 == 0)[None].repeat(3, axis=0)
    x = x * sm[:, :, None, None]
    j_full, j_central = jax.jit(lambda v, a, s: jmodel.apply(v, a, stride_mask=s,
                                                             training=False))(variables, x, sm)
    with torch.inference_mode():
        full, central = model(torch.from_numpy(x), torch.from_numpy(sm))
    np.testing.assert_allclose(central.numpy(), np.asarray(j_central), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(full.numpy(), np.asarray(j_full), atol=2e-5, rtol=1e-4)

    if name == "small_strided":  # a bundled config of this geometry
        h5 = str(tmp_path / "w.h5")
        _run_jax_tool(monkeypatch, "--config", SMALL_CONFIG, "--input", npz, "--output", h5)
        _assert_same_state(load_keras_h5(h5, _model(name)), model)


@pytest.mark.parametrize("name", ["small_strided", "h36m_351"])
def test_cli_round_trip_keeps_every_dataset(name, tmp_path, monkeypatch, capsys):
    """`.h5` → `.npz` → `.h5` through the port's CLI writes every dataset of
    the reference-written `.h5` back byte for byte, under the same names; the
    CLI prints the JAX tool's line and parameter count."""
    npz, h5 = str(tmp_path / "w.npz"), str(tmp_path / "w.h5")
    src = str(FIXTURE_DIR / f"{name}.h5")
    convert_weights.main(["--config", CONFIGS[name], "--input", src, "--output", npz])
    convert_weights.main(["--config", CONFIGS[name], "--input", npz, "--output", h5])
    ours = capsys.readouterr().out.splitlines()
    _run_jax_tool(monkeypatch, "--config", CONFIGS[name], "--input", src,
                  "--output", str(tmp_path / "jax.npz"))
    ref = capsys.readouterr().out.splitlines()
    assert ours[0] == f"converted {src} -> {npz} {re.search(r'[(].*[)]', ref[-1])[0]}"
    assert ours[1] == f"converted {npz} -> {h5} {re.search(r'[(].*[)]', ref[-1])[0]}"
    a, b = _h5_datasets(src), _h5_datasets(h5)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key
    flat = read_npz(str(tmp_path / "jax.npz"))
    mine = read_npz(npz)
    assert sorted(flat["params"]) == sorted(mine["params"])


# (file's model, model loaded into, skip_mismatch): an AMASS-style checkpoint
# without the strided input token, the reverse (a layer the model lacks), a
# file without the spatial stage (its s2t kernel clashes), and shape
# clashes (11 frames into 9)
PARTIAL = [("no_strided_input", "small_strided", False),
           ("small_strided", "no_strided_input", False),
           ("no_spatial", "small_strided", True),
           ("default_pads", "small_strided", True),
           ("no_qkv_bias_bn", "small_strided", True)]


@pytest.mark.parametrize("src,dst,skip", PARTIAL)
def test_load_npz_by_name_report_matches_h5(src, dst, skip, tmp_path):
    """Name-based loading from the npz of a reference `.h5` gives the report
    of `load_keras_h5_by_name` on the `.h5` (the same entries; list order
    follows each file's own order) and the same weights, the transform
    applied to each loaded weight. The `.h5` report also lists its weightless
    layers as not consumed; the npz has none."""
    npz = str(tmp_path / "w.npz")
    save_npz(npz, None, load_keras_h5(str(FIXTURE_DIR / f"{src}.h5"), _model(src)))
    transform = lambda path, value: value * 2.0 if path.endswith("bias") else value
    torch.manual_seed(0)
    via_h5 = _model(dst)
    torch.manual_seed(0)
    via_npz = _model(dst)
    _assert_same_state(via_h5, via_npz)
    # through the training CLI's loader, which picks the reader by extension
    r_h5 = load_weights_by_name(str(FIXTURE_DIR / f"{src}.h5"), via_h5, transform=transform,
                                skip_mismatch=skip, verbose=False)
    r_npz = load_weights_by_name(npz, via_npz, transform=transform, skip_mismatch=skip,
                                 verbose=False)
    weightless = _weightless_layers(str(FIXTURE_DIR / f"{src}.h5"))
    r_h5.unconsumed_layers = [n for n in r_h5.unconsumed_layers if n not in weightless]
    for field in ("assigned", "unconsumed_layers", "unassigned_layers", "unconsumed_weights",
                  "unassigned_weights", "mismatched"):
        assert sorted(getattr(r_npz, field)) == sorted(getattr(r_h5, field)), field
    assert r_npz.fully_matched == r_h5.fully_matched
    assert not r_h5.fully_matched and r_h5.assigned
    _assert_same_state(via_npz, via_h5)
    if not skip:  # a shape clash raises unless skipped
        bad = str(tmp_path / "bad.npz")
        save_npz(bad, None, load_keras_h5(str(FIXTURE_DIR / "default_pads.h5"),
                                          _model("default_pads")))
        with pytest.raises(ValueError, match="Shape mismatch"):
            load_npz_by_name(bad, _model(dst), verbose=False)


def test_cli_weights_npz_in_eval_and_predict(tmp_path):
    """`--weights x.npz` in the eval and predict CLIs (`--device cpu`) gives
    the results of the in-memory model the `.h5` loads."""
    from uplift_upsample_torch.eval import main as eval_main
    from uplift_upsample_torch.eval import run_eval
    from uplift_upsample_torch.predict import main as predict_main
    from uplift_upsample_torch.predict import predict_sequence

    config = resolve_config(SMALL_CONFIG)
    model = load_keras_h5(SMALL_H5, build_uplift_upsample_transformer(config, device="cpu"))
    npz = str(tmp_path / "small.npz")
    save_npz(npz, None, model)
    data = dict(dataset_path=str(SYNTH_DIR / "data_3d_h36m.npz"),
                dataset2d_path=str(SYNTH_DIR / "data_2d_h36m_synth.npz"))
    cli = eval_main(["--weights", npz, "--config", SMALL_CONFIG, "--dataset",
                     data["dataset_path"], "--dataset_2d", data["dataset2d_path"],
                     "--forced_mask_stride", "10", "--device", "cpu"])[10]
    config.MASK_STRIDE = 10
    mem = run_eval(config, "h36m", test_subset="test", model=model, verbose=False,
                   device="cpu", **data)
    for section in (0, 1):
        assert cli[section][0] == mem[section][0]
        assert cli[section][1] == mem[section][1]

    kps = (np.random.default_rng(2).normal(size=(40, 17, 2)) * 0.3).astype(np.float32)
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, positions_2d={"seq": kps})
    predict_main(["--weights", npz, "--config", SMALL_CONFIG, "--input", str(inp),
                  "--output", str(out), "--device", "cpu"])
    config = resolve_config(SMALL_CONFIG)  # the predict CLI's first mask stride
    if isinstance(config.MASK_STRIDE, list):
        config.MASK_STRIDE = config.MASK_STRIDE[0]
    ref = predict_sequence(model, config, kps)
    np.testing.assert_array_equal(np.load(out)["seq"], ref)


def test_unknown_weights_extension_raises(tmp_path):
    """`--weights` takes `.h5` or `.npz`; anything else raises naming both,
    and a prefix matching both formats raises rather than pick one."""
    from uplift_upsample_torch.predict import main as predict_main
    from uplift_upsample_torch.train import resolve_weight_selector

    model = build_uplift_upsample_transformer(resolve_config(SMALL_CONFIG), device="cpu")
    for path in ("w.pt", "w", "w.npz.bak"):
        with pytest.raises(ValueError, match=r"\.h5.*\.npz"):
            load_weights(str(tmp_path / path), model)
    with pytest.raises(ValueError, match=r"\.h5.*\.npz"):
        predict_main(["--weights", str(tmp_path / "w.pt"), "--config", SMALL_CONFIG,
                      "--input", str(tmp_path / "in.npz"), "--output",
                      str(tmp_path / "out.npz"), "--device", "cpu"])

    (tmp_path / "best_weights_0004.npz").write_bytes(b"")
    assert (resolve_weight_selector(str(tmp_path / "best_weights"))
            == str(tmp_path / "best_weights_0004.npz"))
    (tmp_path / "best_weights_0002.h5").write_bytes(b"")
    with pytest.raises(ValueError, match="formats"):
        resolve_weight_selector(str(tmp_path / "best_weights"))
    (tmp_path / "last_weights_0004.h5").write_bytes(b"")
    assert (resolve_weight_selector(str(tmp_path / "last"))
            == str(tmp_path / "last_weights_0004.h5"))
