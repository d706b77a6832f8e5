"""The one-pass bf16 rung (EVAL_MATMUL_PRECISION "default") on the CPU.

The oracle is the JAX package's drift simulator, `tools/sim_drift.py`
(loaded by path): every product of the fused eval path routed through a
site-keyed precision map, bf16 meaning both operands rounded to bf16 and an
fp32 sum. On the CPU JAX ignores DEFAULT precision for f32 dots, so the JAX
kernels in interpret mode compute fp32 there and cannot be the oracle.

All on an h36m_351-shaped model cut to width 64, two blocks a stack (JAX
init, `params_from_jax`), six windows of 27 frames from a numpy seed:

  (a) the port's simulator (`uplift_upsample_torch/tools/sim_drift.py`)
      against the JAX one: fp32 to 1e-5; the bf16 and bf16x3 maps within a
      multiple of the bf16 drift (|sim bf16 - sim f32|). Two exact
      implementations of the same bf16 function that sum in another order
      part by much more than fp32 noise: a sum order that differs by an
      fp32 ulp flips a later bf16 rounding now and then, and each flip moves
      an operand by a bf16 ulp. Measured here: mean |torch - JAX| 0.25 x
      the mean drift and 0.48 x its max for the bf16 map; 0.0011 x the
      bf16 drift for bf16x3. Bounds: 0.4 / 0.75 and 0.01; the map with the
      spatial sites bf16x3 within its drift (measured 0.65 / 0.76);
  (b) the port's `make_test_step(fused="full", precision="default")` (the
      kernels' plain versions) against the JAX sim with every site bf16
      but the spatial attention (fp32 in K1, as on the TPU's vector unit):
      measured 0.42 / 0.49 of the drift, bounds 0.6 / 0.75, and closer to
      that map than to the all-bf16 one (0.49 x: bound 0.75 x); the
      "spatial" route (K1 at "high" whatever the rung, as the JAX step runs
      it) against the map with the `sp_*` sites bf16x3 and every other site
      bf16 (measured 0.66 / 0.62 of the drift), and closer to it than to the
      fused map (0.70 x: bound 0.75 x) (C4); the drift matrix's `fused_high`
      (the JAX tool's `fused_high3`) within that map and not at fp32 (C5).
      That map's bf16x3 spatial sites leave ~2^-17 of each product where
      K1 at "high" is fp32-level, enough to flip ~1 % of the s2t Dense's
      bf16 roundings: the port's simulator and the JAX one, both at that
      map, part by 0.65 / 0.76 of its drift (test (a)), so these two hold
      a mean bound of 0.75 (largest 0.75 as everywhere);
  (c) `fused="none"` against the all-bf16 map (measured 0.26 / 0.48, the
      same bounds, and closer to it than to the fused map);
  (d) the shared-spatial step at "default" against the per-window step;
  (e) "high" and "highest" give the same bits as `precision` omitted, and
      "highest" on the fused "full" route runs the plain model, bit for bit
      (C6);
  (f) what stays unported raises: `--bf16`, COMPUTE_DTYPE and
      SPATIAL_COMPUTE_DTYPE bfloat16, USE_PALLAS_ATTENTION and mp > 1 on the
      bf16 rung;
and the drift matrix (`tools/check_parity.py`) at batch 4 on the CPU, the
simulator's CLI, and the bench CLI at "default".
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from uplift_upsample_torch.config import UpliftUpsampleConfig
from uplift_upsample_torch.eval import make_test_step
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.precision import (check_rung, current, matmul_precision, mm,
                                             round_bf16, rung_matmul)
from uplift_upsample_torch.tools import check_parity
from uplift_upsample_torch.tools import sim_drift as tsim
from uplift_upsample_torch.utils.dedup import dedup_rows
from uplift_upsample_torch.utils.weights_h5 import params_from_jax

REPO = pathlib.Path(__file__).resolve().parent.parent
OVERRIDES = {
    "SEQUENCE_LENGTH": 27, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 32,
    "TEMPORAL_EMBED_DIM": 64, "SPATIAL_TRANSFORMER_BLOCKS": 2,
    "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3, 3],
    "PADDINGS": [[0, 0], [0, 0], [0, 0]], "NUM_HEADS": 8,
    "MASK_STRIDE": 5, "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1,
    "DROP_PATH_RATE": [0.1, 0.1, 0.0],
}
ALL_BF16 = {s: "bf16" for s in tsim.SITES}
# K1 at "high" (bf16x3 on the TPU), everything from the s2t Dense on bf16
SP_BF16X3 = {s: ("bf16x3" if s.startswith("sp_") else "bf16") for s in tsim.SITES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(**overrides):
    config = UpliftUpsampleConfig()
    config.update_from({**OVERRIDES, **overrides})
    return config


@pytest.fixture(scope="module")
def case():
    """The JAX init in both packages, the inputs, and the JAX sim's maps."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from uplift_upsample_tpu.config import UpliftUpsampleConfig as JaxConfig
    from uplift_upsample_tpu.models import build_uplift_upsample_transformer as jax_build
    from uplift_upsample_tpu.models import init_model_params

    spec = importlib.util.spec_from_file_location("jax_sim_drift",
                                                  REPO / "tools" / "sim_drift.py")
    jsim = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsim)
    jconfig = JaxConfig()
    jconfig.update_from(OVERRIDES)
    variables = init_model_params(jax_build(jconfig), seed=0)
    config = _config()
    model = build_uplift_upsample_transformer(config, device="cpu")
    model.load_state_dict(params_from_jax(variables))
    rng = np.random.default_rng(0)
    b, n = 6, config.SEQUENCE_LENGTH
    sm = (np.arange(n) % 5 == 0)[None].repeat(b, axis=0)
    sm[1] = np.roll(sm[1], 2)  # a second phase of the mask
    x = (rng.normal(size=(b, n, 17, 2)) * 0.3).astype(np.float32) * sm[:, :, None, None]
    cfg = tsim.sim_config(model)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), variables["params"])

    def jax_sim(assign):
        prec = {s: assign.get(s, "f32") for s in tsim.SITES}
        fwd = jax.jit(lambda p, a, m: jsim.sim_forward(p, a, m, prec, cfg))
        return np.asarray(fwd(jparams, x, sm), np.float64)

    sims = {"f32": jax_sim({}), "bf16": jax_sim(ALL_BF16),
            "fused": jax_sim(tsim.FUSED_DEFAULT), "bf16x3": jax_sim(
                {s: "bf16x3" for s in tsim.SITES}), "sp_bf16x3": jax_sim(SP_BF16X3)}
    return dict(config=config, model=model, x=torch.from_numpy(x), sm=torch.from_numpy(sm),
                cfg=cfg, sims=sims)


def _gap(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.mean()), float(d.max())


def _within(got, ref, drift_ref, mean_frac, max_frac):
    """got within (mean_frac, max_frac) of the bf16 drift |drift_ref| of ref."""
    (g_mean, g_max), (d_mean, d_max) = _gap(got, ref), _gap(ref, drift_ref)
    assert g_mean <= mean_frac * d_mean and g_max <= max_frac * d_max, (
        g_mean / d_mean, g_max / d_max)


def _step(case, fused, precision, **kw):
    return make_test_step(case["model"], flip_tta=False,
                          flip_lr_indices=case["config"].AUGM_FLIP_KEYPOINT_ORDER,
                          fused=fused, precision=precision, **kw)


def test_round_bf16_and_the_context():
    """round_bf16 rounds to nearest, ties to even (as jnp's astype); the
    context sets the plain modules' rung and restores the one outside."""
    one = 1.0 + 2.0 ** -8  # halfway between 1 and the next bf16: ties to even, 1
    x = torch.tensor([one, 1.0 + 3 * 2.0 ** -8, -2.0 ** -130, 3.0e38])
    assert round_bf16(x).tolist() == [1.0, 1.0 + 2 * 2.0 ** -7, -2.0 ** -130,
                                      float(torch.tensor(3.0e38).to(torch.bfloat16))]
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    assert current() == "highest" and torch.equal(rung_matmul(a, b), a @ b)
    with matmul_precision("default"):
        assert torch.equal(rung_matmul(a, b), round_bf16(a) @ round_bf16(b))
        with matmul_precision("high"):
            assert torch.equal(rung_matmul(a, b), a @ b)
        assert current() == "default"
    assert current() == "highest"
    assert torch.equal(mm(a, b, "default"), round_bf16(a) @ round_bf16(b))
    with pytest.raises(ValueError, match="matmul precision"):
        with matmul_precision("mixed"):
            pass


def test_torch_sim_matches_jax_sim(case):
    """(a): the port's simulator on the same parameters and inputs."""
    params = tsim.params_tree(case["model"])
    run = lambda assign: tsim.run(params, case["x"], case["sm"], case["cfg"], assign)
    sims = case["sims"]
    assert _gap(run({}), sims["f32"])[1] <= 1e-5
    _within(run(ALL_BF16), sims["bf16"], sims["f32"], 0.4, 0.75)
    x3_gap = _gap(run({s: "bf16x3" for s in tsim.SITES}), sims["bf16x3"])[1]
    assert x3_gap <= 0.01 * _gap(sims["bf16"], sims["f32"])[1], x3_gap
    # the map with the spatial sites bf16x3 (the "spatial" route's): its
    # ~2^-17 per spatial product flips ~1 % of the s2t Dense's roundings,
    # so the two simulators part by more there (0.65 / 0.76 of its drift),
    # as far as the port's "spatial" step from the JAX map (test (b))
    (g_mean, g_max), (d_mean, d_max) = (_gap(run(SP_BF16X3), sims["sp_bf16x3"]),
                                        _gap(sims["sp_bf16x3"], sims["f32"]))
    print(f"sp_bf16x3 map: torch sim vs JAX sim {g_mean / d_mean:.2f} / {g_max / d_max:.2f} "
          "of the drift")
    assert g_mean <= d_mean and g_max <= d_max, (g_mean / d_mean, g_max / d_max)


@pytest.mark.parametrize("fused,site_map,other,mean_frac", [
    ("full", "fused", "bf16", 0.6), ("spatial", "sp_bf16x3", "fused", 0.75),
    ("none", "bf16", "fused", 0.6)])
def test_step_at_default_matches_the_jax_sim(case, fused, site_map, other, mean_frac):
    """(b), (c): the kernel path's plain versions (K1's spatial attention
    fp32) follow the fused map, the "spatial" route (K1 at "high") the map
    with the spatial sites bf16x3, the plain model (every product rounded)
    the all-bf16 map, each closer to its own map than to the other."""
    _, got = _step(case, fused, "default")(case["x"], case["sm"])
    sims = case["sims"]
    (g_mean, g_max), (d_mean, d_max) = _gap(got, sims[site_map]), _gap(sims[site_map],
                                                                      sims["f32"])
    print(f"{fused} step vs the {site_map} map: {g_mean / d_mean:.2f} / {g_max / d_max:.2f} "
          "of the drift")
    _within(got, sims[site_map], sims["f32"], mean_frac, 0.75)
    assert _gap(got, sims[site_map])[0] <= 0.75 * _gap(got, sims[other])[0]


def _float64_truth(case):
    import copy
    model = copy.deepcopy(case["model"]).double()
    with torch.inference_mode():
        return model(case["x"].double(), case["sm"])[1].numpy()


def test_fused_high_is_the_jax_fused_high3(case):
    """(C5): the drift matrix's `fused_high` is K1 at "high" and a bf16 tail:
    within the `sp_*` = bf16x3 map, closer to it than to the fused map, and
    not within 0.5 milli-units of the float64 truth; `fused_default` (K1 at
    "default") follows the fused map."""
    sims = case["sims"]
    high = check_parity.run_variant("fused_high", case["model"], case["x"], case["sm"])
    _within(high, sims["sp_bf16x3"], sims["f32"], 0.75, 0.75)
    assert _gap(high, sims["sp_bf16x3"])[0] <= 0.75 * _gap(high, sims["fused"])[0]
    assert check_parity.drift_mm(high.numpy(), _float64_truth(case))[0] > 0.5
    default = check_parity.run_variant("fused_default", case["model"], case["x"], case["sm"])
    _within(default, sims["fused"], sims["f32"], 0.6, 0.75)


def test_highest_full_runs_the_plain_model(case):
    """(C6): at "highest" the fused "full" route is the plain model, as the
    JAX step switches it to "none": the same bits, per window and shared."""
    kw = dict(flip_tta=True, flip_lr_indices=case["config"].AUGM_FLIP_KEYPOINT_ORDER,
              precision="highest")
    full = make_test_step(case["model"], fused="full", **kw)(case["x"], case["sm"])
    none = make_test_step(case["model"], fused="none", **kw)(case["x"], case["sm"])
    assert torch.equal(full[1], none[1]) and torch.equal(full[0], none[0])
    x, sm = case["x"], case["sm"]
    b, n = sm.shape
    uniq, inv = dedup_rows(x.numpy().reshape(b * n, -1))
    uq = torch.from_numpy(uniq.reshape(-1, 17, 2).copy())
    idx = torch.from_numpy(inv.reshape(b, n).astype(np.int64))
    shared = [make_test_step(case["model"], fused=f, shared_spatial=True, **kw)(uq, idx, sm)[1]
              for f in ("full", "none")]
    assert torch.equal(*shared)


def test_shared_step_at_default_matches_per_window(case):
    """(d): K1 on the unique frames, gathered into windows, at "default"."""
    x, sm = case["x"], case["sm"]
    b, n = sm.shape
    uniq, inv = dedup_rows(x.numpy().reshape(b * n, -1))
    uq = torch.from_numpy(uniq.reshape(-1, 17, 2).copy())
    idx = torch.from_numpy(inv.reshape(b, n).astype(np.int64))
    _, shared = _step(case, "full", "default", shared_spatial=True)(uq, idx, sm)
    _, per_window = _step(case, "full", "default")(x, sm)
    _, high = _step(case, "full", "high")(x, sm)
    assert not torch.equal(per_window, high)  # the rung is read
    _within(shared, per_window, high, 0.05, 0.25)


@pytest.mark.parametrize("fused", ["full", "spatial", "none"])
def test_fp32_rungs_unchanged(case, fused):
    """(e): "high" and "highest" run the code that `precision` omitted runs,
    bit for bit, on every path; "highest" on "full" the plain model's (C6)."""
    def omitted(path):
        return make_test_step(case["model"], flip_tta=True,
                              flip_lr_indices=case["config"].AUGM_FLIP_KEYPOINT_ORDER,
                              fused=path)(case["x"], case["sm"])[1]

    for rung in ("high", "highest"):
        got = make_test_step(case["model"], flip_tta=True,
                             flip_lr_indices=case["config"].AUGM_FLIP_KEYPOINT_ORDER,
                             fused=fused, precision=rung)(case["x"], case["sm"])[1]
        path = "none" if (fused, rung) == ("full", "highest") else fused
        assert torch.equal(got, omitted(path)), rung


def test_what_is_not_ported_still_raises():
    """(f): bf16 activations, row 11 and the split over mp on the bf16 rung."""
    from uplift_upsample_torch.eval import main

    with pytest.raises(ValueError, match="COMPUTE_DTYPE"):
        build_uplift_upsample_transformer(_config(COMPUTE_DTYPE="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="SPATIAL_COMPUTE_DTYPE"):
        build_uplift_upsample_transformer(_config(SPATIAL_COMPUTE_DTYPE="bfloat16"),
                                          device="cpu")
    with pytest.raises(ValueError, match="float32"):
        main(["--weights", "unused.npz", "--config", "h36m_351", "--bf16", "--device", "cpu"])
    config = _config(USE_PALLAS_ATTENTION=True)
    model = build_uplift_upsample_transformer(config, device="cpu")
    for fused in ("full", "none"):
        with pytest.raises(NotImplementedError, match="A8"):
            make_test_step(model, flip_tta=False, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                           fused=fused, precision="default")
    make_test_step(model, flip_tta=False, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                   fused="none", precision="high")

    class Split:  # an mp group of two
        size = 2

    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        check_rung("default", tp=Split())
    check_rung("high", tp=Split())
    with pytest.raises(ValueError, match="EVAL_MATMUL_PRECISION"):
        check_rung("mixed")


def test_drift_matrix_on_the_cpu(capsys):
    """The drift matrix at batch 4 with --device cpu: every variant, the JAX
    tool's bounds, and rung_default within SIM_RATIO of the simulator."""
    assert check_parity.main(["--batch", "4", "--device", "cpu", "--assert-bounds"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "drift bounds OK"
    rows = {r["variant"]: r for r in map(json.loads, lines[:-1])}
    assert set(rows) == set(check_parity.VARIANTS)
    assert all(rows[name]["ok"] for name in check_parity.ASSERT_BOUNDS)
    lo, hi = check_parity.SIM_RATIO
    assert lo <= rows["rung_default"]["sim_ratio"] <= hi
    # the fp32 rungs sit at fp32 noise, the bf16 ones at the rung's drift
    assert rows["xla_high"]["mean_mm"] < 0.05 and rows["xla_default"]["mean_mm"] > 10


def test_sim_drift_cli(capsys):
    """validate (the sim at f32 against the model), config and greedy modes."""
    tsim.main(["--mode", "validate", "--batch", "2"])
    tsim.main(["--mode", "config", "--batch", "2", "--sites", "all=bf16,sp_attn=f32"])
    tsim.main(["--mode", "greedy", "--batch", "2", "--target", "1e9"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["sim_vs_model_mean_mm"] < 0.05
    assert lines[1]["sites"]["sp_attn"] == "f32" and lines[1]["mean_mm"] > 10
    assert lines[-1]["final"] == {}


def test_bench_cli_at_default(monkeypatch, capsys):
    """The bench CLI runs the eval step at "default" on the CPU; --pallas there raises."""
    from uplift_upsample_torch import bench

    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    bench.main(["--device", "cpu", "--iters", "4", "--batch", "3", "--precision", "default"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["precision_rung"] == "default" and result["value"] > 0
    with pytest.raises(NotImplementedError, match="A8"):
        bench.main(["--device", "cpu", "--precision", "default", "--pallas"])
