"""Keras-legacy `.h5` ↔ flax-named numpy tree ↔ PyTorch state_dict.

The released reference checkpoints are Keras "save_weights" HDF5 files: a
`layer_names` attribute lists top-level layer groups; each group's
`weight_names` attribute lists datasets in variable-creation order
(reference `weight_io.py:125-263`). `read_keras_h5` reads one into the
JAX package's parameter tree (flax names, numpy arrays), and
`params_from_jax` carries such a tree, from either package, into this
package's state_dict; `params_to_jax` goes back. `load_keras_h5_by_name`
loads by layer name with a `WeightLoadReport` (partial loads), and
`save_keras_h5` writes the JAX package's export layout, so a file written by
either package loads in the other bit for bit.

Layout changes between the two frameworks:
  Keras/flax Dense kernel (in, out)      → nn.Linear weight (out, in)
  Keras/flax Conv1D kernel (k, in, out)  → nn.Conv1d weight (out, in, k)
  LayerNorm / BatchNorm scale            → weight
  BatchNorm mean / var (batch_stats)     → running_mean / running_var

`h5py` is imported inside the reader: the card's machine does not have it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _decode(names) -> List[str]:
    return [n.decode("utf8") if isinstance(n, bytes) else n for n in names]


def _group_weights(h5_group) -> Dict[str, List[np.ndarray]]:
    """Split a layer group's weights by sublayer path, preserving order."""
    by_sublayer: Dict[str, List[np.ndarray]] = {}
    for wname in _decode(h5_group.attrs["weight_names"]):
        parts = wname.split("/")
        sublayer = parts[-2] if len(parts) >= 2 else ""
        by_sublayer.setdefault(sublayer, []).append(
            np.asarray(h5_group[wname], dtype=np.float32))
    return by_sublayer


def _dense(values: List[np.ndarray]) -> Dict[str, np.ndarray]:
    out = {"kernel": values[0]}
    if len(values) > 1:
        out["bias"] = values[1]
    return out


def _ln(values: List[np.ndarray]) -> Dict[str, np.ndarray]:
    return {"scale": values[0], "bias": values[1]}


def _block_params(h5_group, strided: bool) -> Dict[str, Dict]:
    """Transformer block group → flax block params via ordered sublayers."""
    sublayers = list(_group_weights(h5_group).values())
    if len(sublayers) != 8:
        raise ValueError(f"expected 8 sublayers in block, got {len(sublayers)}")
    ln1, wq, wk, wv, proj, ln2, fc1, fc2 = sublayers
    if strided:
        # pointwise conv (1, in, hidden) → dense (in, hidden)
        fc1 = [fc1[0][0], *fc1[1:]]
    return {
        "norm1": _ln(ln1),
        "attn": {"wq": _dense(wq), "wk": _dense(wk), "wv": _dense(wv), "proj": _dense(proj)},
        "norm2": _ln(ln2),
        "mlp": {"fc1": _dense(fc1), "fc2": _dense(fc2)},
    }


# flax param keys whose .h5 layer has another name
_H5_NAMES = {"strided_input_token": "strided_input_token_layer",
             "masked_token": "learnable_masked_token_layer"}


def h5_layer_name(key: str) -> str:
    """The .h5 layer name of the flax param key `key`."""
    return _H5_NAMES.get(key, key)


def _model_layer_plan(model):
    """Ordered (flax param key, h5 layer name, kind) for every model layer."""
    plan = []
    if model.spatial_depth > 0:
        plan.append(("keypoint_embedding", "dense"))
        plan.append(("spatial_pe", "pe"))
        for i in range(1, model.spatial_depth + 1):
            plan.append((f"spatial_block_{i}", "block"))
        plan.append(("spatial_norm", "ln"))
    plan.append(("temporal_pe", "pe"))
    plan.append(("spatial_to_temporal_fc", "dense"))
    if model.has_strided_input:
        plan.append(("strided_input_token", "pe"))
    if model.token_mask_rate > 0 and model.learnable_masked_token:
        plan.append(("masked_token", "pe"))
    for i in range(1, model.temporal_depth + 1):
        plan.append((f"temporal_block_{i}", "block"))
    for i in range(1, len(model.strides) + 1):
        plan.append((f"strided_temporal_pe_{i}", "pe"))
        plan.append((f"strided_temporal_block_{i}", "strided_block"))
    if model.full_output and model.temporal_depth > 0:
        if model.output_bn:
            plan.append(("temporal_norm", "bn"))
        plan.append(("temporal_fc", "dense"))
    if model.output_bn:
        plan.append(("strided_temporal_norm", "bn"))
    plan.append(("strided_temporal_fc", "dense"))
    return [(key, h5_layer_name(key), kind) for key, kind in plan]


def read_keras_h5(path: str, model) -> Dict:
    """Strict read of a reference-format `.h5` into flax-named numpy arrays.

    Returns `{"params": ..., "batch_stats": ...}` (batch_stats only when the
    model has output BatchNorm heads). Every layer the model expects must be
    in the file.
    """
    import h5py

    params, batch_stats = {}, {}
    with h5py.File(path, "r") as f:
        if "layer_names" not in f.attrs and "model_weights" in f:
            f = f["model_weights"]
        file_layers = set(_decode(f.attrs["layer_names"]))
        plan = _model_layer_plan(model)
        missing = [name for _, name, _ in plan if name not in file_layers]
        if missing:
            raise KeyError(f"{path} is missing layers required by the model: {missing}")
        for key, name, kind in plan:
            tree = _read_group_tree(f[name], kind)
            if kind == "bn":
                params[key], batch_stats[key] = tree["params"], tree["batch_stats"]
            else:
                params[key] = tree
    tree = {"params": params}
    if batch_stats:
        tree["batch_stats"] = batch_stats
    return tree


_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
         "var": "running_var"}


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """JAX-package parameters (flax names, numpy-convertible leaves) → state_dict.

    `tree` is a variables dict `{"params": ..., "batch_stats": ...}` or a bare
    params tree. Dense kernels are transposed and Conv1D kernels permuted to
    PyTorch's layouts; everything becomes float32 on the CPU.
    """
    params = tree["params"] if "params" in tree else tree
    state: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, value in node.items():
            if isinstance(value, dict):
                walk(value, path + [name])
                continue
            arr = np.asarray(value, dtype=np.float32)
            if not path:  # top-level parameter: PEs and tokens
                key = name
            elif name == "kernel":
                key = ".".join(path + ["weight"])
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
            else:
                key = ".".join(path + [_LEAF[name]])
            state[key] = torch.tensor(arr)

    walk(params, [])
    for name, stats in tree.get("batch_stats", {}).items():
        walk({name: stats}, [])
        state[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return state


def load_keras_h5(path: str, model):
    """Load a reference-format `.h5` checkpoint into `model` (strict); returns it."""
    state = params_from_jax(read_keras_h5(path, model))
    model.load_state_dict(state, strict=True)
    return model


def params_to_jax(state: Mapping[str, torch.Tensor], model) -> Dict:
    """A state_dict (or a part of one, completed from `model.state_dict()`)
    → the JAX package's variables `{"params": ..., "batch_stats": ...}` as
    float32 numpy arrays: the inverse of `params_from_jax`."""
    full = dict(model.state_dict())
    full.update(state)
    params: Dict = {}
    batch_stats: Dict = {}
    for key, value in full.items():
        if key.endswith("num_batches_tracked"):
            continue
        arr = value.detach().to("cpu", torch.float32).numpy()
        *path, leaf = key.split(".")
        if not path:  # top-level parameter: PEs and tokens
            params[leaf] = arr
            continue
        module = model.get_submodule(".".join(path))
        tree = params
        if leaf in ("running_mean", "running_var"):
            tree, leaf = batch_stats, {"running_mean": "mean", "running_var": "var"}[leaf]
        elif leaf == "weight" and isinstance(module, (nn.Linear, nn.Conv1d)):
            leaf = "kernel"
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
        elif leaf == "weight":
            leaf = "scale"
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = np.ascontiguousarray(arr)
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


# ---------------------------------------------------------------------------
# Name-based partial loading (copied from the JAX package's utils/weights_h5.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WeightLoadReport:
    """Name-based loading diagnostics (reference `weight_io.py:240-263`).

    `unconsumed_*`: present in the .h5 file but not loaded into the model;
    `unassigned_*`: expected by the model but not found in the file;
    `mismatched`: (flax path, file shape, model shape) skipped shape clashes.
    """

    assigned: List[str] = dataclasses.field(default_factory=list)
    unconsumed_layers: List[str] = dataclasses.field(default_factory=list)
    unassigned_layers: List[str] = dataclasses.field(default_factory=list)
    unconsumed_weights: List[Tuple[str, tuple]] = dataclasses.field(default_factory=list)
    unassigned_weights: List[Tuple[str, tuple]] = dataclasses.field(default_factory=list)
    mismatched: List[Tuple[str, tuple, tuple]] = dataclasses.field(default_factory=list)

    @property
    def fully_matched(self) -> bool:
        return not (self.unconsumed_layers or self.unassigned_layers
                    or self.unconsumed_weights or self.unassigned_weights
                    or self.mismatched)

    def summary(self) -> str:
        lines = []
        if self.unconsumed_layers:
            lines.append("The following layers were not consumed from .h5 file:")
            lines += [f"- {n}" for n in self.unconsumed_layers]
        if self.unassigned_layers:
            lines.append("The following layers were not assigned any weights:")
            lines += [f"- {n}" for n in self.unassigned_layers]
        if self.unconsumed_weights:
            lines.append("The following weights were not consumed from .h5 file:")
            lines += [f"- {n} {s}" for n, s in self.unconsumed_weights]
        if self.unassigned_weights:
            lines.append("The following weights were not assigned any values:")
            lines += [f"- {n} {s}" for n, s in self.unassigned_weights]
        if self.mismatched:
            lines.append("The following weights were skipped (shape mismatch):")
            lines += [f"- {n} file{fs} vs model{ms}" for n, fs, ms in self.mismatched]
        return "\n".join(lines) if lines else "all weights matched"

    def log(self, print_fn=print) -> None:
        if not self.fully_matched:
            print_fn(self.summary())


def _read_group_tree(group, kind: str):
    """One h5 layer group → a flax subtree (bn: both collections)."""
    if kind == "pe":
        names = _decode(group.attrs["weight_names"])
        return np.asarray(group[names[0]], dtype=np.float32)
    if kind == "dense":
        return _dense(list(_group_weights(group).values())[0])
    if kind == "ln":
        return _ln(list(_group_weights(group).values())[0])
    if kind == "bn":
        gamma, beta, mean, var = list(_group_weights(group).values())[0]
        return {"params": {"scale": gamma, "bias": beta},
                "batch_stats": {"mean": mean, "var": var}}
    if kind in ("block", "strided_block"):
        return _block_params(group, strided=kind == "strided_block")
    raise ValueError(f"unknown layer kind {kind!r}")


def _leaf_items(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tuple(np.shape(tree))


def _merge_with_template(loaded, template, path, transform, report, skip_mismatch):
    """Merge a loaded subtree into the template's structure, leaf by leaf."""
    if not isinstance(template, dict):
        tshape = tuple(np.shape(template))
        if isinstance(loaded, dict):
            report.unassigned_weights.append((path, tshape))
            for n, s in _leaf_items(loaded, path):
                report.unconsumed_weights.append((n, s))
            return template
        if tuple(loaded.shape) != tshape:
            if not skip_mismatch:
                raise ValueError(
                    f"Shape mismatch for weight {path}: file has "
                    f"{tuple(loaded.shape)}, model expects {tshape}. "
                    f"Pass skip_mismatch=True to skip it.")
            report.mismatched.append((path, tuple(loaded.shape), tshape))
            return template
        report.assigned.append(path)
        return transform(path, loaded) if transform is not None else loaded
    if not isinstance(loaded, dict):
        report.unconsumed_weights.append((path, tuple(np.shape(loaded))))
        for n, s in _leaf_items(template, path):
            report.unassigned_weights.append((n, s))
        return template
    out = {}
    for k, tv in template.items():
        child = f"{path}/{k}" if path else k
        if k in loaded:
            out[k] = _merge_with_template(loaded[k], tv, child, transform, report,
                                          skip_mismatch)
        else:
            out[k] = tv
            for n, s in _leaf_items(tv, child):
                report.unassigned_weights.append((n, s))
    for k, lv in loaded.items():
        if k not in template:
            for n, s in _leaf_items(lv, f"{path}/{k}" if path else k):
                report.unconsumed_weights.append((n, s))
    return out


def load_keras_h5_by_name(path: str, model, transform=None, skip_mismatch: bool = False,
                          verbose: bool = True) -> WeightLoadReport:
    """Name-based partial loading of a reference-format `.h5` into `model`.

    Layers are matched by name: layers of the file the model lacks, and
    layers or weights of the model the file lacks, are tolerated and
    reported; the model keeps its own values for what the file does not
    hold. Shape clashes raise unless `skip_mismatch` (then they are skipped
    and reported), as Keras' `load_weights_from_hdf5_group_by_name`.
    `transform(path, value) -> value` applies per loaded weight (reference
    `KerasWeightLoadingCallback`, `weight_io.py:54-73`). Returns the report,
    whose paths are the JAX package's flax paths.
    """
    import h5py

    report = WeightLoadReport()
    plan = _model_layer_plan(model)
    loaded: Dict[str, object] = {}
    with h5py.File(path, "r") as f:
        if "layer_names" not in f.attrs and "model_weights" in f:
            f = f["model_weights"]
        file_layers = _decode(f.attrs["layer_names"])
        consumed = {name: False for name in file_layers}
        for key, layer_name, kind in plan:
            if layer_name not in consumed:
                report.unassigned_layers.append(layer_name)
                continue
            try:
                loaded[key] = _read_group_tree(f[layer_name], kind)
            except Exception as e:  # malformed group → a mismatch, not a crash
                if not skip_mismatch:
                    raise ValueError(
                        f"Layer {layer_name!r} in {path} could not be parsed as kind "
                        f"{kind!r}: {e}. Pass skip_mismatch=True to skip it.") from e
                report.mismatched.append((layer_name, (), ()))
                continue
            consumed[layer_name] = True
        report.unconsumed_layers = [n for n, c in consumed.items() if not c]

    is_bn = lambda v: isinstance(v, dict) and "params" in v and "batch_stats" in v
    params_loaded = {k: (v["params"] if is_bn(v) else v) for k, v in loaded.items()}
    bn_loaded = {k: v["batch_stats"] for k, v in loaded.items() if is_bn(v)}
    load_merged(params_loaded, bn_loaded, model, report, transform, skip_mismatch)
    if verbose:
        report.log()
    return report


def load_merged(params_loaded: Dict, bn_loaded: Dict, model, report: WeightLoadReport,
                transform=None, skip_mismatch: bool = False) -> None:
    """Merge the layers read from a file (flax-named params and batch stats)
    into `model`'s own weights leaf by leaf, recording into `report`, and
    load the result: what the file lacks keeps the model's values."""
    template = params_to_jax({}, model)
    variables = {"params": _merge_with_template(params_loaded, template["params"], "",
                                                transform, report, skip_mismatch)}
    if "batch_stats" in template or bn_loaded:
        bn_report = WeightLoadReport()  # stats follow their params' fate
        variables["batch_stats"] = _merge_with_template(
            bn_loaded, template.get("batch_stats", {}), "", None, bn_report, skip_mismatch)
        report.mismatched += bn_report.mismatched
    state = params_from_jax(variables)
    state = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(state, strict=False)


# ---------------------------------------------------------------------------
# Export: state_dict → Keras-legacy h5 (the JAX package's save_keras_h5 layout)
# ---------------------------------------------------------------------------

class _KerasNamer:
    """Reproduces Keras' global auto-naming counters (dense, dense_1, ...)."""

    def __init__(self):
        self.counts: Dict[str, int] = {}

    def __call__(self, base: str) -> str:
        n = self.counts.get(base, 0)
        self.counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"


def save_keras_h5(path: str, state: Optional[Mapping[str, torch.Tensor]], model,
                  model_scope: str = "uplift_upsample_transformer") -> None:
    """Write `model`'s weights, with `state` (e.g. the EMA weights, keyed like
    `model.named_parameters()`) in place of its own where given, as a
    Keras-legacy `.h5` weight file in the JAX package's export layout."""
    import h5py

    variables = params_to_jax(state or {}, model)
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    namer = _KerasNamer()
    layers: List = []  # (layer_name, [(weight_name, array), ...])

    def add_fc(layer_name, p):
        layers.append((layer_name, [
            (f"{model_scope}/{layer_name}/kernel:0", p["kernel"]),
            (f"{model_scope}/{layer_name}/bias:0", p["bias"]),
        ]))

    def add_pe(layer_name, arr):
        layers.append((layer_name, [(f"{layer_name}/positional_encoding_weights:0", arr)]))

    def add_token(layer_name, arr):
        layers.append((layer_name, [(f"{layer_name}/learnable_masked_token:0", arr)]))

    def add_block(layer_name, p, strided):
        entries = []
        scope = f"{model_scope}/{layer_name}"
        mha_name = namer("mha")
        ln1 = namer("layer_normalization")
        entries += [(f"{scope}/{ln1}/gamma:0", p["norm1"]["scale"]),
                    (f"{scope}/{ln1}/beta:0", p["norm1"]["bias"])]
        for w in ("wq", "wk", "wv", "proj"):
            d = namer("dense")
            sub = p["attn"][w]
            entries.append((f"{scope}/{mha_name}/{d}/kernel:0", sub["kernel"]))
            if "bias" in sub:
                entries.append((f"{scope}/{mha_name}/{d}/bias:0", sub["bias"]))
        ln2 = namer("layer_normalization")
        entries += [(f"{scope}/{ln2}/gamma:0", p["norm2"]["scale"]),
                    (f"{scope}/{ln2}/beta:0", p["norm2"]["bias"])]
        mlp_name = namer("strided_mlp") if strided else namer("mlp")
        if strided:
            c1, c2 = namer("conv1d"), namer("conv1d")
            fc1_kernel = p["mlp"]["fc1"]["kernel"][None]  # (in, h) → (1, in, h)
            entries += [(f"{scope}/{mlp_name}/{c1}/kernel:0", fc1_kernel),
                        (f"{scope}/{mlp_name}/{c1}/bias:0", p["mlp"]["fc1"]["bias"]),
                        (f"{scope}/{mlp_name}/{c2}/kernel:0", p["mlp"]["fc2"]["kernel"]),
                        (f"{scope}/{mlp_name}/{c2}/bias:0", p["mlp"]["fc2"]["bias"])]
        else:
            d1, d2 = namer("dense"), namer("dense")
            entries += [(f"{scope}/{mlp_name}/{d1}/kernel:0", p["mlp"]["fc1"]["kernel"]),
                        (f"{scope}/{mlp_name}/{d1}/bias:0", p["mlp"]["fc1"]["bias"]),
                        (f"{scope}/{mlp_name}/{d2}/kernel:0", p["mlp"]["fc2"]["kernel"]),
                        (f"{scope}/{mlp_name}/{d2}/bias:0", p["mlp"]["fc2"]["bias"])]
        layers.append((layer_name, entries))

    def add_bn(layer_name):
        p, bs = params[layer_name], batch_stats[layer_name]
        scope = f"{model_scope}/{layer_name}"
        layers.append((layer_name, [
            (f"{scope}/gamma:0", p["scale"]), (f"{scope}/beta:0", p["bias"]),
            (f"{scope}/moving_mean:0", bs["mean"]),
            (f"{scope}/moving_variance:0", bs["var"]),
        ]))

    if model.spatial_depth > 0:
        add_fc("keypoint_embedding", params["keypoint_embedding"])
        add_pe("spatial_pe", params["spatial_pe"])
    add_pe("temporal_pe", params["temporal_pe"])
    for i in range(1, len(model.strides) + 1):
        add_pe(f"strided_temporal_pe_{i}", params[f"strided_temporal_pe_{i}"])
    if model.token_mask_rate > 0 and model.learnable_masked_token:
        add_token("learnable_masked_token_layer", params["masked_token"])
    if model.has_strided_input:
        add_token("strided_input_token_layer", params["strided_input_token"])
    for i in range(1, model.spatial_depth + 1):
        add_block(f"spatial_block_{i}", params[f"spatial_block_{i}"], strided=False)
    if model.spatial_depth > 0:
        layers.append(("spatial_norm", [
            (f"{model_scope}/spatial_norm/gamma:0", params["spatial_norm"]["scale"]),
            (f"{model_scope}/spatial_norm/beta:0", params["spatial_norm"]["bias"])]))
    add_fc("spatial_to_temporal_fc", params["spatial_to_temporal_fc"])
    for i in range(1, model.temporal_depth + 1):
        add_block(f"temporal_block_{i}", params[f"temporal_block_{i}"], strided=False)
    for i in range(1, len(model.strides) + 1):
        add_block(f"strided_temporal_block_{i}", params[f"strided_temporal_block_{i}"],
                  strided=True)
    if model.full_output and model.temporal_depth > 0:
        if model.output_bn:
            add_bn("temporal_norm")
        add_fc("temporal_fc", params["temporal_fc"])
    if model.output_bn:
        add_bn("strided_temporal_norm")
    add_fc("strided_temporal_fc", params["strided_temporal_fc"])

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [name.encode("utf8") for name, _ in layers]
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.4.0"
        for layer_name, entries in layers:
            g = f.create_group(layer_name)
            g.attrs["weight_names"] = [w.encode("utf8") for w, _ in entries]
            for wname, arr in entries:
                g.create_dataset(wname, data=np.asarray(arr, dtype=np.float32))
