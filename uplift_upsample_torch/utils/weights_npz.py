"""The JAX package's npz weight format (`tools/convert_weights.py`), read and written.

An npz holds the flax variables flattened to '/'-joined paths under two
prefixes: `params||keypoint_embedding/kernel`, ...; `batch_stats||...` for the
output BatchNorm heads' statistics. Leaves keep the flax layouts (Dense kernel
(in, out), Conv1D kernel (k, in, out)), and the file is numpy alone: no h5py is
needed to read or write it, so it is how weights reach the card's machine. A
file written by either package loads in the other.

`load_weights` / `load_weights_by_name` are the CLIs' `--weights`: they
dispatch on the extension, `.h5` to `utils/weights_h5.py` and `.npz` here.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .weights_h5 import (WeightLoadReport, _model_layer_plan, h5_layer_name,
                         load_keras_h5, load_keras_h5_by_name, load_merged,
                         params_from_jax, params_to_jax)


def flatten(tree, prefix=""):
    """Copied from `tools/convert_weights.py`: a nested dict → {'a/b/c': array}."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten(flat):
    """Copied from `tools/convert_weights.py`: the inverse of `flatten`."""
    tree = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def read_npz(path: str) -> Dict:
    """The variables `{"params": ..., "batch_stats": ...}` of an npz weight
    file (batch_stats only when the file has them)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    for key in flat:
        if not key.startswith(("params||", "batch_stats||")):
            raise ValueError(f"{path}: key {key!r} is not a params|| or batch_stats|| "
                             f"key of the convert_weights npz format")
    tree = {"params": unflatten({k.split("||", 1)[1]: v for k, v in flat.items()
                                 if k.startswith("params||")})}
    stats = {k.split("||", 1)[1]: v for k, v in flat.items() if k.startswith("batch_stats||")}
    if stats:
        tree["batch_stats"] = unflatten(stats)
    return tree


def save_npz(path: str, state: Optional[Mapping[str, torch.Tensor]], model) -> None:
    """Write `model`'s weights, with `state` (e.g. the EMA weights) in place of
    its own where given, in the convert_weights npz layout."""
    variables = params_to_jax(state or {}, model)
    flat = {f"params||{k}": v for k, v in flatten(variables["params"]).items()}
    for k, v in flatten(variables.get("batch_stats", {})).items():
        flat[f"batch_stats||{k}"] = v
    np.savez(path, **flat)


def load_npz(path: str, model):
    """Load an npz weight file into `model` (strict: every weight of the model
    and no other, in its shape); returns it."""
    model.load_state_dict(params_from_jax(read_npz(path)), strict=True)
    return model


def load_npz_by_name(path: str, model, transform=None, skip_mismatch: bool = False,
                     verbose: bool = True) -> WeightLoadReport:
    """Name-based partial loading of an npz weight file, with the report of
    `load_keras_h5_by_name`: layers of the file the model lacks, and layers
    or weights of the model the file lacks, are tolerated and reported (layers
    by their .h5 names); shape clashes raise unless `skip_mismatch`;
    `transform(path, value) -> value` applies per loaded weight."""
    tree = read_npz(path)
    params, stats = tree["params"], tree.get("batch_stats", {})
    report = WeightLoadReport()
    plan = _model_layer_plan(model)
    params_loaded, bn_loaded = {}, {}
    for key, layer_name, kind in plan:
        if key not in params:
            report.unassigned_layers.append(layer_name)
            continue
        params_loaded[key] = params[key]
        if kind == "bn" and key in stats:
            bn_loaded[key] = stats[key]
    planned = {key for key, _, _ in plan}
    report.unconsumed_layers = [h5_layer_name(k) for k in params if k not in planned]
    load_merged(params_loaded, bn_loaded, model, report, transform, skip_mismatch)
    if verbose:
        report.log()
    return report


def _weights_format(path: str) -> str:
    ext = os.path.splitext(path)[1]
    if ext not in (".h5", ".npz"):
        raise ValueError(f"unsupported weights file {path!r}: expected .h5 (Keras "
                         f"save_weights) or .npz (tools/convert_weights.py's layout)")
    return ext


def load_weights(path: str, model):
    """The CLIs' `--weights`, strict: `.h5` or `.npz` by the extension."""
    if _weights_format(path) == ".npz":
        return load_npz(path, model)
    return load_keras_h5(path, model)


def load_weights_by_name(path: str, model, **kwargs) -> WeightLoadReport:
    """The training CLI's `--weights`, by name: `.h5` or `.npz` by the extension."""
    if _weights_format(path) == ".npz":
        return load_npz_by_name(path, model, **kwargs)
    return load_keras_h5_by_name(path, model, **kwargs)
