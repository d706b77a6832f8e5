"""Keras-legacy `.h5` → flax-named numpy tree → PyTorch state_dict.

The released reference checkpoints are Keras "save_weights" HDF5 files: a
`layer_names` attribute lists top-level layer groups; each group's
`weight_names` attribute lists datasets in variable-creation order
(reference `weight_io.py:125-263`). `read_keras_h5` reads one into the
JAX package's parameter tree (flax names, numpy arrays), and
`params_from_jax` carries such a tree, from either package, into this
package's state_dict. Only the load direction is ported.

Layout changes between the two frameworks:
  Keras/flax Dense kernel (in, out)      → nn.Linear weight (out, in)
  Keras/flax Conv1D kernel (k, in, out)  → nn.Conv1d weight (out, in, k)
  LayerNorm / BatchNorm scale            → weight
  BatchNorm mean / var (batch_stats)     → running_mean / running_var

`h5py` is imported inside the reader: the card's machine does not have it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


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


def _model_layer_plan(model):
    """Ordered (flax param key, h5 layer name, kind) for every model layer."""
    plan = []
    if model.spatial_depth > 0:
        plan.append(("keypoint_embedding", "keypoint_embedding", "dense"))
        plan.append(("spatial_pe", "spatial_pe", "pe"))
        for i in range(1, model.spatial_depth + 1):
            plan.append((f"spatial_block_{i}", f"spatial_block_{i}", "block"))
        plan.append(("spatial_norm", "spatial_norm", "ln"))
    plan.append(("temporal_pe", "temporal_pe", "pe"))
    plan.append(("spatial_to_temporal_fc", "spatial_to_temporal_fc", "dense"))
    if model.has_strided_input:
        plan.append(("strided_input_token", "strided_input_token_layer", "pe"))
    if model.token_mask_rate > 0 and model.learnable_masked_token:
        plan.append(("masked_token", "learnable_masked_token_layer", "pe"))
    for i in range(1, model.temporal_depth + 1):
        plan.append((f"temporal_block_{i}", f"temporal_block_{i}", "block"))
    for i in range(1, len(model.strides) + 1):
        plan.append((f"strided_temporal_pe_{i}", f"strided_temporal_pe_{i}", "pe"))
        plan.append((f"strided_temporal_block_{i}", f"strided_temporal_block_{i}",
                     "strided_block"))
    if model.full_output and model.temporal_depth > 0:
        if model.output_bn:
            plan.append(("temporal_norm", "temporal_norm", "bn"))
        plan.append(("temporal_fc", "temporal_fc", "dense"))
    if model.output_bn:
        plan.append(("strided_temporal_norm", "strided_temporal_norm", "bn"))
    plan.append(("strided_temporal_fc", "strided_temporal_fc", "dense"))
    return plan


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
            group = f[name]
            if kind == "pe":
                names = _decode(group.attrs["weight_names"])
                params[key] = np.asarray(group[names[0]], dtype=np.float32)
            elif kind == "dense":
                params[key] = _dense(list(_group_weights(group).values())[0])
            elif kind == "ln":
                params[key] = _ln(list(_group_weights(group).values())[0])
            elif kind == "bn":
                gamma, beta, mean, var = list(_group_weights(group).values())[0]
                params[key] = {"scale": gamma, "bias": beta}
                batch_stats[key] = {"mean": mean, "var": var}
            else:
                params[key] = _block_params(group, strided=kind == "strided_block")
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
