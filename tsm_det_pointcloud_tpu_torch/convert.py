"""Carry weights from the JAX package's flax variables to the port.

`from_flax_variables(variables_np)` takes the nested dict of numpy arrays
that `model.init(..., training=True)` returns (collections `params`,
`batch_stats` and `statistics`, keyed by flax path) and returns a torch
`state_dict` for the port's detector:

  * a Dense `kernel` (in, out) is transposed to `weight` (out, in); its
    `bias` is copied;
  * BatchNorm `scale` / `bias` become `weight` / `bias`, `batch_stats`
    `mean` / `var` become `running_mean` / `running_var` (each BN's eps and
    momentum are fixed by the layer it belongs to: 1e-3 / 0.99, and 1e-5 /
    0.9 for the teacher head's gate BNs);
  * sparse-conv kernels (K, Cin, Cout) keep their layout as `weight`;
  * a 2D `nn.Conv` kernel (kh, kw, Cin, Cout) becomes the `nn.Conv2d`
    `weight` (Cout, Cin, kh, kw);
  * a 2D `nn.ConvTranspose` kernel (the BEV backbone's `deblock*`),
    (kh, kw, Cin, Cout), becomes the `nn.ConvTranspose2d` `weight`
    (Cin, Cout, kh, kw) flipped in both spatial axes: flax's default
    `transpose_kernel=False` does not flip the kernel, torch's transposed
    convolution does;
  * the teacher head's `reg_weight` (1, 1, 64, code) is copied;
  * `statistics/*` become buffers of the head.

Every leaf of a TSM training init and of a SECOND init is consumed; a leaf
that no rule consumes raises.

`flax_view(state_dict)` is the inverse: each entry of a port state dict as
the flax leaf it comes from (collection, path, value in the flax layout), in
the order jax.tree_util flattens a flax tree (sorted keys at every level);
`to_flax_variables(state_dict)` nests them as flax variables.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

from .models.dense_heads.point_head_vote import STATISTIC_BUFFERS


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def _torch_path(path):
    return re.sub(r"module_list_(\d+)", r"module_list.\1", path).replace("/", ".")


def _convert_leaf(collection, path, arr):
    mod, _, leaf = path.rpartition("/")
    tmod = _torch_path(mod)
    if collection == "params":
        if leaf == "kernel" and arr.ndim == 2:
            return f"{tmod}.weight", arr.T
        if leaf == "kernel" and arr.ndim == 3:
            return f"{tmod}.weight", arr
        if leaf == "kernel" and arr.ndim == 4:
            if re.fullmatch(r"deblock(\d+|_final)", mod.rpartition("/")[2]):
                return f"{tmod}.weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
            return f"{tmod}.weight", arr.transpose(3, 2, 0, 1)
        if leaf == "scale" and arr.ndim == 1:
            return f"{tmod}.weight", arr
        if leaf == "bias" and arr.ndim == 1:
            return f"{tmod}.bias", arr
        if leaf == "reg_weight" and arr.ndim == 4:
            return f"{tmod}.reg_weight", arr
    elif collection == "batch_stats":
        if leaf == "mean":
            return f"{tmod}.running_mean", arr
        if leaf == "var":
            return f"{tmod}.running_var", arr
    elif collection == "statistics":
        return _torch_path(path), arr
    raise ValueError(f"no conversion rule for flax leaf {collection}/{path} "
                     f"{arr.shape}")


def _flax_leaf(key, arr):
    """(collection, flax path, value in the flax layout) of a port state
    dict entry: the inverse of _convert_leaf."""
    mod, _, leaf = key.rpartition(".")
    fmod = re.sub(r"module_list\.(\d+)", r"module_list_\1", mod).replace(".", "/")
    if leaf in STATISTIC_BUFFERS:
        return "statistics", f"{fmod}/{leaf}", arr
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", f"{fmod}/{leaf[len('running_'):]}", arr
    if leaf in ("bias", "reg_weight"):
        return "params", f"{fmod}/{leaf}", arr
    if leaf == "weight" and arr.ndim == 1:
        return "params", f"{fmod}/scale", arr
    if leaf == "weight" and arr.ndim == 2:
        return "params", f"{fmod}/kernel", arr.T
    if leaf == "weight" and arr.ndim == 3:
        return "params", f"{fmod}/kernel", arr
    if leaf == "weight" and arr.ndim == 4:
        if re.fullmatch(r"deblock(\d+|_final)", fmod.rpartition("/")[2]):
            return "params", f"{fmod}/kernel", arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        return "params", f"{fmod}/kernel", arr.transpose(2, 3, 1, 0)
    raise ValueError(f"no flax leaf for port entry {key} {arr.shape}")


def flax_view(state):
    """[(collection, flax path, torch key, numpy value in the flax layout)]
    for every entry of a port state dict, sorted as jax.tree_util flattens
    the flax variables (collection, then path components); each round-trips
    through _convert_leaf to its own key and value."""
    out = []
    for key, t in state.items():
        arr = t.detach().cpu().numpy()
        coll, path, flax_arr = _flax_leaf(key, arr)
        back_key, back = _convert_leaf(coll, path, flax_arr)
        if back_key != key or back.shape != arr.shape or not np.array_equal(back, arr):
            raise ValueError(f"port entry {key} does not round-trip through {coll}/{path}")
        out.append((coll, path, key, flax_arr))
    return sorted(out, key=lambda e: (e[0], tuple(e[1].split("/"))))


def to_flax_variables(state):
    """A port state dict as flax variables: {collection: nested dict of
    numpy leaves}, the inverse of from_flax_variables."""
    tree = {}
    for coll, path, _, arr in flax_view(state):
        d = tree.setdefault(coll, {})
        *mods, leaf = path.split("/")
        for m in mods:
            d = d.setdefault(m, {})
        d[leaf] = arr
    return tree


def from_flax_variables(variables_np):
    """flax variables (numpy leaves) -> torch state_dict."""
    state = OrderedDict()
    for collection in ("params", "batch_stats", "statistics"):
        tree = variables_np.get(collection, {})
        for path, arr in _flatten(tree):
            key, val = _convert_leaf(collection, path, arr)
            if key in state:
                raise ValueError(f"two flax leaves map to {key}")
            state[key] = torch.tensor(np.array(val, np.float32, order="C"))
    other = set(variables_np) - {"params", "batch_stats", "statistics"}
    if other:
        raise ValueError(f"unknown flax collections {sorted(other)}")
    return state
