"""Carry weights from the JAX package's flax variables to the port.

`from_flax_variables(variables_np)` takes the nested dict of numpy arrays
that `model.init(..., training=True)` returns (collections `params`,
`batch_stats` and `statistics`, keyed by flax path) and returns a torch
`state_dict` for the port's detector:

  * a Dense `kernel` (in, out) is transposed to `weight` (out, in); its
    `bias` is copied;
  * BatchNorm `scale` / `bias` become `weight` / `bias`, `batch_stats`
    `mean` / `var` become `running_mean` / `running_var` (each BN's eps is
    fixed by the layer it belongs to: 1e-3 on the eval path);
  * sparse-conv kernels (K, Cin, Cout) keep their layout as `weight`;
  * `statistics/*` become buffers of the head.

Leaves of the teacher head (`module_list_1/head/...`) and of teacher SA
layers past layer 0 (`module_list_0/sa1/...`) are not on the eval path:
they are listed, not converted. Any other leaf that no rule consumes
raises.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

_UNUSED = (re.compile(r"^module_list_1/head/"),
           re.compile(r"^module_list_0/sa([1-9]\d*)/"))


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
        if leaf == "scale" and arr.ndim == 1:
            return f"{tmod}.weight", arr
        if leaf == "bias" and arr.ndim == 1:
            return f"{tmod}.bias", arr
    elif collection == "batch_stats":
        if leaf == "mean":
            return f"{tmod}.running_mean", arr
        if leaf == "var":
            return f"{tmod}.running_var", arr
    elif collection == "statistics":
        return _torch_path(path), arr
    raise ValueError(f"no conversion rule for flax leaf {collection}/{path} "
                     f"{arr.shape}")


def from_flax_variables(variables_np, return_unused=False):
    """flax variables (numpy leaves) -> torch state_dict (and, with
    return_unused, the sorted list of leaves off the eval path)."""
    state = OrderedDict()
    unused = []
    for collection in ("params", "batch_stats", "statistics"):
        tree = variables_np.get(collection, {})
        for path, arr in _flatten(tree):
            if any(p.match(path) for p in _UNUSED):
                unused.append(f"{collection}/{path}")
                continue
            key, val = _convert_leaf(collection, path, arr)
            if key in state:
                raise ValueError(f"two flax leaves map to {key}")
            state[key] = torch.tensor(np.asarray(val, np.float32))
    other = set(variables_np) - {"params", "batch_stats", "statistics"}
    if other:
        raise ValueError(f"unknown flax collections {sorted(other)}")
    if return_unused:
        return state, sorted(unused)
    return state
