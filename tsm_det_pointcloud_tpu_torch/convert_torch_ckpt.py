"""Convert a reference OpenPCDet checkpoint (.pth) into a checkpoint of this
package (the counterpart of the JAX package's tools/convert_torch_ckpt.py):

    python -m tsm_det_pointcloud_tpu_torch.convert_torch_ckpt --ckpt REF.pth \\
        --cfg_file tools/cfgs/kitti_models/fast_cpc.yaml --out OUT.pth

The file's `model_state` (else the whole dict) is read with
torch.load(weights_only=True). Each name is mapped by RULES to a flax
collection and path, and each tensor to the flax layout (`convert_weight`):

  Conv1d / Conv2d 1x1 (Cout, Cin, 1[, 1]), Linear (Cout, Cin) -> (Cin, Cout)
  Conv2d kxk (Cout, Cin, kh, kw)                              -> (kh, kw, Cin, Cout)
  spconv (Cout, kz, ky, kx, Cin) or (kz, ky, kx, Cin, Cout)   -> (K, Cin, Cout)
  BatchNorm weight / bias / running_mean / running_var        -> scale / bias / mean / var
  point_head.object_{statistic_features, momentum, mean}      -> the statistics

Then each converted tensor is grafted, as the JAX tool's `graft_into_tree`
does, onto a leaf of the config's detector, built on the CPU with seeded
weights: the leaves with the same leaf name and flax shape are its
candidates; of several, the one sharing the most path components wins, and
of those the first in the flax tree's order. The detector's entries are
visited in their flax form (`convert.flax_view`: the flax path, layout and
order of each), so that both packages place a checkpoint's tensors on the
same leaves; each placed tensor then goes to the port's layout by
`convert.from_flax_variables`' rule. The output holds {model_state,
optimizer_state: {}, epoch, it}, the layout `runtime.checkpoint` reads:
`evaluate --ckpt`, `train --pretrained_model` and `demo --ckpt` take it.

The report, as the reference's strict=False load shows it: the tensors
converted, the names no rule maps (unmatched), the converted tensors no
leaf takes (unplaced), and the tensors placed among more than one
candidate, which the rule decides by name overlap and order alone.

`reference_state_dict` writes a synthetic checkpoint in these layouts from
a port state dict (the tests and chip_smoke.py hold the converter with it:
no reference checkpoint is at hand).
"""
from __future__ import annotations

import argparse
import re
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from .convert import _convert_leaf, flax_view


def convert_weight(name, arr):
    """Shape-convert one torch tensor to the flax layout."""
    if name.endswith(".weight"):
        if arr.ndim == 2:                      # Linear
            return arr.T
        if arr.ndim == 3 and arr.shape[2] == 1:  # Conv1d 1x1
            return arr[:, :, 0].T
        if arr.ndim == 4 and arr.shape[2] == arr.shape[3] == 1:  # Conv2d 1x1
            return arr[:, :, 0, 0].T
        if arr.ndim == 4:                      # Conv2d kxk
            return arr.transpose(2, 3, 1, 0)
        if arr.ndim == 5:
            # spconv kernels: (Cout, kz, ky, kx, Cin) or (kz, ky, kx, Cin, Cout)
            if arr.shape[1] == arr.shape[2] == arr.shape[3]:
                k = arr.shape[1]
                tap_major = arr.transpose(1, 2, 3, 4, 0)  # kz, ky, kx, Cin, Cout
            else:
                k = arr.shape[0]
                tap_major = arr
            return tap_major.reshape(k ** 3, tap_major.shape[-2], tap_major.shape[-1])
    return arr


# reference dotted name -> (collection, flax path template)
RULES = [
    (r"point_head\.object_statistic_features$",
     ("statistics", "point_head/object_statistic_features")),
    (r"point_head\.object_momentum$",
     ("statistics", "point_head/object_momentum")),
    (r"point_head\.object_mean$",
     ("statistics", "point_head/object_mean")),
    (r"(.*)\.running_mean$", ("batch_stats", r"\1/mean")),
    (r"(.*)\.running_var$", ("batch_stats", r"\1/var")),
    (r"(.*bn.*)\.weight$", ("params", r"\1/scale")),
    (r"(.*bn.*)\.bias$", ("params", r"\1/bias")),
    (r"(.*)\.weight$", ("params", r"\1/kernel")),
    (r"(.*)\.bias$", ("params", r"\1/bias")),
]


def map_name(name):
    for pat, (coll, tmpl) in RULES:
        m = re.match(pat, name)
        if m:
            return coll, m.expand(tmpl).replace(".", "/")
    return None, None


def convert_state_dict(state_dict):
    """torch state dict -> ({collection: {slash/path: ndarray}}, unmatched
    names)."""
    out = {"params": {}, "batch_stats": {}, "statistics": {}}
    unmatched = []
    for name, tensor in state_dict.items():
        arr = (tensor.detach().cpu().numpy() if hasattr(tensor, "detach")
               else np.asarray(tensor))
        coll, path = map_name(name)
        if coll is None:
            unmatched.append(name)
            continue
        out[coll][path] = convert_weight(name, arr)
    return out, unmatched


def graft(template_state, converted):
    """Place `converted` ({collection: {path: flax-layout array}}) onto the
    port state dict `template_state` by the JAX graft's rule (see the module
    docstring). Returns (the new state dict, {collection: {source path:
    port key}} of the placements, the unplaced source paths, the source
    paths placed among more than one candidate)."""
    view = flax_view(template_state)
    key_of = {(c, path): key for c, path, key, _ in view}
    state = OrderedDict((k, v.detach().clone()) for k, v in template_state.items())
    placements, unplaced, tied = {}, [], []
    for coll in ("params", "batch_stats", "statistics"):
        by_suffix = {}
        for c, path, key, arr in view:
            if c == coll:
                parts = path.split("/")
                by_suffix.setdefault((parts[-1], arr.shape), []).append(parts)
        placed, where = {}, {}
        for src_path, arr in converted.get(coll, {}).items():
            cands = by_suffix.get((src_path.split("/")[-1], arr.shape), [])
            if len(cands) > 1:
                tied.append(src_path)
                src_parts = set(src_path.lower().split("/"))
                cands = sorted(cands, key=lambda p: len(src_parts & {k.lower() for k in p}),
                               reverse=True)[:1]
            if cands:
                placed["/".join(cands[0])] = arr
                where[src_path] = "/".join(cands[0])
            else:
                unplaced.append(src_path)
        for path, arr in placed.items():
            key, val = _convert_leaf(coll, path, arr)
            state[key] = torch.tensor(np.array(val, np.float32, order="C"))
        placements[coll] = {src: key_of[coll, path] for src, path in where.items()}
    return state, placements, unplaced, tied


def convert_checkpoint(ref_state, template_state):
    """A reference state dict onto a port state dict: (the new state dict, a
    report dict: `converted`, `unmatched`, `unplaced`, `tied` and the
    `placements` of `graft`)."""
    converted, unmatched = convert_state_dict(ref_state)
    state, placements, unplaced, tied = graft(template_state, converted)
    report = dict(converted=sum(len(v) for v in converted.values()), unmatched=unmatched,
                  unplaced=unplaced, tied=tied, placements=placements)
    return state, report


# the reference detector's module names, in its module_list order, by the
# config section that makes each (OpenPCDet's module topology)
MODULE_NAMES = (("VFE", "vfe"), ("BACKBONE_3D", "backbone_3d"),
                ("MAP_TO_BEV", "map_to_bev_module"), ("PFE", "pfe"),
                ("BACKBONE_2D", "backbone_2d"), ("DENSE_HEAD", "dense_head"),
                ("POINT_HEAD", "point_head"), ("ROI_HEAD", "roi_head"))


def reference_state_dict(state, model_cfg):
    """A synthetic reference checkpoint's state dict in OpenPCDet's layouts
    from a port state dict: each flax leaf (`convert.flax_view`) under its
    flax path with module_list.<i> renamed to the reference module that
    config section makes, `.weight` / `.bias` / `.running_mean` /
    `.running_var` leaves, the statistics as point_head.object_*, and its
    value in a reference layout: Dense kernels in turn as Linear, Conv1d
    1x1 and Conv2d 1x1 weights; sparse-conv kernels in turn as
    (Cout, kz, ky, kx, Cin) and (kz, ky, kx, Cin, Cout) (a 3-tap kernel as
    (3, 1, 1)); 2D conv kernels as Conv2d's (Cout, Cin, kh, kw), the BEV
    deblocks as ConvTranspose2d's (Cin, Cout, kh, kw) of the same function.
    Each BN also gets the int64 `num_batches_tracked` the reference's
    carries (a name no rule maps). Returns (the state dict, {reference name:
    the port key its value came from})."""
    modules = [name for section, name in MODULE_NAMES if section in model_cfg]
    ref, source = OrderedDict(), {}
    n_dense = n_sparse = 0
    for coll, path, key, arr in flax_view(state):
        parts = path.split("/")
        if parts[0].startswith("module_list_"):
            parts[0] = modules[int(parts[0][len("module_list_"):])]
        leaf = parts[-1]
        if coll == "statistics":
            name = f"point_head.{leaf}"
        elif coll == "batch_stats":
            name = ".".join(parts[:-1]) + f".running_{leaf}"
        elif leaf in ("kernel", "scale"):
            name = ".".join(parts[:-1]) + ".weight"
        else:
            name = ".".join(parts)
        val = arr
        if leaf == "kernel" and arr.ndim == 2:
            val = (arr.T, arr.T[:, :, None], arr.T[:, :, None, None])[n_dense % 3]
            n_dense += 1
        elif leaf == "kernel" and arr.ndim == 3:
            k = round(arr.shape[0] ** (1 / 3))
            taps = (k, k, k) if k ** 3 == arr.shape[0] else (arr.shape[0], 1, 1)
            tap_major = arr.reshape(*taps, *arr.shape[1:])
            val = tap_major.transpose(4, 0, 1, 2, 3) if n_sparse % 2 == 0 else tap_major
            n_sparse += 1
        elif leaf == "kernel" and arr.ndim == 4:
            if re.fullmatch(r"deblock(\d+|_final)", parts[-2]):
                val = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                val = arr.transpose(3, 2, 0, 1)
        ref[name] = torch.tensor(np.array(val, np.float32, order="C"))
        source[name] = key
        if coll == "params" and leaf == "scale":
            ref[".".join(parts[:-1]) + ".num_batches_tracked"] = torch.tensor(0)
    return ref, source


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="the reference checkpoint (.pth)")
    ap.add_argument("--cfg_file", required=True)
    ap.add_argument("--out", required=True, help="the port checkpoint to write")
    args = ap.parse_args(argv)

    from .infer import dataset_meta, load_cfg
    from .models import build_network

    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=True)
    ref_state = ckpt.get("model_state", ckpt)
    cfg = load_cfg(args.cfg_file)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset_meta(cfg, 16384, "train"),
                          device="cpu")
    state, report = convert_checkpoint(ref_state, model.state_dict())
    print(f"converted {report['converted']} tensors, {len(report['unmatched'])} unmatched: "
          f"{report['unmatched'][:5]}")
    print(f"unplaced tensors ({len(report['unplaced'])}): {report['unplaced'][:10]}")
    print(f"{len(report['tied'])} tensors placed among more than one candidate (the leaf with "
          f"the most path components in common, then the first in the flax order)")
    epoch, it = int(ckpt.get("epoch", 0)), int(ckpt.get("it", 0))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state": state, "optimizer_state": {}, "epoch": epoch, "it": it},
               args.out)
    print(f"wrote {args.out} (epoch {epoch}, it {it})")
    return report


if __name__ == "__main__":
    main()
