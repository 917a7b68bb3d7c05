"""Checkpoint save / restore with torch.save (counterpart of
tsm_det_pointcloud_tpu/runtime/checkpoint.py:35-92): one file per epoch,
`<ckpt_dir>/checkpoint_epoch_<E>.pth`, holding {model_state,
optimizer_state, epoch, it}; only the `max_ckpt_save_num` newest are kept.
`partial_load` and `transfer_statistics` (the counterparts of :95-148) hand
a teacher checkpoint to a distillation run.
"""
from __future__ import annotations

import re
from pathlib import Path

import torch

from ..models.dense_heads.point_head_vote import STATISTIC_BUFFERS

_PATTERN = re.compile(r"checkpoint_epoch_(\d+)\.pth$")


def _epoch_of(path):
    return int(_PATTERN.search(path.name).group(1))


def _checkpoints(ckpt_dir):
    return sorted((p for p in Path(ckpt_dir).glob("checkpoint_epoch_*.pth")
                   if _PATTERN.search(p.name)), key=_epoch_of)


def save_checkpoint(model, optimizer, ckpt_dir, epoch, it, max_ckpt_save_num=30):
    """Write epoch `epoch`'s checkpoint and drop the oldest beyond
    max_ckpt_save_num. Returns its path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"checkpoint_epoch_{int(epoch)}.pth"
    torch.save({"model_state": model.state_dict(),
                "optimizer_state": optimizer.state_dict(),
                "epoch": int(epoch), "it": int(it)}, path)
    ckpts = _checkpoints(ckpt_dir)
    while len(ckpts) > max_ckpt_save_num:
        ckpts.pop(0).unlink()
    return path


def latest_checkpoint(ckpt_dir):
    ckpts = _checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def restore_checkpoint(path, model, optimizer=None):
    """Load a checkpoint into `model` (strict) and `optimizer`; returns
    (epoch, it)."""
    dev = next(model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(ckpt["model_state"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer_state"])
    return ckpt["epoch"], ckpt["it"]


def load_model_state(path):
    """The model state of a checkpoint file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)["model_state"]


def _copy_into(model, keys, state):
    target = model.state_dict()
    with torch.no_grad():
        for dst, src in keys:
            target[dst].copy_(state[src])


def partial_load(model, state):
    """strict=False load: copy each entry of `state` whose key and shape
    match an entry of the model's state dict (its parameters and buffers,
    as the reference's `load_state_dict(strict=False)` does,
    detector3d_template.py:588-594). Returns the model's keys that were
    not given."""
    target = model.state_dict()
    hit = {k for k, v in target.items()
           if k in state and tuple(state[k].shape) == tuple(v.shape)}
    _copy_into(model, ((k, k) for k in hit), state)
    return [k for k in target if k not in hit]


def transfer_statistics(model, state):
    """Copy the class-statistics buffers (object_statistic_features,
    object_momentum, object_mean) of `state` into the model by leaf name
    and shape, whatever their nesting: the teacher head's branch owns them
    (module_list.1.head.object_*) while the distillation head keeps one
    shared set at its own scope (module_list.1.object_*).

    A structural copy would miss them and leave the student's statistics
    at zeros, which silently turns the multiplicative statistic
    conditioning (`shared * statistics[i]`, the head's cls blocks) into a
    constant-zero classifier. The leaf names are unique, so matching by
    name is exact. Returns the model keys that were filled."""
    names = set(STATISTIC_BUFFERS)
    src = {}
    for k, v in state.items():
        leaf = k.rpartition(".")[2]
        if leaf in names:
            src.setdefault(leaf, (k, v))
    moved = []
    for k, v in model.state_dict().items():
        leaf = k.rpartition(".")[2]
        if leaf in src and tuple(src[leaf][1].shape) == tuple(v.shape):
            moved.append((k, src[leaf][0]))
    _copy_into(model, moved, state)
    return [dst for dst, _ in moved]
