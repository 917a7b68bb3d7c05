"""Checkpoint save / restore with torch.save (counterpart of
tsm_det_pointcloud_tpu/runtime/checkpoint.py:35-92): one file per epoch,
`<ckpt_dir>/checkpoint_epoch_<E>.pth`, holding {model_state,
optimizer_state, epoch, it}; only the `max_ckpt_save_num` newest are kept.
"""
from __future__ import annotations

import re
from pathlib import Path

import torch

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
