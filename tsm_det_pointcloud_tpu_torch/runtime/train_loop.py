"""Training loop (counterpart of tsm_det_pointcloud_tpu/runtime/train_loop.py).

Losses come back from `train_step` as device tensors and are read on the
host only every `log_every` steps and at the end of an epoch, so the host
runs ahead of the card in the steady state.
"""
from __future__ import annotations

import time

import torch

from .checkpoint import save_checkpoint
from .train_state import train_step


def train_one_epoch(model, optimizer, loader, epoch, total_epochs, log=print,
                    log_every=50):
    """One pass over `loader` (an iterable of device batches). Returns the
    epoch's mean loss."""
    losses = []
    n = len(loader)
    t0 = time.perf_counter()
    for i, batch in enumerate(loader):
        loss, tb = train_step(model, optimizer, batch)
        losses.append(loss)
        if log is not None and (i % log_every == 0 or i + 1 == n):
            it = optimizer.state["count"]
            log(f"epoch {epoch}/{total_epochs} iter {i}/{n} loss {float(loss):.4f} "
                f"lr {optimizer.lr_fn(it - 1):.6f} "
                f"{(time.perf_counter() - t0) / (i + 1):.3f} s/step")
    if not losses:
        return float("nan")
    return float(torch.stack(losses).mean())


def train_model(model, optimizer, loader, ckpt_dir, total_epochs, start_epoch=0,
                log=print, log_every=50, max_ckpt_save_num=30):
    """Train from start_epoch to total_epochs, checkpointing each epoch."""
    for epoch in range(start_epoch, total_epochs):
        mean_loss = train_one_epoch(model, optimizer, loader, epoch, total_epochs,
                                    log=log, log_every=log_every)
        if log is not None:
            log(f"epoch {epoch} done: mean loss {mean_loss:.4f}")
        if ckpt_dir is not None:
            save_checkpoint(model, optimizer, ckpt_dir, epoch + 1,
                            optimizer.state["count"], max_ckpt_save_num)
    return model
