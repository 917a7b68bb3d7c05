"""Training loop (counterpart of tsm_det_pointcloud_tpu/runtime/train_loop.py).

Losses come back from `train_step` as device tensors and are read on the
host only every `log_every` steps and at the end of an epoch, so the host
runs ahead of the card in the steady state. Given `device`, the loop takes
the loader's host batches and moves them there (`datasets.load_data_to_device`:
non_blocking copies, from pinned memory when the loader pins; frame_id,
calib and image_shape stay on the host) and clocks its wait on the loader.

In a multi-process run (`model` wrapped by `parallel.train_state.
wrap_data_parallel`) every rank steps on its shard; the logged loss and
tb_dict are the ranks' mean (`comm.reduce_dict`, which every rank joins at
the same steps), and only rank 0 logs, writes metrics and saves or prunes
checkpoints while the others wait at a barrier. After each epoch the
parameters and buffers are checked bit-equal across the ranks. Under
point-axis sharding each rank keeps its segment of the batch's points
(`point_sharding.shard_batch`).
"""
from __future__ import annotations

import time

import torch

from ..datasets import load_data_to_device
from ..parallel import comm, point_sharding
from ..parallel.train_state import check_replicas, unwrap
from .checkpoint import save_checkpoint
from .train_state import train_step


def train_one_epoch(model, optimizer, loader, epoch, total_epochs, log=print,
                    log_every=50, device=None, metrics_writer=None, timings=None):
    """One pass over `loader`: device batches, or host batches when
    `device` is given. Returns the epoch's mean loss. `timings`, a dict,
    gets the pass's `steps`, `seconds` (ending in a wait for the card), its
    wait on the loader for the first batch (`loader_first_wait_s`) and
    summed over the later ones (`loader_wait_s`)."""
    losses, waits = [], []
    n = len(loader)
    t0 = t_end = time.perf_counter()
    for i, batch in enumerate(loader):
        waits.append(time.perf_counter() - t_end)
        psh = point_sharding.active()
        if psh is not None:
            batch = point_sharding.shard_batch(batch, psh)
        if device is not None:
            batch = load_data_to_device(batch, device)
        loss, tb = train_step(model, optimizer, batch)
        losses.append(loss)   # this rank's, a device tensor
        if i % log_every == 0 or i + 1 == n:
            it = optimizer.state["count"]
            lr = optimizer.lr_fn(it - 1)
            if comm.get_world_size() > 1:
                tb = comm.reduce_dict({"loss": loss, **tb})
                loss = tb.pop("loss")
            if metrics_writer is not None:
                metrics_writer.write(it, {"loss": loss, **tb, "learning_rate": lr})
            if log is not None:
                log(f"epoch {epoch}/{total_epochs} iter {i}/{n} loss {float(loss):.4f} "
                    f"lr {lr:.6f} {(time.perf_counter() - t0) / (i + 1):.3f} s/step "
                    f"data {sum(waits) / (i + 1):.3f} s")
        t_end = time.perf_counter()
    mean = float(torch.stack(losses).mean()) if losses else float("nan")  # waits for the card
    mean = comm.all_reduce_mean(mean)
    if timings is not None:
        timings.update(loader_first_wait_s=waits[0] if waits else 0.0,
                       loader_wait_s=sum(waits[1:]), steps=len(losses),
                       seconds=time.perf_counter() - t0)
    return mean


def train_model(model, optimizer, loader, ckpt_dir, total_epochs, start_epoch=0,
                log=print, log_every=50, max_ckpt_save_num=30, ckpt_save_interval=1,
                device=None, metrics_writer=None, timings=None, on_epoch_end=None):
    """Train from start_epoch to total_epochs (the loader's `set_epoch`, where
    it has one, picks each epoch's order and augmentation), checkpointing
    every `ckpt_save_interval` epochs and after the last. `timings` gets each
    epoch's (see train_one_epoch), then `on_epoch_end(epoch, mean_loss)` is
    called. In a multi-process run give `log` and `metrics_writer` on rank 0
    alone (None elsewhere); the checkpoints are rank 0's."""
    for epoch in range(start_epoch, total_epochs):
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        mean_loss = train_one_epoch(model, optimizer, loader, epoch, total_epochs,
                                    log=log, log_every=log_every, device=device,
                                    metrics_writer=metrics_writer, timings=timings)
        if log is not None:
            log(f"epoch {epoch} done: mean loss {mean_loss:.4f}")
        if metrics_writer is not None:
            metrics_writer.write(optimizer.state["count"],
                                 {"epoch": epoch, "mean_loss": mean_loss})
        check_replicas(model, f"after epoch {epoch}")
        if ckpt_dir is not None and ((epoch + 1) % ckpt_save_interval == 0
                                     or epoch + 1 == total_epochs):
            if comm.is_main():
                save_checkpoint(unwrap(model), optimizer, ckpt_dir, epoch + 1,
                                optimizer.state["count"], max_ckpt_save_num)
            comm.barrier()
        if on_epoch_end is not None:
            on_epoch_end(epoch, mean_loss)
    return model
