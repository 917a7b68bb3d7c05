"""Data-parallel training over torch.distributed (counterpart of
tsm_det_pointcloud_tpu/parallel/train_state.py, whose data mesh replicates
the parameters, shards the batch and lets XLA all-reduce the gradients).

`wrap_data_parallel` wraps the detector in DDP. Its buffers are not
broadcast from rank 0 at each forward (`broadcast_buffers=False`): every
BN's batch statistics and the TSM class statistics are computed from
global reductions (`comm.global_sum`), so each rank moves its copies as
the others do, and `check_replicas` asserts that they are bit-equal
instead of overwriting a difference. The student-only masking stays in
runtime/train_state.py (`freeze_teacher`): DDP reduces the gradients of
the parameters that train.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from . import comm


def wrap_data_parallel(model, device):
    """DDP over the process group; the model itself at one process. A model
    whose `unused_parameters` is true (parameters no loss reads: PVSSDA's
    confidence MLPs) has DDP find them each step."""
    if comm.get_world_size() == 1:
        return model
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False,
        find_unused_parameters=bool(getattr(model, "unused_parameters", False)))


def unwrap(model):
    """The detector inside a DDP wrapper, or `model`."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def replica_mismatches(model):
    """The names of the parameters and buffers whose bits differ from rank
    0's on some rank (an empty list at one process): each dtype's tensors
    go out from rank 0 in one broadcast."""
    if comm.get_world_size() == 1:
        return []
    by_dtype = {}
    for name, t in unwrap(model).state_dict().items():
        by_dtype.setdefault(t.dtype, []).append((name, t.detach().reshape(-1)))
    differ = []
    for dtype, items in by_dtype.items():
        mine = torch.cat([t for _, t in items])
        ref = mine.clone()
        dist.broadcast(ref, 0)
        if dtype.is_floating_point:   # bits, so that -0.0 and NaN count too
            width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[dtype.itemsize]
            mine, ref = mine.view(width), ref.view(width)
        same = mine == ref
        off = 0
        for name, t in items:
            if not bool(same[off:off + t.numel()].all()):
                differ.append(name)
            off += t.numel()
    return sorted(set().union(*map(set, comm.all_gather_object(differ))))


def check_replicas(model, what="the replicas"):
    """Raise if any rank's parameters or buffers differ from rank 0's."""
    differ = replica_mismatches(model)
    if differ:
        raise RuntimeError(f"{what}: {len(differ)} tensors differ across ranks, "
                           f"first {differ[:5]}")
