"""Process-group set-up and the collectives of multi-process runs
(counterpart of tsm_det_pointcloud_tpu/parallel/comm.py).

`init_distributed(launcher, device)` joins the process group:
`pytorch` (and `jax`, its synonym, so the JAX tools' command lines run
unchanged) reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
MASTER_PORT, `slurm` reads SLURM_PROCID / SLURM_NTASKS / SLURM_LOCALID and
the first host of SLURM_NODELIST (port MASTER_PORT, else 29500). A missing
variable raises, as does a failed init: there is no quiet fall-back to one
process. On the card each process takes cuda:LOCAL_RANK and NCCL, on the
CPU gloo; `backend=` overrides (two processes on one card need gloo).

The host-side helpers (`all_gather_object`, `all_reduce_mean`,
`reduce_dict`, `merge_results_dist`) order and trim as the JAX versions do.
The model code calls three more: `global_sum` (an all-reduce whose backward
all-reduces the gradient, as XLA's psum transposes), `global_any` and
`global_max` (the hybrids' class statistics, no gradient). They
reduce over the data group: every process, or under point-axis sharding
the processes that hold the same points shard of other samples
(`set_data_group`). Losses that sum over the batch take a rank's partial
sum times the data group's size (`scale_to_global`), so that the ranks'
mean is the global sum and DDP's mean of the rank gradients is its
gradient. At one process every helper returns its input as it is, so a
single-process run computes what it computed before.
"""
from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist

LAUNCHERS = ("none", "pytorch", "jax", "slurm")
_DATA = {"group": None, "size": 1}


def _env(name):
    try:
        return os.environ[name]
    except KeyError:
        raise RuntimeError(f"{name} is not set: start the processes with torchrun "
                           f"(or srun for --launcher slurm)") from None


def first_host(nodelist):
    """The first host name of a SLURM node list ("gpu[03-05,07],cpu1" ->
    "gpu03")."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist.strip())
    if m is None:
        raise RuntimeError(f"cannot read SLURM_NODELIST {nodelist!r}")
    stem, ranges = m.group(1), m.group(2)
    return stem if ranges is None else stem + ranges.split(",")[0].split("-")[0]


def init_distributed(launcher, device="cuda", backend=None):
    """Join the process group of `launcher` and return this process's
    torch.device (cuda:LOCAL_RANK on the card, set as the current device
    before NCCL starts). `launcher` "none" joins nothing and returns the
    device as asked."""
    from ..utils.common_utils import resolve_device

    if launcher not in LAUNCHERS:
        raise ValueError(f"launcher {launcher!r} is not one of {LAUNCHERS}")
    dev = resolve_device(device)
    if launcher == "none":
        return dev
    if launcher == "slurm":
        rank, world = int(_env("SLURM_PROCID")), int(_env("SLURM_NTASKS"))
        local_rank = int(_env("SLURM_LOCALID"))
        addr = first_host(_env("SLURM_NODELIST"))
        port = int(os.environ.get("MASTER_PORT", 29500))
    else:
        rank, world = int(_env("RANK")), int(_env("WORLD_SIZE"))
        local_rank = int(_env("LOCAL_RANK"))
        addr, port = _env("MASTER_ADDR"), int(_env("MASTER_PORT"))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world,
                            device_id=dev if backend == "nccl" else None)
    # a group of their own for the model's collectives, apart from the one
    # DDP's gradient buckets ride
    set_data_group(dist.new_group(list(range(world))), world)
    return dev


def shutdown():
    """Leave the process group (if one was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    set_data_group(None, 1)


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def is_main():
    return get_rank() == 0


def barrier():
    if get_world_size() > 1:
        dist.barrier()


def set_data_group(group, size):
    """The processes `global_sum` / `global_any` reduce over: `group` of
    `size` processes."""
    _DATA.update(group=group, size=int(size))


def data_world_size():
    return _DATA["size"] if dist.is_initialized() else 1


def _comm_device():
    """Where a host value rides a collective: the current card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_object(obj):
    """[each process's `obj`] in rank order."""
    world = get_world_size()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def _gather_f64(vals):
    """(world, K) float64 of every process's K values."""
    t = torch.tensor(vals, dtype=torch.float64, device=_comm_device())
    out = [torch.empty_like(t) for _ in range(get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def all_reduce_mean(value):
    """The mean of a python float over the processes."""
    if get_world_size() == 1:
        return float(value)
    return float(_gather_f64([float(value)]).mean())


def reduce_dict(d, average=True):
    """A dict of scalars reduced over the processes (mean, else sum), keys
    sorted, in float64 as the JAX version."""
    if get_world_size() == 1:
        return dict(d)
    keys = sorted(d)
    g = _gather_f64([float(d[k]) for k in keys])
    red = g.mean(0) if average else g.sum(0)
    return {k: float(v) for k, v in zip(keys, red)}


def merge_results_dist(part_list, total_size, replicas=1):
    """The processes' result lists of a rank-strided loader (padded to a
    multiple of the shard count) merged into dataset order and trimmed to
    `total_size`. replicas: the consecutive ranks that share a shard (a
    point-axis group); the first of each is taken."""
    gathered = all_gather_object(part_list)[::replicas]
    merged = []
    for rank_parts in zip(*gathered):
        merged.extend(rank_parts)
    return merged[:total_size]


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(t):
    """`t` summed over the data group, differentiable: the backward sums the
    ranks' gradients (a rank's upstream gradient covers its own terms of a
    replicated value)."""
    if data_world_size() == 1:
        return t
    return _GlobalSum.apply(t, _DATA["group"])


def group_sum(t, group):
    """`t` summed over `group`, differentiable as `global_sum`."""
    return _GlobalSum.apply(t, group)


class _GatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, t.shape[dim]
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def all_gather_cat(t, dim, group):
    """Every rank's `t` of `group`, concatenated along `dim` in rank order,
    differentiable: the backward sums the ranks' gradients and takes this
    rank's part (XLA's all_gather transposes to a psum_scatter)."""
    return _GatherCat.apply(t, dim, group)


def global_max(t):
    """`t`'s elementwise maximum over the data group (no gradient)."""
    if data_world_size() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_DATA["group"])
    return out


def global_any(mask):
    """0-d bool: whether `mask` has a True element on any rank of the data
    group."""
    local = mask.any()
    if data_world_size() == 1:
        return local
    flag = local.to(torch.int32)
    dist.all_reduce(flag, group=_DATA["group"])
    return flag > 0


def scale_to_global(t):
    """A rank's partial sum of a batch-wide sum, times the data group's
    size: the ranks' mean of it is the global sum."""
    n = data_world_size()
    return t if n == 1 else t * n
