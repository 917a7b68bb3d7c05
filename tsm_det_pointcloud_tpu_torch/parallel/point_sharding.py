"""Point-axis sharding over processes (counterpart of
tsm_det_pointcloud_tpu/parallel/point_sharding.py).

The processes form a (data, points) grid (`make_point_mesh`, a
`torch.distributed.device_mesh` of shape (world / pax, pax); rank r sits at
(r // pax, r % pax), as the JAX `make_point_mesh` reshapes its devices row
major). The ranks of one points group load the same samples and each keeps
its contiguous segment of every scan's point axis (B, N / pax, ·), as the
JAX `shard_batch` places `P(data, points)`. Under `activate`, the TSM
backbone's layer 0 runs on the segments (models/backbones_3d/
voxel_pointnet2_backbone.py) through the primitives here; everything after
it runs replicated on the sampled set, on every rank of the group alike:

- `segment_local_fps`: exact d-fps on each segment for ceil(npoint / pax)
  picks (`sampling.furthest_point_sample`: K1, or K6 past 16384 points a
  row, on the card), one all_gather, then the picks interleaved round-robin
  (every segment's k-th pick before any segment's (k+1)-th);
  `segment_local_fps_plain` computes the same picks in one process;
- `gather_from_sharded`: rows of the sharded axis fetched by global index
  through an owner-masked all_reduce;
- `sharded_ball_group_multi`: the multi-scale nearest-k query and gather
  (`grouping.query_group`: K2 on the card) on the local segment, each
  candidate's d² recomputed from its gathered xyz as K2 computes it, the
  candidates all-gathered and merged by (d², global index), the counts
  summed: the nearest-k by (d², index) over the whole cloud;
- `sharded_voxel_centroids`: per-segment voxel sums and counts, gathered
  and merged by a second compaction.

The collectives of the gathered rows are differentiable (`comm.group_sum`,
`comm.all_gather_cat`): a gradient reaching the segments flows back
through them. The detector's layer-0 inputs (the points) take none.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from ..ops import grouping, sampling
from ..ops.voxel import voxel_centroids
from . import comm


@dataclasses.dataclass(frozen=True)
class PointAxisContext:
    group: object      # the ranks of this rank's points group
    size: int          # pax: the segments of a scan
    index: int         # this rank's segment
    data_index: int    # this rank's points group (the loader's shard)
    n_data: int        # the points groups (the loader's shard count)


_ACTIVE: list = []


def active():
    """The innermost active PointAxisContext, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def activate(ctx):
    """Route the TSM backbone's layer 0 through the sharded primitives."""
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def make_point_mesh(n_points, device_type="cpu"):
    """The (data, points) grid over the process group, with a trailing
    `points` axis of n_points; sets `comm`'s data group to this rank's
    `data` axis. Raises when the world size is not a multiple of
    n_points."""
    from torch.distributed.device_mesh import init_device_mesh

    world = comm.get_world_size()
    if n_points < 1 or world % n_points:
        raise ValueError(f"{world} processes not divisible by points={n_points}")
    n_data = world // n_points
    mesh = init_device_mesh(device_type, (n_data, n_points),
                            mesh_dim_names=("data", "points"))
    rank = comm.get_rank()
    comm.set_data_group(mesh.get_group("data"), n_data)
    return PointAxisContext(mesh.get_group("points"), n_points, rank % n_points,
                            rank // n_points, n_data)


def local_segment(t, ctx):
    """This rank's contiguous segment of axis 1 of a (B, N, ...) tensor."""
    n = t.shape[1]
    if n % ctx.size:
        raise ValueError(f"{n} points a scan do not split into {ctx.size} segments")
    n_local = n // ctx.size
    return t[:, ctx.index * n_local:(ctx.index + 1) * n_local]


def shard_batch(batch, ctx):
    """A loader batch with `points` and `points_mask` cut to this rank's
    segment (on the host, before the copy to the card)."""
    return {k: (local_segment(v, ctx) if k in ("points", "points_mask") else v)
            for k, v in batch.items()}


def _interleave(picks, npoint):
    """[(B, per) global indices of each segment] -> (B, npoint), round
    robin."""
    merged = torch.stack(picks, dim=2)        # (B, per, D)
    return merged.reshape(merged.shape[0], -1)[:, :npoint]


def segment_local_fps(xyz, npoint, ctx, valid_mask=None):
    """d-fps over a point-axis-sharded cloud: xyz (B, N / D, 3) this rank's
    segment -> (B, npoint) int32 global indices, the same on every rank of
    the group."""
    per = -(-npoint // ctx.size)
    n_local = xyz.shape[1]
    idx = sampling.furthest_point_sample(xyz, per, valid_mask) + ctx.index * n_local
    picks = [torch.empty_like(idx) for _ in range(ctx.size)]
    dist.all_gather(picks, idx.contiguous(), group=ctx.group)
    return _interleave(picks, npoint)


def segment_local_fps_plain(xyz, npoint, n_segments, valid_mask=None):
    """`segment_local_fps`'s picks in one process: xyz (B, N, 3) the whole
    cloud, split into n_segments, each sampled by the plain d-fps."""
    n_local = xyz.shape[1] // n_segments
    per = -(-npoint // n_segments)
    picks = []
    for s in range(n_segments):
        sl = slice(s * n_local, (s + 1) * n_local)
        vm = None if valid_mask is None else valid_mask[:, sl]
        picks.append(sampling.furthest_point_sample_plain(xyz[:, sl], per, vm)
                     + s * n_local)
    return _interleave(picks, npoint)


def gather_from_sharded(values, idx, ctx):
    """values (B, N / D, C) this rank's segment, idx (B, K) global indices
    (the same on every rank) -> (B, K, C), replicated: each row from the
    rank that owns it, through an all_reduce of the owners' rows."""
    n_local = values.shape[1]
    rel = idx.long() - ctx.index * n_local
    owned = (rel >= 0) & (rel < n_local)
    take = torch.gather(values, 1, rel.clamp(0, n_local - 1)[..., None]
                        .expand(-1, -1, values.shape[-1]))
    contrib = torch.where(owned[..., None], take, torch.zeros_like(take))
    return comm.group_sum(contrib, ctx.group)


def _sq_d2(q, x):
    """d² of queries q (B, M, 3) to their candidates x (B, M, ns, 3) in
    grouping's expanded form (K2's and `query_group_plain`'s, each term
    rounded alike), canonicalised at 0."""
    q2 = grouping._sq_norm(q)[..., None]
    x2 = grouping._sq_norm(x)
    qe = q[:, :, None, :]
    cross = (qe[..., 0] * x[..., 0] + qe[..., 1] * x[..., 1]) + qe[..., 2] * x[..., 2]
    d2 = (q2 + x2) - 2.0 * cross
    return torch.where(d2 > 0, d2, torch.zeros_like(d2))


def sharded_ball_group_multi(scales, xyz, features, valid, new_xyz, ctx):
    """Multi-scale annulus query and gather over a point-axis-sharded
    cloud, with replicated queries.

    xyz (B, N / D, 3), features (B, N / D, C) or None, valid (B, N / D) this
    rank's segment; new_xyz (B, M, 3) the same on every rank; scales a
    sequence of (min_r, max_r, ns). Returns per scale (cnt (B, M) int32,
    grouped (B, M, ns, 3 + C)): the ns nearest hits of the whole cloud by
    (d², global index), their absolute xyz and features, unfilled slots
    zero; cnt the exact global hit count."""
    B, n_local, _ = xyz.shape
    payload = xyz if features is None else torch.cat([xyz, features], -1)
    local = grouping.query_group(xyz, valid, new_xyz, scales, payload=payload)
    inf_key = torch.iinfo(torch.int64).max
    out = []
    for (mn, mx, ns), (idx, cnt, grouped) in zip(scales, local):
        hit = torch.arange(ns, device=xyz.device) < cnt[..., None]
        d2 = _sq_d2(new_xyz, grouped[..., :3])
        gidx = idx.long() + ctx.index * n_local
        # (d² bits, global index): d² >= +0 orders like its bits
        key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | gidx
        key = torch.where(hit, key, torch.full_like(key, inf_key))
        rows = torch.where(hit[..., None], grouped, torch.zeros_like(grouped))
        keys = comm.all_gather_cat(key, 2, ctx.group)
        rows = comm.all_gather_cat(rows, 2, ctx.group)
        top = torch.sort(keys, dim=2, stable=True)
        keep = top.indices[..., :ns]
        m_hit = top.values[..., :ns] != inf_key
        merged = torch.gather(rows, 2, keep[..., None].expand(-1, -1, -1, rows.shape[-1]))
        merged = torch.where(m_hit[..., None], merged, torch.zeros_like(merged))
        total = cnt.clone()
        dist.all_reduce(total, group=ctx.group)
        out.append((total, merged))
    return out


def sharded_voxel_centroids(coords_zyx, features, valid, num_voxels, grid_dims, ctx):
    """`ops.voxel.voxel_centroids` over a point-axis-sharded cloud:
    coords_zyx (B, N / D, 3) int, features (B, N / D, C), valid (B, N / D)
    this rank's segment. Returns centroids, coordinates, counts, num_voxels
    and valid, replicated (no point_slot: it would index the merged
    compaction). Each segment's voxels are compacted to (sum, count) rows;
    the D partial lists are gathered and compacted again, averaging the
    partial sums and counts of the k segments that hold a voxel (the 1 / k
    cancels in their ratio)."""
    loc = voxel_centroids(coords_zyx, features, valid, num_voxels, grid_dims)
    counts = loc["counts"].to(features.dtype)
    payload = torch.cat([loc["centroids"] * counts[..., None], counts[..., None]], -1)
    g_payload = comm.all_gather_cat(payload, 1, ctx.group)
    parts = [torch.empty_like(loc["coordinates"]) for _ in range(ctx.size)]
    dist.all_gather(parts, loc["coordinates"].contiguous(), group=ctx.group)
    g_coords = torch.cat(parts, dim=1)
    valid_u8 = loc["valid"].to(torch.uint8)   # gloo gathers no bool
    vparts = [torch.empty_like(valid_u8) for _ in range(ctx.size)]
    dist.all_gather(vparts, valid_u8, group=ctx.group)
    g_valid = torch.cat(vparts, dim=1).bool()
    merged = voxel_centroids(g_coords, g_payload, g_valid, num_voxels, grid_dims)
    mean_sums = merged["centroids"][..., :-1]
    mean_counts = merged["centroids"][..., -1:]
    centroids = mean_sums / torch.clamp(mean_counts, min=1e-12)
    n_entries = torch.clamp(merged["counts"], min=1).to(features.dtype)
    totals = torch.round(mean_counts[..., 0] * n_entries).to(torch.int32)
    return dict(centroids=centroids, coordinates=merged["coordinates"],
                counts=torch.where(merged["valid"], totals, torch.zeros_like(totals)),
                num_voxels=merged["num_voxels"], valid=merged["valid"])
