"""Voxelisation, voxel centroids and the voxel (window) query.

Counterpart of tsm_det_pointcloud_tpu/ops/voxel.py:31-231. The functions
here take a leading batch axis (the JAX versions are per sample and vmapped
by their callers).
"""
from __future__ import annotations

import numpy as np
import torch

from .grouping import query_group


def grid_size(point_cloud_range, voxel_size, stride=1):
    """Static (z, y, x) grid extents (python ints)."""
    pc = np.asarray(point_cloud_range, np.float64)
    vs = np.asarray(voxel_size, np.float64) * stride
    g = np.round((pc[3:6] - pc[0:3]) / vs).astype(np.int64)   # (x, y, z)
    return int(g[2]), int(g[1]), int(g[0])


def compute_voxel_coords(points_xyz, point_cloud_range, voxel_size, stride=1):
    """(..., 3) xyz -> (..., 3) int32 voxel coords in (z, y, x) order and the
    bool in-range mask. `stride` scales voxel_size."""
    dev = points_xyz.device
    lo = torch.tensor(np.asarray(point_cloud_range[:3], np.float32), device=dev)
    vs = torch.tensor(np.asarray(voxel_size, np.float32), device=dev) * stride
    cxyz = torch.floor((points_xyz - lo) / vs).to(torch.int32)
    gz, gy, gx = grid_size(point_cloud_range, voxel_size, stride)
    ext = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)
    in_range = ((cxyz >= 0) & (cxyz < ext)).all(-1)
    return cxyz.flip(-1), in_range


def voxelize(points, coords_zyx, valid, num_voxels, max_points, grid_dims):
    """Group points into fixed-capacity voxels, sorted by voxel key.

    points (B, N, C), coords_zyx (B, N, 3) int, valid (B, N). The sort is
    stable, so a voxel keeps its first `max_points` points in input order;
    overflow voxels (largest keys) are dropped. Returns dict: voxels
    (B, V, max_points, C) zero-padded, coordinates (B, V, 3) int32 (-1 pad),
    num_points (B, V) int32 (<= max_points), num_voxels (B,), point_voxel_idx
    (B, N) int32 (-1 invalid / dropped)."""
    gz, gy, gx = grid_dims
    B, N, C = points.shape
    V, P = int(num_voxels), int(max_points)
    dev = points.device
    key = _linearize(coords_zyx, grid_dims, valid)
    skey, order = torch.sort(key, dim=1, stable=True)
    spts = torch.gather(points, 1, order[..., None].expand(-1, -1, C))
    scoords = torch.gather(coords_zyx.to(torch.int32), 1, order[..., None].expand(-1, -1, 3))
    svalid = skey < gz * gy * gx
    is_start = torch.cat(
        [svalid[:, :1], (skey[:, 1:] != skey[:, :-1]) & svalid[:, 1:]], 1)
    slot = torch.cumsum(is_start.long(), 1) - 1
    # rank of each point inside its voxel: its position minus its run's start
    pos = torch.arange(N, device=dev).expand(B, N)
    run_start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)), 1).values
    rank = pos - run_start
    ok = svalid & (slot < V) & (rank < P)
    boff = torch.arange(B, device=dev)[:, None]

    cell = torch.where(ok, slot * P + rank, torch.full_like(slot, V * P))
    vox = torch.zeros((B * (V * P + 1), C), dtype=points.dtype, device=dev)
    vox[(cell + boff * (V * P + 1)).reshape(-1)] = spts.reshape(-1, C)
    vox = vox.reshape(B, V * P + 1, C)[:, :V * P].reshape(B, V, P, C)

    head = torch.where(is_start & (slot < V), slot, torch.full_like(slot, V))
    vcoords = torch.full((B * (V + 1), 3), -1, dtype=torch.int32, device=dev)
    vcoords[(head + boff * (V + 1)).reshape(-1)] = scoords.reshape(-1, 3)
    vcoords = vcoords.reshape(B, V + 1, 3)[:, :V]

    seg = torch.where(ok, slot, torch.full_like(slot, V))
    counts = torch.zeros((B * (V + 1),), dtype=torch.int32, device=dev)
    counts.index_add_(0, (seg + boff * (V + 1)).reshape(-1),
                      torch.ones(B * N, dtype=torch.int32, device=dev))
    counts = counts.reshape(B, V + 1)[:, :V]

    pslot = torch.where(svalid & (slot < V), slot, torch.full_like(slot, -1)).to(torch.int32)
    point_voxel_idx = torch.zeros((B, N), dtype=torch.int32, device=dev)
    point_voxel_idx.scatter_(1, order, pslot)
    return dict(voxels=vox, coordinates=vcoords, num_points=counts,
                num_voxels=torch.clamp(is_start.sum(1), max=V),
                point_voxel_idx=point_voxel_idx)


def _linearize(coords_zyx, grid_dims, valid):
    """(..., 3) zyx -> int64 keys; invalid -> sentinel gz*gy*gx. Only the
    validity mask is checked, as in the reference."""
    gz, gy, gx = grid_dims
    c = coords_zyx.long()
    key = (c[..., 0] * gy + c[..., 1]) * gx + c[..., 2]
    return torch.where(valid, key, torch.full_like(key, gz * gy * gx))


def voxel_centroids(coords_zyx, features, valid, num_voxels, grid_dims):
    """Scatter-mean `features` per voxel with a static voxel capacity.

    coords_zyx (B, N, 3) int, features (B, N, C), valid (B, N). Voxels come
    out sorted by key; overflow voxels (largest keys) are dropped. Returns
    dict: centroids (B, V, C), coordinates (B, V, 3) int32 (-1 pad), counts
    (B, V) int32, point_slot (B, N) int32 (-1 dropped / invalid), num_voxels
    (B,), valid (B, V)."""
    gz, gy, gx = grid_dims
    B, N, C = features.shape
    V = int(num_voxels)
    dev = features.device
    key = _linearize(coords_zyx, grid_dims, valid)
    skey, order = torch.sort(key, dim=1, stable=True)
    sfeat = torch.gather(features, 1, order[..., None].expand(-1, -1, C))
    scoords = torch.gather(coords_zyx.to(torch.int32), 1,
                           order[..., None].expand(-1, -1, 3))
    svalid = skey < gz * gy * gx
    is_start = torch.cat(
        [svalid[:, :1], (skey[:, 1:] != skey[:, :-1]) & svalid[:, 1:]], 1)
    slot = torch.cumsum(is_start.long(), 1) - 1
    keep = svalid & (slot < V)
    seg = torch.where(keep, slot, torch.full_like(slot, V))
    flat = (seg + torch.arange(B, device=dev)[:, None] * (V + 1)).reshape(-1)

    sums = torch.zeros((B * (V + 1), C), dtype=features.dtype, device=dev)
    sums.index_add_(0, flat, sfeat.reshape(-1, C))
    counts = torch.zeros((B * (V + 1),), dtype=torch.int32, device=dev)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    sums = sums.reshape(B, V + 1, C)[:, :V]
    counts = counts.reshape(B, V + 1)[:, :V]
    centroids = sums / torch.clamp(counts, min=1)[..., None].to(sums.dtype)

    vflat = torch.where(is_start & (slot < V), seg, torch.full_like(seg, V))
    vflat = (vflat + torch.arange(B, device=dev)[:, None] * (V + 1)).reshape(-1)
    vcoords = torch.full((B * (V + 1), 3), -1, dtype=torch.int32, device=dev)
    vcoords[vflat] = scoords.reshape(-1, 3)
    # several writes land on each batch's drop row V; only rows < V are read
    vcoords = vcoords.reshape(B, V + 1, 3)[:, :V]

    pslot = torch.where(keep, slot, torch.full_like(slot, -1)).to(torch.int32)
    point_slot = torch.zeros((B, N), dtype=torch.int32, device=dev)
    point_slot.scatter_(1, order, pslot)
    return dict(
        centroids=centroids,
        coordinates=vcoords,
        counts=counts,
        point_slot=point_slot,
        num_voxels=torch.clamp(is_start.sum(1), max=V),
        valid=counts > 0,
    )


def voxel_query(new_xyz, new_coords_zyx, centroid_xyz, centroid_coords_zyx,
                centroid_valid, radius, nsample, query_range, min_radius=0.0):
    """Query points against voxel centroids: a centroid is a neighbour iff
    |Δ voxel coord| <= query_range per axis and min_radius <= d < radius.
    new_xyz (B, M, 3), new_coords_zyx (B, M, 3), centroid_* (B, V, ...).
    Returns idx (B, M, nsample) nearest-k and cnt (B, M)."""
    (idx, cnt, _), = query_group(
        centroid_xyz, centroid_valid, new_xyz,
        [(float(min_radius), float(radius), int(nsample), tuple(query_range))],
        src_coords=centroid_coords_zyx, q_coords=new_coords_zyx,
    )
    return idx, cnt
