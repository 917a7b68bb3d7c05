"""PV-RCNN++'s keypoint sampling and VectorPool aggregation (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/pfe/vector_pool.py).

`sectorized_fps` (SAMPLE_METHOD SPC): each scan's points are split by
azimuth into S sectors, `sector = floor((atan2(y, x) + pi) / (2 pi / S)) % S`;
sector 0 draws `npoint // S` keypoints plus the remainder, the others
`npoint // S` each, each by d-fps over the whole scan with the other
sectors' points masked off, and the picks are concatenated in sector
order. The d-fps semantics are the JAX package's: the seed is original
index 0 even where point 0 lies outside the sector (the first distance
update runs from its xyz); a sector with no valid point picks index 0
throughout; a sector with fewer valid points than its share repeats its
lowest valid index once they are spent. All S sectors of all B scans go to
`sampling.furthest_point_sample` as one batch of B * S rows at sector 0's
share, and each sector keeps the prefix of its own share: d-fps picks are
prefix-consistent, so this equals S calls. On the card that is one launch,
of K6 (csrc/fps_block.cu) for rows above 16384 points and of K1 below.

`VectorPoolAggregation` (one scale): one single-scale nearest-k ball query
with the gather of [xyz, features] (`grouping.query_group`, K2 on the card),
xyz re-centred on the keypoint and unfilled slots zeroed; each slot's local
cell in the ball's (nx, ny, nz) lattice, `clip(g / (2 r) + 0.5, 0,
1 - 1e-6) * n` truncated (a true division by 2 r, as the JAX package
divides: a multiplication by the reciprocal can move a point on a cell edge
to the next cell); the per-cell mean of the filled slots by a one-hot
einsum (the JAX package's too, outside any kernel), flattened to cells x
(3 + C), then `post_mlp`, a SharedMLP without a mask, whose train-mode BN
statistics run over every query (invalid keypoints and empty balls
included); an empty ball gives 0. `VectorPoolAggregationModuleMSG`
concatenates its scales (`scale{i}`), then the optional `agg` SharedMLP; its
scales' K2 calls share the sources' tiles on the card (`grouping.TileCache`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ....ops import grouping, sampling
from ..pointnet2_modules import SharedMLP


def sector_ids(xyz, num_sectors):
    """(B, N, 3) -> (B, N) int64 azimuth sector of each point, as the JAX
    `sectorized_fps` computes it (a true division by the sector width)."""
    angle = torch.atan2(xyz[..., 1], xyz[..., 0])
    width = torch.full((), 2 * math.pi / num_sectors, dtype=xyz.dtype, device=xyz.device)
    return torch.floor((angle + math.pi) / width).to(torch.int64) % num_sectors


def sector_shares(npoint, num_sectors):
    """The keypoints each sector draws: npoint // S, sector 0 the remainder too."""
    per = npoint // num_sectors
    return [per + npoint - per * num_sectors] + [per] * (num_sectors - 1)


def sector_rows(xyz, valid, num_sectors):
    """The B * S d-fps rows of `sectorized_fps`: each scan's xyz once a
    sector, (B * S, N, 3), and its valid points of that sector, (B * S, N)."""
    B, N, _ = xyz.shape
    sector = sector_ids(xyz, num_sectors)
    ids = torch.arange(num_sectors, device=xyz.device)
    masks = valid[:, None, :] & (sector[:, None, :] == ids[None, :, None])
    rows = xyz[:, None].expand(B, num_sectors, N, 3).reshape(B * num_sectors, N, 3)
    return rows.contiguous(), masks.reshape(B * num_sectors, N)


def sectorized_fps(xyz, valid, npoint, num_sectors=6):
    """(B, N, 3), valid (B, N) -> (B, npoint) int32 keypoint indices: each
    sector's share of d-fps picks, in sector order, from one d-fps call over
    the B * S sector rows at sector 0's share."""
    B = xyz.shape[0]
    shares = sector_shares(npoint, num_sectors)
    rows, masks = sector_rows(xyz.detach(), valid, num_sectors)
    idx = sampling.furthest_point_sample(rows, shares[0], masks).reshape(
        B, num_sectors, shares[0])
    return torch.cat([idx[:, s, :k] for s, k in enumerate(shares)], 1)


class VectorPoolAggregation(nn.Module):
    """One scale of vector-pool aggregation over a support set with
    `in_channels` features a point."""

    def __init__(self, in_channels, radius, nsample, local_grid=(3, 3, 3), mlp=(32,)):
        super().__init__()
        self.radius = float(radius)
        self.nsample = int(nsample)
        self.local_grid = tuple(int(v) for v in local_grid)
        self.n_cells = math.prod(self.local_grid)
        self.post_mlp = SharedMLP(self.n_cells * (3 + int(in_channels)), mlp)
        self.out_channels = self.post_mlp.channels[-1]

    def cells(self, g_xyz):
        """(..., 3) re-centred xyz -> (...) int64 local cell, x-major."""
        nx, ny, nz = self.local_grid
        two_r = torch.full((), 2.0 * self.radius, dtype=g_xyz.dtype, device=g_xyz.device)
        frac = torch.clamp(g_xyz / two_r + 0.5, 0.0, 1.0 - 1e-6)
        ix, iy, iz = ((frac[..., a] * n).to(torch.int64) for a, n in enumerate((nx, ny, nz)))
        return ix * (ny * nz) + iy * nz + iz

    def forward(self, query_xyz, support_xyz, support_feats, support_valid, cache=None):
        payload = support_xyz if support_feats is None else torch.cat(
            [support_xyz, support_feats], -1)
        ((_, cnt, grouped),) = grouping.query_group(
            support_xyz, support_valid, query_xyz, [(0.0, self.radius, self.nsample)],
            payload=payload, cache=cache)
        slot_ok = torch.arange(self.nsample, device=query_xyz.device) < cnt[..., None]
        feats = torch.cat([grouped[..., :3] - query_xyz[:, :, None, :], grouped[..., 3:]], -1)
        feats = torch.where(slot_ok[..., None], feats, torch.zeros_like(feats))
        onehot = nn.functional.one_hot(self.cells(feats[..., :3]), self.n_cells).to(feats.dtype)
        onehot = onehot * slot_ok[..., None]
        sums = torch.einsum("bmnc,bmnk->bmkc", feats, onehot)
        mean = sums / torch.clamp(onehot.sum(2), min=1.0)[..., None]
        out = self.post_mlp(mean.reshape(mean.shape[0], mean.shape[1], -1))
        return torch.where(cnt[..., None] > 0, out, torch.zeros_like(out))


class VectorPoolAggregationModuleMSG(nn.Module):
    """Multi-scale vector pool: `scale{i}` a scale, concatenated, then the
    optional `agg` SharedMLP. `out_channels` is agg's last width, or else
    the sum of the scales' last widths."""

    def __init__(self, in_channels, radii, nsamples, local_grids, mlps, aggregation_mlp=None):
        super().__init__()
        self.n_scales = len(radii)
        c = 0
        for i, (r, ns, grid, mlp) in enumerate(zip(radii, nsamples, local_grids, mlps)):
            scale = VectorPoolAggregation(in_channels, r, ns, grid, mlp)
            setattr(self, f"scale{i}", scale)
            c += scale.out_channels
        self.agg = SharedMLP(c, aggregation_mlp) if aggregation_mlp else None
        self.out_channels = self.agg.channels[-1] if self.agg is not None else c

    def forward(self, query_xyz, support_xyz, support_feats, support_valid):
        cache = grouping.TileCache()
        out = torch.cat([getattr(self, f"scale{i}")(query_xyz, support_xyz, support_feats,
                                                    support_valid, cache)
                         for i in range(self.n_scales)], -1)
        return self.agg(out) if self.agg is not None else out
