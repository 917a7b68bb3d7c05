"""Voxel feature encoders (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/vfe.py): each voxelises the
(B, N, C) points on the device. `MeanVFE` averages each voxel's points;
`PillarVFE` (PointPillars) runs a stack of Linear (+ BN) + ReLU layers over
each pillar's decorated points and max-pools them. The JAX registry's variants:
`DynamicMeanVFE` and `DynamicPillarVFE` (the reference's scatter-based
VFEs, the same computation here, as in the JAX package), `MeanDensityVFE`
(the mean and the voxel's point count) and `SPVFE` / `VPCVFE` (the mean
refined by a per-voxel Dense -> masked BN -> ReLU stack).

batch_dict in: points (B, N, C), points_mask (B, N) bool; out:
voxel_features (B, V, C'), voxel_coords (B, V, 3) int32 zyx sorted by key
(-1 pad), voxel_mask (B, V) bool; MeanVFE also voxel_num_points (B, V),
PillarVFE also pillar_features (B, V, C').
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.voxel import compute_voxel_coords, grid_size, voxelize
from .pointnet2_modules import BatchNorm


class MeanVFE(nn.Module):
    """Mean of the point features per voxel; the mean divides by
    max(num_points, 1)."""

    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, max_voxels, max_points_per_voxel):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_point_features = int(num_point_features)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_voxels = int(max_voxels)
        self.max_points_per_voxel = int(max_points_per_voxel)

    def get_output_feature_dim(self):
        return self.num_point_features

    def forward(self, batch_dict):
        points, mask = batch_dict["points"], batch_dict["points_mask"]
        coords, in_range = compute_voxel_coords(points[..., :3], self.point_cloud_range,
                                                self.voxel_size)
        out = voxelize(points, coords, mask & in_range, self.max_voxels,
                       self.max_points_per_voxel,
                       grid_size(self.point_cloud_range, self.voxel_size))
        cnt = torch.clamp(out["num_points"], min=1)[..., None].to(points.dtype)
        batch_dict["voxel_features"] = out["voxels"].sum(2) / cnt
        batch_dict["voxel_coords"] = out["coordinates"]
        batch_dict["voxel_num_points"] = out["num_points"]
        batch_dict["voxel_mask"] = out["num_points"] > 0
        return batch_dict


class PillarVFE(nn.Module):
    """PointPillars' feature net (JAX vfe.py:61-150). Each pillar keeps its
    first `max_points_per_voxel` points in scan order (`voxelize`); a
    point's features (without x, y, z under USE_ABSLOTE_XYZ False) are
    followed by the xyz offsets from its pillar's mean (divided by
    max(n, 1)) and from its pillar's centre, z included, and with
    WITH_DISTANCE by its xyz norm; the padded slots are zeroed. Then for
    each NUM_FILTERS entry k a Linear `pfn_{k}` (bias-free under USE_NORM,
    then a BN `pfn_bn_{k}`, eps 1e-3, momentum 0.99; with a bias and no BN
    otherwise), a ReLU and a max over the pillar's points with -1e9 at
    padded slots. A layer before the last concatenates that max back onto
    each point, whose own features are zeroed at padded slots, so the next
    layer reads twice NUM_FILTERS[k] inputs (the JAX package's widths:
    OpenPCDet's PFNLayer halves a non-last layer's width instead). An empty
    pillar gives 0. The BN has no mask, as in the JAX package: its training
    statistics count all B x V x P rows, padded slots and empty pillars
    included. Module names follow the flax ones, so
    `convert.from_flax_variables` maps a JAX state onto it."""

    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, max_voxels, max_points_per_voxel):
        super().__init__()
        cfg = model_cfg
        self.filters = [int(n) for n in cfg["NUM_FILTERS"]]
        self.use_norm = bool(cfg.get("USE_NORM", True))
        self.with_distance = bool(cfg.get("WITH_DISTANCE", False))
        self.use_abs_xyz = bool(cfg.get("USE_ABSLOTE_XYZ", True))
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_voxels = int(max_voxels)
        self.max_points_per_voxel = int(max_points_per_voxel)
        c = (int(num_point_features) - (0 if self.use_abs_xyz else 3) + 6
             + int(self.with_distance))
        for k, n in enumerate(self.filters):
            self.add_module(f"pfn_{k}", nn.Linear(c, n, bias=not self.use_norm))
            if self.use_norm:
                self.add_module(f"pfn_bn_{k}", BatchNorm(n, eps=1e-3))
            c = 2 * n

    def get_output_feature_dim(self):
        return self.filters[-1]

    def forward(self, batch_dict):
        points, mask = batch_dict["points"], batch_dict["points_mask"]
        coords, in_range = compute_voxel_coords(points[..., :3], self.point_cloud_range,
                                                self.voxel_size)
        out = voxelize(points, coords, mask & in_range, self.max_voxels,
                       self.max_points_per_voxel,
                       grid_size(self.point_cloud_range, self.voxel_size))
        voxels, coords, npts = out["voxels"], out["coordinates"], out["num_points"]
        P = voxels.shape[2]
        pt_valid = (torch.arange(P, device=voxels.device)[None, None, :]
                    < npts[..., None])[..., None]                     # (B, V, P, 1)
        xyz = voxels[..., :3]
        cnt = torch.clamp(npts, min=1)[..., None, None].to(xyz.dtype)
        f_cluster = xyz - xyz.sum(2, keepdim=True) / cnt
        vx, vy, vz = self.voxel_size
        x0, y0, z0 = self.point_cloud_range[:3]
        c = coords.to(xyz.dtype)
        center = torch.stack([(c[..., 2] + 0.5) * vx + x0, (c[..., 1] + 0.5) * vy + y0,
                              (c[..., 0] + 0.5) * vz + z0], -1)[:, :, None, :]
        feats = [voxels if self.use_abs_xyz else voxels[..., 3:], f_cluster, xyz - center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        x = torch.cat(feats, -1) * pt_valid.to(xyz.dtype)
        neg = torch.full((), -1e9, dtype=x.dtype, device=x.device)
        for k in range(len(self.filters)):
            x = getattr(self, f"pfn_{k}")(x)
            if self.use_norm:
                x = getattr(self, f"pfn_bn_{k}")(x)
            x = torch.where(pt_valid, torch.relu(x), neg)
            pooled = x.amax(2)
            if k < len(self.filters) - 1:
                x = torch.cat([torch.where(pt_valid, x, torch.zeros_like(x)),
                               pooled[:, :, None, :].expand_as(x)], -1)
        vmask = npts > 0
        pooled = torch.where(vmask[..., None], pooled, torch.zeros_like(pooled))
        batch_dict["pillar_features"] = pooled
        batch_dict["voxel_features"] = pooled
        batch_dict["voxel_coords"] = coords
        batch_dict["voxel_mask"] = vmask
        return batch_dict


class DynamicMeanVFE(MeanVFE):
    """The reference's scatter-mean VFE: MeanVFE's computation (JAX
    vfe.py:153-156)."""


class DynamicPillarVFE(PillarVFE):
    """The reference's scatter-based pillar VFE: PillarVFE's computation
    (JAX vfe.py:159-161)."""


class MeanDensityVFE(MeanVFE):
    """MeanVFE's features followed by the voxel's point count as a float
    channel (JAX vfe.py:164-184)."""

    def get_output_feature_dim(self):
        return self.num_point_features + 1

    def forward(self, batch_dict):
        batch_dict = super().forward(batch_dict)
        feats = batch_dict["voxel_features"]
        batch_dict["voxel_features"] = torch.cat(
            [feats, batch_dict["voxel_num_points"][..., None].to(feats.dtype)], -1)
        return batch_dict


class SPVFE(MeanVFE):
    """The voxel means refined by a per-voxel stack (JAX vfe.py:187-208):
    for each NUM_FILTERS entry (default [32]) a bias-free Linear `spv_fc<i>`,
    a BN `spv_bn<i>` (1e-3 / 0.99) whose training statistics count the
    valid voxels only, and a ReLU; invalid voxels then give 0."""

    def __init__(self, model_cfg, num_point_features, voxel_size, point_cloud_range,
                 max_voxels, max_points_per_voxel):
        super().__init__(model_cfg, num_point_features, voxel_size, point_cloud_range,
                         max_voxels, max_points_per_voxel)
        self.filters = [int(c) for c in model_cfg.get("NUM_FILTERS", [32])]
        cin = self.num_point_features
        for i, c in enumerate(self.filters):
            self.add_module(f"spv_fc{i}", nn.Linear(cin, c, bias=False))
            self.add_module(f"spv_bn{i}", BatchNorm(c, eps=1e-3))
            cin = c

    def get_output_feature_dim(self):
        return self.filters[-1]

    def forward(self, batch_dict):
        batch_dict = super().forward(batch_dict)
        feats, vmask = batch_dict["voxel_features"], batch_dict["voxel_mask"]
        for i in range(len(self.filters)):
            feats = torch.relu(getattr(self, f"spv_bn{i}")(getattr(self, f"spv_fc{i}")(feats),
                                                           vmask))
        batch_dict["voxel_features"] = torch.where(vmask[..., None], feats,
                                                   torch.zeros_like(feats))
        return batch_dict


class VPCVFE(SPVFE):
    """The reference's voxel-wise point-conv VFE: SPVFE's computation (JAX
    vfe.py:211-213)."""


VOXEL_VFES = {"MeanVFE": MeanVFE, "DynamicMeanVFE": DynamicMeanVFE, "DynMeanVFE": DynamicMeanVFE,
              "MeanDensityVFE": MeanDensityVFE, "SPVFE": SPVFE, "VPCVFE": VPCVFE}
PILLAR_VFES = {"PillarVFE": PillarVFE, "DynamicPillarVFE": DynamicPillarVFE,
               "DynPillarVFE": DynamicPillarVFE}
