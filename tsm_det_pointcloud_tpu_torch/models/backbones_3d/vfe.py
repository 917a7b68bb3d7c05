"""Voxel feature encoder (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/vfe.py:23-56): `MeanVFE`
voxelises the (B, N, C) points on the device and averages each voxel's
points.

batch_dict in: points (B, N, C), points_mask (B, N) bool; out:
voxel_features (B, V, C), voxel_coords (B, V, 3) int32 zyx sorted by key
(-1 pad), voxel_num_points (B, V), voxel_mask (B, V) bool.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.voxel import compute_voxel_coords, grid_size, voxelize


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
