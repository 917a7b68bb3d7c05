"""Sparse -> dense BEV maps (counterpart of
tsm_det_pointcloud_tpu/models/backbones_2d/map_to_bev.py:14-38, 60-75):
PointPillars' pillar scatter and the height compression of a dense 3D
volume. Both give NHWC maps, the layout `BaseBEVBackbone` takes."""
from __future__ import annotations

import torch
from torch import nn


class PointPillarScatter(nn.Module):
    """Write each valid pillar's features at its (y, x) cell of a zero
    (B, ny, nx, C) canvas (NHWC); an invalid pillar writes nothing. The
    write (`index_copy` onto a flat canvas with one spare row that the
    invalid pillars share) is differentiable with respect to the
    features. Out: spatial_features."""

    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        self.nx, self.ny, nz = (int(g) for g in grid_size)
        if nz != 1:
            raise ValueError(f"PointPillarScatter needs a grid of one z cell, not {nz}")

    def forward(self, batch_dict):
        feats = batch_dict.get("pillar_features", batch_dict.get("voxel_features"))
        coords, vmask = batch_dict["voxel_coords"], batch_dict["voxel_mask"]
        B, V, C = feats.shape
        cells = self.ny * self.nx
        b = torch.arange(B, device=feats.device)[:, None]
        idx = torch.where(vmask, b * cells + coords[..., 1].long() * self.nx
                          + coords[..., 2].long(), torch.full_like(b, B * cells))
        canvas = feats.new_zeros(B * cells + 1, C).index_copy(
            0, idx.reshape(-1), feats.reshape(-1, C))
        batch_dict["spatial_features"] = canvas[:B * cells].reshape(B, self.ny, self.nx, C)
        return batch_dict


class HeightCompression(nn.Module):
    """Collapse the z axis of the dense (B, nz, ny, nx, C) volume into
    channels, in the JAX package's order: channel z * C + c. (The
    reference's NCDHW `view` is C-major; following it would permute the
    channels that the first BEV conv reads.) Out: spatial_features
    (B, ny, nx, nz * C), NHWC."""

    def __init__(self, model_cfg):
        super().__init__()
        self.model_cfg = model_cfg

    def forward(self, batch_dict):
        dense = batch_dict["encoded_spconv_tensor"]
        B, nz, ny, nx, C = dense.shape
        batch_dict["spatial_features"] = dense.permute(0, 2, 3, 1, 4).reshape(
            B, ny, nx, nz * C)
        batch_dict["spatial_features_stride"] = batch_dict.get(
            "encoded_spconv_tensor_stride", 8)
        return batch_dict
