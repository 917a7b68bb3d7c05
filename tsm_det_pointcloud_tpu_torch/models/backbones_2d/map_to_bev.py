"""Sparse -> dense BEV maps (counterpart of
tsm_det_pointcloud_tpu/models/backbones_2d/map_to_bev.py): PointPillars'
pillar scatter, CaDDN's learned collapse of a dense voxel volume and the
height compression of a dense 3D volume. Each gives NHWC maps, the layout
`BaseBEVBackbone` takes."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .base_bev_backbone import _BatchNorm2d


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


class Conv2DCollapse(nn.Module):
    """CaDDN's collapse of the dense (B, nx, ny, nz, C) voxel volume to BEV
    (JAX map_to_bev.py:41-56): (B, ny, nx, nz * C) with channel z * C + c,
    a bias-free 1x1 conv `collapse` to NUM_BEV_FEATURES, BN `bn` (1e-3 /
    0.99) and ReLU. The conv is a matmul over the NHWC channels; ImageVFE's
    volume is a view of (B, ny, nx, nz, C) memory, so the reshape copies
    nothing. Out: spatial_features (B, ny, nx, NUM_BEV_FEATURES), NHWC."""

    def __init__(self, model_cfg, num_features, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        out_ch = int(model_cfg.get("NUM_BEV_FEATURES", 64))
        self.collapse = nn.Conv2d(int(grid_size[2]) * int(num_features), out_ch, 1, bias=False)
        self.bn = _BatchNorm2d(out_ch)

    def forward(self, batch_dict):
        vox = batch_dict["spatial_features_3d"]
        B, nx, ny, nz, C = vox.shape
        x = F.linear(vox.permute(0, 2, 1, 3, 4).reshape(B, ny, nx, nz * C),
                     self.collapse.weight.flatten(1))
        x = self.bn(x.permute(0, 3, 1, 2))                   # NCHW view of NHWC memory
        batch_dict["spatial_features"] = torch.relu(x).permute(0, 2, 3, 1)
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
