"""UNetV2, Part-A2's sparse U-Net (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/spconv_unet.py).

The encoder is VoxelBackBone8x's (conv_input, conv1, then a strided conv
and two submanifold convs at each of levels 2-4; 16, 32, 64, 64 channels),
with conv_out (128 over (3, 1, 1), stride (2, 1, 1)) feeding
HeightCompression. The decoder climbs back to the input voxels: at each
level a lateral submanifold conv on the skip tensor, an inverse conv from
the coarser level onto the skip's positions, the two concatenated
(lateral first) and fused by a submanifold conv (64, 32, 16 channels;
padding (0, 1, 1) from level 4 to 3, as conv4_down has it). Every conv takes
the by-key route, as the JAX package's does on the TPU when no rulebook is
passed: K4 forward and K5 backward on the card. Each position set has one
`LazyRulebook`, which all of its submanifold convs share (the input set:
conv_input, conv1, up2to1_lateral and up2to1_fuse), and each inverse conv
the rulebook of the strided conv it mirrors, rebuilt onto the fine set.
Every level keeps V slots (VOXEL_CAPACITIES, which PartA2.yaml does not
set, or the input's V). RETURN_ENCODED_TENSOR, which no config sets, is
read nowhere: conv_out always runs.

batch_dict in: voxel_features, voxel_coords, voxel_mask; out:
encoded_spconv_tensor (stride 8), point_features (B, V, 16) on the input
voxels, point_coords_voxel, point_valid, multi_scale_3d_features
{x_conv1..4}, multi_scale_3d_strides.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import spconv as sp
from .spconv_backbone import (
    SparseConv,
    SparseInverseConv,
    SparseTensor,
    SubMConv,
    sparse_shape_from_meta,
)


class UNetV2(nn.Module):
    num_point_features = 16

    def __init__(self, model_cfg, input_channels, meta):
        super().__init__()
        self.model_cfg = model_cfg
        self.grid0 = sparse_shape_from_meta(meta)
        caps = model_cfg.get("VOXEL_CAPACITIES", None) or [None] * 4
        self.conv_input = SubMConv(input_channels, 16)
        self.conv1 = SubMConv(16, 16)
        self.conv2_down = SparseConv(16, 32, out_capacity=caps[0])
        self.conv2_a = SubMConv(32, 32)
        self.conv2_b = SubMConv(32, 32)
        self.conv3_down = SparseConv(32, 64, out_capacity=caps[1])
        self.conv3_a = SubMConv(64, 64)
        self.conv3_b = SubMConv(64, 64)
        self.conv4_down = SparseConv(64, 64, padding=(0, 1, 1), out_capacity=caps[2])
        self.conv4_a = SubMConv(64, 64)
        self.conv4_b = SubMConv(64, 64)
        self.conv_out = SparseConv(64, 128, kernel_size=(3, 1, 1), stride=(2, 1, 1),
                                   padding=0, out_capacity=caps[3])
        for tag, c_in, ch, pad in (("up4to3", 64, 64, (0, 1, 1)), ("up3to2", 64, 32, 1),
                                   ("up2to1", 32, 16, 1)):
            setattr(self, f"{tag}_lateral", SubMConv(ch, ch))
            setattr(self, f"{tag}_inv", SparseInverseConv(c_in, ch, padding=pad))
            setattr(self, f"{tag}_fuse", SubMConv(2 * ch, ch))

    def _up(self, tag, coarse, fine, fine_rb):
        lat = getattr(self, f"{tag}_lateral")(fine, rulebook=fine_rb)
        up = getattr(self, f"{tag}_inv")(coarse, fine)
        cat = fine._replace(features=torch.cat([lat.features, up.features], -1))
        return getattr(self, f"{tag}_fuse")(cat, rulebook=fine_rb)

    def forward(self, batch_dict):
        st = SparseTensor(batch_dict["voxel_features"], batch_dict["voxel_coords"],
                          batch_dict["voxel_mask"], self.grid0, 1)
        rb = {}

        def subm(conv, x, level):
            if level not in rb:
                rb[level] = sp.build_subm_rulebook(x.coords, x.valid, x.grid)
            return conv(x, rulebook=rb[level])

        x1 = subm(self.conv1, subm(self.conv_input, st, 1), 1)
        x2 = subm(self.conv2_b, subm(self.conv2_a, self.conv2_down(x1), 2), 2)
        x3 = subm(self.conv3_b, subm(self.conv3_a, self.conv3_down(x2), 3), 3)
        x4 = subm(self.conv4_b, subm(self.conv4_a, self.conv4_down(x3), 4), 4)
        out = self.conv_out(x4)
        batch_dict["encoded_spconv_tensor"] = sp.sparse_to_dense(
            out.features, out.coords, out.valid, out.grid)
        batch_dict["encoded_spconv_tensor_stride"] = 8
        u3 = self._up("up4to3", x4, x3, rb[3])
        u2 = self._up("up3to2", u3, x2, rb[2])
        u1 = self._up("up2to1", u2, x1, rb[1])
        batch_dict["point_features"] = u1.features
        batch_dict["point_coords_voxel"] = u1.coords
        batch_dict["point_valid"] = u1.valid
        batch_dict["multi_scale_3d_features"] = {
            "x_conv1": x1, "x_conv2": x2, "x_conv3": x3, "x_conv4": x4}
        batch_dict["multi_scale_3d_strides"] = {
            "x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
        return batch_dict

