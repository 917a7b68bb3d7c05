"""Sparse conv layers and SECOND's sparse stem (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/spconv_backbone.py:27-249).

A conv's `weight` keeps the JAX layout (K, Cin, Cout), taps ordered like
ops.spconv.kernel_offsets(). BN is eps 1e-3, momentum 0.99; in train mode
its batch stats count the output's valid rows only. A conv takes the route
of the rulebook or plan it is handed (ops/spconv.py): the TSM U-Nets hand
by-key ones, `VoxelBackBone8x` materialised ones.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ...ops import spconv as sp
from .pointnet2_modules import BatchNorm


class SparseTensor(NamedTuple):
    """Fixed-capacity batched sparse tensor (rows sorted by voxel key)."""
    features: torch.Tensor   # (B, V, C)
    coords: torch.Tensor     # (B, V, 3) int32 zyx, -1 pad
    valid: torch.Tensor      # (B, V) bool
    grid: tuple              # (gz, gy, gx)
    stride: int              # downsample factor vs the voxel grid


def _out_grid(grid, kernel_size, stride, padding):
    ks = np.asarray((kernel_size,) * 3 if isinstance(kernel_size, int) else kernel_size)
    st = np.asarray((stride,) * 3 if isinstance(stride, int) else stride)
    pd = np.asarray((padding,) * 3 if isinstance(padding, int) else padding)
    g = (np.asarray(grid) + 2 * pd - ks) // st + 1
    return tuple(int(v) for v in g)


class _ConvBase(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, use_norm, use_relu):
        super().__init__()
        ks = kernel_size
        K = ks ** 3 if isinstance(ks, int) else int(np.prod(ks))
        self.kernel_size = ks
        self.use_norm = use_norm
        self.use_relu = use_relu
        self.weight = nn.Parameter(torch.zeros(K, int(in_channels), int(out_channels)))
        if use_norm:
            self.bn = BatchNorm(int(out_channels), eps=1e-3)
        else:
            self.bias = nn.Parameter(torch.zeros(int(out_channels)))

    def _post(self, feats, valid):
        feats = self.bn(feats, valid) if self.use_norm else feats + self.bias
        if self.use_relu:
            feats = torch.relu(feats)
        return torch.where(valid[..., None], feats, torch.zeros_like(feats))


class SubMConv(_ConvBase):
    """Submanifold conv + BN + ReLU; pass a shared `rulebook`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, use_norm=True,
                 use_relu=True):
        super().__init__(in_channels, out_channels, kernel_size, use_norm, use_relu)

    def forward(self, st: SparseTensor, rulebook=None) -> SparseTensor:
        feats = sp.subm_conv3d(st.features, st.coords, st.valid, self.weight,
                               st.grid, rulebook=rulebook)
        return st._replace(features=self._post(feats, st.valid))


class SparseConv(_ConvBase):
    """Strided sparse conv + BN + ReLU; changes the position set."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=2,
                 padding=1, out_capacity=None, use_norm=True, use_relu=True):
        super().__init__(in_channels, out_channels, kernel_size, use_norm, use_relu)
        self.stride = stride
        self.padding = padding
        self.out_capacity = out_capacity

    def forward(self, st: SparseTensor, plan=None) -> SparseTensor:
        out_grid = _out_grid(st.grid, self.kernel_size, self.stride, self.padding)
        cap = self.out_capacity or st.features.shape[1]
        feats, coords, valid = sp.sparse_conv3d(
            st.features, st.coords, st.valid, self.weight, st.grid, out_grid,
            kernel_size=self.kernel_size, stride=self.stride,
            padding=self.padding, out_capacity=cap, plan=plan)
        s = self.stride if isinstance(self.stride, int) else max(self.stride)
        return SparseTensor(self._post(feats, valid), coords, valid, out_grid,
                            st.stride * s)


class SparseInverseConv(_ConvBase):
    """Inverse (decoder) conv back onto a known fine position set."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=2,
                 padding=1, use_norm=True, use_relu=True):
        super().__init__(in_channels, out_channels, kernel_size, use_norm, use_relu)
        self.stride = stride
        self.padding = padding

    def forward(self, st: SparseTensor, fine: SparseTensor,
                rulebook=None) -> SparseTensor:
        feats = sp.inverse_conv3d(
            st.features, st.coords, st.valid, self.weight, fine.coords,
            fine.valid, st.grid, kernel_size=self.kernel_size,
            stride=self.stride, padding=self.padding, rulebook=rulebook)
        return SparseTensor(self._post(feats, fine.valid), fine.coords,
                            fine.valid, fine.grid, fine.stride)


def sparse_shape_from_meta(meta):
    """The reference adds +1 on z: sparse_shape = grid_size[::-1] + [1, 0, 0]."""
    nx, ny, nz = meta.grid_size
    return (int(nz) + 1, int(ny), int(nx))


class VoxelBackBone8x(nn.Module):
    """SECOND's sparse stem: conv_input + conv1..4 (strides 1, 2, 4, 8) +
    conv_out, 12 sparse convs on 4 submanifold rulebooks and 4 strided
    plans. Every rulebook and plan is materialised (`lazy=False`): each
    probes once (K3 on the card), each subm rulebook serves two convs, and
    every conv gathers by index (K7).

    batch_dict in: voxel_features (B, V, C), voxel_coords (B, V, 3) zyx
    sorted, voxel_mask (B, V); out: encoded_spconv_tensor (dense
    (B, nz', ny/8, nx/8, 128)), encoded_spconv_tensor_stride 8,
    multi_scale_3d_features {x_conv1..4: SparseTensor},
    multi_scale_3d_strides {1, 2, 4, 8}. The voxel capacity of every level
    is VOXEL_CAPACITIES, or V."""

    def __init__(self, model_cfg, input_channels, meta):
        super().__init__()
        self.grid0 = sparse_shape_from_meta(meta)
        self.capacities = model_cfg.get("VOXEL_CAPACITIES", None)
        self.conv_input = SubMConv(input_channels, 16)
        self.conv1 = SubMConv(16, 16)
        self.conv2_down = SparseConv(16, 32)
        self.conv2_a = SubMConv(32, 32)
        self.conv2_b = SubMConv(32, 32)
        self.conv3_down = SparseConv(32, 64)
        self.conv3_a = SubMConv(64, 64)
        self.conv3_b = SubMConv(64, 64)
        self.conv4_down = SparseConv(64, 64, padding=(0, 1, 1))
        self.conv4_a = SubMConv(64, 64)
        self.conv4_b = SubMConv(64, 64)
        self.conv_out = SparseConv(64, 128, kernel_size=(3, 1, 1), stride=(2, 1, 1),
                                   padding=0)

    @staticmethod
    def _down(conv, st, capacity):
        """A strided conv through its materialised plan."""
        out_grid = _out_grid(st.grid, conv.kernel_size, conv.stride, conv.padding)
        plan = sp.build_conv_plan(st.coords, st.valid, st.grid, out_grid,
                                  conv.kernel_size, conv.stride, conv.padding,
                                  capacity, lazy=False)
        return conv(st, plan=plan)

    @staticmethod
    def _subm_pair(conv_a, conv_b, st):
        """Two submanifold convs on one materialised rulebook."""
        rb = sp.build_subm_rulebook(st.coords, st.valid, st.grid, lazy=False)
        return conv_b(conv_a(st, rulebook=rb), rulebook=rb)

    def forward(self, batch_dict):
        st = SparseTensor(batch_dict["voxel_features"], batch_dict["voxel_coords"],
                          batch_dict["voxel_mask"], self.grid0, 1)
        V = st.features.shape[1]
        caps = self.capacities or [V] * 4
        x1 = self._subm_pair(self.conv_input, self.conv1, st)
        x2 = self._subm_pair(self.conv2_a, self.conv2_b,
                             self._down(self.conv2_down, x1, caps[0]))
        x3 = self._subm_pair(self.conv3_a, self.conv3_b,
                             self._down(self.conv3_down, x2, caps[1]))
        x4 = self._subm_pair(self.conv4_a, self.conv4_b,
                             self._down(self.conv4_down, x3, caps[2]))
        out = self._down(self.conv_out, x4, caps[3])
        batch_dict["encoded_spconv_tensor"] = sp.sparse_to_dense(
            out.features, out.coords, out.valid, out.grid)
        batch_dict["encoded_spconv_tensor_stride"] = 8
        batch_dict["multi_scale_3d_features"] = {
            "x_conv1": x1, "x_conv2": x2, "x_conv3": x3, "x_conv4": x4}
        batch_dict["multi_scale_3d_strides"] = {
            "x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
        return batch_dict
