"""Sparse conv layers, SECOND's sparse stem and its residual variant
(counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/spconv_backbone.py:27-309).

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


def _pyramid(grid0, channels, downs):
    """{x_conv1..4: (channels, grid (gz, gy, gx), stride)} of a trunk whose
    levels start at `grid0` and step down through the strided convs
    `downs`: what `multi_scale_3d_features` holds."""
    out, grid = {}, grid0
    for i, c in enumerate(channels):
        if i:
            conv = downs[i - 1]
            grid = _out_grid(grid, conv.kernel_size, conv.stride, conv.padding)
        out[f"x_conv{i + 1}"] = (int(c), grid, 2 ** i)
    return out


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
        self.pyramid = _pyramid(self.grid0, (16, 32, 64, 64),
                                (self.conv2_down, self.conv3_down, self.conv4_down))
        self.x_conv4_grid = self.pyramid["x_conv4"][1]

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


class SpaceVoxelBackBone8x(VoxelBackBone8x):
    """The JAX registry's name for VoxelBackBone8x's trunk (JAX
    spconv_backbone.py:318-321; the reference's spatial-attention blocks are
    not in the JAX package either)."""


class DSASNetVoxelBackBone8x(VoxelBackBone8x):
    """The JAX registry's name for VoxelBackBone8x's trunk under DSASNet
    (JAX spconv_backbone.py:312-315: the same trunk and pyramid)."""


class SparseBasicBlock(nn.Module):
    """Residual pair of submanifold convs on one position set: `conv1`
    (BN, ReLU), `conv2` (BN, no ReLU), then relu(out + identity) masked to
    the valid rows. Both convs take the `rulebook` they are handed."""

    def __init__(self, channels):
        super().__init__()
        self.conv1 = SubMConv(channels, channels)
        self.conv2 = SubMConv(channels, channels, use_relu=False)

    def forward(self, st: SparseTensor, rulebook=None) -> SparseTensor:
        out = self.conv2(self.conv1(st, rulebook=rulebook), rulebook=rulebook)
        feats = torch.relu(out.features + st.features)
        return st._replace(features=torch.where(st.valid[..., None], feats,
                                                torch.zeros_like(feats)))


class VoxelResBackBone8x(nn.Module):
    """CenterPoint's residual sparse stem: conv_input + two SparseBasicBlocks
    a level (16, 32, 64, 128 channels; strided convs between the levels) +
    conv_out (128 over (3, 1, 1)), 21 sparse convs. Each level's position
    set has one materialised subm rulebook, which all of that level's convs
    share (five at level 1, four at levels 2-4; the JAX package builds one a
    conv, and a position set has one rulebook), and each strided conv one
    materialised plan: 8 probes a forward (K3 on the card), every conv an
    index gather-GEMM (K7). batch_dict in and out as `VoxelBackBone8x`."""

    def __init__(self, model_cfg, input_channels, meta):
        super().__init__()
        self.grid0 = sparse_shape_from_meta(meta)
        self.capacities = model_cfg.get("VOXEL_CAPACITIES", None)
        self.conv_input = SubMConv(input_channels, 16)
        self.res1_a, self.res1_b = SparseBasicBlock(16), SparseBasicBlock(16)
        self.conv2_down = SparseConv(16, 32)
        self.res2_a, self.res2_b = SparseBasicBlock(32), SparseBasicBlock(32)
        self.conv3_down = SparseConv(32, 64)
        self.res3_a, self.res3_b = SparseBasicBlock(64), SparseBasicBlock(64)
        self.conv4_down = SparseConv(64, 128, padding=(0, 1, 1))
        self.res4_a, self.res4_b = SparseBasicBlock(128), SparseBasicBlock(128)
        self.conv_out = SparseConv(128, 128, kernel_size=(3, 1, 1), stride=(2, 1, 1),
                                   padding=0)
        self.pyramid = _pyramid(self.grid0, (16, 32, 64, 128),
                                (self.conv2_down, self.conv3_down, self.conv4_down))

    @staticmethod
    def _blocks(st, *convs):
        """Submanifold convs and blocks in turn on one materialised rulebook."""
        rb = sp.build_subm_rulebook(st.coords, st.valid, st.grid, lazy=False)
        for conv in convs:
            st = conv(st, rulebook=rb)
        return st

    def forward(self, batch_dict):
        st = SparseTensor(batch_dict["voxel_features"], batch_dict["voxel_coords"],
                          batch_dict["voxel_mask"], self.grid0, 1)
        V = st.features.shape[1]
        caps = self.capacities or [V] * 4
        down = VoxelBackBone8x._down
        x1 = self._blocks(st, self.conv_input, self.res1_a, self.res1_b)
        x2 = self._blocks(down(self.conv2_down, x1, caps[0]), self.res2_a, self.res2_b)
        x3 = self._blocks(down(self.conv3_down, x2, caps[1]), self.res3_a, self.res3_b)
        x4 = self._blocks(down(self.conv4_down, x3, caps[2]), self.res4_a, self.res4_b)
        out = down(self.conv_out, x4, caps[3])
        batch_dict["encoded_spconv_tensor"] = sp.sparse_to_dense(
            out.features, out.coords, out.valid, out.grid)
        batch_dict["encoded_spconv_tensor_stride"] = 8
        batch_dict["multi_scale_3d_features"] = {
            "x_conv1": x1, "x_conv2": x2, "x_conv3": x3, "x_conv4": x4}
        batch_dict["multi_scale_3d_strides"] = {
            "x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
        return batch_dict
