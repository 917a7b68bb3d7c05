"""Sparse conv layers (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/spconv_backbone.py:27-163).

A conv's `weight` keeps the JAX layout (K, Cin, Cout), taps ordered like
ops.spconv.kernel_offsets(). BN is eps 1e-3, momentum 0.99; in train mode
its batch stats count the output's valid rows only.
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
