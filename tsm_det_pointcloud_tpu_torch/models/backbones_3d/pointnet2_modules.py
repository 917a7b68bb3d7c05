"""Shared point MLPs (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/pointnet2_modules.py:25-70).

`Dense` is `nn.Linear`; `BatchNorm` is the eval form of flax's BatchNorm,
computed in flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias.
Only the eval path is ported: normalisation always uses the running stats.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Channels-last batch norm over the trailing axis, running stats only."""

    def __init__(self, num_features, eps=1e-3):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


def safe_bn_mask(mask):
    """An all-empty BatchNorm mask falls back to all-True (training-time
    stats guard; kept for parity, eval normalises with running stats)."""
    if mask is None:
        return None
    return mask | ~mask.any()


class SharedMLP(nn.Module):
    """Dense (no bias) + BN(eps 1e-3) + ReLU stack over the trailing axis."""

    def __init__(self, in_channels: int, channels: Sequence[int], use_norm=True):
        super().__init__()
        self.channels = [int(c) for c in channels]
        self.use_norm = use_norm
        c_in = int(in_channels)
        for i, c in enumerate(self.channels):
            setattr(self, f"fc{i}", nn.Linear(c_in, c, bias=not use_norm))
            if use_norm:
                setattr(self, f"bn{i}", BatchNorm(c, eps=1e-3))
            c_in = c

    def forward(self, x):
        for i in range(len(self.channels)):
            x = getattr(self, f"fc{i}")(x)
            if self.use_norm:
                x = getattr(self, f"bn{i}")(x)
            x = torch.relu(x)
        return x
