"""Shared point MLPs (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/pointnet2_modules.py:25-70).

`Dense` is `nn.Linear`; `BatchNorm` is flax's BatchNorm over the trailing
axis, normalising in flax's order: (x - mean) * (rsqrt(var + eps) * scale)
+ bias. In eval mode it uses the running stats. In train mode it uses the
batch stats of the masked elements (flax 0.12 semantics, see `BatchNorm`)
and updates the running stats in place.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Channels-last batch norm over the trailing axis.

    Train mode, as flax's `BatchNorm(use_running_average=False)` with a
    `mask`: mean and variance over the elements where `mask` (shape
    `x.shape[:-1]`) is True, the fast variance E[x²] - E[x]² clipped at 0
    (biased), and `running = momentum * running + (1 - momentum) * batch`
    with the biased batch variance. (`torch.nn.BatchNorm1d` stores the
    unbiased variance, so it is not used.) The mask is taken as given, as
    flax does: the MLPs guard it with `safe_bn_mask` first, the convs and
    the head's single BNs do not."""

    def __init__(self, num_features, eps=1e-3, momentum=0.99):
        super().__init__()
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x, mask=None):
        if self.training:
            mean, var = _masked_stats(x, mask)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


def _masked_stats(x, mask):
    """Per-channel mean and fast variance over the leading axes of x,
    counting only the elements where mask (x.shape[:-1]) is True."""
    flat = x.reshape(-1, x.shape[-1])
    if mask is None:
        mean = flat.mean(0)
        mean2 = (flat * flat).mean(0)
    else:
        m = mask.reshape(-1, 1)
        n = m.sum().to(x.dtype)
        flat = torch.where(m, flat, torch.zeros((), dtype=x.dtype, device=x.device))
        mean = flat.sum(0) / n
        mean2 = (flat * flat).sum(0) / n
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def safe_bn_mask(mask):
    """An all-empty BatchNorm mask falls back to all-True (inputs are
    already masked to 0, so the stats stay finite)."""
    if mask is None:
        return None
    return mask | ~mask.any()


class SharedMLP(nn.Module):
    """Dense (no bias) + BN(eps 1e-3) + ReLU stack over the trailing axis;
    `mask` (x.shape[:-1]) selects the elements of the train-mode BN stats."""

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

    def forward(self, x, mask=None):
        mask = safe_bn_mask(mask)
        for i in range(len(self.channels)):
            x = getattr(self, f"fc{i}")(x)
            if self.use_norm:
                x = getattr(self, f"bn{i}")(x, mask)
            x = torch.relu(x)
        return x
