"""Shared point MLPs and the PointNet++ set-abstraction / feature-propagation
modules (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/pointnet2_modules.py:25-70, :130
and :242).

`PointnetSAModuleMSG`: d-fps of `npoint` centres (K1 on the card,
`sampling.furthest_point_sample`), one multi-scale nearest-k ball query with
the gather of [xyz, features] (K2, `grouping.query_group`), xyz re-centred
on the centre, unfilled slots zeroed, a masked SharedMLP a scale and the
masked max pool (-1e9 fill; 0 for an invalid centre or an empty ball).
`PointnetFPModule`: 3-NN inverse-distance interpolation
(`grouping.three_nn`, plain PyTorch on any device, as the JAX package's XLA
code), the skip features concatenated, a SharedMLP masked by the unknown
points' validity, zeros at invalid points.

`Dense` is `nn.Linear`; `BatchNorm` is flax's BatchNorm over the trailing
axis, normalising in flax's order: (x - mean) * (rsqrt(var + eps) * scale)
+ bias. In eval mode it uses the running stats. In train mode it uses the
batch stats of the masked elements (flax 0.12 semantics, see `BatchNorm`)
and updates the running stats in place. In a multi-process run the batch
is the global one: the sums, squared sums and count come through
`comm.global_sum`, and a mask is empty only where it is empty on every rank
(`comm.global_any`), as the JAX package's jit over a data mesh sees one
array.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops import grouping, sampling
from ...parallel import comm


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
    if comm.data_world_size() > 1:
        return _global_stats(flat, None if mask is None else mask.reshape(-1, 1))
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


def _global_stats(flat, m):
    """_masked_stats over the data group's global batch: the per-channel
    sums, squared sums and count summed over the ranks in one all-reduce."""
    C = flat.shape[-1]
    if m is None:
        n = torch.full((1,), flat.shape[0], dtype=flat.dtype, device=flat.device)
    else:
        n = m.sum().to(flat.dtype)[None]
        flat = torch.where(m, flat, torch.zeros((), dtype=flat.dtype, device=flat.device))
    sums = comm.global_sum(torch.cat([flat.sum(0), (flat * flat).sum(0), n]))
    mean = sums[:C] / sums[2 * C]
    mean2 = sums[C:2 * C] / sums[2 * C]
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def safe_bn_mask(mask):
    """An all-empty BatchNorm mask falls back to all-True (inputs are
    already masked to 0, so the stats stay finite). Empty means empty on
    every rank of a multi-process run."""
    if mask is None:
        return None
    return mask | ~comm.global_any(mask)


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


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale grouping set abstraction; `mlp{i}` is scale i's SharedMLP
    over [re-centred xyz, features] (in_channels: the features' width)."""

    def __init__(self, npoint, radii, nsamples, mlps, in_channels):
        super().__init__()
        self.npoint = int(npoint)
        self.scales = [(0.0, float(r), int(ns)) for r, ns in zip(radii, nsamples)]
        for i, mlp in enumerate(mlps):
            setattr(self, f"mlp{i}", SharedMLP(3 + int(in_channels), mlp))
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, features, valid):
        """xyz (B, N, 3), features (B, N, C) or None, valid (B, N) ->
        new_xyz (B, npoint, 3), new_features (B, npoint, out_channels),
        new_valid (B, npoint)."""
        idx = sampling.furthest_point_sample(xyz, self.npoint, valid)
        new_xyz = sampling.gather_points(xyz, idx)
        new_valid = torch.gather(valid, 1, idx.long())
        payload = xyz if features is None else torch.cat([xyz, features], -1)
        groups = grouping.query_group(xyz, valid, new_xyz, self.scales, payload=payload)
        outs = []
        for i, (_, cnt, grouped) in enumerate(groups):
            ns = self.scales[i][2]
            slot_ok = (torch.arange(ns, device=xyz.device) < cnt[..., None]) & new_valid[..., None]
            g = torch.cat([grouped[..., :3] - new_xyz[:, :, None, :], grouped[..., 3:]], -1)
            g = torch.where(slot_ok[..., None], g, torch.zeros_like(g))
            h = getattr(self, f"mlp{i}")(g, slot_ok)
            h = torch.where(slot_ok[..., None], h, torch.full_like(h, -1e9)).amax(dim=2)
            keep = new_valid[..., None] & (cnt[..., None] > 0)
            outs.append(torch.where(keep, h, torch.zeros_like(h)))
        return new_xyz, torch.cat(outs, -1), new_valid


class PointnetFPModule(nn.Module):
    """Feature propagation: the known points' features interpolated at the
    unknown points from their three nearest known ones, the unknown points'
    own features after them, then `mlp` (SharedMLP)."""

    def __init__(self, mlp, in_channels):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp)

    def forward(self, unknown, known, unknown_feats, known_feats, known_valid, unknown_valid):
        dist, idx = grouping.three_nn(unknown, known, known_valid)
        interp = grouping.three_interpolate(known_feats, idx,
                                            grouping.three_interpolate_weights(dist))
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], -1)
        out = self.mlp(interp, unknown_valid)
        return torch.where(unknown_valid[..., None], out, torch.zeros_like(out))
