"""Shared point MLPs and the PointNet++ set-abstraction / feature-propagation
modules (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/pointnet2_modules.py:25-70,
:73-111, :130, :169-239 and :242).

`PointnetSAModuleMSG`: d-fps of `npoint` centres (K1 on the card,
`sampling.furthest_point_sample`), one multi-scale nearest-k ball query with
the gather of [xyz, features] (K2, `grouping.query_group`), xyz re-centred
on the centre, unfilled slots zeroed, a masked SharedMLP a scale and the
masked max pool (-1e9 fill; 0 for an invalid centre or an empty ball).
`PointnetSAModuleFSMSG` (3DSSD's fusion sampling): the centres by
`sample_by_methods` (d-fps, f-fps or s-fps over index ranges of the
points), the scales' balls dilated into annuli (scale i from radius i - 1)
when asked, the same grouping and pooling, then the aggregation SharedMLP
and the confidence SharedMLP with its `confidence_out` logits (-1e9 at
invalid centres), which the next layer's s-fps reads.
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


def sample_by_methods(xyz, features, scores, valid, npoint_list, sample_range_list,
                      sample_method_list, gamma=1.0):
    """Fusion sampling: each (npoint, [lo, hi], method) picks npoint of the
    points lo..hi - 1 by d-fps (`sampling.furthest_point_sample`: K1 / K6 on
    the card), f-fps (FPS on the points' squared distance plus their
    features', `sampling.furthest_point_sample_feature`) or s-fps (FPS
    weighted by sigmoid(largest confidence logit) ** gamma,
    `sampling.furthest_point_sample_weights`: K1 / K6). Returns the picks'
    indices into the whole set, side by side: (B, sum(npoint_list)) int32."""
    out = []
    for npoint, (lo, hi), method in zip(npoint_list, sample_range_list, sample_method_list):
        sub_xyz = xyz[:, lo:hi].detach()
        sub_valid = valid[:, lo:hi]
        if method in ("d-fps", "D-FPS"):
            idx = sampling.furthest_point_sample(sub_xyz, int(npoint), sub_valid)
        elif method in ("f-fps", "F-FPS"):
            idx = sampling.furthest_point_sample_feature(
                sub_xyz, features[:, lo:hi].detach(), int(npoint), sub_valid)
        elif method in ("s-fps", "S-FPS"):
            if scores is None:
                raise ValueError("s-fps needs the previous layer's confidence scores")
            w = torch.sigmoid(scores[:, lo:hi].detach().amax(-1)) ** gamma
            idx = sampling.furthest_point_sample_weights(sub_xyz, w, int(npoint), sub_valid)
        else:
            raise NotImplementedError(f"sample method {method}")
        out.append(idx + int(lo))
    return torch.cat(out, dim=1)


class _SAGroupPool(nn.Module):
    """The grouping half of a set-abstraction layer: `mlp{i}` is scale i's
    SharedMLP over [re-centred xyz, features] (in_channels: the features'
    width); `scales` are (min_r, max_r, ns)."""

    def _init_mlps(self, scales, mlps, in_channels):
        self.scales = scales
        for i, mlp in enumerate(mlps):
            setattr(self, f"mlp{i}", SharedMLP(3 + int(in_channels), mlp))
        return sum(int(m[-1]) for m in mlps)

    def group_pool(self, xyz, features, valid, new_xyz, new_valid):
        """One multi-scale query + gather, each scale's MLP and masked max
        pool: (B, M, sum of the MLPs' last widths)."""
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
        return torch.cat(outs, -1)


class PointnetSAModuleMSG(_SAGroupPool):
    """Multi-scale grouping set abstraction on d-fps centres."""

    def __init__(self, npoint, radii, nsamples, mlps, in_channels):
        super().__init__()
        self.npoint = int(npoint)
        self.out_channels = self._init_mlps(
            [(0.0, float(r), int(ns)) for r, ns in zip(radii, nsamples)], mlps, in_channels)

    def forward(self, xyz, features, valid):
        """xyz (B, N, 3), features (B, N, C) or None, valid (B, N) ->
        new_xyz (B, npoint, 3), new_features (B, npoint, out_channels),
        new_valid (B, npoint)."""
        idx = sampling.furthest_point_sample(xyz, self.npoint, valid)
        new_xyz = sampling.gather_points(xyz, idx)
        new_valid = torch.gather(valid, 1, idx.long())
        return new_xyz, self.group_pool(xyz, features, valid, new_xyz, new_valid), new_valid


class PointnetSAModuleFSMSG(_SAGroupPool):
    """Fusion-sampling multi-scale set abstraction (3DSSD): the centres by
    `sample_by_methods`, scale i's ball an annulus from radius i - 1 with
    `dilated_group`, then `aggregation` (SharedMLP over the concatenated
    scales) and `confidence` + `confidence_out` (num_class logits, bias
    -log(99) at init), each where the config gives its widths."""

    def __init__(self, npoint_list, sample_range_list, sample_method_list, radii, nsamples,
                 mlps, in_channels, dilated_group=False, aggregation_mlp=None,
                 confidence_mlp=None, num_class=3, weight_gamma=1.0):
        super().__init__()
        self.npoint_list = [int(n) for n in npoint_list]
        self.sample_range_list = [tuple(int(v) for v in r) for r in sample_range_list]
        self.sample_method_list = list(sample_method_list)
        self.weight_gamma = float(weight_gamma)
        scales = []
        for i, (r, ns) in enumerate(zip(radii, nsamples)):
            lo = float(radii[i - 1]) if (dilated_group and i > 0) else 0.0
            scales.append((lo, float(r), int(ns)))
        c = self._init_mlps(scales, mlps, in_channels)
        self.has_aggregation = bool(aggregation_mlp)
        if self.has_aggregation:
            self.aggregation = SharedMLP(c, aggregation_mlp)
            c = int(aggregation_mlp[-1])
        self.has_confidence = bool(confidence_mlp)
        if self.has_confidence:
            self.confidence = SharedMLP(c, confidence_mlp)
            self.confidence_out = nn.Linear(int(confidence_mlp[-1]), int(num_class))
        self.out_channels = c

    def forward(self, xyz, features, valid, scores=None):
        """xyz (B, N, 3), features (B, N, C) or None, valid (B, N), scores
        (B, N, num_class) logits or None -> new_xyz (B, M, 3), new_features
        (B, M, out_channels), new_valid (B, M) and new_scores (B, M,
        num_class) or None, M = sum(npoint_list)."""
        idx = sample_by_methods(xyz, features, scores, valid, self.npoint_list,
                                self.sample_range_list, self.sample_method_list,
                                self.weight_gamma)
        new_xyz = sampling.gather_points(xyz, idx)
        new_valid = torch.gather(valid, 1, idx.long())
        new_features = self.group_pool(xyz, features, valid, new_xyz, new_valid)
        zero = torch.zeros((), dtype=new_features.dtype, device=new_features.device)
        if self.has_aggregation:
            new_features = torch.where(new_valid[..., None],
                                       self.aggregation(new_features, new_valid), zero)
        new_scores = None
        if self.has_confidence:
            logits = self.confidence_out(self.confidence(new_features, new_valid))
            new_scores = torch.where(new_valid[..., None], logits,
                                     torch.full_like(logits, -1e9))
        return new_xyz, new_features, new_valid, new_scores


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
