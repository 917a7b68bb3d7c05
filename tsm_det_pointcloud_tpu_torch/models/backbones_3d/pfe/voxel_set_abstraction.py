"""Voxel set abstraction, PV-RCNN's keypoint features (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/pfe/voxel_set_abstraction.py).

NUM_KEYPOINTS keypoints a scan by d-fps over the raw points
(`sampling.furthest_point_sample`: K1 up to 16384 points a scan on the card,
K6 above), or with SAMPLE_METHOD SPC (PV-RCNN++) by
`vector_pool.sectorized_fps` (SPC_SAMPLING.NUM_SECTORS azimuth sectors, one
d-fps call over all of them); then one feature block per FEATURES_SOURCE,
in the JAX package's order: `bev` (the BEV map bilinearly sampled at each
keypoint's xy), then `raw_points`, then each `x_conv*` in the config's
order, each of the last two an `SAGroup` (a multi-scale nearest-k ball
query over the source, all its scales in one K2 call, and a SharedMLP a
scale max-pooled over the filled slots; an empty ball gives 0) or, where
the source's NAME is VectorPoolAggregationModuleMSG (PV-RCNN++), a
`vector_pool.VectorPoolAggregationModuleMSG`. The sparse sources group
their voxel centres (`voxel_centers`). The blocks are concatenated
(`point_features_before_fusion`) and fused by `vsa_point_feature_fusion`
(Dense without bias), `fusion_bn` (masked by the keypoints' validity) and
ReLU into `point_features`.
"""
from __future__ import annotations

import torch
from torch import nn

from ....ops import grouping, sampling
from ..pointnet2_modules import BatchNorm, SharedMLP
from .vector_pool import VectorPoolAggregationModuleMSG, sectorized_fps


def voxel_centers(coords_zyx, stride, voxel_size, point_cloud_range):
    """(..., 3) int zyx voxel coords at `stride` -> (..., 3) float32 xyz
    centres."""
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=coords_zyx.device) * stride
    origin = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=coords_zyx.device)
    return (coords_zyx.flip(-1).to(torch.float32) + 0.5) * vs + origin


def _clip01(w):
    """w clipped to [0, 1] as jnp.clip does it, gradient included: half the
    gradient passes at a bound (torch.clamp passes all of it), which a
    lattice point on a pixel's edge meets in SECONDHead's pool."""
    return torch.minimum(torch.maximum(w, torch.zeros_like(w)), torch.ones_like(w))


def bilinear_interpolate(bev, x, y):
    """bev (H, W, C); x, y (K,) in pixel units -> (K, C), the corner indices
    clamped to the map and the weights to [0, 1]."""
    H, W, _ = bev.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    x1, y1 = x0 + 1, y0 + 1
    wx = _clip01(x - x0.to(x.dtype))
    wy = _clip01(y - y0.to(y.dtype))
    return (bev[y0, x0] * ((1 - wx) * (1 - wy))[:, None]
            + bev[y0, x1] * (wx * (1 - wy))[:, None]
            + bev[y1, x0] * ((1 - wx) * wy)[:, None]
            + bev[y1, x1] * (wx * wy)[:, None])


class SAGroup(nn.Module):
    """Multi-scale ball-query aggregation of a fixed-capacity source set at
    query points: `mlp{i}` over [xyz - query, features] of scale i, max over
    the filled slots, the scales concatenated."""

    def __init__(self, in_channels, radii, nsamples, mlps):
        super().__init__()
        self.scales = [(0.0, float(r), int(ns)) for r, ns in zip(radii, nsamples)]
        self.out_channels = 0
        for i, mlp in enumerate(mlps):
            m = SharedMLP(3 + int(in_channels), mlp)
            setattr(self, f"mlp{i}", m)
            self.out_channels += m.channels[-1]

    def forward(self, query_xyz, support_xyz, support_feats, support_valid):
        payload = support_xyz if support_feats is None else torch.cat(
            [support_xyz, support_feats], -1)
        groups = grouping.query_group(support_xyz, support_valid, query_xyz, self.scales,
                                      payload=payload)
        outs = []
        for i, (_, cnt, grouped) in enumerate(groups):
            slot_ok = torch.arange(self.scales[i][2], device=query_xyz.device) < cnt[..., None]
            g = torch.cat([grouped[..., :3] - query_xyz[:, :, None, :], grouped[..., 3:]], -1)
            g = torch.where(slot_ok[..., None], g, torch.zeros_like(g))
            h = getattr(self, f"mlp{i}")(g, slot_ok)
            h = torch.where(slot_ok[..., None], h, torch.full_like(h, -1e9)).amax(dim=2)
            outs.append(torch.where(cnt[..., None] > 0, h, torch.zeros_like(h)))
        return torch.cat(outs, -1)


def _group(sc, in_channels):
    """A source's aggregation: PV-RCNN++'s VectorPool (NAME
    VectorPoolAggregationModuleMSG; LOCAL_GRIDS default 3^3 a scale,
    AGGREGATION_MLPS optional) or PV-RCNN's SAGroup."""
    if str(sc.get("NAME", "")) == "VectorPoolAggregationModuleMSG":
        n = len(sc["POOL_RADIUS"])
        return VectorPoolAggregationModuleMSG(
            in_channels, sc["POOL_RADIUS"], sc["NSAMPLE"],
            sc.get("LOCAL_GRIDS", [[3, 3, 3]] * n), sc["MLPS"],
            sc.get("AGGREGATION_MLPS") or None)
    return SAGroup(in_channels, sc["POOL_RADIUS"], sc["NSAMPLE"], sc["MLPS"])


# the channels of each sparse source of VoxelBackBone8x / UNetV2's encoder
X_CONV_CHANNELS = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64, "x_conv4": 64}


class VoxelSetAbstraction(nn.Module):
    def __init__(self, model_cfg, voxel_size, point_cloud_range, num_bev_features=256,
                 num_rawpoint_features=4):
        super().__init__()
        cfg = model_cfg
        self.num_sectors = (int(cfg.get("SPC_SAMPLING", {}).get("NUM_SECTORS", 6))
                            if str(cfg.get("SAMPLE_METHOD", "FPS")) in ("SPC", "SectorFPS")
                            else None)
        self.model_cfg = cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.num_keypoints = int(cfg["NUM_KEYPOINTS"])
        self.sources = list(cfg["FEATURES_SOURCE"])
        sa_cfg = cfg.get("SA_LAYER", {})
        c = int(num_bev_features) if "bev" in self.sources else 0
        if "raw_points" in self.sources:
            self.sa_rawpoints = _group(sa_cfg["raw_points"], int(num_rawpoint_features) - 3)
            c += self.sa_rawpoints.out_channels
        for src in self.x_conv_sources:
            m = _group(sa_cfg[src], X_CONV_CHANNELS[src])
            setattr(self, f"sa_{src}", m)
            c += m.out_channels
        self.num_point_features = int(cfg["NUM_OUTPUT_FEATURES"])
        self.num_point_features_before_fusion = c
        self.vsa_point_feature_fusion = nn.Linear(c, self.num_point_features, bias=False)
        self.fusion_bn = BatchNorm(self.num_point_features, eps=1e-3)

    @property
    def x_conv_sources(self):
        return [s for s in self.sources if s.startswith("x_conv")]

    def forward(self, batch_dict):
        points = batch_dict["points"]
        pmask = batch_dict["points_mask"]
        xyz = points[..., :3].contiguous()
        if self.num_sectors is None:
            idx = sampling.furthest_point_sample(xyz, self.num_keypoints, pmask)
        else:
            idx = sectorized_fps(xyz, pmask, self.num_keypoints, self.num_sectors)
        keypoints = sampling.gather_points(xyz, idx)
        kp_valid = torch.gather(pmask, 1, idx.long())
        feats = []
        if "bev" in self.sources:
            bev = batch_dict["spatial_features"]
            stride = batch_dict.get("spatial_features_stride", 8)
            vx, vy = self.voxel_size[0] * stride, self.voxel_size[1] * stride
            pcr = self.point_cloud_range
            feats.append(torch.stack([
                bilinear_interpolate(bm, (kp[:, 0] - pcr[0]) / vx, (kp[:, 1] - pcr[1]) / vy)
                for bm, kp in zip(bev, keypoints)]))
        if "raw_points" in self.sources:
            raw = points[..., 3:] if points.shape[-1] > 3 else None
            feats.append(self.sa_rawpoints(keypoints, xyz, raw, pmask))
        for src in self.x_conv_sources:
            st = batch_dict["multi_scale_3d_features"][src]
            stride = batch_dict["multi_scale_3d_strides"][src]
            centers = voxel_centers(st.coords, stride, self.voxel_size, self.point_cloud_range)
            feats.append(getattr(self, f"sa_{src}")(keypoints, centers, st.features, st.valid))
        fused = torch.cat(feats, -1)
        out = torch.relu(self.fusion_bn(self.vsa_point_feature_fusion(fused), kp_valid))
        out = torch.where(kp_valid[..., None], out, torch.zeros_like(out))
        batch_dict["point_features_before_fusion"] = fused
        batch_dict["point_features"] = out
        batch_dict["point_coords"] = keypoints
        batch_dict["point_valid"] = kp_valid
        return batch_dict
