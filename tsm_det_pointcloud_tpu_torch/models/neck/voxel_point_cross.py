"""The VoxelPointCross neck, BEV <-> point fusion (counterpart of
tsm_det_pointcloud_tpu/models/neck/voxel_point_cross.py:42-120; a module
of another registry than the 2D backbone of the same name).

The BEV input is `spatial_features_2d` where a 2D backbone ran (at
`spatial_features_2d_stride`, else `spatial_features_stride`, else 2),
otherwise `spatial_features` (at the trunk's stride). The points are the
backbone's (`point_coords`, `point_valid`; the raw points where it wrote
none). Their seed features: `point_grid_pool` over the sparse pyramid
where the config has POINT_GRID_POOL and the detector a sparse trunk
(K2 window queries), else the `point_features` the backbone wrote; `point_features`
(SharedMLP to NUM_FILTERS). The BEV trunk: `v_input`, then five `v2p_k`
blocks chained through four `p2v_k` and `v_k` (`v_k` over [state,
p2v_k]); the point cascade reads each `v2p_k` map bilinearly at the points
(`p{k}_out`). Out: `spatial_features(_2d)` (NHWC, NUM_FILTERS channels)
and the points' fused `point_features`. A head that reads only the BEV map
gives the point branch no gradient (PVSSDA on this neck: the JAX package's
is zero there).
"""
from __future__ import annotations

import torch
from torch import nn

from ..backbones_2d.point_bev_hybrids import ConvBlock, PointGridPool, _nchw, _nhwc, _pixels, interp_bev
from ..backbones_3d.pointnet2_modules import SharedMLP


class VoxelPointCross(nn.Module):
    def __init__(self, model_cfg, voxel_size, point_cloud_range, bev_channels, point_channels,
                 source_channels=None):
        super().__init__()
        cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        ch = self.ch = int(cfg.get("NUM_FILTERS", 128))
        self.has_pool = bool(cfg.get("POINT_GRID_POOL")) and source_channels is not None
        pooled = point_channels
        if self.has_pool:
            self.point_grid_pool = PointGridPool(dict(cfg["POINT_GRID_POOL"]), voxel_size,
                                                 point_cloud_range, source_channels)
            pooled = self.point_grid_pool.out_channels
        self.pooled_channels = pooled
        self.point_features = SharedMLP(int(pooled), [ch])
        self.v_input = ConvBlock(bev_channels, (ch,))
        for k in range(1, 6):
            setattr(self, f"v2p_{k}", ConvBlock(ch, (ch // 2, ch)))
            setattr(self, f"p{k}_out", SharedMLP(2 * ch, [ch, ch]))
        for k in range(1, 5):
            setattr(self, f"p2v_{k}", ConvBlock(ch, (ch // 2, ch)))
            setattr(self, f"v{k}", ConvBlock(2 * ch, (ch, ch)))
        self.bev_channels = self.point_channels = ch

    def forward(self, batch_dict):
        if "spatial_features_2d" in batch_dict:
            bev = batch_dict["spatial_features_2d"]
            stride = int(batch_dict.get("spatial_features_2d_stride",
                                        batch_dict.get("spatial_features_stride", 2)))
        else:
            bev = batch_dict["spatial_features"]
            stride = int(batch_dict.get("encoded_spconv_tensor_stride", 8))
        if "point_coords" in batch_dict:
            pts = batch_dict["point_coords"]
            pvalid = batch_dict.get("point_valid")
        else:
            pts = batch_dict["points"][..., :3]
            pvalid = batch_dict.get("points_mask")
        if pvalid is None or pvalid.shape != pts.shape[:2]:   # a stale mask of another set
            pvalid = torch.ones(pts.shape[:2], dtype=torch.bool, device=pts.device)

        if self.has_pool and "multi_scale_3d_features" in batch_dict:
            pooled, _ = self.point_grid_pool(batch_dict, pts, pvalid)
        else:
            pooled = batch_dict["point_features"]
        pfeat = self.point_features(pooled, pvalid)

        state = self.v_input(_nchw(bev))
        maps = []
        for k in range(1, 6):
            v2p = getattr(self, f"v2p_{k}")(state)
            maps.append(_nhwc(v2p))
            if k == 5:
                break
            p2v = getattr(self, f"p2v_{k}")(v2p)
            state = getattr(self, f"v{k}")(torch.cat([state, p2v], 1))

        px, py = _pixels(pts, self.voxel_size, self.point_cloud_range, stride)
        p = pfeat
        for k, m in enumerate(maps, 1):
            p = getattr(self, f"p{k}_out")(torch.cat([p, interp_bev(m, px, py)], -1), pvalid)
        p = torch.where(pvalid[..., None], p, torch.zeros_like(p))

        state = _nhwc(state)
        batch_dict["spatial_features"] = state
        batch_dict["spatial_features_2d"] = state
        batch_dict["point_coords"] = pts
        batch_dict["point_valid"] = pvalid
        batch_dict["point_features"] = p
        batch_dict["encoded_point_features"] = p
        return batch_dict


NECKS = {"VoxelPointCross": VoxelPointCross}
