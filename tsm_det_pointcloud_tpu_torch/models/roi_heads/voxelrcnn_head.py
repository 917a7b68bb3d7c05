"""Voxel R-CNN's RoI head (counterpart of
tsm_det_pointcloud_tpu/models/roi_heads/voxelrcnn_head.py).

RoI-grid pooling over the sparse backbone's voxels: a GRID_SIZE^3 lattice of
points in each RoI's frame (`roi_grid_points`), then for each POOL_LAYERS
source, in the config's order, one K2 window query over the source's voxel
centres (`voxel_centers` at its `multi_scale_3d_strides`) with all of the
source's scales: a centre is a neighbour when its voxel coords lie within
QUERY_RANGES of the lattice point's own (`floor((grid - pcr[:3]) /
(voxel_size * stride))`, zyx) and it lies within POOL_RADIUS; the NSAMPLE
nearest are kept. A lattice point outside the grid has coords past its
ends and finds only what lies within the window there. The grouped centres
are re-centred on their lattice point here, outside the query, so that the
RCNN losses reach the RoIs through the lattice, as in the JAX head. Each
(source, scale)'s `pool_{src}_{ri}` (SharedMLP over [xyz, features]) is
max-pooled over the filled slots (an empty window gives 0). The flattened
lattice then goes through SHARED_FC (`shared_fc{k}` / `shared_bn{k}`, BN
masked by the RoIs' validity), and CLS_FC and REG_FC, which are SharedMLPs
here (`cls_fc.fc0`, `cls_fc.bn0`, ..., as flax names them; not PV-RCNN's
`cls_fc{k}` / `cls_bn{k}`), to `cls_out` (1) and `reg_out` (7). As in the
JAX head every RoI is pooled, not only the sampled ones, and DP_RATIO,
PRE_MLP, FEATURES_SOURCE and POOL_METHOD are read nowhere.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import grouping
from ..backbones_3d.pfe.voxel_set_abstraction import X_CONV_CHANNELS, voxel_centers
from ..backbones_3d.pointnet2_modules import SharedMLP
from . import roi_head_template as tmpl
from .pvrcnn_head import roi_grid_points


class VoxelRCNNHead(tmpl.RoIHeadTemplate):
    def __init__(self, model_cfg, num_class=1, voxel_size=(0.05, 0.05, 0.1),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1)):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        pool = model_cfg["ROI_GRID_POOL"]
        self.grid_size = int(pool["GRID_SIZE"])
        # per source: [(0, radius, nsample, query range)] of its scales
        self.pool_layers = {}
        c_out = 0
        for src, sc in pool["POOL_LAYERS"].items():
            ranges = sc.get("QUERY_RANGES", [[4, 4, 4]] * len(sc["POOL_RADIUS"]))
            self.pool_layers[src] = [
                (0.0, float(r), int(ns), tuple(int(v) for v in qr))
                for r, ns, qr in zip(sc["POOL_RADIUS"], sc["NSAMPLE"], ranges)]
            for ri, mlp in enumerate(sc["MLPS"]):
                m = SharedMLP(3 + X_CONV_CHANNELS[src], mlp)
                setattr(self, f"pool_{src}_{ri}", m)
                c_out += m.channels[-1]
        self.n_shared = len(model_cfg["SHARED_FC"])
        c = tmpl.fc_stack(self, "shared", self.grid_size ** 3 * c_out, model_cfg["SHARED_FC"])
        self.cls_fc = SharedMLP(c, model_cfg["CLS_FC"])
        self.cls_out = nn.Linear(self.cls_fc.channels[-1], 1)
        self.reg_fc = SharedMLP(c, model_cfg["REG_FC"])
        self.reg_out = nn.Linear(self.reg_fc.channels[-1], 7)

    def lattice_coords(self, grid, stride):
        """The voxel coords (zyx, int32) at `stride` of each lattice point,
        as the JAX head computes them (f32 division by the f32 voxel size)."""
        vs = torch.tensor(np.asarray(self.voxel_size) * stride, dtype=torch.float32,
                          device=grid.device)
        origin = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32,
                              device=grid.device)
        return torch.floor((grid - origin) / vs).to(torch.int32).flip(-1)

    def roi_grid_pool(self, batch_dict, rois):
        """(B, R, G^3 * sum of the pool layers' widths) pooled features."""
        B, R = rois.shape[:2]
        grid = roi_grid_points(rois, self.grid_size).reshape(B, R * self.grid_size ** 3, 3)
        q = grid.detach()
        outs = []
        for src, scales in self.pool_layers.items():
            st = batch_dict["multi_scale_3d_features"][src]
            stride = batch_dict["multi_scale_3d_strides"][src]
            centers = voxel_centers(st.coords, stride, self.voxel_size, self.point_cloud_range)
            groups = grouping.query_group(
                centers, st.valid, q, scales, payload=torch.cat([centers, st.features], -1),
                src_coords=st.coords, q_coords=self.lattice_coords(q, stride))
            for ri, (_, cnt, grouped) in enumerate(groups):
                slot_ok = torch.arange(scales[ri][2], device=q.device) < cnt[..., None]
                g = torch.cat([grouped[..., :3] - grid[:, :, None, :], grouped[..., 3:]], -1)
                g = torch.where(slot_ok[..., None], g, torch.zeros_like(g))
                h = getattr(self, f"pool_{src}_{ri}")(g, slot_ok)
                h = torch.where(slot_ok[..., None], h, torch.full_like(h, -1e9)).amax(dim=2)
                outs.append(torch.where(cnt[..., None] > 0, h, torch.zeros_like(h)))
        return torch.cat(outs, -1).reshape(B, R, -1)

    def rcnn(self, batch_dict, rois, roi_valid):
        h = tmpl.run_fc_stack(self, "shared", self.n_shared,
                              self.roi_grid_pool(batch_dict, rois), roi_valid)
        hc = self.cls_fc(h, roi_valid)
        hr = self.reg_fc(h, roi_valid)
        return self.cls_out(hc)[..., 0], self.reg_out(hr)
