"""PV-RCNN's RoI head (counterpart of
tsm_det_pointcloud_tpu/models/roi_heads/pvrcnn_head.py).

RoI-grid pooling: a GRID_SIZE^3 lattice of points in each RoI's frame, each
lattice point grouping the score-weighted keypoint features by a
multi-scale nearest-k ball query (POOL_RADIUS, NSAMPLE), one K2 call for
all scales (`grouping.query_group`); the grouped keypoints' xyz are
re-centred on their lattice point here, outside the query, so that the
gradient reaches the RoIs through the lattice, as it does in the JAX head.
Each scale's `pool_mlp{i}` (SharedMLP over [xyz, features]) is max-pooled
over the filled slots (an empty ball gives 0). The flattened lattice then
goes through SHARED_FC, CLS_FC and REG_FC (Dense without bias, BN masked by
the RoIs' validity, ReLU; `shared_fc{k}` / `shared_bn{k}`, `cls_fc{k}` /
`cls_bn{k}`, `reg_fc{k}` / `reg_bn{k}`, as flax names them) to `cls_out` (1)
and `reg_out` (7). As in the JAX head every RoI is pooled, not only the
sampled ones, and DP_RATIO and POOL_METHOD are read nowhere.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import grouping
from ..backbones_3d.pointnet2_modules import SharedMLP
from . import roi_head_template as tmpl


def roi_grid_points(rois, grid_size):
    """(B, R, 7) -> (B, R, G^3, 3) lattice points in world coordinates, the
    lattice index (ix, iy, iz) in C order."""
    g = grid_size
    idx = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"), -1).reshape(-1, 3)
    frac = torch.from_numpy(((idx.astype(np.float32) + 0.5) / g - 0.5).astype(np.float32))
    local = frac.to(rois.device)[None, None] * rois[:, :, None, 3:6]
    cosa = torch.cos(rois[..., 6])[..., None]
    sina = torch.sin(rois[..., 6])[..., None]
    x = local[..., 0] * cosa - local[..., 1] * sina + rois[:, :, None, 0]
    y = local[..., 0] * sina + local[..., 1] * cosa + rois[:, :, None, 1]
    z = local[..., 2] + rois[:, :, None, 2]
    return torch.stack([x, y, z], -1)


class PVRCNNHead(tmpl.RoIHeadTemplate):
    def __init__(self, model_cfg, input_channels, num_class=1):
        super().__init__()
        self.model_cfg = model_cfg
        pool = model_cfg["ROI_GRID_POOL"]
        self.grid_size = int(pool["GRID_SIZE"])
        self.scales = [(0.0, float(r), int(ns))
                       for r, ns in zip(pool["POOL_RADIUS"], pool["NSAMPLE"])]
        c_out = 0
        for i, mlp in enumerate(pool["MLPS"]):
            m = SharedMLP(3 + int(input_channels), mlp)
            setattr(self, f"pool_mlp{i}", m)
            c_out += m.channels[-1]
        self.n_fc = {p: len(model_cfg[f"{p.upper()}_FC"]) for p in ("shared", "cls", "reg")}
        c = tmpl.fc_stack(self, "shared", self.grid_size ** 3 * c_out, model_cfg["SHARED_FC"])
        self.cls_out = nn.Linear(tmpl.fc_stack(self, "cls", c, model_cfg["CLS_FC"]), 1)
        self.reg_out = nn.Linear(tmpl.fc_stack(self, "reg", c, model_cfg["REG_FC"]), 7)

    def roi_grid_pool(self, batch_dict, rois):
        """(B, R, G^3 * sum of the scales' widths) pooled features."""
        kp = batch_dict["point_coords"]
        kp_feat = batch_dict["point_features"]
        if "point_cls_scores" in batch_dict:
            kp_feat = kp_feat * batch_dict["point_cls_scores"][..., None]
        B, R = rois.shape[:2]
        g3 = self.grid_size ** 3
        grid = roi_grid_points(rois, self.grid_size).reshape(B, R * g3, 3)
        groups = grouping.query_group(kp, batch_dict["point_valid"], grid.detach(),
                                      self.scales, payload=torch.cat([kp, kp_feat], -1))
        outs = []
        for i, (_, cnt, grouped) in enumerate(groups):
            ns = self.scales[i][2]
            slot_ok = torch.arange(ns, device=kp.device) < cnt[..., None]
            g = torch.cat([grouped[..., :3] - grid[:, :, None, :], grouped[..., 3:]], -1)
            g = torch.where(slot_ok[..., None], g, torch.zeros_like(g))
            h = getattr(self, f"pool_mlp{i}")(g, slot_ok)
            h = torch.where(slot_ok[..., None], h, torch.full_like(h, -1e9)).amax(dim=2)
            outs.append(torch.where(cnt[..., None] > 0, h, torch.zeros_like(h)))
        return torch.cat(outs, -1).reshape(B, R, -1)

    def rcnn(self, batch_dict, rois, roi_valid):
        h = tmpl.run_fc_stack(self, "shared", self.n_fc["shared"],
                              self.roi_grid_pool(batch_dict, rois), roi_valid)
        hc = tmpl.run_fc_stack(self, "cls", self.n_fc["cls"], h, roi_valid)
        hr = tmpl.run_fc_stack(self, "reg", self.n_fc["reg"], h, roi_valid)
        return self.cls_out(hc)[..., 0], self.reg_out(hr)


class EPointRoIHead(PVRCNNHead):
    """PVRCNNHead under the TSM project's EPointRoIHead name (JAX
    pvrcnn_head.py:139-150: the same head under three names)."""


class EPointRoIHeadV2(PVRCNNHead):
    """PVRCNNHead under the TSM project's EPointRoIHeadV2 name."""


class DSASNetRoIHead(PVRCNNHead):
    """PVRCNNHead under the TSM project's DSASNetRoIHead name."""


PVRCNN_HEADS = {"PVRCNNHead": PVRCNNHead, "EPointRoIHead": EPointRoIHead,
                "EPointRoIHeadV2": EPointRoIHeadV2, "DSASNetRoIHead": DSASNetRoIHead}
