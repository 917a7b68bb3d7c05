"""PointRCNN's RoI head (counterpart of
tsm_det_pointcloud_tpu/models/roi_heads/pointrcnn_head.py: `roipoint_pool`
:25, `PointRCNNHead` :51).

RoI-point pooling: for each RoI, the first NUM_SAMPLED_POINTS valid points
inside it by index (`grouping.first_k_true` on the (R, N) containment grid;
an unfilled slot reads the first hit and is masked by `slot_ok`), moved to
the RoI's canonical frame (centre at the origin, heading along x), with the
payload [point score, depth / DEPTH_NORMALIZER - 0.5, point features]. As in
the JAX head, POOL_EXTRA_WIDTH is not applied and unfilled slots are masked,
where the reference repeats the pooled points to fill them.

`xyz_up` (a SharedMLP over [canonical xyz, payload], masked by the filled
slots) lifts every pooled point; then the in-RoI encoder runs on (B * R,
NUM_SAMPLED_POINTS) rows, the valid slots those filled in a non-empty RoI:
SA_CONFIG's single-scale `roi_sa{i}` PointnetSAModuleMSG layers (d-fps on
K1, the ball query on K2) and, for NPOINTS -1, the JAX package's GroupAll
terminal: `roi_sa{i}` a SharedMLP over [xyz, features] and a masked max over
the row (0 for a row with no valid point). An SA_CONFIG without that
terminal max-pools its last SA level the same way (JAX :129-133); without an
SA_CONFIG the head max-pools `xyz_up`'s features over the RoI's filled slots
(JAX :135-136). An empty RoI's feature is 0. Then
the SHARED_FC Dense + BN + ReLU stack (`shared_fc{k}` / `shared_bn{k}`),
the CLS_FC and REG_FC SharedMLPs (`cls_fc`, `reg_fc`) masked by the RoIs'
validity, and `cls_out` (1) / `reg_out` (7). Every SharedMLP has BN, so
USE_BN and DP_RATIO are read nowhere, as in the JAX head.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.boxes import in_box_frame
from ...ops.grouping import first_k_true
from ..backbones_3d.pointnet2_modules import BatchNorm, PointnetSAModuleMSG, SharedMLP
from . import roi_head_template as tmpl


def roipoint_pool(points_xyz, point_feats, point_valid, rois, num_sampled):
    """points_xyz (N, 3), point_feats (N, C), point_valid (N,), rois (R, 7)
    -> canonical xyz (R, S, 3), pooled features (R, S, C), empty (R,) and
    slot_ok (R, S); unfilled slots are 0."""
    local = in_box_frame(points_xyz, rois)                           # (N, R, 3)
    inside = (local.abs() <= rois[None, :, 3:6] * 0.5).all(-1) & point_valid[:, None]
    del local
    idx, cnt = first_k_true(inside.t(), num_sampled)                 # (R, S)
    rel = points_xyz[idx] - rois[:, None, 0:3]
    cosa = torch.cos(-rois[:, 6])[:, None]
    sina = torch.sin(-rois[:, 6])[:, None]
    cx = rel[..., 0] * cosa - rel[..., 1] * sina
    cy = rel[..., 0] * sina + rel[..., 1] * cosa
    canon = torch.stack([cx, cy, rel[..., 2]], -1)
    slot_ok = torch.arange(num_sampled, device=rois.device)[None, :] < cnt[:, None]
    canon = torch.where(slot_ok[..., None], canon, torch.zeros_like(canon))
    g_feat = point_feats[idx]
    g_feat = torch.where(slot_ok[..., None], g_feat, torch.zeros_like(g_feat))
    return canon, g_feat, cnt == 0, slot_ok


def _masked_row_max(x, valid):
    """(M, S, C) max over the valid slots of each row, 0 for a row with
    none (-1e9 fill, as the JAX head)."""
    h = torch.where(valid[..., None], x, torch.full_like(x, -1e9)).amax(dim=1)
    return torch.where(valid.any(1, keepdim=True), h, torch.zeros_like(h))


class PointRCNNHead(tmpl.RoIHeadTemplate):
    def __init__(self, model_cfg, input_channels, num_class=1):
        super().__init__()
        self.model_cfg = model_cfg
        pool = model_cfg["ROI_POINT_POOL"]
        self.num_sampled = int(pool.get("NUM_SAMPLED_POINTS", 512))
        self.depth_normalizer = float(pool.get("DEPTH_NORMALIZER", 70.0))
        self.xyz_up = SharedMLP(3 + 2 + int(input_channels), model_cfg["XYZ_UP_LAYER"])
        c = self.xyz_up.channels[-1]
        sa = model_cfg.get("SA_CONFIG")
        self.has_sa = bool(sa)
        npoints = [int(n) for n in sa["NPOINTS"]] if sa else []
        # the JAX head stops at the group-all layer; without one it runs them all
        self.n_sa = npoints.index(-1) if -1 in npoints else len(npoints)
        self.group_all = -1 in npoints
        for i in range(self.n_sa):
            m = PointnetSAModuleMSG(npoints[i], [sa["RADIUS"][i]], [sa["NSAMPLE"][i]],
                                    [sa["MLPS"][i]], c)
            setattr(self, f"roi_sa{i}", m)
            c = m.out_channels
        if self.group_all:
            group_all = SharedMLP(3 + c, sa["MLPS"][self.n_sa])
            setattr(self, f"roi_sa{self.n_sa}", group_all)
            c = group_all.channels[-1]
        self.n_shared = len(model_cfg["SHARED_FC"])
        for k, w in enumerate(model_cfg["SHARED_FC"]):
            setattr(self, f"shared_fc{k}", nn.Linear(c, int(w), bias=False))
            setattr(self, f"shared_bn{k}", BatchNorm(int(w), eps=1e-3))
            c = int(w)
        self.cls_fc = SharedMLP(c, model_cfg["CLS_FC"])
        self.reg_fc = SharedMLP(c, model_cfg["REG_FC"])
        self.cls_out = nn.Linear(([c] + self.cls_fc.channels)[-1], 1)
        self.reg_out = nn.Linear(([c] + self.reg_fc.channels)[-1], 7)

    def pool(self, batch_dict, rois):
        """(canonical xyz (B, R, S, 3), pooled [score, depth, features]
        (B, R, S, 2 + C), empty (B, R), slot_ok (B, R, S))."""
        pts = batch_dict["point_coords"]
        feats = batch_dict["point_features"]
        valid = batch_dict["point_valid"]
        scores = batch_dict["point_cls_scores"]
        sq = pts * pts
        depth = torch.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2]) / self.depth_normalizer - 0.5
        merged = torch.cat([scores[..., None], depth[..., None], feats], -1)
        parts = [roipoint_pool(p, f, v, r, self.num_sampled)
                 for p, f, v, r in zip(pts, merged, valid, rois)]
        return tuple(torch.stack(t) for t in zip(*parts))

    def encode(self, canon, h_pts, empty, slot_ok):
        """The in-RoI encoder: (B, R, C) features of each RoI."""
        B, R, S = slot_ok.shape
        if not self.has_sa:
            return _masked_row_max(h_pts.reshape(B * R, S, -1),
                                   slot_ok.reshape(B * R, S)).reshape(B, R, -1)
        xyz = canon.reshape(B * R, S, 3)
        f = h_pts.reshape(B * R, S, -1)
        v = (slot_ok & ~empty[..., None]).reshape(B * R, S)
        for i in range(self.n_sa):
            xyz, f, v = getattr(self, f"roi_sa{i}")(xyz, f, v)
        if self.group_all:
            f = getattr(self, f"roi_sa{self.n_sa}")(torch.cat([xyz, f], -1), v)
        return _masked_row_max(f, v).reshape(B, R, -1)

    def rcnn(self, batch_dict, rois, roi_valid):
        canon, g_feat, empty, slot_ok = self.pool(batch_dict, rois)
        h_pts = self.xyz_up(torch.cat([canon, g_feat], -1), slot_ok)
        h = self.encode(canon, h_pts, empty, slot_ok)
        h = torch.where(~empty[..., None], h, torch.zeros_like(h))
        for k in range(self.n_shared):
            h = getattr(self, f"shared_fc{k}")(h)
            h = torch.relu(getattr(self, f"shared_bn{k}")(h, roi_valid))
        hc = self.cls_fc(h, roi_valid)
        hr = self.reg_fc(h, roi_valid)
        return self.cls_out(hc)[..., 0], self.reg_out(hr)
