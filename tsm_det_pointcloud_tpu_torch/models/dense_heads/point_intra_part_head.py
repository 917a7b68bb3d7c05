"""Part-A2's point head (counterpart of
tsm_det_pointcloud_tpu/models/dense_heads/point_intra_part_head.py).

On UNetV2's stride-1 voxel features: the CLS_FC and PART_FC SharedMLPs
(identities when empty, as PartA2.yaml has them), `cls_out` (num_class
logits, bias -log(99) at init) and `part_out` (3). Sets point_coords (the
voxel centres, unless the batch has them), point_cls_preds,
point_part_offset (the sigmoid of the part logits) and point_cls_scores (the
largest class sigmoid). Training: the point's class is that of the first gt
box holding it (0 outside every box), the focal cls loss over the valid
points and the BCE of the part offsets (the point's normalised position in
its box, clipped to [0, 1]) over the foreground, each normalised by the
global batch's foreground count. As in the JAX head there is no
GT_EXTRA_WIDTH ignore band.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import loss_utils
from ...ops.boxes import in_box_frame, points_in_boxes
from ...parallel import comm
from ..backbones_3d.pfe.voxel_set_abstraction import voxel_centers
from ..backbones_3d.pointnet2_modules import SharedMLP

CLS_PRIOR_BIAS = -float(np.log(99.0))


class PointIntraPartOffsetHead(nn.Module):
    def __init__(self, model_cfg, num_class, input_channels, meta):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = int(num_class)
        self.meta = meta
        c = int(input_channels)
        self.cls_fc = SharedMLP(c, model_cfg["CLS_FC"])
        self.cls_out = nn.Linear(([c] + self.cls_fc.channels)[-1], self.num_class)
        self.part_fc = SharedMLP(c, model_cfg["PART_FC"])
        self.part_out = nn.Linear(([c] + self.part_fc.channels)[-1], 3)

    def forward(self, batch_dict):
        feats = batch_dict["point_features"]
        valid = batch_dict["point_valid"]
        coords = batch_dict.get("point_coords")
        if coords is None:
            coords = voxel_centers(batch_dict["point_coords_voxel"], 1, self.meta.voxel_size,
                                   self.meta.point_cloud_range)
            batch_dict["point_coords"] = coords
        cls_preds = self.cls_out(self.cls_fc(feats, valid))
        part_preds = self.part_out(self.part_fc(feats, valid))
        batch_dict["point_cls_preds"] = cls_preds
        batch_dict["point_part_offset"] = torch.sigmoid(part_preds)
        batch_dict["point_cls_scores"] = torch.sigmoid(cls_preds).amax(-1)
        if self.training:
            batch_dict["loss_point"] = self.loss(batch_dict, cls_preds, part_preds)
        return batch_dict

    def loss(self, batch_dict, cls_preds, part_preds):
        coords, valid = batch_dict["point_coords"], batch_dict["point_valid"]
        gt, gv = batch_dict["gt_boxes"], batch_dict["gt_boxes_mask"]
        idx = points_in_boxes(coords, gt[..., :7], valid_mask=gv)         # (B, N)
        safe = torch.clamp(idx, min=0)
        box = torch.gather(gt, 1, safe[..., None].expand(-1, -1, gt.shape[-1]))   # (B, N, 8)
        labels = torch.where(idx >= 0, box[..., 7].to(torch.int64), torch.zeros_like(idx))
        local = in_box_frame(coords, gt[..., :7])                          # (B, N, M, 3)
        local = torch.gather(local, 2, safe[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
        part = local / torch.clamp(box[..., 3:6], min=1e-5) + 0.5
        part = torch.where((idx >= 0)[..., None], torch.clamp(part, 0, 1),
                           torch.zeros_like(part))
        labels = torch.where(valid, labels, torch.full_like(labels, -1))
        pos, neg = labels > 0, labels == 0
        cls_w = (pos | neg).to(cls_preds.dtype)
        one_hot = F.one_hot(torch.clamp(labels, min=0), self.num_class + 1)[..., 1:]
        n_pos = torch.clamp(comm.global_sum(pos.sum().to(cls_preds.dtype)), min=1.0)
        cls_loss = comm.scale_to_global(loss_utils.sigmoid_focal_loss(
            cls_preds, one_hot.to(cls_preds.dtype), cls_w).sum()) / n_pos
        part_loss = comm.scale_to_global(loss_utils.bce_with_logits(
            part_preds, part).mul(pos.to(part.dtype)[..., None]).sum()) / n_pos
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        return (cls_loss * lw.get("point_cls_weight", 1.0)
                + part_loss * lw.get("point_part_weight", 1.0))
