"""PV-RCNN's keypoint segmentation head (counterpart of
tsm_det_pointcloud_tpu/models/dense_heads/point_head_simple.py).

The CLS_FC SharedMLP over the keypoint features (before the fusion, with
USE_POINT_FEATURES_BEFORE_FUSION) and `cls_out`, one class-agnostic
foreground logit (bias 0 at init, as flax's Dense); point_cls_scores is its
sigmoid (0 at invalid keypoints). Training: a keypoint inside a gt box is
foreground, one only inside the box grown by GT_EXTRA_WIDTH is ignored, the
rest background; the focal loss normalised by the global batch's foreground
count, times point_cls_weight.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import loss_utils
from ...ops.boxes import points_in_boxes
from ...parallel import comm
from ..backbones_3d.pointnet2_modules import SharedMLP


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, num_class, input_channels, meta=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = int(num_class)
        self.cls_fc = SharedMLP(int(input_channels), model_cfg["CLS_FC"])
        self.cls_out = nn.Linear(([int(input_channels)] + self.cls_fc.channels)[-1], 1)

    def forward(self, batch_dict):
        cfg = self.model_cfg
        src = cfg.get("POINT_FEATURE_SOURCE", "point_features")
        feats = batch_dict["point_features_before_fusion"
                           if cfg.get("USE_POINT_FEATURES_BEFORE_FUSION") else src]
        valid = batch_dict["point_valid"]
        logits = self.cls_out(self.cls_fc(feats, valid))[..., 0]
        batch_dict["point_cls_scores"] = torch.sigmoid(
            torch.where(valid, logits, torch.full_like(logits, -1e9)))
        if self.training:
            batch_dict["loss_point"] = self.loss(batch_dict, logits)
        return batch_dict

    def loss(self, batch_dict, logits):
        cfg = self.model_cfg
        pts, valid = batch_dict["point_coords"], batch_dict["point_valid"]
        gt, gv = batch_dict["gt_boxes"][..., :7], batch_dict["gt_boxes_mask"]
        extra = cfg.get("TARGET_CONFIG", {}).get("GT_EXTRA_WIDTH", [0.2, 0.2, 0.2])
        inside = points_in_boxes(pts, gt, valid_mask=gv)
        ext = points_in_boxes(pts, gt, extra_width=extra, valid_mask=gv)
        labels = torch.where(inside >= 0, 1, 0)
        labels = torch.where((inside < 0) & (ext >= 0), -1, labels)
        labels = torch.where(valid, labels, -1)
        pos, neg = labels > 0, labels == 0
        w = (pos | neg).to(logits.dtype)
        loss = comm.scale_to_global(loss_utils.sigmoid_focal_loss(
            logits[..., None], pos.to(logits.dtype)[..., None], w[..., None]).sum())
        loss = loss / torch.clamp(comm.global_sum(pos.sum().to(logits.dtype)), min=1.0)
        lw = cfg.get("LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {})
        return loss * float(lw.get("point_cls_weight", 1.0))
