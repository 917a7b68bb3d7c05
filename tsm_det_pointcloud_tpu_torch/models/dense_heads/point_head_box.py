"""PointRCNN's point head (counterpart of
tsm_det_pointcloud_tpu/models/dense_heads/point_head_box.py:17,
`PointHeadBox`), and the TSM project's `VPCNetHead`, `DSASNetHead` and
`PVSSDAHead`, the same head under three names (:102-113).

Per point: the CLS_FC SharedMLP and `cls_out` (num_class logits, bias
-log(99) at init; -1e9 at invalid points), the REG_FC SharedMLP and
`box_out` (the box coder's code, PointResidualCoder's 8). point_cls_scores
is the largest of the class sigmoids; each point's box is decoded with its
argmax class (batch_box_preds, batch_cls_preds: the proposals the RoI head
takes).

Training: a point inside a gt box takes the first such box by index and its
class, one inside only the box grown by GT_EXTRA_WIDTH is ignored (-1), the
rest are background, as are invalid points ignored; the focal loss over the
classes (positives and negatives) and the smooth-L1 loss of the encoded box
over the positives, each normalised by the global batch's positives, times
point_cls_weight and point_box_weight: `loss_point`.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import box_coder_utils, loss_utils
from ...ops.boxes import points_in_boxes
from ...parallel import comm
from ..backbones_3d.pointnet2_modules import SharedMLP


class PointHeadBox(nn.Module):
    def __init__(self, model_cfg, num_class, input_channels, meta=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = int(num_class)
        tc = model_cfg["TARGET_CONFIG"]
        self.box_coder = getattr(box_coder_utils, tc.get("BOX_CODER", "PointResidualCoder"))(
            **dict(tc.get("BOX_CODER_CONFIG", {})))
        c = int(input_channels)
        self.cls_fc = SharedMLP(c, model_cfg["CLS_FC"])
        self.cls_out = nn.Linear(([c] + self.cls_fc.channels)[-1], self.num_class)
        self.box_fc = SharedMLP(c, model_cfg["REG_FC"])
        self.box_out = nn.Linear(([c] + self.box_fc.channels)[-1], self.box_coder.code_size)

    def forward(self, batch_dict):
        feats = batch_dict["point_features"]
        coords = batch_dict["point_coords"]
        valid = batch_dict["point_valid"]
        cls_preds = self.cls_out(self.cls_fc(feats, valid))
        box_preds = self.box_out(self.box_fc(feats, valid))
        cls_preds = torch.where(valid[..., None], cls_preds, torch.full_like(cls_preds, -1e9))
        batch_dict["point_cls_preds"] = cls_preds
        batch_dict["point_box_preds_raw"] = box_preds
        batch_dict["point_cls_scores"] = torch.sigmoid(cls_preds).amax(-1)
        pred_classes = torch.argmax(cls_preds, dim=-1) + 1
        batch_dict["batch_cls_preds"] = cls_preds
        batch_dict["batch_box_preds"] = self.box_coder.decode(box_preds, coords, pred_classes)
        batch_dict["cls_preds_normalized"] = False
        if self.training:
            batch_dict["loss_point"] = self.loss(batch_dict, cls_preds, box_preds)
        return batch_dict

    def assign_targets(self, coords, valid, gt_boxes, gt_valid):
        """(B, N) labels (class 1.., 0 background, -1 ignored) and (B, N,
        code) box targets (0 off the positives)."""
        extra = self.model_cfg["TARGET_CONFIG"].get("GT_EXTRA_WIDTH", [0.2, 0.2, 0.2])
        inside = points_in_boxes(coords, gt_boxes[..., :7], valid_mask=gt_valid)
        ext = points_in_boxes(coords, gt_boxes[..., :7], extra_width=extra, valid_mask=gt_valid)
        safe = torch.clamp(inside, min=0)
        box = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, gt_boxes.shape[-1]))
        cls = box[..., 7].to(torch.int64)
        labels = torch.where(inside >= 0, cls, torch.zeros_like(cls))
        labels = torch.where((inside < 0) & (ext >= 0), torch.full_like(labels, -1), labels)
        labels = torch.where(valid, labels, torch.full_like(labels, -1))
        reg = self.box_coder.encode(box[..., :7], coords, cls)
        reg = torch.where((inside >= 0)[..., None], reg, torch.zeros_like(reg))
        return labels, reg

    def loss(self, batch_dict, cls_preds, box_preds):
        labels, reg_labels = self.assign_targets(
            batch_dict["point_coords"], batch_dict["point_valid"], batch_dict["gt_boxes"],
            batch_dict["gt_boxes_mask"])
        pos, neg = labels > 0, labels == 0
        cls_w = (pos | neg).to(cls_preds.dtype)
        one_hot = torch.nn.functional.one_hot(torch.clamp(labels, min=0),
                                              self.num_class + 1)[..., 1:].to(cls_preds.dtype)
        n_pos = torch.clamp(comm.global_sum(pos.sum().to(cls_preds.dtype)), min=1.0)
        cls_loss = comm.scale_to_global(
            loss_utils.sigmoid_focal_loss(cls_preds, one_hot, cls_w).sum()) / n_pos
        reg_loss = comm.scale_to_global(loss_utils.weighted_smooth_l1(
            box_preds, reg_labels, weights=pos.to(box_preds.dtype)).sum()) / n_pos
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        return (cls_loss * float(lw.get("point_cls_weight", 1.0))
                + reg_loss * float(lw.get("point_box_weight", 1.0)))


class VPCNetHead(PointHeadBox):
    """PointHeadBox under the TSM project's VPCNet name."""


class DSASNetHead(PointHeadBox):
    """PointHeadBox under the TSM project's DSASNet name."""


class PVSSDAHead(PointHeadBox):
    """PointHeadBox under the TSM project's PVSSDA name."""


POINT_BOX_HEADS = {"PointHeadBox": PointHeadBox, "PVSSDAHead": PVSSDAHead,
                   "VPCNetHead": VPCNetHead, "DSASNetHead": DSASNetHead}
