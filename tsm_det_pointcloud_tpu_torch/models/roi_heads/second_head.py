"""SECONDNetIoU's RoI head (counterpart of
tsm_det_pointcloud_tpu/models/roi_heads/second_head.py).

Proposals from the anchor head (`roi_head_template.proposal_layer`), then
BEV pooling: the BEV backbone's `spatial_features_2d` bilinearly sampled
(`bilinear_interpolate`, corners clamped to the map) at the xy of each
RoI's GRID_SIZE^3 lattice. As in the JAX head z is dropped and all G^3
samples are kept, so the pooled row of a RoI holds G^3 * C values (343 *
512 at second_iou.yaml's widths), where the reference pools a G x G BEV
grid. Then SHARED_FC (`shared_fc{k}` / `shared_bn{k}`, BN masked by the
RoIs' validity), `iou_fc` (a SharedMLP over IOU_FC) and `iou_out` (1).

Training: the loss is |sigmoid(iou) - the RoI's largest 3D IoU with a valid
gt box|, averaged over the valid RoIs (the global batch's in a
multi-process run), times LOSS_WEIGHTS.rcnn_iou_weight; as in the JAX head
the IoU target is not detached, so its gradient reaches the RoIs and the
anchor head's box regression through `boxes_iou3d`, and no RoI is sampled
(the reference trains a BCE over 128 sampled RoIs). TARGET_CONFIG is read
nowhere.

Outputs: the RoIs as `batch_box_preds`, `roi_scores`, `iou_preds`
(sigmoid), `roi_labels`, and the rectified score clip(roi_score, 1e-6)^(1 -
a) * clip(iou, 1e-6)^a, a = IOU_WEIGHT (0.5), as `batch_cls_preds` with
`cls_preds_normalized`, which SCORE_THRESH and the final NMS read.
"""
from __future__ import annotations

import torch
from torch import nn

from ..backbones_3d.pfe.voxel_set_abstraction import bilinear_interpolate
from ..backbones_3d.pointnet2_modules import SharedMLP
from ...ops import iou3d
from . import roi_head_template as tmpl
from .pvrcnn_head import roi_grid_points


class SECONDHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class=1, voxel_size=(0.05, 0.05, 0.1),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1)):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.grid_size = int(model_cfg.get("ROI_GRID_POOL", {}).get("GRID_SIZE", 7))
        self.n_shared = len(model_cfg["SHARED_FC"])
        c = tmpl.fc_stack(self, "shared", self.grid_size ** 3 * int(input_channels),
                          model_cfg["SHARED_FC"])
        self.iou_fc = SharedMLP(c, model_cfg.get("IOU_FC", [256]))
        self.iou_out = nn.Linear(self.iou_fc.channels[-1], 1)

    def roi_grid_pool(self, batch_dict, rois):
        """(B, R, G^3 * C): the BEV map sampled at the xy of each RoI's
        lattice points."""
        bev = batch_dict["spatial_features_2d"]                # (B, H, W, C)
        stride = batch_dict.get("spatial_features_stride", 8)
        vx, vy = self.voxel_size[0] * stride, self.voxel_size[1] * stride
        pcr = self.point_cloud_range
        B, R = rois.shape[:2]
        grid = roi_grid_points(rois, self.grid_size)[..., :2].reshape(B, -1, 2)
        return torch.stack([
            bilinear_interpolate(bm, (g[:, 0] - pcr[0]) / vx, (g[:, 1] - pcr[1]) / vy)
            for bm, g in zip(bev, grid)]).reshape(B, R, -1)

    def forward(self, batch_dict):
        cfg = self.model_cfg
        nms_cfg = cfg["NMS_CONFIG"]["TRAIN" if self.training else "TEST"]
        rois, roi_scores, roi_labels, roi_valid = tmpl.proposal_layer(
            batch_dict["batch_cls_preds"], batch_dict["batch_box_preds"], nms_cfg,
            score_normalized=bool(batch_dict.get("cls_preds_normalized", False)))
        h = tmpl.run_fc_stack(self, "shared", self.n_shared,
                              self.roi_grid_pool(batch_dict, rois), roi_valid)
        iou_preds = self.iou_out(self.iou_fc(h, roi_valid))[..., 0]    # (B, R)
        if self.training:
            target = []
            for r, g, gv in zip(rois, batch_dict["gt_boxes"], batch_dict["gt_boxes_mask"]):
                iou = iou3d.boxes_iou3d(r, g[:, :7])
                # amax: at ties the gradient splits evenly, as jnp.max's does
                target.append(torch.where(gv[None, :], iou, torch.zeros_like(iou)).amax(-1))
            w = roi_valid.to(iou_preds.dtype)
            loss = tmpl._global_mean((torch.sigmoid(iou_preds) - torch.stack(target)).abs(), w)
            weights = cfg.get("LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {})
            batch_dict["loss_rcnn"] = loss * float(weights.get("rcnn_iou_weight", 1.0))
            batch_dict["tb_dict_rcnn"] = {"rcnn_iou_loss": loss}
        iou = torch.sigmoid(iou_preds)
        a = float(cfg.get("IOU_WEIGHT", 0.5))
        rect = torch.clamp(roi_scores, min=1e-6) ** (1 - a) * torch.clamp(iou, min=1e-6) ** a
        batch_dict.update(batch_box_preds=rois, roi_scores=roi_scores, iou_preds=iou,
                          roi_labels=roi_labels, rois=rois, roi_valid=roi_valid,
                          has_class_labels=True, batch_cls_preds=rect[..., None],
                          cls_preds_normalized=True)
        return batch_dict
