"""CenterPoint detector (counterpart of
tsm_det_pointcloud_tpu/models/detectors/centerpoint.py)."""
from __future__ import annotations

import torch

from ...ops import iou3d
from ..model_utils import centernet_utils
from .detector3d_template import Detector3DTemplate


class CenterPoint(Detector3DTemplate):
    """MeanVFE -> VoxelResBackBone8x -> HeightCompression -> BaseBEVBackbone
    -> CenterHead. In training (`.train()`, a batch with gt_boxes and
    gt_boxes_mask) the forward adds the head's `loss` and `tb_dict`; at
    eval its own `post_processing` takes the head's decoded boxes."""

    def forward(self, batch_dict):
        batch_dict = self.forward_modules(batch_dict)
        if self.training:
            batch_dict["loss"] = batch_dict["loss_center"]
            batch_dict["tb_dict"] = batch_dict["tb_dict_center"]
        return batch_dict

    @torch.no_grad()
    def post_processing(self, batch_dict):
        """final_boxes / final_scores / final_labels -> (dict(pred_boxes
        (B, P, 7), pred_scores (B, P), pred_labels (B, P), count (B,)), the
        recall dict), P = min(NMS_POST_MAXSIZE, boxes a scan): per scan the
        boxes scoring above SCORE_THRESH through one class-agnostic NMS over
        all groups, `circle_nms` or rotated `nms_bev` by NMS_TYPE; slots past
        count are zero. The recall dict as the template's. A velocity head's
        9-column boxes are cut to 7 here, as the JAX detector cuts them: the
        predictions carry no velocity, and nuScenes' mAVE is 1 (ROADMAP §C)."""
        post_cfg = self.model_cfg["POST_PROCESSING"]
        nms_cfg = post_cfg.get("NMS_CONFIG", {})
        score_thresh = float(post_cfg.get("SCORE_THRESH", 0.1))
        post_max = int(nms_cfg.get("NMS_POST_MAXSIZE", 500))
        nms_type = str(nms_cfg.get("NMS_TYPE", "nms_gpu"))
        out = {"pred_boxes": [], "pred_scores": [], "pred_labels": [], "count": []}
        for bx, sc, lb in zip(batch_dict["final_boxes"], batch_dict["final_scores"],
                              batch_dict["final_labels"]):
            valid = sc > score_thresh
            if nms_type == "circle_nms":
                pos, cnt, ksc = centernet_utils.circle_nms(
                    bx[:, :2], sc, valid, float(nms_cfg.get("MIN_RADIUS", 1.0)), post_max)
            else:
                pos, cnt, ksc = iou3d.nms_bev(
                    bx[:, :7], torch.where(valid, sc, torch.full_like(sc, -float("inf"))),
                    float(nms_cfg.get("NMS_THRESH", 0.7)),
                    pre_maxsize=int(nms_cfg.get("NMS_PRE_MAXSIZE", bx.shape[0])),
                    post_maxsize=post_max)
            slot_ok = torch.arange(pos.shape[0], device=pos.device) < cnt
            out["pred_boxes"].append(torch.where(slot_ok[:, None], bx[pos][:, :7],
                                                 torch.zeros((), device=bx.device)))
            out["pred_scores"].append(torch.where(slot_ok, ksc, torch.zeros_like(ksc)))
            out["pred_labels"].append(torch.where(slot_ok, lb[pos], torch.zeros_like(lb[pos])))
            out["count"].append(cnt.to(torch.int32))
        pred = {k: torch.stack(v) for k, v in out.items()}
        recall_dict = {}
        if "gt_boxes" in batch_dict:
            recall_dict = self.generate_recall_record(
                pred["pred_boxes"], pred["count"], batch_dict,
                post_cfg.get("RECALL_THRESH_LIST", [0.3, 0.5, 0.7]))
        return pred, recall_dict
