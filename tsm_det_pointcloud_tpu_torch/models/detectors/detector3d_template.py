"""Detector base (counterpart of
tsm_det_pointcloud_tpu/models/detectors/detector3d_template.py): the module
list, forward_modules and the fixed-size post-processing. The per-sample
`lax.map` of the reference is a Python loop here."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...ops import iou3d
from ..model_utils import model_nms_utils


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    """Static dataset geometry handed to model builders."""
    class_names: tuple
    point_cloud_range: tuple
    voxel_size: tuple = None
    grid_size: tuple = None
    max_voxels: int = 16000
    max_points_per_voxel: int = 5
    num_point_features: int = 4
    max_points: int = 16384
    depth_downsample_factor: int = None


class Detector3DTemplate(nn.Module):
    def __init__(self, model_cfg, num_class, dataset_meta, modules):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.dataset_meta = dataset_meta
        self.module_list = nn.ModuleList(modules)

    def forward_modules(self, batch_dict):
        for m in self.module_list:
            batch_dict = m(batch_dict)
        return batch_dict

    def forward(self, batch_dict):
        return self.forward_modules(batch_dict)

    @torch.no_grad()
    def post_processing(self, batch_dict):
        """batch_cls_preds (B, N, C) + batch_box_preds (B, N, 7+) ->
        (dict(pred_boxes (B, P, 7), pred_scores (B, P), pred_labels (B, P),
        count (B,)) with P = NMS_POST_MAXSIZE, slots >= count zero, the
        labels those of the RoIs where a two-stage head set `roi_labels`,
        else each box's best class; and the
        recall dict, which `generate_recall_record` fills when `batch_dict`
        holds "gt_boxes" and which is {} otherwise)."""
        post_cfg = self.model_cfg["POST_PROCESSING"]
        nms_cfg = post_cfg["NMS_CONFIG"]
        score_thresh = post_cfg.get("SCORE_THRESH", 0.1)
        cls_preds = batch_dict["batch_cls_preds"]
        box_preds = batch_dict["batch_box_preds"]
        if not batch_dict.get("cls_preds_normalized", False):
            cls_preds = torch.sigmoid(cls_preds)
        roi_labels = batch_dict.get("roi_labels")

        boxes, scores, labels, counts = [], [], [], []
        for b, (cls_p, box_p) in enumerate(zip(cls_preds, box_preds)):
            max_scores = cls_p.amax(dim=-1)
            if roi_labels is not None:   # a two-stage head's: its RoIs' classes
                lab = roi_labels[b]
            else:
                lab = torch.argmax(cls_p, dim=-1).to(torch.int32) + 1
            if isinstance(score_thresh, (list, tuple)):
                idx, cnt, sc = model_nms_utils.multi_thresh_nms(
                    max_scores, box_p[:, :7], lab, nms_cfg, list(score_thresh))
            else:
                idx, cnt, sc = model_nms_utils.class_agnostic_nms(
                    max_scores, box_p[:, :7], nms_cfg,
                    score_thresh=float(score_thresh))
            slot_ok = torch.arange(idx.shape[0], device=idx.device) < cnt
            boxes.append(torch.where(slot_ok[:, None], box_p[idx][:, :7],
                                     torch.zeros_like(box_p[idx][:, :7])))
            scores.append(torch.where(slot_ok, sc, torch.zeros_like(sc)))
            labels.append(torch.where(slot_ok, lab[idx], torch.zeros_like(lab[idx])))
            counts.append(cnt.to(torch.int32))
        pred = {
            "pred_boxes": torch.stack(boxes), "pred_scores": torch.stack(scores),
            "pred_labels": torch.stack(labels), "count": torch.stack(counts),
        }
        recall_dict = {}
        if "gt_boxes" in batch_dict:
            recall_dict = self.generate_recall_record(
                pred["pred_boxes"], pred["count"], batch_dict,
                post_cfg.get("RECALL_THRESH_LIST", [0.3, 0.5, 0.7]))
        return pred, recall_dict

    @staticmethod
    def generate_recall_record(pred_boxes, counts, batch_dict, thresh_list):
        """Recall counters of the JAX `generate_recall_record`
        (detector3d_template.py:140-160): for each threshold th, `roi_<th>`
        (0.0: one stage), `rcnn_<th>` (the valid gt boxes whose best 3D IoU
        with a kept prediction exceeds th) and `gt` (the valid gt boxes),
        each a 0-d float32 sum over the batch. Runs on the predictions'
        device; `infer`'s synthetic eval batches carry no gt boxes, so the
        timed eval path never reaches it."""
        gt_boxes = batch_dict["gt_boxes"]
        gt_valid = batch_dict["gt_boxes_mask"]
        out = {}
        for th in thresh_list:
            out["roi_%s" % str(th)] = pred_boxes.new_zeros(())
            out["rcnn_%s" % str(th)] = pred_boxes.new_zeros(())
        out["gt"] = pred_boxes.new_zeros(())
        for pb, cnt, gts, gv in zip(pred_boxes, counts, gt_boxes, gt_valid):
            iou = iou3d.boxes_iou3d(gts[:, :7], pb)                   # (M, P)
            slot_ok = torch.arange(pb.shape[0], device=pb.device)[None, :] < cnt
            iou = torch.where(slot_ok & gv[:, None], iou, torch.zeros_like(iou))
            best = iou.amax(dim=1)
            for th in thresh_list:
                out["rcnn_%s" % str(th)] += ((best > th) & gv).sum().float()
            out["gt"] += gv.sum().float()
        return out
