"""NMS dispatch (counterpart of
tsm_det_pointcloud_tpu/models/model_utils/model_nms_utils.py).

Scores below threshold are masked to -inf so they never enter the kept set;
`count` reports real detections. Rotated (nms_gpu) NMS only. The
class-agnostic route takes the top NMS_PRE_MAXSIZE first and clips only
their pairs (`iou3d.nms_bev`); the multi-threshold route builds the
polygon-clip IoU grid once per sample and replays the per-class and global
keep fixpoints on it.
"""
from __future__ import annotations

import torch

from ...ops import iou3d


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None):
    """box_scores (N,), box_preds (N, 7). Returns (idx (post,), count,
    scores (post,))."""
    scores = box_scores
    if score_thresh is not None:
        scores = torch.where(box_scores >= score_thresh, box_scores,
                             torch.full_like(box_scores, -float("inf")))
    if nms_config["NMS_TYPE"] != "nms_gpu":
        raise NotImplementedError("only the rotated (nms_gpu) NMS is ported")
    return iou3d.nms_bev(
        box_preds, scores, thresh=float(nms_config["NMS_THRESH"]),
        pre_maxsize=int(nms_config["NMS_PRE_MAXSIZE"]),
        post_maxsize=int(nms_config["NMS_POST_MAXSIZE"]))


def multi_thresh_nms(cls_scores, box_preds, labels, nms_config,
                     score_thresh_list):
    """Per-class score gating + per-class NMS + a global second NMS, on the
    sequential per-class route. cls_scores (N,), labels (N,) 1-based."""
    num_class = len(score_thresh_list)
    thr = torch.tensor(score_thresh_list, dtype=cls_scores.dtype,
                       device=cls_scores.device)
    thresh = thr[torch.clamp(labels.long() - 1, 0, num_class - 1)]
    neg = torch.full_like(cls_scores, -float("inf"))
    gated = torch.where(cls_scores >= thresh, cls_scores, neg)

    nms_thresh = float(nms_config["NMS_THRESH"])
    pre = int(nms_config["NMS_PRE_MAXSIZE"])
    post = int(nms_config["NMS_POST_MAXSIZE"])
    rotated = nms_config["NMS_TYPE"] == "nms_gpu"
    n = int(gated.shape[0])
    if n > max(pre, 4096):
        raise NotImplementedError(
            "multi_thresh_nms: the per-pass top-k route (n > max(pre, 4096)) "
            "is not ported")
    s_mat = iou3d.suppression_matrix(box_preds, nms_thresh, rotated=rotated)
    kept = torch.zeros_like(gated, dtype=torch.bool)
    for c in range(1, num_class + 1):
        cls_gated = torch.where(labels == c, gated, neg)
        kept |= iou3d.nms_keep_mask_from_matrix(
            s_mat, cls_gated, pre_maxsize=pre, post_maxsize=post)
    survivors = torch.where(kept, gated, neg)
    return iou3d.nms_from_matrix(s_mat, survivors, pre_maxsize=pre,
                                 post_maxsize=post)
