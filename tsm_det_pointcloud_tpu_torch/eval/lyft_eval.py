"""The official Lyft 3D detection mAP in numpy: the port's own copy of
tsm_det_pointcloud_tpu/eval/lyft_eval.py, the protocol of the reference's
vendored Lyft toolkit (pcdet/datasets/lyft/lyft_mAP_eval/lyft_eval.py).

* IoU (`_iou3d`): rotated 3D IoU, the BEV polygon intersection
  (`rotate_iou_np` with criterion 0: intersection over the first box's
  area) times the z overlap, over the union of the volumes.
* Matching (`_recall_precision`): a class's predictions pooled over every
  sample and sorted by score; each takes the gt of its sample with the
  largest IoU, over all of that class's gt including the ones already
  taken; a TP where that IoU passes the threshold and the gt is not yet
  taken, else an FP.
* AP (`_get_ap`): VOC all-point interpolation, the precision envelope's
  area with (0, 0) and (1, 0) sentinels.
* A class's AP is the mean over the IoU thresholds (EVAL_LYFT_IOU_LIST,
  0.5 ... 0.95); the mAP the mean over the classes, a class without gt or
  without predictions scoring 0.

Annos: gt name / gt_boxes_lidar, detections name / score / boxes_lidar;
boxes (x, y, z, dx, dy, dz, yaw) in the lidar frame.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from .rotate_iou_np import rotate_iou_np


def _iou3d(box, gt_boxes):
    """The rotated 3D IoU of one box (7,) with each of gt_boxes (N, 7)."""
    a = np.asarray(box, np.float64).reshape(1, 7)
    b = np.asarray(gt_boxes, np.float64).reshape(-1, 7)
    inter_ratio = rotate_iou_np(a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]], criterion=0)[0]
    inter_area = inter_ratio * (a[0, 3] * a[0, 4])
    zmin = np.maximum(a[0, 2] - a[0, 5] / 2, b[:, 2] - b[:, 5] / 2)
    zmax = np.minimum(a[0, 2] + a[0, 5] / 2, b[:, 2] + b[:, 5] / 2)
    inter = inter_area * np.maximum(zmax - zmin, 0.0)
    vol_a = float(np.prod(a[0, 3:6]))
    vol_b = np.prod(b[:, 3:6], axis=-1)
    union = vol_a + vol_b - inter
    return np.clip(inter / np.maximum(union, 1e-12), 0.0, 1.0)


def _get_ap(recalls, precisions):
    """VOC all-point AP under the precision envelope."""
    rec = np.concatenate(([0.0], recalls, [1.0]))
    prec = np.concatenate(([0.0], precisions, [0.0]))
    for i in range(prec.size - 1, 0, -1):
        prec[i - 1] = np.maximum(prec[i - 1], prec[i])
    idx = np.where(rec[1:] != rec[:-1])[0]
    return float(np.sum((rec[idx + 1] - rec[idx]) * prec[idx + 1]))


def _recall_precision(gt, preds, iou_thresholds):
    """One class's AP at each threshold; gt holds (sample, box7) records,
    preds (sample, box7, score); None without gt."""
    num_gts = len(gt)
    if num_gts == 0:
        return None
    gts_by_sample = defaultdict(list)
    for s, box in gt:
        gts_by_sample[s].append(box)
    gts_by_sample = {s: np.stack(v) for s, v in gts_by_sample.items()}
    checked = {s: np.zeros((len(v), len(iou_thresholds))) for s, v in gts_by_sample.items()}
    preds = sorted(preds, key=lambda r: -r[2])
    tp = np.zeros((len(preds), len(iou_thresholds)))
    fp = np.zeros((len(preds), len(iou_thresholds)))
    for pi, (s, box, _) in enumerate(preds):
        gt_boxes = gts_by_sample.get(s)
        if gt_boxes is None:
            fp[pi, :] = 1.0
            continue
        overlaps = _iou3d(box, gt_boxes)
        jmax = int(np.argmax(overlaps))
        max_overlap = float(overlaps[jmax])
        for ti, th in enumerate(iou_thresholds):
            if max_overlap > th and checked[s][jmax, ti] == 0:
                tp[pi, ti] = 1.0
                checked[s][jmax, ti] = 1
            else:
                fp[pi, ti] = 1.0
    tp = np.cumsum(tp, axis=0)
    fp = np.cumsum(fp, axis=0)
    recalls = tp / float(num_gts)
    precisions = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return [_get_ap(recalls[:, i], precisions[:, i]) for i in range(len(iou_thresholds))]


def lyft_evaluation(gt_annos, det_annos, class_names,
                    iou_thresholds=(0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95),
                    version="trainval"):
    """The Lyft mAP of per-sample annos: (the result table, {class: AP,
    "mAP": mean}), as the reference's format_lyft_results gives them."""
    assert len(gt_annos) == len(det_annos), \
        f"sample count mismatch: {len(gt_annos)} gt vs {len(det_annos)} dt"
    gt_by_class = defaultdict(list)
    dt_by_class = defaultdict(list)
    for si, (ga, da) in enumerate(zip(gt_annos, det_annos)):
        g_names = np.asarray(ga.get("name", []), object)
        g_boxes = np.asarray(ga.get("gt_boxes_lidar", ga.get("boxes_lidar", np.zeros((0, 7)))),
                             np.float64)
        for i, n in enumerate(g_names):
            gt_by_class[str(n)].append((si, g_boxes[i, :7]))
        d_names = np.asarray(da.get("name", []), object)
        d_boxes = np.asarray(da.get("boxes_lidar", np.zeros((0, 7))), np.float64)
        d_scores = np.asarray(da.get("score", np.ones(len(d_names))), np.float64)
        for i, n in enumerate(d_names):
            dt_by_class[str(n)].append((si, d_boxes[i, :7], float(d_scores[i])))

    iou_thresholds = [float(t) for t in iou_thresholds]
    classwise_ap = np.zeros(len(class_names))
    for ci, cls in enumerate(class_names):
        if cls in dt_by_class and cls in gt_by_class:
            ap_list = _recall_precision(gt_by_class[cls], dt_by_class[cls], iou_thresholds)
            if ap_list is not None:
                classwise_ap[ci] = float(np.mean(ap_list))

    ret = {}
    result = f"----------------Lyft {version} results-----------------\n"
    result += f"Average precision over IoUs: {iou_thresholds}\n"
    for ci, cls in enumerate(class_names):
        result += "{:<20}: \t {:.4f}\n".format(cls, classwise_ap[ci])
        ret[cls] = float(classwise_ap[ci])
    result += "--------------average performance-------------\n"
    mAP = float(np.mean(classwise_ap)) if len(classwise_ap) else 0.0
    result += "mAP:\t {:.4f}\n".format(mAP)
    ret["mAP"] = mAP
    return result, ret
