"""The official KITTI detection AP protocol on the host (counterpart of
tsm_det_pointcloud_tpu/eval/kitti_eval.py, `get_official_eval_result` :397).

Difficulty gating (height / occlusion / truncation), neighbouring-class
ignores (Van ~ Car, Person_sitting ~ Pedestrian), DontCare suppression, the
score-threshold sweep over 41 recall points, R11 and R40 AP and AOS, in
numpy; the rotated overlaps come from `rotate_iou_np` (the host library).

Annotation dicts follow the KITTI devkit schema: name, truncated, occluded,
alpha, bbox (N, 4), dimensions (N, 3) [l, h, w], location (N, 3) camera
frame, rotation_y (N,), score (detections only).
"""
from __future__ import annotations

import numpy as np

from .rotate_iou_np import rotate_iou_np

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting", "Truck"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
NO_DETECTION = -10000000.0


# ---------------------------------------------------------------------------
# overlaps
# ---------------------------------------------------------------------------

def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D IoU on image bboxes (N, 4) x (K, 4)."""
    N, K = len(boxes), len(query_boxes)
    if N == 0 or K == 0:
        return np.zeros((N, K), np.float32)
    b = boxes[:, None, :]
    q = query_boxes[None, :, :]
    iw = np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0])
    ih = np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    area_q = (q[..., 2] - q[..., 0]) * (q[..., 3] - q[..., 1])
    if criterion == -1:
        denom = area_b + area_q - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        denom = np.broadcast_to(area_q, inter.shape)
    return (inter / np.maximum(denom, 1e-9)).astype(np.float32)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """Rotated BEV IoU; boxes (N, 5) = (x, z, l, w, ry) camera frame."""
    return rotate_iou_np(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D IoU in camera frame; boxes (N, 7) = (x, y, z, l, h, w, ry);
    y is the box bottom (KITTI convention, y axis points down)."""
    inter2d = rotate_iou_np(
        boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], criterion=None
    )
    ymax = np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
    ymin = np.maximum(
        boxes[:, None, 1] - boxes[:, None, 4],
        qboxes[None, :, 1] - qboxes[None, :, 4],
    )
    inter_h = np.clip(ymax - ymin, 0, None)
    inter = inter2d * inter_h
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    if criterion == -1:
        denom = vol_a + vol_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(vol_a, inter.shape)
    else:
        denom = np.broadcast_to(vol_b, inter.shape)
    return (inter / np.maximum(denom, 1e-9)).astype(np.float32)


# ---------------------------------------------------------------------------
# per-image statistics (the devkit protocol)
# ---------------------------------------------------------------------------

def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Split gt/dt into care / ignore / discard per the devkit rules."""
    cls_name = current_class.lower()
    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        name = gt_anno["name"][i].lower()
        height = gt_anno["bbox"][i, 3] - gt_anno["bbox"][i, 1]
        if name == cls_name:
            valid_class = 1
        elif cls_name == "pedestrian" and name == "person_sitting":
            valid_class = 0
        elif cls_name == "car" and name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        if dt_anno["name"][i].lower() == cls_name:
            valid_class = 1
        else:
            valid_class = -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """One image, one threshold. overlaps is (num_dt, num_gt).
    gt_datas (num_gt, 5) [bbox, alpha]; dt_datas (num_dt, 6) [bbox, alpha,
    score]. Returns tp, fp, fn, similarity, tp_scores."""
    det_size = len(dt_datas)
    gt_size = len(gt_datas)
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [
        compute_fp and dt_scores[i] < thresh for i in range(det_size)
    ]
    tp, fp, fn, similarity = 0, 0, 0, 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp) and overlap > min_overlap and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True
    if compute_fp:
        for j in range(det_size):
            if not (assigned_detection[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            dc = np.asarray(dc_bboxes, np.float64).reshape(-1, 4)
            overlaps_dt_dc = image_box_overlap(dt_bboxes, dc, criterion=0)
            for i in range(len(dc)):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        fp -= 1
                        assigned_detection[j] = True
                        nstuff += 1
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if tp > 0 or fp > 0 else -1.0
    return tp, fp, fn, similarity, np.asarray(thresholds, np.float64)


def get_thresholds(scores, num_gt, num_sample_pts=N_SAMPLE_PTS):
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return np.asarray(thresholds, np.float64)


# ---------------------------------------------------------------------------
# dataset-level eval
# ---------------------------------------------------------------------------

def _prep_image_data(gt_anno, dt_anno):
    gt_datas = np.concatenate(
        [gt_anno["bbox"].reshape(-1, 4), gt_anno["alpha"].reshape(-1, 1)], 1
    )
    dt_datas = np.concatenate(
        [dt_anno["bbox"].reshape(-1, 4), dt_anno["alpha"].reshape(-1, 1),
         dt_anno["score"].reshape(-1, 1)], 1
    )
    return gt_datas, dt_datas


def calculate_iou_partly(gt_annos, dt_annos, metric):
    """Per-image (num_dt, num_gt) overlap matrices."""
    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            o = image_box_overlap(
                dt["bbox"].reshape(-1, 4), gt["bbox"].reshape(-1, 4)
            )
        elif metric == 1:
            dt_b = np.concatenate(
                [dt["location"][:, [0, 2]], dt["dimensions"][:, [0, 2]],
                 dt["rotation_y"].reshape(-1, 1)], 1
            )
            gt_b = np.concatenate(
                [gt["location"][:, [0, 2]], gt["dimensions"][:, [0, 2]],
                 gt["rotation_y"].reshape(-1, 1)], 1
            )
            o = bev_box_overlap(dt_b, gt_b)
        else:
            dt_b = np.concatenate(
                [dt["location"], dt["dimensions"], dt["rotation_y"].reshape(-1, 1)], 1
            )
            gt_b = np.concatenate(
                [gt["location"], gt["dimensions"], gt["rotation_y"].reshape(-1, 1)], 1
            )
            # (x, y, z, l, h, w, ry): dimensions stored (l, h, w)
            o = d3_box_overlap(dt_b, gt_b)
        overlaps.append(o.astype(np.float64))
    return overlaps


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    """Returns dict with precision / aos arrays shaped
    (num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS)."""
    assert len(gt_annos) == len(dt_annos)
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros((num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS))
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    all_overlaps = calculate_iou_partly(gt_annos, dt_annos, metric)

    for m, current_class in enumerate(current_classes):
        for d, difficulty in enumerate(difficultys):
            # per-image cleaned data
            rets = [
                clean_data(gt, dt, current_class, difficulty)
                for gt, dt in zip(gt_annos, dt_annos)
            ]
            datas = [
                _prep_image_data(gt, dt) for gt, dt in zip(gt_annos, dt_annos)
            ]
            total_num_valid_gt = sum(r[0] for r in rets)
            for k in range(num_minoverlap):
                min_overlap = min_overlaps[k, metric, m]
                # pass 1: collect tp score thresholds
                all_thresholds = []
                for img in range(len(gt_annos)):
                    nv, ig_gt, ig_dt, dc = rets[img]
                    gt_d, dt_d = datas[img]
                    _, _, _, _, th = compute_statistics(
                        all_overlaps[img], gt_d, dt_d, ig_gt, ig_dt, dc,
                        metric, min_overlap=min_overlap, thresh=0.0,
                        compute_fp=False,
                    )
                    all_thresholds.append(th)
                if total_num_valid_gt == 0:
                    continue
                thresholds = get_thresholds(
                    np.concatenate(all_thresholds), total_num_valid_gt
                )
                if len(thresholds) == 0:
                    continue
                pr = np.zeros((len(thresholds), 4))
                for img in range(len(gt_annos)):
                    nv, ig_gt, ig_dt, dc = rets[img]
                    gt_d, dt_d = datas[img]
                    for t, thresh in enumerate(thresholds):
                        tp, fp, fn, sim, _ = compute_statistics(
                            all_overlaps[img], gt_d, dt_d, ig_gt, ig_dt, dc,
                            metric, min_overlap=min_overlap, thresh=thresh,
                            compute_fp=True, compute_aos=compute_aos,
                        )
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if sim != -1:
                            pr[t, 3] += sim
                for t in range(len(thresholds)):
                    recall[m, d, k, t] = pr[t, 0] / max(pr[t, 0] + pr[t, 2], 1e-9)
                    precision[m, d, k, t] = pr[t, 0] / max(pr[t, 0] + pr[t, 1], 1e-9)
                    if compute_aos:
                        aos[m, d, k, t] = pr[t, 3] / max(pr[t, 0] + pr[t, 1], 1e-9)
                # right-max smoothing (devkit)
                for t in range(len(thresholds)):
                    precision[m, d, k, t] = precision[m, d, k, t:].max()
                    recall[m, d, k, t] = recall[m, d, k, t:].max()
                    if compute_aos:
                        aos[m, d, k, t] = aos[m, d, k, t:].max()
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    """R11: precision at recall 0, 0.1, ..., 1.0 (sample indices 0::4)."""
    sums = prec[..., 0::4].sum(-1)
    return sums / 11 * 100


def get_mAP_R40(prec):
    """R40: precision at the 40 recall points excluding 0."""
    sums = prec[..., 1:].sum(-1)
    return sums / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_bbox_R40 = get_mAP_R40(ret["precision"])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps)
    mAP_bev = get_mAP(ret["precision"])
    mAP_bev_R40 = get_mAP_R40(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps)
    mAP_3d = get_mAP(ret["precision"])
    mAP_3d_R40 = get_mAP_R40(ret["precision"])
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
            mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40)


OVERLAP_0_7 = np.array([
    [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
    [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
    [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
])
OVERLAP_0_5 = np.array([
    [0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
    [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
    [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
])


def get_official_eval_result(gt_annos, dt_annos, current_classes):
    """Returns (result_str, result_dict) like the reference
    (kitti_object_eval_python/eval.py get_official_eval_result)."""
    min_overlaps = np.stack([OVERLAP_0_7, OVERLAP_0_5], 0)  # (2, 3, 6)
    if isinstance(current_classes, (str,)):
        current_classes = [current_classes]
    current_classes = [
        CLASS_NAMES[c] if isinstance(c, int) else c for c in current_classes
    ]
    cls_to_idx = {n.lower(): i for i, n in enumerate(CLASS_NAMES)}
    idxs = [cls_to_idx[c.lower()] for c in current_classes]
    min_overlaps = min_overlaps[:, :, idxs]  # (2, 3, num_class)
    # reshape for eval_class indexing (num_minoverlap, metric, class)
    compute_aos = any(
        len(a["name"]) and a.get("alpha") is not None
        and len(np.asarray(a["alpha"]).reshape(-1))
        and np.asarray(a["alpha"]).reshape(-1)[0] != -10
        for a in dt_annos
    )
    (mAP_bbox, mAP_bev, mAP_3d, mAP_aos, mAP_bbox_R40, mAP_bev_R40,
     mAP_3d_R40, mAP_aos_R40) = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos
    )
    result = ""
    ret_dict = {}
    for j, cls in enumerate(current_classes):
        for i in range(min_overlaps.shape[0]):
            ov = min_overlaps[i, :, j]
            result += (
                f"{cls} AP@{ov[0]:.2f}, {ov[1]:.2f}, {ov[2]:.2f}:\n"
            )
            result += "bbox AP:%.4f, %.4f, %.4f\n" % tuple(mAP_bbox[j, :, i])
            result += "bev  AP:%.4f, %.4f, %.4f\n" % tuple(mAP_bev[j, :, i])
            result += "3d   AP:%.4f, %.4f, %.4f\n" % tuple(mAP_3d[j, :, i])
            if compute_aos:
                result += "aos  AP:%.2f, %.2f, %.2f\n" % tuple(mAP_aos[j, :, i])
            result += (
                f"{cls} AP_R40@{ov[0]:.2f}, {ov[1]:.2f}, {ov[2]:.2f}:\n"
            )
            result += "bbox AP:%.4f, %.4f, %.4f\n" % tuple(mAP_bbox_R40[j, :, i])
            result += "bev  AP:%.4f, %.4f, %.4f\n" % tuple(mAP_bev_R40[j, :, i])
            result += "3d   AP:%.4f, %.4f, %.4f\n" % tuple(mAP_3d_R40[j, :, i])
            if compute_aos:
                result += "aos  AP:%.2f, %.2f, %.2f\n" % tuple(mAP_aos_R40[j, :, i])
            if i == 0:
                for d, dname in enumerate(["easy", "moderate", "hard"]):
                    ret_dict[f"{cls}_3d/{dname}"] = mAP_3d[j, d, 0]
                    ret_dict[f"{cls}_3d/{dname}_R40"] = mAP_3d_R40[j, d, 0]
                    ret_dict[f"{cls}_bev/{dname}"] = mAP_bev[j, d, 0]
                    ret_dict[f"{cls}_bev/{dname}_R40"] = mAP_bev_R40[j, d, 0]
                    ret_dict[f"{cls}_image/{dname}"] = mAP_bbox[j, d, 0]
                    ret_dict[f"{cls}_image/{dname}_R40"] = mAP_bbox_R40[j, d, 0]
                    if compute_aos:
                        ret_dict[f"{cls}_aos/{dname}"] = mAP_aos[j, d, 0]
                        ret_dict[f"{cls}_aos/{dname}_R40"] = mAP_aos_R40[j, d, 0]
    return result, ret_dict
