"""Waymo detection metrics (AP / APH at LEVEL_1 / LEVEL_2) in numpy: the
port's own copy of tsm_det_pointcloud_tpu/eval/waymo_eval.py, the official
protocol of the reference's waymo_eval.py (the waymo_open_dataset metric ops,
config :87-106):

  * matcher TYPE_HUNGARIAN: per (frame, class) a maximum-total-IoU
    assignment over the pairs with IoU >= the class threshold
    (scipy.optimize.linear_sum_assignment, as the JAX package calls it);
  * IoU thresholds 0.7 (Vehicle) / 0.5 (Pedestrian, Cyclist, Sign), 3D;
  * score cutoffs 0.00, 0.01, ..., 0.99, 1.0: the PR curve is sampled at
    these fixed cutoffs, re-matching at each, so scores are quantised to
    that grid;
  * LEVEL_2 gt: difficulty 2 or <= 5 lidar points. L1 counts only L1 gts
    (a detection matched to an L2 gt is neither TP nor FP); L2 counts all;
  * APH weighs every TP by its heading accuracy
    1 - |dtheta| wrapped to [0, pi] / pi, in the precision and the recall;
  * AP: step integration of the sampled PR curve after making precision
    monotone (right-max).

`breakdown_range=True` adds the range breakdown [0, 30) / [30, 50) /
[50, inf) metres by box centre distance (a gt by its own, a false positive
by its own centre).
"""
from __future__ import annotations

import numpy as np

from .rotate_iou_np import rotate_iou_np

CLASS_IOU = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5, "Sign": 0.5}
SCORE_CUTOFFS = np.concatenate([np.arange(100) * 0.01, [1.0]])
RANGE_BUCKETS = ((0.0, 30.0), (30.0, 50.0), (50.0, np.inf))


def iou3d_np(boxes_a, boxes_b):
    """(N, 7) x (M, 7) lidar-frame 3D IoU in numpy (host eval)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    bev_a = boxes_a[:, [0, 1, 3, 4, 6]]
    bev_b = boxes_b[:, [0, 1, 3, 4, 6]]
    inter2d = rotate_iou_np(bev_a, bev_b, criterion=None)
    zmax = np.minimum(
        boxes_a[:, None, 2] + boxes_a[:, None, 5] / 2,
        boxes_b[None, :, 2] + boxes_b[None, :, 5] / 2,
    )
    zmin = np.maximum(
        boxes_a[:, None, 2] - boxes_a[:, None, 5] / 2,
        boxes_b[None, :, 2] - boxes_b[None, :, 5] / 2,
    )
    inter = inter2d * np.clip(zmax - zmin, 0, None)
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return inter / np.maximum(vol_a[:, None] + vol_b[None, :] - inter, 1e-9)


def _heading_accuracy(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    return np.clip(1.0 - d / np.pi, 0.0, 1.0)


def hungarian_match(iou, thresh):
    """Official TYPE_HUNGARIAN: maximize total IoU over pairs with
    iou >= thresh. iou (D, G). Returns per-dt matched gt index or -1."""
    from scipy.optimize import linear_sum_assignment

    D, G = iou.shape
    matched = np.full(D, -1, np.int64)
    if D == 0 or G == 0:
        return matched
    gain = np.where(iou >= thresh, iou, 0.0)
    rows, cols = linear_sum_assignment(-gain)
    for r, c in zip(rows, cols):
        if iou[r, c] >= thresh:
            matched[r] = c
    return matched


class _FrameClass:
    """Per-(frame, class) working set: IoU matrix + cutoff-indexed stats."""

    __slots__ = ("g_boxes", "g_ignore", "g_bucket", "d_boxes", "d_scores",
                 "d_bucket", "iou", "order")

    def __init__(self, g_boxes, g_ignore, g_bucket, d_boxes, d_scores,
                 d_bucket):
        self.g_boxes = g_boxes
        self.g_ignore = g_ignore
        self.g_bucket = g_bucket
        self.d_boxes = d_boxes
        self.d_scores = d_scores
        self.d_bucket = d_bucket
        self.iou = iou3d_np(d_boxes, g_boxes)
        self.order = np.argsort(-d_scores)

    def stats_at(self, cutoff, thresh, n_buckets):
        """(tp, tph, fp) per range bucket for detections with
        score > cutoff, re-matched Hungarian like the official op."""
        keep = self.d_scores > cutoff
        tp = np.zeros(n_buckets)
        tph = np.zeros(n_buckets)
        fp = np.zeros(n_buckets)
        if not keep.any() or len(self.g_boxes) == 0:
            for j in np.where(keep)[0]:
                fp[self.d_bucket[j]] += 1
            return tp, tph, fp
        sub = np.where(keep)[0]
        matched = hungarian_match(self.iou[sub], thresh)
        for k, j in enumerate(sub):
            m = matched[k]
            if m < 0:
                fp[self.d_bucket[j]] += 1
            elif not self.g_ignore[m]:
                b = self.g_bucket[m]
                tp[b] += 1
                tph[b] += _heading_accuracy(
                    self.d_boxes[j, 6], self.g_boxes[m, 6]
                )
            # matches to ignored gts drop out entirely
        return tp, tph, fp


def _extract(gt, dt, cls):
    g_sel = np.asarray(gt["name"]) == cls
    g_boxes = np.asarray(
        gt.get("gt_boxes_lidar", gt.get("boxes_lidar"))
    ).reshape(-1, 7)[g_sel] if g_sel.any() else np.zeros((0, 7))
    npts = np.asarray(
        gt.get("num_points_in_gt", np.full(int(g_sel.sum()), 99))
    ).reshape(-1)[: len(g_boxes)]
    diff = np.asarray(
        gt.get("difficulty", np.zeros(int(g_sel.sum())))
    ).reshape(-1)[: len(g_boxes)]
    is_l2 = (npts <= 5) | (diff == 2)

    d_sel = np.asarray(dt["name"]) == cls
    d_boxes = np.asarray(dt["boxes_lidar"]).reshape(-1, 7)[d_sel] \
        if d_sel.any() else np.zeros((0, 7))
    d_scores = np.asarray(dt["score"]).reshape(-1)[d_sel] \
        if d_sel.any() else np.zeros((0,))
    return g_boxes, is_l2, d_boxes, d_scores


def _bucketize(boxes, buckets):
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    rng = np.linalg.norm(boxes[:, :2], axis=1)
    out = np.zeros(len(boxes), np.int64)
    for i, (lo, hi) in enumerate(buckets):
        out[(rng >= lo) & (rng < hi)] = i
    return out


def _ap_from_curve(recalls, precisions):
    """Official step integration: sort by recall, right-max precision."""
    order = np.argsort(recalls)
    r = np.asarray(recalls)[order]
    p = np.asarray(precisions)[order]
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    ap, prev = 0.0, 0.0
    for i in range(len(r)):
        if r[i] > prev:
            ap += (r[i] - prev) * p[i]
            prev = r[i]
    return float(ap)


def waymo_evaluation(gt_annos, dt_annos,
                     class_names=("Vehicle", "Pedestrian", "Cyclist"),
                     breakdown_range=False, score_cutoffs=None):
    """gt_annos/dt_annos: per-frame dicts with
      name (N,), boxes_lidar/gt_boxes_lidar (N, 7), score (dt),
      heading = boxes[:, 6], num_points_in_gt (gt; optional),
      difficulty (gt; optional, 2 marks LEVEL_2).
    Returns (result_str, dict of '<CLASS>/(AP|APH)_L1/L2' and, with
    breakdown_range, '<CLASS>_[lo,hi)/(AP|APH)_L1/L2')."""
    cutoffs = SCORE_CUTOFFS if score_cutoffs is None else \
        np.asarray(score_cutoffs)
    buckets = RANGE_BUCKETS if breakdown_range else ((0.0, np.inf),)
    n_b = len(buckets)
    results = {}
    for cls in class_names:
        thr = CLASS_IOU.get(cls, 0.5)
        for level in (1, 2):
            frames = []
            total_gt = np.zeros(n_b)
            for gt, dt in zip(gt_annos, dt_annos):
                g_boxes, is_l2, d_boxes, d_scores = _extract(gt, dt, cls)
                gt_ignore = is_l2 if level == 1 else \
                    np.zeros(len(g_boxes), bool)
                g_bucket = _bucketize(g_boxes, buckets)
                d_bucket = _bucketize(d_boxes, buckets)
                for b in range(n_b):
                    total_gt[b] += int((~gt_ignore & (g_bucket == b)).sum())
                frames.append(_FrameClass(
                    g_boxes, gt_ignore, g_bucket, d_boxes, d_scores,
                    d_bucket,
                ))

            # PR curve sampled at the official fixed score cutoffs.
            # Re-matching only happens when the cutoff actually changes
            # some frame's surviving-detection set. stats_per_cut[i] is
            # (3, n_b): tp / heading-weighted tp / fp per range bucket.
            stats_per_cut = []
            prev_counts = None
            for cut in cutoffs:
                counts = tuple(
                    int((f.d_scores > cut).sum()) for f in frames
                )
                if counts == prev_counts:
                    stats_per_cut.append(stats_per_cut[-1])
                    continue
                stats = np.zeros((3, n_b))
                for f in frames:
                    tp, tph, fp = f.stats_at(cut, thr, n_b)
                    stats[0] += tp
                    stats[1] += tph
                    stats[2] += fp
                stats_per_cut.append(stats)
                prev_counts = counts

            def emit(tag, tp_v, tph_v, fp_v, gt_n):
                if gt_n == 0:
                    results[f"{tag}/AP_L{level}"] = 0.0
                    results[f"{tag}/APH_L{level}"] = 0.0
                    return
                denom = np.maximum(tp_v + fp_v, 1e-9)
                results[f"{tag}/AP_L{level}"] = _ap_from_curve(
                    tp_v / gt_n, tp_v / denom
                ) * 100
                results[f"{tag}/APH_L{level}"] = _ap_from_curve(
                    tph_v / gt_n, tph_v / denom
                ) * 100

            S = np.stack(stats_per_cut)  # (n_cut, 3, n_b)
            emit(cls, S[:, 0].sum(-1), S[:, 1].sum(-1), S[:, 2].sum(-1),
                 total_gt.sum())
            if breakdown_range:
                for b in range(n_b):
                    tag = f"{cls}_[{buckets[b][0]:g},{buckets[b][1]:g})"
                    emit(tag, S[:, 0, b], S[:, 1, b], S[:, 2, b],
                         total_gt[b])

    lines = [f"{k}: {v:.4f}" for k, v in sorted(results.items())]
    return "\n".join(lines), results
