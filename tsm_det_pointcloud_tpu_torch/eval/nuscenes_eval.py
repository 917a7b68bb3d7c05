"""nuScenes detection evaluation (the official NDS protocol) in numpy: the
port's own copy of tsm_det_pointcloud_tpu/eval/nuscenes_eval.py, the
nuscenes-devkit detection eval the reference runs through ``NuScenesEval``
with the ``detection_cvpr_2019`` config (the reference's
pcdet/datasets/nuscenes/nuscenes_dataset.py:229-252). The protocol (devkit
nuscenes/eval/detection):

* Per (class, dist_th) in {0.5, 1, 2, 4} m: predictions pooled across all
  samples, sorted by score descending; each greedily matches the CLOSEST
  not-yet-taken same-class GT in its sample by 2D center distance; match
  iff distance < dist_th.
* Precision interpolated at 101 recall points; AP = mean of
  clip(precision - 0.1, 0) over recall in (0.1, 1], / 0.9.
* TP errors at dist_th = 2 m only, cumulative-mean curves interpolated on
  the confidence curve: ATE (2D center distance), ASE (1 - IoU of
  center-and-yaw-aligned boxes), AOE (smallest yaw difference; period pi
  for barrier; not defined for traffic_cone), AVE (2D velocity L2; not
  defined for barrier/cone), AAE (1 - attribute accuracy; not defined for
  barrier/cone). Each TP metric is averaged over recall indices
  [11, max_achieved_recall]; classes where a metric is undefined are
  nan-excluded from the mean.
* NDS = (5 * mAP + sum over 5 TP metrics of max(0, 1 - err)) / 10.

Filtering: boxes beyond the per-class range from the ego (class_range
below) are dropped; GT with zero lidar points is dropped. Two documented
deltas vs the devkit: range is measured from the LIDAR origin in the box
frame we store (the devkit measures from the ego pose in the global
frame — same to within the lidar->ego lever arm), and the devkit's
map-based bike-rack exclusion needs map data no anno stream carries.

Anno schema (the repo's standard host-eval dicts):
  gt:  name (N,), gt_boxes_lidar (N, 7|9[+vx,vy]), num_lidar_pts (N,)
       [optional attr (N,) str]
  dt:  name (M,), score (M,), boxes_lidar (M, 7|9) [optional attr]
A box of fewer than 9 columns carries no velocity: its matches' AVE is
undefined, and a class whose matches all lack it scores AVE 1.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

# detection_cvpr_2019 constants (devkit eval config)
CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}
DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MEAN_AP_WEIGHT = 5
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
TP_METRIC_NAMES = {"trans_err": "mATE", "scale_err": "mASE",
                   "orient_err": "mAOE", "vel_err": "mAVE",
                   "attr_err": "mAAE"}
N_REC = 101


def _cummean(x):
    """Devkit cummean: nan entries contribute nothing; all-nan -> ones."""
    x = np.asarray(x, np.float64)
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    s = np.nancumsum(x)
    c = np.cumsum(~np.isnan(x)).astype(np.float64)
    return np.divide(s, c, out=np.zeros_like(s), where=c != 0)


def _scale_iou(gt_size, dt_size):
    """IoU of two boxes after aligning center and yaw (devkit scale_iou)."""
    mins = np.minimum(gt_size, dt_size)
    inter = float(np.prod(mins))
    union = float(np.prod(gt_size)) + float(np.prod(dt_size)) - inter
    return inter / union if union > 0 else 0.0


def _yaw_diff(a, b, period=2 * np.pi):
    d = (a - b) % period
    return float(min(d, period - d))


class _MetricData:
    """101-point interpolated curves for one (class, dist_th)."""

    def __init__(self, recall, precision, confidence, errors):
        self.recall = recall
        self.precision = precision
        self.confidence = confidence
        self.errors = errors  # dict name -> (101,)

    @property
    def max_recall_ind(self):
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else 0

    @classmethod
    def no_predictions(cls):
        z = np.zeros(N_REC)
        return cls(np.linspace(0, 1, N_REC), z, z,
                   {k: np.ones(N_REC) for k in TP_METRICS})


def _accumulate(gt_by_sample, preds, npos, dist_th):
    """preds: list of dicts {sample, xy, size, yaw, vel, attr, score,
    name}; gt_by_sample: sample -> list of gt dicts (same keys)."""
    if npos == 0 or not preds:
        return _MetricData.no_predictions()
    order = np.argsort([-p["score"] for p in preds], kind="stable")
    taken = set()
    tp, fp, conf = [], [], []
    match = {k: [] for k in TP_METRICS}
    match_conf = []
    for pi in order:
        p = preds[pi]
        gts = gt_by_sample.get(p["sample"], [])
        best, best_d = None, np.inf
        for gi, g in enumerate(gts):
            if (p["sample"], gi) in taken:
                continue
            d = float(np.hypot(*(g["xy"] - p["xy"])))
            if d < best_d:
                best, best_d = gi, d
        if best is not None and best_d < dist_th:
            taken.add((p["sample"], best))
            g = gts[best]
            tp.append(1), fp.append(0), conf.append(p["score"])
            match["trans_err"].append(best_d)
            match["scale_err"].append(1 - _scale_iou(g["size"], p["size"]))
            period = np.pi if p["name"] == "barrier" else 2 * np.pi
            match["orient_err"].append(
                np.nan if p["name"] == "traffic_cone"
                else _yaw_diff(g["yaw"], p["yaw"], period))
            if p["name"] in ("barrier", "traffic_cone"):
                match["vel_err"].append(np.nan)
                match["attr_err"].append(np.nan)
            else:
                gv, pv = g.get("vel"), p.get("vel")
                match["vel_err"].append(
                    float(np.hypot(*(gv - pv)))
                    if gv is not None and pv is not None else np.nan)
                ga, pa = g.get("attr"), p.get("attr")
                match["attr_err"].append(
                    np.nan if not ga else float(ga != pa))
            match_conf.append(p["score"])
        else:
            tp.append(0), fp.append(1), conf.append(p["score"])

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    prec = tp / np.maximum(tp + fp, 1e-12)
    rec = tp / float(npos)
    rec_interp = np.linspace(0, 1, N_REC)
    precision = np.interp(rec_interp, rec, prec, right=0)
    confidence = np.interp(rec_interp, rec, conf, right=0)
    errors = {}
    if match_conf:
        for k in TP_METRICS:
            tmp = _cummean(match[k])
            errors[k] = np.interp(confidence[::-1],
                                  np.asarray(match_conf)[::-1],
                                  tmp[::-1])[::-1]
    else:
        errors = {k: np.ones(N_REC) for k in TP_METRICS}
    return _MetricData(rec_interp, precision, confidence, errors)


def _calc_ap(md):
    prec = np.copy(md.precision)[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _calc_tp(md, metric):
    first = round(100 * MIN_RECALL) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(md.errors[metric][first:last + 1]))


def _to_records(annos, box_key, with_score, class_names):
    """anno dicts -> per-sample record lists, range- and points-filtered."""
    by_sample = defaultdict(list)
    counts = defaultdict(int)
    for si, anno in enumerate(annos):
        names = np.asarray(anno.get("name", []), object)
        boxes = None
        for k in box_key:
            if k in anno and len(np.asarray(anno[k])):
                boxes = np.asarray(anno[k], np.float64)
                break
        if boxes is None:
            boxes = np.zeros((len(names), 7))
        boxes = boxes.reshape(len(names), -1) if len(names) else boxes.reshape(0, 7)
        scores = np.asarray(anno.get("score", np.ones(len(names))), np.float64)
        npts = np.asarray(
            anno.get("num_lidar_pts", np.ones(len(names), np.int64)))
        attrs = anno.get("attr")
        for i, name in enumerate(names):
            name = str(name)
            if name not in CLASS_RANGE or name not in class_names:
                continue
            xy = boxes[i, :2]
            if float(np.hypot(*xy)) > CLASS_RANGE[name]:
                continue
            if not with_score and npts[i] <= 0:
                continue
            rec = {
                "sample": si, "name": name, "xy": xy,
                # lidar boxes are (x, y, z, dx=l, dy=w, dz=h, yaw[, vx, vy])
                "size": np.array([boxes[i, 4], boxes[i, 3], boxes[i, 5]]),
                "yaw": float(boxes[i, 6]),
                "vel": boxes[i, 7:9] if boxes.shape[1] >= 9 else None,
                "attr": str(attrs[i]) if attrs is not None else None,
            }
            if with_score:
                rec["score"] = float(scores[i])
            by_sample[si].append(rec)
            counts[name] += 1
    return by_sample, counts


def nuscenes_evaluation(gt_annos, det_annos, class_names):
    """Official NDS over per-sample anno dicts (see module docstring).
    Returns (result_str, result_dict) with per-class APs, TP errors,
    mAP and NDS — the same summary the reference reads out of the
    devkit's metrics_summary.json (nuscenes_dataset.py:249-252)."""
    assert len(gt_annos) == len(det_annos), \
        f"sample count mismatch: {len(gt_annos)} gt vs {len(det_annos)} dt"
    class_names = [c for c in class_names if c in CLASS_RANGE] or \
        list(CLASS_RANGE)
    gt_by_sample, gt_counts = _to_records(
        gt_annos, ("gt_boxes_lidar", "boxes_lidar"), False, class_names)
    dt_by_sample, _ = _to_records(
        det_annos, ("boxes_lidar",), True, class_names)

    aps = {}          # (class, th) -> ap
    tp_errs = {}      # (class, metric) -> err
    for cls in class_names:
        cls_gt_by_sample = {
            s: [g for g in lst if g["name"] == cls]
            for s, lst in gt_by_sample.items()}
        cls_preds = [p for lst in dt_by_sample.values() for p in lst
                     if p["name"] == cls]
        npos = gt_counts.get(cls, 0)
        for th in DIST_THS:
            md = _accumulate(cls_gt_by_sample, cls_preds, npos, th)
            aps[(cls, th)] = _calc_ap(md)
            if th == DIST_TH_TP:
                for m in TP_METRICS:
                    if cls == "traffic_cone" and m in (
                            "attr_err", "vel_err", "orient_err"):
                        tp_errs[(cls, m)] = np.nan
                    elif cls == "barrier" and m in ("attr_err", "vel_err"):
                        tp_errs[(cls, m)] = np.nan
                    else:
                        tp_errs[(cls, m)] = _calc_tp(md, m)

    mean_aps = {c: float(np.mean([aps[(c, t)] for t in DIST_THS]))
                for c in class_names}
    mAP = float(np.mean(list(mean_aps.values()))) if mean_aps else 0.0
    def _nanmean(vals):
        vals = [v for v in vals if not np.isnan(v)]
        return float(np.mean(vals)) if vals else 1.0  # undefined -> worst

    mean_tp = {m: _nanmean([tp_errs[(c, m)] for c in class_names])
               for m in TP_METRICS}
    tp_scores = [max(0.0, 1.0 - mean_tp[m]) for m in TP_METRICS]
    nds = (MEAN_AP_WEIGHT * mAP + sum(tp_scores)) / (
        MEAN_AP_WEIGHT + len(TP_METRICS))

    ret = {"mAP": mAP, "NDS": nds}
    lines = ["----------------NuScenes detection results (hermetic "
             "official protocol)-----------------"]
    for c in class_names:
        per_th = " ".join(f"{aps[(c, t)]:.4f}" for t in DIST_THS)
        lines.append(f"{c:<22s} AP@{list(DIST_THS)}: {per_th} "
                     f"mean {mean_aps[c]:.4f}")
        ret[f"{c}_AP"] = mean_aps[c]
        for t in DIST_THS:
            ret[f"{c}_AP_{t}"] = aps[(c, t)]
        for m in TP_METRICS:
            ret[f"{c}_{m}"] = float(tp_errs[(c, m)])
    for m in TP_METRICS:
        lines.append(f"{TP_METRIC_NAMES[m]}: {mean_tp[m]:.4f}")
        ret[TP_METRIC_NAMES[m]] = mean_tp[m]
    lines.append(f"mAP: {mAP:.4f}")
    lines.append(f"NDS: {nds:.4f}")
    return "\n".join(lines) + "\n", ret
