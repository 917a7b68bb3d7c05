"""Pseudo-KITTI annotations for datasets without a camera calibration: the
port's own copy of tsm_det_pointcloud_tpu/datasets/kitti/kitti_format.py
(`to_kitti_format` :16), the reference's kitti_utils.py:5-49
`transform_annotations_to_kitti_format` without its in-place mutation.

Lidar boxes go through the canonical KITTI camera extrinsic (camera x = -y,
y = -z at the box's bottom, z = x; ry = -yaw - pi/2) with benign 2D fields
(50-pixel boxes, no truncation or occlusion), so that every object lands in
the easiest difficulty and the official KITTI AP (`eval.kitti_eval`) can
score them: Lyft's `eval_metric="kitti"`.
"""
from __future__ import annotations

import numpy as np


def to_kitti_format(annos, name_map=None):
    """New KITTI-style anno dicts of lidar-box annos (name (N,), boxes_lidar
    or gt_boxes_lidar (N, >= 7), optionally score); the inputs are not
    changed. name_map maps a dataset class to a KITTI one; a name it lacks
    passes as it is (the KITTI eval ignores classes it does not score)."""
    out = []
    for anno in annos:
        names = np.asarray(anno.get("name", anno.get("gt_names", [])), object)
        if name_map:
            names = np.asarray([name_map.get(str(n), str(n)) for n in names], object)
        boxes = anno.get("boxes_lidar", anno.get("gt_boxes_lidar"))
        boxes = (np.asarray(boxes, np.float64).reshape(-1, boxes.shape[-1])
                 if boxes is not None and len(boxes) else np.zeros((0, 7)))
        n = len(names)
        rec = {
            "name": names,
            "truncated": np.zeros(n),
            "occluded": np.zeros(n),
            "bbox": np.concatenate([np.zeros((n, 2)), np.full((n, 2), 50.0)], axis=1),
        }
        if n:
            x, y, z = boxes[:, 0], boxes[:, 1], boxes[:, 2]
            dx, dy, dz = boxes[:, 3], boxes[:, 4], boxes[:, 5]
            ry = -boxes[:, 6] - np.pi / 2.0
            rec["location"] = np.stack([-y, -(z - dz / 2.0), x], axis=1)
            rec["dimensions"] = np.stack([dx, dz, dy], axis=1)   # l, h, w
            rec["rotation_y"] = ry
            rec["alpha"] = -np.arctan2(-y, x) + ry
        else:
            rec["location"] = np.zeros((0, 3))
            rec["dimensions"] = np.zeros((0, 3))
            rec["rotation_y"] = np.zeros(0)
            rec["alpha"] = np.zeros(0)
        if "score" in anno:
            rec["score"] = np.asarray(anno["score"], np.float64)
        out.append(rec)
    return out
