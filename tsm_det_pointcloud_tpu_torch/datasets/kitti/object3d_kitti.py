"""KITTI label-file parsing (counterpart of
tsm_det_pointcloud_tpu/datasets/kitti/object3d_kitti.py).

One label line has 15 (+1 optional score) space-separated columns:
type truncated occluded alpha | bbox(4: left top right bottom) |
dimensions(3: h w l) | location(3: x y z, rect frame, bottom centre) |
rotation_y | [score]. `Object3d` is a view of one row.
"""
from __future__ import annotations

import numpy as np

_CLASS_IDS = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}

# difficulty tiers: (min 2d-box height px, max truncation, max occlusion)
_LEVELS = (
    ("Easy", 40.0, 0.15, 0),
    ("Moderate", 25.0, 0.30, 1),
    ("Hard", 25.0, 0.50, 2),
)


def cls_type_to_id(cls_type):
    return _CLASS_IDS.get(cls_type, -1)


def parse_label_file(label_file):
    """Parse a label txt -> (list of type names, (N, 15) float column matrix).

    Column layout: 0 truncation, 1 occlusion, 2 alpha, 3:7 bbox, 7:10 hwl,
    10:13 location, 13 rotation_y, 14 score (-1 when absent).
    """
    names, rows = [], []
    with open(label_file) as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            names.append(fields[0])
            vals = [float(v) for v in fields[1:16]]
            if len(vals) == 14:  # no score column
                vals.append(-1.0)
            rows.append(vals)
    mat = (
        np.asarray(rows, dtype=np.float64)
        if rows
        else np.zeros((0, 15), np.float64)
    )
    return names, mat


def get_objects_from_label(label_file):
    names, mat = parse_label_file(label_file)
    return [Object3d(n, row) for n, row in zip(names, mat)]


def _difficulty(box_height, truncation, occlusion):
    for idx, (name, min_h, max_trunc, max_occ) in enumerate(_LEVELS):
        if box_height >= min_h and truncation <= max_trunc and occlusion <= max_occ:
            return idx, name
    return -1, "UnKnown"


class Object3d:
    """One labeled object; attributes mirror the reference's field names."""

    def __init__(self, cls_type, row):
        self.cls_type = cls_type
        self.cls_id = cls_type_to_id(cls_type)
        self.truncation = row[0]
        self.occlusion = row[1]  # 0..3 (3 = unknown)
        self.alpha = row[2]
        self.box2d = row[3:7].astype(np.float32)
        self.h, self.w, self.l = row[7:10]
        self.loc = row[10:13].astype(np.float32)
        self.dis_to_cam = float(np.linalg.norm(self.loc))
        self.ry = row[13]
        self.score = row[14]
        # +1: KITTI boxes are inclusive pixel ranges
        box_height = self.box2d[3] - self.box2d[1] + 1
        self.level, self.level_str = _difficulty(
            box_height, self.truncation, self.occlusion
        )
        self.src = "%s %s" % (cls_type, " ".join("%g" % v for v in row[:14]))

    def get_kitti_obj_level(self):
        return self.level

    def generate_corners3d(self):
        """(8, 3) box corners in the rect frame; loc is the bottom center."""
        half_l, h, half_w = self.l / 2, self.h, self.w / 2
        # bottom face then top face, counter-clockwise from +x+z
        corners = np.array(
            [
                [half_l, 0.0, half_w], [half_l, 0.0, -half_w],
                [-half_l, 0.0, -half_w], [-half_l, 0.0, half_w],
                [half_l, -h, half_w], [half_l, -h, -half_w],
                [-half_l, -h, -half_w], [-half_l, -h, half_w],
            ]
        )
        c, s = np.cos(self.ry), np.sin(self.ry)
        rot_y = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return corners @ rot_y.T + self.loc

    def to_str(self):
        return (
            "%s %.3f %.3f %.3f box2d: %s hwl: [%.3f %.3f %.3f] pos: %s ry: %.3f"
            % (self.cls_type, self.truncation, self.occlusion, self.alpha,
               self.box2d, self.h, self.w, self.l, self.loc, self.ry)
        )
