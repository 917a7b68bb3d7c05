"""Numpy augmentation primitives on the host (counterpart of
tsm_det_pointcloud_tpu/datasets/augmentor/augmentor_utils.py).

Every function takes and returns numpy arrays; randomness comes from an
explicit np.random.Generator, in the JAX package's draw order, so that a
sample's augmentation is a function of its (seed, epoch, index).
Boxes: (N, 7+) [x, y, z, dx, dy, dz, heading, ...].
"""
from __future__ import annotations

import numpy as np

from ...ops.boxes import points_in_boxes_np
from ...utils.common_utils import rotate_points_along_z_np


def random_flip_along_x(gt_boxes, points, rng, prob=0.5):
    if rng.random() < prob:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:  # velocities vx, vy
            gt_boxes[:, 8] = -gt_boxes[:, 8] if gt_boxes.shape[1] > 8 else gt_boxes[:, 8]
    return gt_boxes, points


def random_flip_along_y(gt_boxes, points, rng, prob=0.5):
    if rng.random() < prob:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rng, rot_range, prob=1.0):
    if rng.random() >= prob:
        return gt_boxes, points
    noise = rng.uniform(rot_range[0], rot_range[1])
    points = rotate_points_along_z_np(points[None], np.array([noise]))[0]
    gt_boxes = gt_boxes.copy()
    gt_boxes[:, 0:3] = rotate_points_along_z_np(
        gt_boxes[None, :, 0:3], np.array([noise])
    )[0]
    gt_boxes[:, 6] += noise
    if gt_boxes.shape[1] > 8:
        vel = np.concatenate(
            [gt_boxes[:, 7:9], np.zeros((gt_boxes.shape[0], 1), gt_boxes.dtype)], axis=1
        )
        gt_boxes[:, 7:9] = rotate_points_along_z_np(vel[None], np.array([noise]))[0][:, :2]
    return gt_boxes, points


def global_scaling(gt_boxes, points, rng, scale_range, prob=1.0):
    if rng.random() >= prob or (scale_range[1] - scale_range[0]) < 1e-3:
        return gt_boxes, points
    s = rng.uniform(scale_range[0], scale_range[1])
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] *= s
    gt_boxes[:, :6] *= s
    if gt_boxes.shape[1] > 8:
        gt_boxes[:, 7:9] *= s
    return gt_boxes, points


def random_box_noise(gt_boxes, points, rng, loc_noise, scale_range, rot_range,
                     prob=0.5):
    """Independently perturb each gt box (and the points inside it).
    Parity: data_augmentor.random_box_noise (:228-253) — per-box rotation
    about the box center, translation, and scale."""
    if rng.random() >= prob or gt_boxes.shape[0] == 0:
        return gt_boxes, points
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    idx = points_in_boxes_np(points, gt_boxes[:, :7])
    for k in range(gt_boxes.shape[0]):
        mask = idx == k
        rot = rng.uniform(rot_range[0], rot_range[1])
        trans = rng.uniform(-1, 1, 3) * np.asarray(loc_noise)
        scale = rng.uniform(scale_range[0], scale_range[1])
        center = gt_boxes[k, 0:3].copy()

        pts = points[mask]
        pts[:, :3] -= center
        pts[:, :3] = rotate_points_along_z_np(pts[None, :, :3], np.array([rot]))[0]
        pts[:, :3] *= scale
        pts[:, :3] += center + trans
        points[mask] = pts

        gt_boxes[k, 0:3] += trans
        gt_boxes[k, 3:6] *= scale
        gt_boxes[k, 6] += rot
    return gt_boxes, points


def random_local_rotation(gt_boxes, points, rng, rot_range):
    if gt_boxes.shape[0] == 0:
        return gt_boxes, points
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    idx = points_in_boxes_np(points, gt_boxes[:, :7])
    for k in range(gt_boxes.shape[0]):
        rot = rng.uniform(rot_range[0], rot_range[1])
        mask = idx == k
        center = gt_boxes[k, 0:3].copy()
        pts = points[mask]
        pts[:, :3] -= center
        pts[:, :3] = rotate_points_along_z_np(pts[None, :, :3], np.array([rot]))[0]
        pts[:, :3] += center
        points[mask] = pts
        gt_boxes[k, 6] += rot
    return gt_boxes, points


def random_local_translation(gt_boxes, points, rng, offset_range, axes=("x", "y", "z")):
    if gt_boxes.shape[0] == 0:
        return gt_boxes, points
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    ax_map = {"x": 0, "y": 1, "z": 2}
    idx = points_in_boxes_np(points, gt_boxes[:, :7])
    for k in range(gt_boxes.shape[0]):
        mask = idx == k
        for ax in axes:
            a = ax_map[ax]
            off = rng.uniform(offset_range[0], offset_range[1])
            points[mask, a] += off
            gt_boxes[k, a] += off
    return gt_boxes, points


def random_local_scaling(gt_boxes, points, rng, scale_range):
    if gt_boxes.shape[0] == 0 or (scale_range[1] - scale_range[0]) < 1e-3:
        return gt_boxes, points
    gt_boxes = gt_boxes.copy()
    points = points.copy()
    idx = points_in_boxes_np(points, gt_boxes[:, :7])
    for k in range(gt_boxes.shape[0]):
        mask = idx == k
        s = rng.uniform(scale_range[0], scale_range[1])
        center = gt_boxes[k, 0:3].copy()
        points[mask, :3] = (points[mask, :3] - center) * s + center
        gt_boxes[k, 3:6] *= s
    return gt_boxes, points


# ---------------------------------------------------------------------------
# SE-SSD style pyramid augmentations (frustums of the 6 box faces)
# ---------------------------------------------------------------------------

def _points_in_pyramids(points, boxes, rng=None):
    """Assign each point to (box, face) pyramid. Returns (N,) box idx and
    (N,) face idx in 0..5 (-1 outside), faces ordered [+x,-x,+y,-y,+z,-z]
    from the box center."""
    idx = points_in_boxes_np(points, boxes[:, :7])
    face = np.full(points.shape[0], -1, np.int64)
    inside = idx >= 0
    if not inside.any():
        return idx, face
    b = boxes[idx[inside]]
    rel = points[inside, :3] - b[:, 0:3]
    c, s = np.cos(-b[:, 6]), np.sin(-b[:, 6])
    lx = rel[:, 0] * c - rel[:, 1] * s
    ly = rel[:, 0] * s + rel[:, 1] * c
    lz = rel[:, 2]
    # normalize by half-sizes: dominant axis picks the face pyramid
    nx, ny, nz = lx / (b[:, 3] / 2), ly / (b[:, 4] / 2), lz / (b[:, 5] / 2)
    mags = np.stack([nx, -nx, ny, -ny, nz, -nz], axis=1)
    face[inside] = np.argmax(mags, axis=1)
    return idx, face


def local_pyramid_aug(gt_boxes, points, rng, drop_prob=0.25, sparsify_prob=0.05,
                      sparsify_max_num=50, swap_prob=0.1, swap_max_num=50):
    """SE-SSD pyramid drop/sparsify/swap (parity: data_augmentor.py:205-226).
    Deletion happens by boolean mask; swap exchanges points between the same
    face pyramid of two different boxes (positions normalized to each box)."""
    if gt_boxes.shape[0] == 0:
        return gt_boxes, points
    box_idx, face = _points_in_pyramids(points, gt_boxes)
    keep = np.ones(points.shape[0], bool)
    for k in range(gt_boxes.shape[0]):
        for f in range(6):
            mask = (box_idx == k) & (face == f)
            cnt = int(mask.sum())
            if cnt == 0:
                continue
            r = rng.random()
            if r < drop_prob:
                keep &= ~mask
            elif r < drop_prob + sparsify_prob and cnt > sparsify_max_num:
                sel = np.where(mask)[0]
                drop = rng.choice(sel, cnt - sparsify_max_num, replace=False)
                keep[drop] = False
            elif r < drop_prob + sparsify_prob + swap_prob:
                # swap with the same face of a random other box
                others = [j for j in range(gt_boxes.shape[0]) if j != k]
                if not others:
                    continue
                j = int(rng.choice(others))
                mask_j = (box_idx == j) & (face == f)
                if not mask_j.any():
                    continue
                points = _swap_pyramid_points(
                    points, gt_boxes, k, j, mask, mask_j, swap_max_num, rng
                )
    return gt_boxes, points[keep]


def _swap_pyramid_points(points, boxes, k, j, mask_k, mask_j, max_num, rng):
    """Exchange (normalized) point positions between box k and box j."""
    points = points.copy()

    def to_local(pts, box):
        rel = pts[:, :3] - box[0:3]
        c, s = np.cos(-box[6]), np.sin(-box[6])
        out = rel.copy()
        out[:, 0] = rel[:, 0] * c - rel[:, 1] * s
        out[:, 1] = rel[:, 0] * s + rel[:, 1] * c
        return out / box[3:6]

    def to_global(loc, box):
        sc = loc * box[3:6]
        c, s = np.cos(box[6]), np.sin(box[6])
        out = sc.copy()
        out[:, 0] = sc[:, 0] * c - sc[:, 1] * s
        out[:, 1] = sc[:, 0] * s + sc[:, 1] * c
        return out + box[0:3]

    sel_k = np.where(mask_k)[0][:max_num]
    sel_j = np.where(mask_j)[0][:max_num]
    loc_k = to_local(points[sel_k], boxes[k])
    loc_j = to_local(points[sel_j], boxes[j])
    points[sel_k, :3] = to_global(loc_j[: len(sel_k)] if len(loc_j) >= len(sel_k)
                                  else np.resize(loc_j, (len(sel_k), 3)), boxes[k])
    points[sel_j, :3] = to_global(loc_k[: len(sel_j)] if len(loc_k) >= len(sel_j)
                                  else np.resize(loc_k, (len(sel_j), 3)), boxes[j])
    return points


# ---------------------------------------------------------------------------
# frustum dropout (JAX augmentor_utils.py:248-288): every point and gt box
# beyond a threshold along z (top / bottom) or y (left / right) goes; the
# threshold sits an intensity drawn from the sample's generator of the
# points' extent along that axis in from its high or low end. The gt names
# and gt_boxes_mask are not cut with the boxes, as in the JAX package: a
# dropped box then fails the mask at the end of `DataAugmentor.forward`
# ---------------------------------------------------------------------------

def _frustum_threshold(vals, intensity, side):
    lo, hi = float(np.min(vals)), float(np.max(vals))
    span = hi - lo
    if side == "high":
        return hi - intensity * span
    return lo + intensity * span


def global_frustum_dropout_top(gt_boxes, points, rng, intensity_range):
    t = _frustum_threshold(points[:, 2], rng.uniform(*intensity_range), "high")
    return gt_boxes[gt_boxes[:, 2] < t], points[points[:, 2] < t]


def global_frustum_dropout_bottom(gt_boxes, points, rng, intensity_range):
    t = _frustum_threshold(points[:, 2], rng.uniform(*intensity_range), "low")
    return gt_boxes[gt_boxes[:, 2] > t], points[points[:, 2] > t]


def global_frustum_dropout_left(gt_boxes, points, rng, intensity_range):
    t = _frustum_threshold(points[:, 1], rng.uniform(*intensity_range), "high")
    return gt_boxes[gt_boxes[:, 1] < t], points[points[:, 1] < t]


def global_frustum_dropout_right(gt_boxes, points, rng, intensity_range):
    t = _frustum_threshold(points[:, 1], rng.uniform(*intensity_range), "low")
    return gt_boxes[gt_boxes[:, 1] > t], points[points[:, 1] > t]
