"""Losses of the TSM distillation step (counterpart of
tsm_det_pointcloud_tpu/ops/loss_utils.py). Every function returns
per-element losses, unreduced, so callers normalise as the reference does;
the functions take any leading batch axes."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .boxes import points_in_boxes, rotate_points_along_z


def bce_with_logits(logits, targets):
    """Numerically stable elementwise BCE-with-logits."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))


def _weigh(loss, weights):
    if weights is None:
        return loss
    if weights.dim() < loss.dim():
        weights = weights[..., None]
    return loss * weights


def sigmoid_focal_loss(logits, targets, weights=None, gamma=2.0, alpha=0.25):
    """Per-element sigmoid focal loss, OpenPCDet form."""
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - p) + (1.0 - targets) * p
    return _weigh(alpha_w * torch.pow(pt, gamma) * bce_with_logits(logits, targets),
                  weights)


def weighted_smooth_l1(preds, targets, weights=None, beta=1.0 / 9.0):
    """Overflow-safe Huber: never squares an unbounded residual."""
    n = (preds - targets).abs()
    if beta < 1e-5:
        loss = n
    else:
        c = torch.clamp(n, max=beta)
        loss = 0.5 * c * c / beta + (n - c)
    return _weigh(loss, weights)


def centerness_label(point_xyz, point_box_labels, pos_mask, epsilon=1e-6):
    """Per-point centerness in [0, 1] against its assigned box, 0 for
    background. point_xyz (..., 3), point_box_labels (..., 7), pos_mask
    (...) bool."""
    canonical = point_xyz - point_box_labels[..., 0:3]
    canonical = rotate_points_along_z(canonical[..., None, :],
                                      -point_box_labels[..., 6])[..., 0, :]
    half = point_box_labels[..., 3:6] / 2
    front = half - canonical
    back = half + canonical
    ratio = torch.minimum(front, back) / torch.clamp(torch.maximum(front, back),
                                                     min=epsilon)
    cent = torch.clamp(ratio[..., 0] * ratio[..., 1] * ratio[..., 2],
                       min=epsilon) ** (1 / 3.0)
    return torch.where(pos_mask, cent, torch.zeros_like(cent))


def rdiou(bboxes1, bboxes2):
    """Rotation-decoupled IoU (heading as a 4th unit-length axis). Returns
    (u, rdiou) with u the DIoU centre-distance term; elementwise over
    (..., 7) boxes."""
    x1, y1, z1 = bboxes1[..., 0], bboxes1[..., 1], bboxes1[..., 2]
    l1 = torch.clamp(bboxes1[..., 3], max=10.0)
    w1 = torch.clamp(bboxes1[..., 4], max=10.0)
    h1 = torch.clamp(bboxes1[..., 5], max=10.0)
    x2, y2, z2 = bboxes2[..., 0], bboxes2[..., 1], bboxes2[..., 2]
    l2, w2, h2 = bboxes2[..., 3], bboxes2[..., 4], bboxes2[..., 5]
    t1 = torch.sin(bboxes1[..., 6]) * torch.cos(bboxes2[..., 6])
    t2 = torch.cos(bboxes1[..., 6]) * torch.sin(bboxes2[..., 6])
    j = torch.ones_like(h2)
    vol1 = l1 * w1 * h1
    vol2 = l2 * w2 * h2

    def overlap(c1, s1, c2, s2):
        lo = torch.maximum(c1 - s1 / 2, c2 - s2 / 2)
        hi = torch.minimum(c1 + s1 / 2, c2 + s2 / 2)
        return torch.clamp(hi - lo, min=0.0)

    def hull(c1, s1, c2, s2):
        lo = torch.minimum(c1 - s1 / 2, c2 - s2 / 2)
        hi = torch.maximum(c1 + s1 / 2, c2 + s2 / 2)
        return torch.clamp(hi - lo, min=0.0)

    inter = (overlap(x1, l1, x2, l2) * overlap(y1, w1, y2, w2)
             * overlap(z1, h1, z2, h2) * overlap(t1, j, t2, j))
    inter_diag = (x2 - x1) ** 2 + (y2 - y1) ** 2 + (z2 - z1) ** 2 + (t2 - t1) ** 2
    c_diag = (hull(x1, l1, x2, l2) ** 2 + hull(y1, w1, y2, w2) ** 2
              + hull(z1, h1, z2, h2) ** 2 + hull(t1, j, t2, j) ** 2)
    union = vol1 + vol2 - inter
    u = inter_diag / torch.clamp(c_diag, min=1e-7)
    return u, inter / torch.clamp(union, min=1e-7)


def sasa_assign_targets(points_xyz, gt_boxes, extra_width=None,
                        set_ignore_flag=True, num_class=3, gt_valid=None):
    """Per-point segmentation labels: points_xyz (B, N, 3), gt_boxes
    (B, M, 8) with the 1-based class in column 7, gt_valid (B, M).
    Returns labels (B, N) int64 in {-1 ignore, 0 bg, 1..num_class}."""
    valid = gt_valid if gt_valid is not None else gt_boxes[..., 3] > 0
    idx_in = points_in_boxes(points_xyz, gt_boxes[..., :7], valid_mask=valid)
    fg = idx_in >= 0
    if num_class == 1:
        cls = torch.ones_like(idx_in)
    else:
        cls = torch.gather(gt_boxes[..., 7].long(), 1, torch.clamp(idx_in, min=0))
    labels = torch.where(fg, cls, torch.zeros_like(cls))
    if set_ignore_flag and extra_width is not None:
        idx_ext = points_in_boxes(points_xyz, gt_boxes[..., :7],
                                  extra_width=extra_width, valid_mask=valid)
        labels = torch.where(~fg & (idx_ext >= 0), torch.full_like(labels, -1), labels)
    return labels


def sasa_layer_loss(scores, labels, num_class=3):
    """One SASA pyramid level: focal loss of per-point (num_class,) logits
    against one-hot labels, ignoring -1, normalised by #(fg + bg)."""
    cls_weights = (labels >= 0).to(scores.dtype)
    one_hot = F.one_hot(torch.clamp(labels, min=0), num_class + 1)[..., 1:].to(scores.dtype)
    loss = sigmoid_focal_loss(scores, one_hot, cls_weights)
    return loss.sum() / torch.clamp(cls_weights.sum(), min=1.0)
