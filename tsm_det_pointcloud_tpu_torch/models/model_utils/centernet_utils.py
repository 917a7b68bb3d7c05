"""CenterNet utilities: heatmap targets, heatmap decode and circle NMS
(counterpart of tsm_det_pointcloud_tpu/models/model_utils/centernet_utils.py).

The functions take a leading batch axis (the JAX ones are per sample and
vmapped by their callers), but `circle_nms`, which is per scan like
`iou3d.nms_bev`. As in the JAX package, a gt's gaussian is drawn
analytically over the whole map and the maps of a class are max-combined;
the window is d2 <= 2 (r + 1)^2 around the floored centre (the reference
draws a (2r + 1) square).
"""
from __future__ import annotations

import torch

from ...ops.iou3d import _suppression_fixpoint, stable_top_k


def gaussian_radius(height, width, min_overlap=0.5):
    """Smallest gaussian radius keeping IoU >= min_overlap (CornerNet),
    elementwise."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 4 * 4 * c2, min=0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_gaussians(centers_xy, radii, valid, size_hw):
    """centers_xy (B, M, 2) in feature-map cells, radii (B, M), valid (B, M)
    -> (B, H, W): the max over the valid gts of exp(-d2 / (2 sigma^2)),
    sigma = (2r + 1) / 6, d2 the squared distance from the gt's floored
    centre, 0 outside d2 <= 2 (r + 1)^2. At the floored centre d2 is 0
    exactly, so the peak is exactly 1."""
    H, W = size_hw
    dev, dt = centers_xy.device, centers_xy.dtype
    ys = torch.arange(H, device=dev, dtype=dt)[:, None]
    xs = torch.arange(W, device=dev, dtype=dt)[None, :]
    cx = torch.floor(centers_xy[..., 0])[..., None, None]
    cy = torch.floor(centers_xy[..., 1])[..., None, None]
    r = radii[..., None, None]
    sigma = (2.0 * r + 1.0) / 6.0
    d2 = (xs - cx) ** 2 + (ys - cy) ** 2                     # (B, M, H, W)
    g = torch.exp(-d2 / (2.0 * sigma ** 2 + 1e-9))
    g = torch.where((d2 <= (r + 1.0) ** 2 * 2.0) & valid[..., None, None], g,
                    torch.zeros((), dtype=dt, device=dev))
    return g.amax(1)


def assign_center_targets(gt_boxes, gt_valid, class_ids, num_classes, point_cloud_range,
                          voxel_size, feature_map_stride, size_hw, gaussian_overlap=0.1,
                          min_radius=2, code_size=8):
    """CenterPoint targets. gt_boxes (B, M, 7+), gt_valid (B, M), class_ids
    (B, M) 1-based within the head's classes. Returns dict: heatmap
    (B, C, H, W), box_targets (B, M, 8): the centre's offset from its
    floored cell, z, log dims, sin and cos of the heading, then with
    code_size > 8 and boxes of 9 or more columns the velocity (vx, vy:
    columns 7 and 8; (B, M, 10)), zero outside the map; inds (B, M) int64,
    the flat map index of each gt's cell; mask (B, M), the valid gts whose
    centre lies on the map. The radius is the int-truncated gaussian_radius,
    at least min_radius."""
    H, W = size_hw
    vx = voxel_size[0] * feature_map_stride
    vy = voxel_size[1] * feature_map_stride
    cx = (gt_boxes[..., 0] - point_cloud_range[0]) / vx
    cy = (gt_boxes[..., 1] - point_cloud_range[1]) / vy
    in_map = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H) & gt_valid
    radius = gaussian_radius(gt_boxes[..., 4] / vy, gt_boxes[..., 3] / vx,
                             min_overlap=gaussian_overlap)
    radius = torch.clamp(radius.to(torch.int32), min=int(min_radius)).to(gt_boxes.dtype)
    centers = torch.stack([cx, cy], -1)
    heatmap = torch.stack([draw_gaussians(centers, radius, in_map & (class_ids == c + 1),
                                          size_hw) for c in range(num_classes)], 1)
    xi = torch.clamp(torch.floor(cx), 0, W - 1).to(torch.int64)
    yi = torch.clamp(torch.floor(cy), 0, H - 1).to(torch.int64)
    tgt = [(cx - xi.to(cx.dtype))[..., None], (cy - yi.to(cy.dtype))[..., None],
           gt_boxes[..., 2:3], torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-5)),
           torch.sin(gt_boxes[..., 6:7]), torch.cos(gt_boxes[..., 6:7])]
    if code_size > 8 and gt_boxes.shape[-1] >= 9:
        tgt.append(gt_boxes[..., 7:9])
    box_targets = torch.cat(tgt, -1)
    box_targets = torch.where(in_map[..., None], box_targets, torch.zeros_like(box_targets))
    return dict(heatmap=heatmap, box_targets=box_targets, inds=yi * W + xi, mask=in_map)


def decode_bbox_from_heatmap(heatmap, rot_cos, rot_sin, center, center_z, dim,
                             point_cloud_range, voxel_size, feature_map_stride, vel=None, K=100):
    """heatmap (B, C, H, W) sigmoid scores, the regression maps (B, c, H, W)
    -> boxes (B, k, 7), or (B, k, 9) with the velocity map `vel` (B, 2, H, W)
    read at each box's cell, scores (B, k), labels (B, k) int64 (0-based),
    the k = min(K, C H W) best scores of each scan, descending (an exact
    stable sort: ties go to the lower index, as `lax.top_k`); heading
    atan2(sin, cos)."""
    B, C, H, W = heatmap.shape
    k = min(int(K), C * H * W)
    scores, idx = torch.sort(heatmap.reshape(B, C * H * W), dim=1, descending=True,
                             stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    labels = idx // (H * W)
    pix = idx % (H * W)
    yi = (pix // W).to(heatmap.dtype)
    xi = (pix % W).to(heatmap.dtype)

    def take(m):
        flat = m.reshape(B, m.shape[1], H * W)
        return torch.gather(flat, 2, pix[:, None, :].expand(-1, m.shape[1], -1))

    off = take(center)
    angle = torch.atan2(take(rot_sin)[:, 0], take(rot_cos)[:, 0])
    xs = (xi + off[:, 0]) * feature_map_stride * voxel_size[0] + point_cloud_range[0]
    ys = (yi + off[:, 1]) * feature_map_stride * voxel_size[1] + point_cloud_range[1]
    parts = [xs[..., None], ys[..., None], take(center_z)[:, 0, :, None],
             torch.exp(take(dim)).transpose(1, 2), angle[..., None]]
    if vel is not None:
        parts.append(take(vel).transpose(1, 2))
    return torch.cat(parts, -1), scores, labels


def circle_nms(centers_xy, scores, valid, min_radius, post_max_size):
    """One scan's distance NMS over boxes in score order: a valid box is
    suppressed by a kept valid box before it whose centre lies closer than
    min_radius, the keep fixpoint of `iou3d.nms_bev`. centers_xy (n, 2),
    scores (n,), valid (n,). Returns (positions (p,), count, kept scores
    (p,)), p = min(post_max_size, n): the kept boxes by score (-inf past
    count)."""
    n = centers_xy.shape[0]
    d2 = ((centers_xy[:, None, :] - centers_xy[None, :, :]) ** 2).sum(-1)
    order = torch.arange(n, device=centers_xy.device)
    S = ((d2 < min_radius ** 2) & (order[:, None] < order[None, :])
         & valid[:, None] & valid[None, :])
    keep = _suppression_fixpoint(S, valid)
    kept_scores, pos = stable_top_k(
        torch.where(keep, scores, torch.full_like(scores, -float("inf"))),
        min(post_max_size, n))
    return pos, torch.clamp(keep.sum(), max=post_max_size), kept_scores
