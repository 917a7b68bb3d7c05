"""Rotated BEV IoU and NMS.

Counterpart of tsm_det_pointcloud_tpu/ops/iou3d.py: the intersection area of
two convex quads is a boundary integral (each edge of A clipped to B plus
each edge of B clipped to A), pure elementwise math on the (N, M) pair
grid. `nms_normal` and `suppression_matrix(rotated=False)` are the
axis-aligned forms: each box becomes x +- dx/2, y +- dy/2 with the heading
ignored, and the IoU is the product of the two overlaps over the union.
Two NMS routes, as in the JAX package: `nms_bev` / `nms_normal` take the
top `pre_maxsize` boxes first and compare only their k x k pairs
(class-agnostic NMS over SECOND's 211,200 anchors a scan); the
suppression-matrix route builds the N x N grid once and replays keep
fixpoints on it (`multi_thresh_nms`, whose passes share one set of boxes).
Top-k selections are stable sorts, so ties go to the lower index, as
`jax.lax.top_k`.
"""
from __future__ import annotations

import torch

from .boxes import boxes_to_corners_bev

# iterations of the keep fixpoint (`_suppression_fixpoint`) since the last
# reset: each ends in one host sync (`infer.profile_call` reads it)
FIXPOINT_ITERS = [0]


def stable_top_k(x, k):
    """(N,) -> (values (k,), int64 indices (k,)), descending; ties keep the
    lower index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _pair_intersection_area_grid(ca, cb):
    """ca (N, 4, 2), cb (M, 4, 2) -> (N, M) intersection areas. Colinear
    shared edges count once: the A-in-B pass uses h <= +eps, the B-in-A
    pass h <= -eps."""
    eps = 1e-7

    def directed_sum(src, dst, src_rows, strict):
        if src_rows:
            s_take = lambda v: v[:, None]
            d_take = lambda v: v[None, :]
        else:
            s_take = lambda v: v[None, :]
            d_take = lambda v: v[:, None]
        thr = -eps if strict else eps
        total = 0.0
        for i in range(4):
            px, py = s_take(src[:, i, 0]), s_take(src[:, i, 1])
            qx, qy = s_take(src[:, (i + 1) % 4, 0]), s_take(src[:, (i + 1) % 4, 1])
            dx, dy = qx - px, qy - py
            t_lo = torch.zeros_like(px + d_take(dst[:, 0, 0]) * 0)
            t_hi = torch.ones_like(t_lo)
            ok = torch.ones_like(t_lo, dtype=torch.bool)
            for k in range(4):
                e1x, e1y = d_take(dst[:, k, 0]), d_take(dst[:, k, 1])
                e2x, e2y = d_take(dst[:, (k + 1) % 4, 0]), d_take(dst[:, (k + 1) % 4, 1])
                ex, ey = e2x - e1x, e2y - e1y
                h0 = ex * (py - e1y) - ey * (px - e1x)
                sh = ex * dy - ey * dx
                small = sh.abs() < 1e-12
                t_bound = (thr - h0) / torch.where(small, torch.full_like(sh, 1e-12), sh)
                t_hi = torch.where(sh > 0, torch.minimum(t_hi, t_bound), t_hi)
                t_lo = torch.where(sh < 0, torch.maximum(t_lo, t_bound), t_lo)
                ok = ok & torch.where(sh.abs() <= 1e-12, h0 <= thr,
                                      torch.ones_like(ok))
            valid = ok & (t_hi > t_lo)
            sx, sy = px + t_lo * dx, py + t_lo * dy
            ex_, ey_ = px + t_hi * dx, py + t_hi * dy
            contrib = 0.5 * (sx * ey_ - ex_ * sy)
            total = total + torch.where(valid, contrib, torch.zeros_like(contrib))
        return total

    total = directed_sum(ca, cb, True, False) + directed_sum(cb, ca, False, True)
    return total.abs()


def boxes_iou_bev(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) rotated BEV IoU."""
    overlap = _pair_intersection_area_grid(boxes_to_corners_bev(boxes_a),
                                           boxes_to_corners_bev(boxes_b))
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-6)


def boxes_iou3d(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) 3D IoU: rotated BEV overlap times height
    overlap over the volume union (JAX ops/iou3d.py:108)."""
    overlap_bev = _pair_intersection_area_grid(boxes_to_corners_bev(boxes_a),
                                               boxes_to_corners_bev(boxes_b))
    a_max = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    a_min = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    b_max = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    b_min = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    overlap_h = torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min),
                            min=0.0)
    inter = overlap_bev * overlap_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / torch.clamp(vol_a + vol_b - inter, min=1e-6)


def _aabb(boxes):
    """(N, 7+) -> (N, 4) BEV extents (x0, y0, x1, y1), the heading ignored."""
    return torch.cat([boxes[:, 0:2] - boxes[:, 3:5] / 2,
                      boxes[:, 0:2] + boxes[:, 3:5] / 2], -1)


def _iou_grid(boxes, rotated):
    """(N, 7+) -> (N, N) BEV IoU of every pair (JAX `_iou_grid_fn`):
    rotated quads, or axis-aligned extents."""
    areas = boxes[:, 3] * boxes[:, 4]
    if rotated:
        geom = boxes_to_corners_bev(boxes)
        inter = _pair_intersection_area_grid(geom, geom)
    else:
        geom = _aabb(boxes)
        inter = torch.clamp(torch.minimum(geom[:, None, 2:], geom[None, :, 2:])
                            - torch.maximum(geom[:, None, :2], geom[None, :, :2]),
                            min=0.0).prod(-1)
    return inter / torch.clamp(areas[:, None] + areas[None, :] - inter, min=1e-6)


def suppression_matrix(boxes, thresh, rotated=True):
    """(N, 7) boxes -> (N, N) bool: IoU(i, j) > thresh, original order;
    rotated (nms_gpu) or axis-aligned (nms_normal)."""
    return _iou_grid(boxes, rotated) > thresh


def _suppression_fixpoint(S, valid):
    """keep <- valid & ~any_j(S[j, i] & keep[j]) iterated to its fixpoint,
    which equals greedy NMS in rank order."""
    keep = valid
    while True:
        FIXPOINT_ITERS[0] += 1
        suppressed = (S & keep[:, None]).any(dim=0)
        new = valid & ~suppressed
        if torch.equal(new, keep):
            return keep
        keep = new


def _keep_from_matrix(s_mat, scores, pre_maxsize, post_maxsize):
    """Greedy-NMS keep mask in original order from a suppression matrix.
    Returns (keep (N,), top_scores (k,), order (k,))."""
    n = scores.shape[0]
    k = min(pre_maxsize, n)
    top_scores, order = stable_top_k(scores, k)
    rank = torch.full((n,), n, dtype=torch.int64, device=scores.device)
    rank[order] = torch.arange(k, device=scores.device)
    valid = torch.isfinite(scores) & (rank < k)
    S = (s_mat & (rank[:, None] < rank[None, :])
         & valid[:, None] & valid[None, :])
    keep = _suppression_fixpoint(S, valid)
    if post_maxsize < k:
        kk = keep[order]
        kk = kk & (torch.cumsum(kk.to(torch.int32), 0) <= post_maxsize)
        keep = torch.zeros((n,), dtype=torch.bool, device=scores.device)
        keep[order] = kk
    return keep, top_scores, order


def _select_kept(order, top_scores, keep, post_maxsize):
    """Compact kept indices into a fixed (post,) buffer in score order."""
    k = order.shape[0]
    masked = torch.where(keep, top_scores, torch.full_like(top_scores, -float("inf")))
    post = min(post_maxsize, k)
    kept_scores, kept_pos = stable_top_k(masked, post)
    keep_idx = order[kept_pos]
    keep_count = torch.clamp(keep.sum(), max=post)
    return keep_idx, keep_count, kept_scores


def _nms_top_k(boxes, scores, thresh, pre_maxsize, post_maxsize, score_thresh,
               rotated):
    """NMS over the top `pre_maxsize` scores: the k x k suppression grid of
    the score-sorted boxes, the keep fixpoint, fixed-size outputs."""
    n = scores.shape[0]
    k = min(pre_maxsize, n)
    top_scores, order = stable_top_k(scores, k)
    floor = -float("inf") if score_thresh is None else score_thresh
    valid = torch.isfinite(top_scores) & (top_scores > floor)
    rank = torch.arange(k, device=scores.device)
    S = ((_iou_grid(boxes[order], rotated) > thresh) & (rank[:, None] < rank[None, :])
         & valid[:, None] & valid[None, :])
    keep = _suppression_fixpoint(S, valid)
    return _select_kept(order, top_scores, keep, post_maxsize)


def nms_bev(boxes, scores, thresh, pre_maxsize=4096, post_maxsize=512,
            score_thresh=None):
    """Rotated BEV NMS (JAX ops/iou3d.py:227-244). Returns (keep_idx (post,),
    keep_count, kept scores (post,))."""
    return _nms_top_k(boxes, scores, thresh, pre_maxsize, post_maxsize, score_thresh,
                      rotated=True)


def nms_normal(boxes, scores, thresh, pre_maxsize=4096, post_maxsize=512,
               score_thresh=None):
    """Axis-aligned BEV NMS, the heading ignored (JAX ops/iou3d.py:247-262);
    `nms_bev`'s outputs."""
    return _nms_top_k(boxes, scores, thresh, pre_maxsize, post_maxsize, score_thresh,
                      rotated=False)


def nms_from_matrix(s_mat, scores, pre_maxsize=4096, post_maxsize=512):
    keep, top_scores, order = _keep_from_matrix(s_mat, scores, pre_maxsize,
                                                post_maxsize)
    return _select_kept(order, top_scores, keep[order], post_maxsize)


def nms_keep_mask_from_matrix(s_mat, scores, pre_maxsize=4096,
                              post_maxsize=512):
    keep, _, _ = _keep_from_matrix(s_mat, scores, pre_maxsize, post_maxsize)
    return keep
