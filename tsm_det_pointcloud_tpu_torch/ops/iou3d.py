"""Rotated BEV IoU and NMS.

Counterpart of tsm_det_pointcloud_tpu/ops/iou3d.py: the intersection area of
two convex quads is a boundary integral (each edge of A clipped to B plus
each edge of B clipped to A), pure elementwise math on the (N, M) pair
grid. Two NMS routes, as in the JAX package: `nms_bev` takes the top
`pre_maxsize` boxes first and clips only their k x k pairs (class-agnostic
NMS over SECOND's 211,200 anchors a scan); the suppression-matrix route
builds the N x N grid once and replays keep fixpoints on it
(`multi_thresh_nms`, whose passes share one set of boxes). Top-k selections
are stable sorts, so ties go to the lower index, as `jax.lax.top_k`.
"""
from __future__ import annotations

import torch

from .boxes import boxes_to_corners_bev


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


def suppression_matrix(boxes, thresh, rotated=True):
    """(N, 7) boxes -> (N, N) bool: IoU(i, j) > thresh, original order."""
    if not rotated:
        raise NotImplementedError("only the rotated (nms_gpu) route is ported")
    areas = boxes[:, 3] * boxes[:, 4]
    geom = boxes_to_corners_bev(boxes)
    inter = _pair_intersection_area_grid(geom, geom)
    iou = inter / torch.clamp(areas[:, None] + areas[None, :] - inter, min=1e-6)
    return iou > thresh


def _suppression_fixpoint(S, valid):
    """keep <- valid & ~any_j(S[j, i] & keep[j]) iterated to its fixpoint,
    which equals greedy NMS in rank order."""
    keep = valid
    while True:
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


def nms_bev(boxes, scores, thresh, pre_maxsize=4096, post_maxsize=512,
            score_thresh=None):
    """Rotated BEV NMS over the top `pre_maxsize` scores (JAX
    ops/iou3d.py:227-244): the k x k suppression grid of the score-sorted
    boxes, the keep fixpoint, fixed-size outputs. Returns (keep_idx (post,),
    keep_count, kept scores (post,))."""
    n = scores.shape[0]
    k = min(pre_maxsize, n)
    top_scores, order = stable_top_k(scores, k)
    boxes_s = boxes[order]
    floor = -float("inf") if score_thresh is None else score_thresh
    valid = torch.isfinite(top_scores) & (top_scores > floor)
    areas = boxes_s[:, 3] * boxes_s[:, 4]
    corners = boxes_to_corners_bev(boxes_s)
    inter = _pair_intersection_area_grid(corners, corners)
    iou = inter / torch.clamp(areas[:, None] + areas[None, :] - inter, min=1e-6)
    rank = torch.arange(k, device=scores.device)
    S = ((iou > thresh) & (rank[:, None] < rank[None, :])
         & valid[:, None] & valid[None, :])
    keep = _suppression_fixpoint(S, valid)
    return _select_kept(order, top_scores, keep, post_maxsize)


def nms_from_matrix(s_mat, scores, pre_maxsize=4096, post_maxsize=512):
    keep, top_scores, order = _keep_from_matrix(s_mat, scores, pre_maxsize,
                                                post_maxsize)
    return _select_kept(order, top_scores, keep[order], post_maxsize)


def nms_keep_mask_from_matrix(s_mat, scores, pre_maxsize=4096,
                              post_maxsize=512):
    keep, _, _ = _keep_from_matrix(s_mat, scores, pre_maxsize, post_maxsize)
    return keep
