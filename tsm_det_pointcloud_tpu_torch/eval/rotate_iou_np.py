"""Rotated 2D IoU on the host (counterpart of
tsm_det_pointcloud_tpu/eval/rotate_iou_np.py), for the offline KITTI eval.

`rotate_iou_np` runs the host library (ops/host_native.py,
csrc/host_ops.cpp); `_rotate_iou_numpy` is its plain version: convex quad
intersection by Sutherland-Hodgman clipping as fixed-iteration array ops over
the (N, M) pair grid. Boxes are (cx, cy, w, h, angle); the intersection of
two convex quads has at most 8 vertices, clipped in a 16-slot buffer.
"""
from __future__ import annotations

import numpy as np

_SLOTS = 16


def _corners(boxes):
    """(N, 5) -> (N, 4, 2) corners, CCW."""
    cx, cy, w, h, a = (boxes[:, i] for i in range(5))
    dx = np.stack([w, w, -w, -w], 1) / 2
    dy = np.stack([-h, h, h, -h], 1) / 2
    cos, sin = np.cos(a)[:, None], np.sin(a)[:, None]
    x = cx[:, None] + dx * cos - dy * sin
    y = cy[:, None] + dx * sin + dy * cos
    return np.stack([x, y], -1)


def _poly_area(pts, cnt):
    """Shoelace over the first cnt vertices of each (P, S, 2) buffer."""
    P, S, _ = pts.shape
    idx = np.arange(S)
    valid = idx[None, :] < cnt[:, None]
    nxt = (idx[None, :] + 1) % np.maximum(cnt, 1)[:, None]
    x, y = pts[..., 0], pts[..., 1]
    xn = np.take_along_axis(x, nxt, 1)
    yn = np.take_along_axis(y, nxt, 1)
    cross = x * yn - xn * y
    return 0.5 * np.abs(np.where(valid, cross, 0.0).sum(1))


def _clip_edge(poly, cnt, a, b):
    """Clip each polygon in (P, S, 2)/cnt by half-plane left-of edge a->b
    ((P, 2) each). Returns new (poly, cnt)."""
    P, S, _ = poly.shape
    e = b - a  # (P, 2)
    idx = np.arange(S)
    valid = idx[None, :] < cnt[:, None]
    rel = poly - a[:, None, :]
    side = e[:, None, 0] * rel[..., 1] - e[:, None, 1] * rel[..., 0]  # >0 inside
    inside = (side >= -1e-9) & valid

    nxt = (idx[None, :] + 1) % np.maximum(cnt, 1)[:, None]
    nxt_inside = np.take_along_axis(inside, nxt, 1)
    nxt_side = np.take_along_axis(side, nxt, 1)
    nxt_poly = np.stack(
        [np.take_along_axis(poly[..., 0], nxt, 1),
         np.take_along_axis(poly[..., 1], nxt, 1)], -1
    )

    denom = side - nxt_side
    t = np.where(np.abs(denom) > 1e-12, side / np.where(denom == 0, 1, denom), 0.0)
    inter = poly + (nxt_poly - poly) * t[..., None]

    # each input vertex emits: itself (if inside) then the crossing point
    # (if the edge to the next vertex crosses the boundary)
    emit_self = inside & valid
    emit_cross = (inside != nxt_inside) & valid
    n_emit = emit_self.astype(np.int32) + emit_cross.astype(np.int32)
    offs = np.cumsum(n_emit, 1) - n_emit  # start slot per vertex

    out = np.zeros((P, _SLOTS, 2), poly.dtype)
    new_cnt = n_emit.sum(1)

    pslot = np.where(emit_self, offs, _SLOTS - 1)
    np.put_along_axis(
        out[..., 0], pslot, np.where(emit_self, poly[..., 0], 0.0), 1
    )
    np.put_along_axis(
        out[..., 1], pslot, np.where(emit_self, poly[..., 1], 0.0), 1
    )
    cslot = np.where(emit_cross, offs + emit_self.astype(np.int32), _SLOTS - 1)
    # crossing writes may collide with the last pad slot only
    ox = out[..., 0]
    oy = out[..., 1]
    np.put_along_axis(ox, cslot, np.where(emit_cross, inter[..., 0], ox[np.arange(P)[:, None], cslot]), 1)
    np.put_along_axis(oy, cslot, np.where(emit_cross, inter[..., 1], oy[np.arange(P)[:, None], cslot]), 1)
    out = np.stack([ox, oy], -1)
    return out, np.minimum(new_cnt, _SLOTS - 1)


def rotate_iou_np(boxes_a, boxes_b, criterion=-1):
    """Pairwise rotated IoU. boxes (N, 5)/(M, 5) = (cx, cy, w, h, angle).

    criterion: -1 IoU, 0 intersection/area_a, 1 intersection/area_b
    (the reference's extra modes used for DontCare suppression).

    criterion None gives the raw intersection area. Runs the host library
    (ops/host_native.py); `_rotate_iou_numpy` is its plain version.
    """
    N, M = len(boxes_a), len(boxes_b)
    if N == 0 or M == 0:
        return np.zeros((N, M), np.float32)
    from ..ops import host_native

    return host_native.rotate_iou(np.asarray(boxes_a), np.asarray(boxes_b), criterion)


def _rotate_iou_numpy(boxes_a, boxes_b, criterion=-1):
    N, M = len(boxes_a), len(boxes_b)
    ca = _corners(boxes_a.astype(np.float64))   # (N, 4, 2)
    cb = _corners(boxes_b.astype(np.float64))   # (M, 4, 2)
    area_a = (boxes_a[:, 2] * boxes_a[:, 3]).astype(np.float64)
    area_b = (boxes_b[:, 2] * boxes_b[:, 3]).astype(np.float64)

    P = N * M
    poly = np.zeros((P, _SLOTS, 2))
    poly[:, :4] = np.broadcast_to(ca[:, None], (N, M, 4, 2)).reshape(P, 4, 2)
    cnt = np.full((P,), 4, np.int64)
    clip = np.broadcast_to(cb[None], (N, M, 4, 2)).reshape(P, 4, 2)

    for e in range(4):
        a = clip[:, e]
        b = clip[:, (e + 1) % 4]
        poly, cnt = _clip_edge(poly, cnt, a, b)

    inter = _poly_area(poly, cnt)
    inter = inter.reshape(N, M)
    if criterion is None:  # raw intersection area (3D IoU building block)
        return inter.astype(np.float32)
    if criterion == -1:
        denom = area_a[:, None] + area_b[None, :] - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a[:, None], (N, M))
    else:
        denom = np.broadcast_to(area_b[None, :], (N, M))
    return (inter / np.maximum(denom, 1e-9)).astype(np.float32)
