"""Neighbourhood query + grouping: nearest-k ball / annulus / window queries.

Counterpart of tsm_det_pointcloud_tpu/ops/grouping.py (`ball_query_multi`
:102-151, `group_points` :226-235) and of the query half of ops/voxel.py's
`voxel_query`. Semantics, per query and scale:

  * a source is a hit when it is valid, `d2 < max_r**2`, `d2 >= min_r**2`
    when `min_r > 0`, and, for window queries, `|coord_q - coord_src| <= qr`
    per axis;
  * `cnt` is the exact, uncapped number of hits;
  * `idx` holds the `ns` nearest hits ordered by (d2, index) — ties go to
    the lower index, as `jax.lax.top_k`; unfilled slots repeat the first
    hit, or 0 when there is none. Callers mask slots with `slot < cnt`;
  * d2 is the expanded form `max((|q|^2 + |x|^2) - 2 q.x, 0)`, each term
    summed x, y, z in order, and the cross term is elementwise, not a
    matmul, so the plain version and kernel K2 agree at radius boundaries.

On a CUDA tensor `query_group` launches kernel K2 (csrc/group.cu, replacing
the Pallas `_kernel` of ops/group_pallas.py:108), which also gathers the
payload rows (xyz and features, exact f32) of the chosen slots.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _kernels

_INF_BITS = 0x7F800000


def _r2(r):
    """float32 of float(r)**2 — the threshold the reference compares."""
    return float(np.float32(float(r) ** 2))


def _sq_norm(p):
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]


def _norm_scales(scales):
    out = []
    for s in scales:
        mn, mx, ns = float(s[0]), float(s[1]), int(s[2])
        qr = tuple(int(v) for v in s[3]) if len(s) > 3 and s[3] is not None else None
        out.append((mn, mx, ns, qr))
    return out


def query_group_plain(src_xyz, src_valid, q_xyz, scales, payload=None,
                      src_coords=None, q_coords=None):
    """Plain PyTorch version of K2 (same contract as `query_group`)."""
    scales = _norm_scales(scales)
    B, N, _ = src_xyz.shape
    M = q_xyz.shape[1]
    dev = src_xyz.device
    x2 = _sq_norm(src_xyz)                                     # (B, N)
    q2 = _sq_norm(q_xyz)                                       # (B, M)
    lanes = torch.arange(N, device=dev, dtype=torch.int64)
    n_pad = max(0, max(ns for _, _, ns, _ in scales) - N)
    chunk = max(1, min(M, (1 << 25) // max(1, B * N)))
    idx_parts = [[] for _ in scales]
    cnt_parts = [[] for _ in scales]
    for m0 in range(0, M, chunk):
        qc = q_xyz[:, m0:m0 + chunk]
        cross = (qc[..., 0:1] * src_xyz[:, None, :, 0]
                 + qc[..., 1:2] * src_xyz[:, None, :, 1]) \
            + qc[..., 2:3] * src_xyz[:, None, :, 2]
        d2 = (q2[:, m0:m0 + chunk, None] + x2[:, None, :]) - 2.0 * cross
        d2 = torch.where(d2 > 0, d2, torch.zeros_like(d2))
        base = src_valid[:, None, :].expand_as(d2)
        dc = None
        if src_coords is not None and q_coords is not None:
            dc = (q_coords[:, m0:m0 + chunk, None, :].long()
                  - src_coords[:, None, :, :].long()).abs()
        # composite (d2 bits, index) keys: d2 >= +0 orders like its bits,
        # and the index makes every key unique, so top-k has no ties
        dbits = d2.contiguous().view(torch.int32).to(torch.int64) << 32
        for si, (mn, mx, ns, qr) in enumerate(scales):
            hit = base & (d2 < _r2(mx))
            if mn > 0:
                hit = hit & (d2 >= _r2(mn))
            if qr is not None:
                hit = hit & (dc[..., 0] <= qr[0]) & (dc[..., 1] <= qr[1]) \
                    & (dc[..., 2] <= qr[2])
            key = torch.where(hit, dbits, torch.full_like(dbits, _INF_BITS << 32)) | lanes
            if n_pad:
                pad = (torch.full(key.shape[:-1] + (n_pad,), 0x7FFFFFFF << 32,
                                  dtype=torch.int64, device=dev)
                       | torch.arange(N, N + n_pad, device=dev))
                key = torch.cat([key, pad], -1)
            top = torch.topk(key, ns, dim=-1, largest=False, sorted=True).values
            top_idx = (top & 0xFFFFFFFF).to(torch.int32)
            cnt = hit.sum(-1, dtype=torch.int32)
            slot = torch.arange(ns, device=dev)
            filled = slot < cnt[..., None]
            idx = torch.where(filled, top_idx, top_idx[..., :1])
            idx_parts[si].append(idx)
            cnt_parts[si].append(cnt)
    out = []
    for si in range(len(scales)):
        idx = torch.cat(idx_parts[si], 1)
        cnt = torch.cat(cnt_parts[si], 1)
        grouped = group_points(payload, idx) if payload is not None else None
        out.append((idx, cnt, grouped))
    return out


def _query_group_kernel(src_xyz, src_valid, q_xyz, scales, payload,
                        src_coords, q_coords):
    scales = _norm_scales(scales)
    if not 1 <= len(scales) <= 4:
        raise ValueError("K2 takes 1 to 4 scales per call")
    if any(not 1 <= ns <= 32 for _, _, ns, _ in scales):
        raise ValueError("K2 takes nsample in [1, 32]")
    window = any(qr is not None for *_, qr in scales)
    if window and (src_coords is None or q_coords is None):
        raise ValueError("window queries need src_coords and q_coords")
    B, N = src_xyz.shape[:2]
    M = q_xyz.shape[1]
    _kernels.check_shape(src_xyz, (B, N, 3), "query_group src_xyz")
    _kernels.check_shape(src_valid, (B, N), "query_group src_valid")
    _kernels.check_shape(q_xyz, (B, M, 3), "query_group q_xyz")
    _kernels.check_shape(payload, (B, N, None), "query_group payload")
    if window:
        _kernels.check_shape(src_coords, (B, N, 3), "query_group src_coords")
        _kernels.check_shape(q_coords, (B, M, 3), "query_group q_coords")
    src_xyz = src_xyz.contiguous().float()
    q_xyz = q_xyz.contiguous().float()
    src_valid = src_valid.contiguous().to(torch.uint8)
    sc_c = q_c = None
    if window:
        sc_c = src_coords.contiguous().to(torch.int32)
        q_c = q_coords.contiguous().to(torch.int32)
    pl = None if payload is None else payload.contiguous().float()
    _kernels.require_cuda(src_xyz, src_valid, q_xyz, sc_c, q_c, pl)
    D = 0 if pl is None else pl.shape[-1]

    sc = _kernels.GroupScales()
    sc.n_scales = len(scales)
    sc.use_window = int(window)
    off = 0
    for i, (mn, mx, ns, qr) in enumerate(scales):
        sc.ns[i] = ns
        sc.offset[i] = off
        sc.has_min[i] = int(mn > 0)
        sc.min_r2[i] = _r2(mn)
        sc.max_r2[i] = _r2(mx)
        big = 1 << 30
        q3 = qr if qr is not None else (big, big, big)
        for a in range(3):
            sc.qr[i][a] = int(q3[a])
        off += ns
    total = off
    dev = src_xyz.device
    idx = torch.empty((B, M, total), dtype=torch.int32, device=dev)
    cnt = torch.empty((B, M, len(scales)), dtype=torch.int32, device=dev)
    grouped = (torch.empty((B, M, total, D), dtype=torch.float32, device=dev)
               if pl is not None else None)
    fn = _kernels.func("query_group")
    err = fn(src_xyz.data_ptr(), src_valid.data_ptr(), _kernels.ptr(sc_c),
             _kernels.ptr(pl), B, N, D, q_xyz.data_ptr(), _kernels.ptr(q_c),
             M, sc, total, idx.data_ptr(), cnt.data_ptr(),
             _kernels.ptr(grouped), _kernels.stream_ptr(dev))
    _kernels.check(err, "query_group")
    _kernels.count("query_group")
    out = []
    for i, (_, _, ns, _) in enumerate(scales):
        o = sc.offset[i]
        out.append((idx[..., o:o + ns], cnt[..., i],
                    grouped[:, :, o:o + ns] if grouped is not None else None))
    return out


def query_group(src_xyz, src_valid, q_xyz, scales, payload=None,
                src_coords=None, q_coords=None):
    """Multi-scale nearest-k query + gather in one pass over the sources.

    src_xyz (B, N, 3), src_valid (B, N) bool, q_xyz (B, M, 3); scales: a
    sequence of (min_r, max_r, ns) or (min_r, max_r, ns, query_range);
    payload (B, N, D) rows to gather (or None); src_coords / q_coords
    (B, ·, 3) int voxel coords for window queries. Returns one
    (idx (B, M, ns) int32, cnt (B, M) int32, grouped (B, M, ns, D) or None)
    per scale."""
    if src_xyz.is_cuda:
        return _query_group_kernel(src_xyz, src_valid, q_xyz, scales, payload,
                                   src_coords, q_coords)
    return query_group_plain(src_xyz, src_valid, q_xyz, scales, payload,
                             src_coords, q_coords)


def ball_query_multi(radius_pairs, nsamples, xyz, new_xyz, valid_mask=None):
    """Multi-scale (dilated) ball query. radius_pairs: (min_r, max_r) per
    scale. Returns a list of (idx (B, M, ns), cnt (B, M))."""
    B, N, _ = xyz.shape
    valid = valid_mask if valid_mask is not None else torch.ones(
        (B, N), dtype=torch.bool, device=xyz.device)
    scales = [(mn, mx, ns) for (mn, mx), ns in zip(radius_pairs, nsamples)]
    return [(i, c) for i, c, _ in query_group(xyz, valid, new_xyz, scales)]


def group_points(features, idx):
    """features (B, N, C), idx (B, M, ns) -> (B, M, ns, C)."""
    B, N, C = features.shape
    _, M, ns = idx.shape
    flat = torch.gather(features, 1,
                        idx.reshape(B, M * ns, 1).long().expand(-1, -1, C))
    return flat.reshape(B, M, ns, C)
