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
payload rows (xyz and features, exact f32) of the chosen slots. K2 takes 1-4
scales of 1-64 samples a call: a call whose scales take at most 32 launches
its one-entry-a-lane kernel, one with a scale of 33-64 (3DSSD's widest
balls) its two-entry kernel (counted as "query_group_wide"). K2 visits
only the sources that can be hit, as the Pallas kernel does. Its prep is
PyTorch, on any device: `tile_sources` Morton-sorts each scan's sources
into tiles of `GROUP_TILE` rows with per-tile boxes (xyz of the valid rows,
their voxel coordinates, their largest |x|^2), by the sort and boxes K6's
blocks use (`sampling.morton_tiles`, `sampling.tile_boxes`), and
`query_order` Morton-sorts the queries. A thread block of `GROUP_QBLOCK`
consecutive sorted queries then visits only the tiles within reach of its
query box, by `_visit_rule` plus a rounding margin that provably keeps
every hit (derived in csrc/group.cu), and orders its candidates by (d2,
original index), so the result equals `query_group_plain`'s. K2 calls on
the same sources share their tiles through a `TileCache`.
`query_group_pruned_plain` is that route in PyTorch (visit rule, then
nearest-k over the visited pairs), the kernel's CPU twin with the same
visit counts. The gathered payload is differentiable (`_GroupPayload`);
the kernel output alone has no `grad_fn`.

Also the JAX module's XLA helpers of PointRCNN, plain PyTorch on any
device: `first_k_true` (the RoI-point pool's first k hits of a row),
`three_nn`, `three_interpolate_weights` and `three_interpolate` (the
feature propagation's inverse-distance 3-NN interpolation).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _kernels
from .sampling import morton_code, morton_tiles, pad_rows, tile_boxes

_INF_BITS = 0x7F800000
GROUP_TILE = 256       # sources per Morton tile: kTile of csrc/group.cu
GROUP_QBLOCK = 8       # sorted queries per K2 thread block: its kWarps
GROUP_MAX_NSAMPLE = 64  # K2's largest nsample: 32 * its kMaxSlots
_MARGIN_SCALE = 2.0 ** -19   # the pruning margin's factor: its kMarginScale
_EMPTY = 1e30          # box of an all-invalid tile: never within reach
_EMPTY_COORD = 1 << 29


def _r2(r):
    """float32 of float(r)**2 — the threshold the reference compares."""
    return float(np.float32(float(r) ** 2))


def _sq_norm(p):
    """((x*x + y*y) + z*z), each operation rounded, in three launches."""
    s = p * p
    return (s[..., 0] + s[..., 1]) + s[..., 2]


def _norm_scales(scales):
    out = []
    for s in scales:
        mn, mx, ns = float(s[0]), float(s[1]), int(s[2])
        qr = tuple(int(v) for v in s[3]) if len(s) > 3 and s[3] is not None else None
        out.append((mn, mx, ns, qr))
    return out


def query_group_plain(src_xyz, src_valid, q_xyz, scales, payload=None,
                      src_coords=None, q_coords=None):
    """Plain PyTorch version of K2. Returns the scales side by side, as
    the kernel fills them: idx (B, M, T) int32 with T the sum of the ns,
    cnt (B, M, S) int32 and grouped (B, M, T, D) or None."""
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
    idx = torch.cat([torch.cat(p, 1) for p in idx_parts], -1)
    cnt = torch.stack([torch.cat(p, 1) for p in cnt_parts], -1)
    grouped = group_points(payload, idx) if payload is not None else None
    return idx, cnt, grouped


class SourceTiles(NamedTuple):
    """A batch of scans' sources prepared for K2. P = NT * GROUP_TILE is N
    rounded up to whole tiles; rows are in Morton order, invalid rows last;
    the pad and invalid rows carry index -1 and no meaning else."""
    pts: torch.Tensor     # (B, P, 4) f32 x, y, z, |x|^2
    oi: torch.Tensor      # (B, P) i32 original row, -1 on invalid and pad rows
    crd: torch.Tensor     # (B, P, 4) i32 voxel coords (zyx, 0), or None
    tbox: torch.Tensor    # (B, NT, 8) f32 lo xyz, hi xyz, max |x|^2, - of the valid rows
    cbox: torch.Tensor    # (B, NT, 8) i32 lo zyx, hi zyx, -, - of the valid rows, or None


class GroupPrep(NamedTuple):
    """What one K2 launch reads: the fields of a SourceTiles and the Morton
    order of the call's queries."""
    pts: torch.Tensor
    oi: torch.Tensor
    crd: torch.Tensor
    tbox: torch.Tensor
    cbox: torch.Tensor
    qperm: torch.Tensor   # (B, M) i32 Morton order of the queries: sorted position -> row


def _box8(lo, hi):
    """(lo, hi) (B, NT, 4) -> (B, NT, 8): lo of columns 0-2, hi of all four
    (column 3 is the fourth value's largest), then lo of column 3."""
    return torch.cat([lo[..., :3], hi, lo[..., 3:]], -1)


def tile_sources(src_xyz, src_valid, src_coords=None):
    """Morton tiles of each scan's sources and the boxes of their valid rows:
    the counterpart of ops/group_pallas.py's `prepare_sources` (:604) with
    f32 xyz and integer indices, by the sort K6's blocks use
    (`sampling.morton_tiles`). Runs wherever the inputs lie. An all-invalid
    tile gets an empty box (lo 1e30, hi -1e30), so it is never visited."""
    xyz = src_xyz.detach().float()
    order, live = morton_tiles(xyz, src_valid.bool(), GROUP_TILE)
    rows = pad_rows(order, GROUP_TILE, 0)[..., None]     # pad rows read row 0, index -1
    pts = torch.gather(torch.cat([xyz, _sq_norm(xyz)[..., None]], -1), 1,
                       rows.expand(-1, -1, 4))
    oi = rows[..., 0].to(torch.int32).masked_fill_(~live, -1)
    tbox = _box8(*tile_boxes(pts, live, GROUP_TILE, _EMPTY))
    crd = cbox = None
    if src_coords is not None:
        crd = torch.nn.functional.pad(
            torch.gather(src_coords.to(torch.int32), 1, rows.expand(-1, -1, 3)), (0, 1))
        cbox = _box8(*tile_boxes(crd, live, GROUP_TILE, _EMPTY_COORD))
    return SourceTiles(pts, oi, crd, tbox, cbox)


def query_order(q_xyz):
    """(B, M, 3) -> (B, M) i32: each scan's queries in stable Morton order,
    so that a K2 thread block's queries are spatially compact."""
    q = q_xyz.detach().float()
    code = morton_code(q, q.amin(1, keepdim=True))
    return torch.sort(code, dim=1, stable=True).indices.to(torch.int32)


def group_prep(src_xyz, src_valid, q_xyz, src_coords=None):
    """`tile_sources` and `query_order` in one GroupPrep."""
    return GroupPrep(*tile_sources(src_xyz, src_valid, src_coords), query_order(q_xyz))


class TileCache:
    """K2's prepared sources, kept for the next K2 calls on the same source
    tensors. In a TSM forward the teacher's SA layer 1, `s_sa1` and both
    heads' VSA queries all query SA layer 0's voxel centroids: one cache
    passed to them tiles those sources once. A call whose sources are other
    tensors (by identity), or were written since (by version), tiles them
    anew. Used on the card only; the plain version takes no tiles."""

    def __init__(self):
        self._srcs = ()
        self._versions = ()
        self._tiles = None

    def get(self, src_xyz, src_valid, src_coords=None):
        srcs = (src_xyz, src_valid, src_coords)
        versions = tuple(None if t is None else t._version for t in srcs)
        if (len(self._srcs) != 3 or any(a is not b for a, b in zip(srcs, self._srcs))
                or versions != self._versions):
            self._tiles = tile_sources(src_xyz, src_valid, src_coords)
            self._srcs, self._versions = srcs, versions
        return self._tiles


def _reach(scales):
    """The call's largest max_r**2 (f32) and, per axis, its largest query
    window (None without window queries)."""
    r2 = max(_r2(mx) for _, mx, _, _ in scales)
    qrs = [qr for *_, qr in scales]
    if all(qr is None for qr in qrs):
        return r2, None
    big = 1 << 30
    return r2, tuple(max(big if qr is None else int(qr[a]) for qr in qrs) for a in range(3))


def _within_reach(tb, qlo, qhi, q2max, r2):
    """K2's tile test (csrc/group.cu `within_reach`), the same f32
    operations in the same order: gap2 <= r2 + 2**-19 ((q2max + x2max) + r2).
    tb (..., 8) tile boxes; qlo / qhi (..., 3) and q2max (...) broadcast."""
    g = torch.clamp(torch.maximum(tb[..., 0:3] - qhi, qlo - tb[..., 3:6]), min=0.0)
    gap2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    r2 = torch.tensor(r2, dtype=torch.float32, device=tb.device)
    return gap2 <= r2 + ((q2max + tb[..., 6]) + r2) * _MARGIN_SCALE


def _within_window(cb, qclo, qchi, qrmax):
    qr = torch.tensor(qrmax, dtype=torch.int64, device=cb.device)
    cb = cb.long()
    return ((cb[..., 0:3] - qchi <= qr) & (qclo - cb[..., 3:6] <= qr)).all(-1)


def _visit_rule(prep, q_xyz, q_coords, scales):
    """The tiles K2 tests for each query. Returns visited (B, M, NT) bool
    with queries in Morton order (row i is query qperm[:, i]) and visits
    (B, ceil(M / GROUP_QBLOCK)) i32, the (query, tile) pairs each thread
    block tests: a tile within reach of the block's query box and of the
    query itself."""
    B, M = prep.qperm.shape
    nb = -(-M // GROUP_QBLOCK)
    r2, qrmax = _reach(scales)
    perm = prep.qperm.long()
    qs = torch.gather(q_xyz.detach().float(), 1, perm[..., None].expand(-1, -1, 3))
    q2 = _sq_norm(qs)
    pad = nb * GROUP_QBLOCK - M
    live = torch.nn.functional.pad(torch.ones((B, M), dtype=torch.bool, device=qs.device),
                                   (0, pad)).reshape(B, nb, GROUP_QBLOCK, 1)
    qb = torch.nn.functional.pad(qs, (0, 0, 0, pad)).reshape(B, nb, GROUP_QBLOCK, 3)
    qlo = torch.where(live, qb, torch.full_like(qb, float("inf"))).amin(2)   # (B, nb, 3)
    qhi = torch.where(live, qb, torch.full_like(qb, -float("inf"))).amax(2)
    q2max = torch.nn.functional.pad(q2, (0, pad)).reshape(B, nb, GROUP_QBLOCK).amax(2)
    tb = prep.tbox[:, None]                                                  # (B, 1, NT, 8)
    block = _within_reach(tb, qlo[:, :, None], qhi[:, :, None], q2max[..., None], r2)
    own = _within_reach(tb, qs[:, :, None], qs[:, :, None], q2[..., None], r2)
    if qrmax is not None:
        qc = torch.gather(q_coords.long(), 1, perm[..., None].expand(-1, -1, 3))
        qcb = torch.nn.functional.pad(qc, (0, 0, 0, pad)).reshape(B, nb, GROUP_QBLOCK, 3)
        qclo = torch.where(live, qcb, torch.full_like(qcb, 2 ** 40)).amin(2)
        qchi = torch.where(live, qcb, torch.full_like(qcb, -2 ** 40)).amax(2)
        cb = prep.cbox[:, None]
        block = block & _within_window(cb, qclo[:, :, None], qchi[:, :, None], qrmax)
        own = own & _within_window(cb, qc[:, :, None], qc[:, :, None], qrmax)
    visited = own & block.repeat_interleave(GROUP_QBLOCK, 1)[:, :M]
    visits = torch.nn.functional.pad(visited.sum(-1), (0, pad)).reshape(
        B, nb, GROUP_QBLOCK).sum(-1).to(torch.int32)
    return visited, visits


def query_group_pruned_plain(src_xyz, src_valid, q_xyz, scales, payload=None,
                             src_coords=None, q_coords=None):
    """K2's route in plain PyTorch: `group_prep`, the visit rule, then the
    nearest k by (d2, original index) over the visited pairs alone. Equal to
    `query_group_plain` (idx, cnt, grouped), and also returns K2's visits
    (B, ceil(M / GROUP_QBLOCK)). Materialises every (query, row) pair: for
    tests at small sizes."""
    scales = _norm_scales(scales)
    window = any(qr is not None for *_, qr in scales)
    prep = group_prep(src_xyz, src_valid, q_xyz, src_coords if window else None)
    visited, visits = _visit_rule(prep, q_xyz, q_coords, scales)
    B, M = prep.qperm.shape
    P = prep.oi.shape[1]
    perm = prep.qperm.long()
    qs = torch.gather(q_xyz.detach().float(), 1, perm[..., None].expand(-1, -1, 3))
    x = prep.pts
    cross = (qs[..., 0:1] * x[:, None, :, 0] + qs[..., 1:2] * x[:, None, :, 1]) \
        + qs[..., 2:3] * x[:, None, :, 2]
    d2 = (_sq_norm(qs)[..., None] + x[:, None, :, 3]) - 2.0 * cross
    d2 = torch.where(d2 > 0, d2, torch.zeros_like(d2))                   # (B, M, P)
    base = (prep.oi >= 0)[:, None, :] & visited.repeat_interleave(GROUP_TILE, -1)
    dc = None
    if window:
        qc = torch.gather(q_coords.long(), 1, perm[..., None].expand(-1, -1, 3))
        dc = (qc[:, :, None, :] - prep.crd[:, None, :, :3].long()).abs()
    oi = prep.oi.to(torch.int64)[:, None, :].expand(B, M, P)
    dbits = d2.contiguous().view(torch.int32).to(torch.int64) << 32
    idx_parts, cnt_parts = [], []
    for mn, mx, ns, qr in scales:
        hit = base & (d2 < _r2(mx))
        if mn > 0:
            hit = hit & (d2 >= _r2(mn))
        if qr is not None:
            hit = hit & (dc[..., 0] <= qr[0]) & (dc[..., 1] <= qr[1]) & (dc[..., 2] <= qr[2])
        key = torch.where(hit, dbits | oi, torch.full_like(dbits, _INF_BITS << 32))
        top = torch.topk(key, ns, dim=-1, largest=False, sorted=True).values
        top_idx = (top & 0xFFFFFFFF).to(torch.int32)
        cnt = hit.sum(-1, dtype=torch.int32)
        first = torch.where(cnt > 0, top_idx[..., 0], torch.zeros_like(cnt))
        filled = torch.arange(ns, device=d2.device) < cnt[..., None]
        idx_parts.append(torch.where(filled, top_idx, first[..., None]))
        cnt_parts.append(cnt)
    # back to the original query rows
    idx = torch.empty_like(torch.cat(idx_parts, -1)).scatter_(
        1, perm[..., None].expand(-1, -1, sum(s[2] for s in scales)), torch.cat(idx_parts, -1))
    cnt = torch.empty_like(torch.stack(cnt_parts, -1)).scatter_(
        1, perm[..., None].expand(-1, -1, len(scales)), torch.stack(cnt_parts, -1))
    grouped = group_points(payload, idx) if payload is not None else None
    return idx, cnt, grouped, visits


def _group_scales(scales):
    """The kernel's `GroupScales` struct from normalised scales."""
    sc = _kernels.GroupScales()
    sc.n_scales = len(scales)
    sc.use_window = int(any(qr is not None for *_, qr in scales))
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
    return sc, off


def _query_group_launch(prep, q_xyz, scales, payload=None, q_coords=None):
    """K2's one launch on prepared sources. q_xyz / q_coords / payload in
    their original row order (contiguous f32 / i32 / f32 on the card).
    Returns idx, cnt, grouped (or None) and visits (B, ceil(M / 8)) i32."""
    scales = _norm_scales(scales)
    sc, total = _group_scales(scales)
    B, M = prep.qperm.shape
    nt = prep.tbox.shape[1]
    N = 1 if payload is None else payload.shape[1]   # payload rows (unused without one)
    D = 0 if payload is None else payload.shape[-1]
    _kernels.require_cuda(*prep, q_xyz, q_coords, payload)
    dev = q_xyz.device
    idx = torch.empty((B, M, total), dtype=torch.int32, device=dev)
    cnt = torch.empty((B, M, len(scales)), dtype=torch.int32, device=dev)
    grouped = (torch.empty((B, M, total, D), dtype=torch.float32, device=dev)
               if payload is not None else None)
    visits = torch.empty((B, -(-M // GROUP_QBLOCK)), dtype=torch.int32, device=dev)
    err = _kernels.func("query_group")(
        prep.pts.data_ptr(), prep.oi.data_ptr(), _kernels.ptr(prep.crd),
        prep.tbox.data_ptr(), _kernels.ptr(prep.cbox), nt, _kernels.ptr(payload), B,
        N, D, q_xyz.data_ptr(), _kernels.ptr(q_coords), prep.qperm.data_ptr(), M, sc,
        total, idx.data_ptr(), cnt.data_ptr(), _kernels.ptr(grouped), visits.data_ptr(),
        _kernels.stream_ptr(dev))
    name = "query_group_wide" if max(ns for _, _, ns, _ in scales) > 32 else "query_group"
    _kernels.check(err, name)
    _kernels.count(name)
    return idx, cnt, grouped, visits


def _kernel_inputs(src_xyz, src_valid, q_xyz, scales, payload, src_coords, q_coords):
    """Checks and normalises K2's inputs; returns (scales, src_xyz, src_valid,
    q_xyz, payload, src_coords, q_coords) ready for the prep and the launch
    (the coords None without window queries)."""
    scales = _norm_scales(scales)
    if not 1 <= len(scales) <= 4:
        raise ValueError("K2 takes 1 to 4 scales per call")
    if any(not 1 <= ns <= GROUP_MAX_NSAMPLE for _, _, ns, _ in scales):
        raise ValueError(f"K2 takes nsample in [1, {GROUP_MAX_NSAMPLE}]")
    window = any(qr is not None for *_, qr in scales)
    if window and (src_coords is None or q_coords is None):
        raise ValueError("window queries need src_coords and q_coords")
    B, N = src_xyz.shape[:2]
    M = q_xyz.shape[1]
    _kernels.check_shape(src_xyz, (B, N, 3), "query_group src_xyz")
    _kernels.check_shape(src_valid, (B, N), "query_group src_valid")
    _kernels.check_shape(q_xyz, (B, M, 3), "query_group q_xyz")
    _kernels.check_shape(payload, (B, N, None), "query_group payload")
    sc_c = q_c = None
    if window:
        _kernels.check_shape(src_coords, (B, N, 3), "query_group src_coords")
        _kernels.check_shape(q_coords, (B, M, 3), "query_group q_coords")
        sc_c = _kernels.as_int32(src_coords)
        q_c = _kernels.as_int32(q_coords)
    pl = None if payload is None else payload.detach().contiguous().float()
    src_xyz = src_xyz.detach().contiguous().float()
    src_valid = src_valid.contiguous()
    q_xyz = q_xyz.detach().contiguous().float()
    _kernels.require_cuda(src_xyz, src_valid, q_xyz, sc_c, q_c, pl)
    return scales, src_xyz, src_valid, q_xyz, pl, sc_c, q_c


def _query_group_kernel(src_xyz, src_valid, q_xyz, scales, payload,
                        src_coords, q_coords, tiles=None):
    """K2 on CUDA tensors: the prep on the card (`tile_sources`, unless
    `tiles` of these sources are given, and `query_order`), then one
    launch. Returns idx, cnt, grouped (or None)."""
    scales, src_xyz, src_valid, q_xyz, pl, sc_c, q_c = _kernel_inputs(
        src_xyz, src_valid, q_xyz, scales, payload, src_coords, q_coords)
    if tiles is None:
        tiles = tile_sources(src_xyz, src_valid, sc_c)
    prep = GroupPrep(*tiles, query_order(q_xyz))
    return _query_group_launch(prep, q_xyz, scales, pl, q_c)[:3]


def _query_group_any(src_xyz, src_valid, q_xyz, scales, payload, src_coords,
                     q_coords, tiles):
    if src_xyz.is_cuda:
        return _query_group_kernel(src_xyz, src_valid, q_xyz, scales, payload,
                                   src_coords, q_coords, tiles)
    return query_group_plain(src_xyz, src_valid, q_xyz, scales, payload,
                             src_coords, q_coords)


class _GroupPayload(torch.autograd.Function):
    """query_group whose gathered payload has a gradient (counterpart of the
    JAX `_fused_core` VJP, ops/group_pallas.py:918-965): the payload's
    cotangent is scattered back onto the chosen source rows with
    index_add_; xyz and the selection get none."""

    @staticmethod
    def forward(ctx, payload, src_xyz, src_valid, q_xyz, scales, src_coords,
                q_coords, tiles):
        idx, cnt, grouped = _query_group_any(src_xyz, src_valid, q_xyz, scales,
                                             payload, src_coords, q_coords, tiles)
        ctx.mark_non_differentiable(idx, cnt)
        ctx.save_for_backward(idx)
        ctx.n_src = src_xyz.shape[1]
        return grouped, idx, cnt

    @staticmethod
    def backward(ctx, d_grouped, _d_idx, _d_cnt):
        idx, = ctx.saved_tensors
        B, N, D = idx.shape[0], ctx.n_src, d_grouped.shape[-1]
        rows = idx.long() + torch.arange(B, device=idx.device)[:, None, None] * N
        d_payload = torch.zeros((B * N, D), dtype=d_grouped.dtype,
                                device=d_grouped.device)
        d_payload.index_add_(0, rows.reshape(-1), d_grouped.reshape(-1, D))
        return d_payload.reshape(B, N, D), None, None, None, None, None, None, None


def query_group(src_xyz, src_valid, q_xyz, scales, payload=None,
                src_coords=None, q_coords=None, cache=None):
    """Multi-scale nearest-k query + gather in one pass over the sources.

    src_xyz (B, N, 3), src_valid (B, N) bool, q_xyz (B, M, 3); scales: a
    sequence of (min_r, max_r, ns) or (min_r, max_r, ns, query_range);
    payload (B, N, D) rows to gather (or None); src_coords / q_coords
    (B, ·, 3) int voxel coords for window queries; cache: a TileCache
    shared by the K2 calls on the same sources, or None. Returns one
    (idx (B, M, ns) int32, cnt (B, M) int32, grouped (B, M, ns, D) or None)
    per scale. The gathered payload has a gradient (`_GroupPayload`)."""
    tiles = None
    if cache is not None and src_xyz.is_cuda:
        window = any(qr is not None for *_, qr in _norm_scales(scales))
        tiles = cache.get(src_xyz, src_valid, src_coords if window else None)
    grouped, idx, cnt = _GroupPayload.apply(payload, src_xyz, src_valid, q_xyz,
                                            scales, src_coords, q_coords, tiles)
    out, off = [], 0
    for i, s in enumerate(scales):
        ns = int(s[2])
        out.append((idx[..., off:off + ns], cnt[..., i],
                    grouped[:, :, off:off + ns] if grouped is not None else None))
        off += ns
    return out


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


def first_k_true(mask, k):
    """mask (R, N) bool -> idx (R, k) int64 of each row's first k True
    columns in index order, unfilled slots holding the row's first True
    column (0 when it has none), and cnt (R,) int32, the row's True count
    (counterpart of the JAX `_first_k_true`, ops/grouping.py:28)."""
    if mask.dim() != 2:
        raise ValueError("first_k_true expects a 2D mask")
    R, N = mask.shape
    rank = torch.cumsum(mask, dim=1) - 1                          # position among the hits
    write = torch.where(mask & (rank < k), rank, torch.full_like(rank, k))
    first = torch.argmax(mask.to(torch.uint8), dim=1)            # 0 if no hit
    out = first[:, None].expand(R, k + 1).clone()
    cols = torch.arange(N, device=mask.device).expand(R, N)
    out.scatter_(1, write, cols)     # column k collects the dropped hits
    return out[:, :k], mask.sum(1, dtype=torch.int32)


def three_nn(unknown, known, valid_mask=None, chunk=1024):
    """unknown (B, M, 3), known (B, N, 3) -> dist (B, M, 3) f32, idx (B, M, 3)
    int64: each unknown point's three nearest known points (counterpart of
    the JAX `three_nn`, ops/grouping.py:239). d2 is ((dx*dx + dy*dy) +
    dz*dz), each operation rounded; an invalid known point is at d2 = inf;
    the order is by (d2, index), ties to the lower index as lax.top_k, by
    unique int64 (d2 bits, index) keys. dist is sqrt(d2), so inf where fewer
    than three known points are valid. Runs `chunk` unknown points at a time."""
    unknown = unknown.detach()
    known = known.detach()
    B, M, _ = unknown.shape
    N = known.shape[1]
    lanes = torch.arange(N, device=known.device, dtype=torch.int64)
    inf = torch.tensor(float("inf"), dtype=known.dtype, device=known.device)
    dists, idxs = [], []
    for m0 in range(0, M, chunk):
        d = unknown[:, m0:m0 + chunk, None, :] - known[:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        if valid_mask is not None:
            d2 = torch.where(valid_mask[:, None, :], d2, inf)
        key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | lanes
        top = torch.topk(key, 3, dim=-1, largest=False, sorted=True).values
        idx = top & 0xFFFFFFFF
        dists.append(torch.sqrt(torch.gather(d2, 2, idx)))
        idxs.append(idx)
    return torch.cat(dists, 1), torch.cat(idxs, 1)


def three_interpolate_weights(dist):
    """Inverse-distance weights of three_nn's dist: 1 / clip(d, 1e-8) over
    their sum (the JAX `three_interpolate_weights`, ops/grouping.py:270): a
    neighbour at inf weighs 0, and a point with all three at inf gets NaN, as
    in the JAX package."""
    recip = 1.0 / torch.clamp(dist, min=1e-8)
    return recip / ((recip[..., 0:1] + recip[..., 1:2]) + recip[..., 2:3])


def three_interpolate(features, idx, weight):
    """features (B, N, C), idx (B, M, 3), weight (B, M, 3) -> (B, M, C), the
    weighted sum of the three gathered rows in order (the JAX
    `three_interpolate`, ops/grouping.py:263)."""
    g = group_points(features, idx)                                  # (B, M, 3, C)
    w = weight[..., None]
    return (g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1]) + g[:, :, 2] * w[:, :, 2]
