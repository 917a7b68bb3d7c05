"""Point sampling ops: d-fps, s-fps, f-fps and the point gather.

Counterpart of tsm_det_pointcloud_tpu/ops/sampling.py:48-166. Semantics:
the seed pick is index 0; invalid lanes hold -1 so they are never picked
while a valid lane remains; s-fps carries the raw min-distance and applies
the weight only at the argmax; ties go to the first maximum.

On a CUDA tensor both samplers launch kernel K1 (csrc/fps.cu, replacing the
Pallas `_fps_kernel_batched` / `_fps_kernel`, ops/fps_pallas.py:28, :67;
a row on a thread-block cluster) up to 16384 points a row; over more points
they launch kernel K6 (csrc/fps_block.cu, replacing the three block-pruned
Pallas kernels `_fps_block_kernel`, `_fps_block_kernel_2row` and
`_fps_block_kernel_nrow`, ops/fps_pallas.py:197, :490, :633, for d-fps,
and the weighted `_fps_kernel` for s-fps), rows of up to 262144 points. On
a CPU tensor they run the plain version below, which repeats the kernel's
arithmetic step by step.

f-fps (`furthest_point_sample_feature`, the JAX package's
`furthest_point_sample_matrix` over the matrix d_xyz + gamma * d_feat that
its callers build) is plain PyTorch on any device, as the JAX package's is
XLA code: each step computes the one row of that matrix the step reads,
the picked point's, so no (N, N) matrix is ever built.

Block-pruned d-fps (counterpart of ops/fps_pallas.py:171-487) is exact: the
points are Morton-sorted into blocks of 128, each block keeps its bounding
box, the maximum of its running min-distance and the least original index
that attains it, and a step updates only the blocks whose squared gap to
the picked point is below their maximum. The running min-distance only
falls, and the gap is rounded the same way as d2, so a skipped block could
not have changed; the picks equal `furthest_point_sample_plain`'s. With
weights a block keeps apart the largest min-distance (the skip test) and
the largest key, weight times min-distance, with its least index (the
pick): a skipped block's keys do not change either.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels

FPS_MAX_POINTS = 16384  # K1's widest layout: 8 points a lane, a cluster of 8 CTAs
FPS_BLOCK = 128         # points per Morton block of the block-pruned d-fps
_BIG_IDX = 1 << 30      # original index of a pad lane: never the least
# K6 (csrc/fps_block.cu): 16 blocks a warp; a row on a cluster of 8 CTAs (64
# warps) up to FPS_BLOCK_SMALL_POINTS, of 16 CTAs (128 warps) up to the cap
FPS_BLOCK_SMALL_POINTS = 16 * 64 * FPS_BLOCK
FPS_BLOCK_MAX_POINTS = 16 * 128 * FPS_BLOCK
_FAR = 1e30             # xyz of an invalid row when sorting; empty boxes
_LAST = 2 ** 31 - 1     # sort key of an invalid row: above every Morton code


def _sq_dist(xyz, sel):
    """((dx*dx + dy*dy) + dz*dz) in that order, each op rounded."""
    d = xyz - sel
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def furthest_point_sample_plain(xyz, npoint, valid_mask=None, weights=None):
    """Plain PyTorch FPS (d-fps, or s-fps when `weights` is given). Ties go
    to the lowest index (`argmax` returns the first maximum). A step is
    about ten launches on the card, so the loop there is launch-bound; the
    picks stay on the device until the end."""
    B, N, _ = xyz.shape
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    if valid_mask is not None:
        mind = torch.where(valid_mask, mind, torch.full_like(mind, -1.0))
    idxs = torch.zeros((B, npoint), dtype=torch.long, device=xyz.device)
    last = torch.zeros((B, 1, 1), dtype=torch.long, device=xyz.device).expand(B, 1, 3)
    neg = torch.full_like(mind, -1.0)
    for i in range(1, npoint):
        d2 = _sq_dist(xyz, torch.gather(xyz, 1, last))
        mind = torch.minimum(mind, d2)
        if weights is None:
            if valid_mask is not None:
                mind = torch.where(valid_mask, mind, neg)
            key = mind
        else:
            key = weights * mind
            if valid_mask is not None:
                key = torch.where(valid_mask, key, neg)
        pick = key.argmax(dim=-1, keepdim=True)
        idxs[:, i:i + 1] = pick
        last = pick[..., None].expand(B, 1, 3)
    return idxs.to(torch.int32)


def furthest_point_sample_feature(xyz, features, npoint, valid_mask=None, gamma=1.0):
    """f-fps: FPS over the distance d_xyz + gamma * d_feat, the squared
    distance of the points plus gamma times that of their features. xyz
    (B, N, 3), features (B, N, C) -> (B, npoint) int32. Each step takes the
    picked point's row of that matrix (the elements the JAX package's
    `furthest_point_sample_matrix` reads), with no host sync."""
    B, N, _ = xyz.shape
    dev = xyz.device
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=dev)
    neg = torch.full_like(mind, -1.0)
    if valid_mask is not None:
        mind = torch.where(valid_mask, mind, neg)
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=dev)
    last = torch.zeros((B, 1), dtype=torch.long, device=dev)
    lanes = torch.arange(N, device=dev).expand(B, N)
    for i in range(1, npoint):
        sel = torch.gather(xyz, 1, last[..., None].expand(-1, -1, 3))
        fsel = torch.gather(features, 1, last[..., None].expand(-1, -1, features.shape[-1]))
        df = features - fsel
        row = _sq_dist(xyz, sel) + gamma * (df * df).sum(-1)
        mind = torch.minimum(mind, row)
        if valid_mask is not None:
            mind = torch.where(valid_mask, mind, neg)
        kmax = mind.max(dim=-1, keepdim=True).values
        last = torch.where(mind == kmax, lanes, N).min(dim=-1, keepdim=True).values
        idxs[:, i:i + 1] = last.to(torch.int32)
    return idxs


def fps_plan(n, weighted=False):
    """K1's launch plan for rows of `n` points on the current card: cluster
    size (CTAs a row: 4 for rows of up to 4096 points, else 8), the most
    clusters of that layout resident at once (cudaOccupancyMaxActiveClusters;
    a larger batch runs in waves) and the shared memory of a CTA (its
    exchange slots)."""
    out = (ctypes.c_int * 3)()
    _kernels.check(_kernels.func("fps_plan")(n, int(weighted), ctypes.addressof(out)),
                   "fps_plan")
    return {"cluster_size": out[0], "active_clusters": out[1], "smem_bytes": out[2]}


def _fps_kernel(xyz, npoint, valid_mask, weights):
    B, N = xyz.shape[:2]
    _kernels.check_shape(xyz, (B, N, 3), "fps xyz")
    _kernels.check_shape(valid_mask, (B, N), "fps valid_mask")
    _kernels.check_shape(weights, (B, N), "fps weights")
    if N > FPS_MAX_POINTS:
        raise ValueError(
            f"FPS kernel K1 takes at most {FPS_MAX_POINTS} points per row "
            f"(got {N}); longer rows go to the block-pruned kernel K6")
    xyz = xyz.contiguous().float()
    w = None if weights is None else weights.contiguous().float()
    v = None if valid_mask is None else valid_mask.contiguous().to(torch.uint8)
    _kernels.require_cuda(xyz, w, v)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    fn = _kernels.func("fps")
    err = fn(_kernels.ptr(xyz), _kernels.ptr(w), _kernels.ptr(v), B, N,
             npoint, out.data_ptr(), _kernels.stream_ptr(xyz.device))
    _kernels.check(err, "fps")
    _kernels.count("fps")
    return out


@functools.lru_cache(maxsize=None)
def _spread_table(device):
    """(3, 1024) i32 rows: bit i of v moved to bit 3 i + axis, for axis 0, 1
    and 2; and the (3,) axis column that picks a row. One pair a device."""
    v = np.arange(1024, dtype=np.int64)
    s = sum(((v >> i) & 1) << (3 * i) for i in range(10))
    table = np.stack([s, s << 1, s << 2]).astype(np.int32)
    return torch.from_numpy(table).to(device), torch.arange(3, device=device)


def morton_code(xyz, origin, cell=1.0):
    """(..., 3) f32 -> int32 Morton codes on a `cell`-metre grid, 10 bits an
    axis (own copy of ops/group_pallas.py:91-105). Close points get close
    codes, which is what gives the blocks tight bounding boxes; the picks of
    the block-pruned d-fps do not depend on it, only its speed does. The
    bits are spread by a table (few launches on the card); the three
    spread axes share no bit, so their sum is their union."""
    v = ((xyz - origin) / cell).clamp(0, 1023).to(torch.int64)
    table, axis = _spread_table(xyz.device)
    return table[axis, v].sum(-1, dtype=torch.int32)


def pad_rows(a, width, fill):
    """(B, N, ...) -> (B, P, ...), P = N rounded up to whole `width`s; the
    new rows hold `fill`."""
    pad = -a.shape[1] % width
    if not pad:
        return a
    return torch.cat([a, a.new_full((a.shape[0], pad) + tuple(a.shape[2:]), fill)], 1)


def morton_tiles(xyz, valid, width):
    """The sort that K6's blocks and K2's tiles share: per scan, the stable
    Morton order of the rows, invalid rows last, and which rows of that
    order, padded to whole tiles of `width`, are valid. xyz (B, N, 3) f32,
    valid (B, N) bool -> order (B, N) i64, live (B, P) bool."""
    inv = ~valid
    vxyz = xyz.masked_fill(inv[..., None], _FAR)
    code = morton_code(vxyz, vxyz.amin(1, keepdim=True)).masked_fill(inv, _LAST)
    key, order = torch.sort(code, dim=1, stable=True)
    return order, pad_rows(key != _LAST, width, False)


def tile_boxes(a, live, width, far):
    """Per tile of `width` rows of a (B, P, C), the least and the largest
    value of each column over the live rows: lo, hi (B, P / width, C). A
    tile with no live row gets lo `far`, hi `-far`, a box nothing reaches."""
    B, P, C = a.shape
    t = a.reshape(B, P // width, width, C)
    dead = ~live.reshape(B, P // width, width, 1)
    return t.masked_fill(dead, far).amin(2), t.masked_fill(dead, -far).amax(2)


class BlockState(NamedTuple):
    """A batch of scans prepared for block-pruned FPS. P = NB * 128 is N
    rounded up to whole blocks; pad lanes hold xyz 0, original index 2**30
    and min-distance -2, so they never win and never widen a box."""
    xs: torch.Tensor      # (B, P) f32, Morton order, invalid rows last
    ys: torch.Tensor
    zs: torch.Tensor
    ois: torch.Tensor     # (B, P) i32 original index
    mind: torch.Tensor    # (B, P) f32 running min-distance: 1e10 / -1 / -2
    bbox: torch.Tensor    # (B, 6, NB) f32 lox, hix, loy, hiy, loz, hiz (valid points)
    bmax: torch.Tensor    # (B, NB) f32 block maximum of the key (mind, or w * mind)
    barg: torch.Tensor    # (B, NB) i32 least original index attaining it
    ws: torch.Tensor = None     # (B, P) f32 weights in Morton order (s-fps), pad 0
    bmind: torch.Tensor = None  # (B, NB) f32 block maximum of mind (s-fps)


def _keys(mind, ws):
    """The selection key: mind, or on valid points (mind >= 0) w * mind."""
    return mind if ws is None else torch.where(mind >= 0, ws * mind, mind)


def block_prep(xyz, valid_mask=None, weights=None):
    """Morton sort, blocks, boxes and the initial block maxima: the
    counterpart of ops/fps_pallas.py:361-428 with integer indices and no
    TPU packing; with `weights` (B, N) also the weights in Morton order and
    the blocks' largest mind beside their largest key. Runs wherever `xyz`
    lies."""
    B, N, _ = xyz.shape
    dev = xyz.device
    xyz = xyz.detach().float()
    valid = (torch.ones((B, N), dtype=torch.bool, device=dev) if valid_mask is None
             else valid_mask.bool())
    order, live = morton_tiles(xyz, valid, FPS_BLOCK)
    nb = live.shape[1] // FPS_BLOCK
    xs, ys, zs = (pad_rows(torch.gather(xyz[..., a], 1, order), FPS_BLOCK, 0.0)
                  for a in range(3))
    ois = pad_rows(order.to(torch.int32), FPS_BLOCK, _BIG_IDX)
    mind = pad_rows(torch.where(live[:, :N], 1e10, -1.0).to(torch.float32), FPS_BLOCK, -2.0)
    lo, hi = tile_boxes(torch.stack([xs, ys, zs], -1), live, FPS_BLOCK, _FAR)
    bbox = torch.stack([lo, hi], -1).reshape(B, nb, 6).transpose(1, 2)
    ws = bmind = None
    if weights is not None:
        ws = pad_rows(torch.gather(weights.detach().float(), 1, order), FPS_BLOCK, 0.0)
        bmind = mind.reshape(B, nb, FPS_BLOCK).amax(-1)
    bmax, barg = _block_max(_keys(mind, ws).reshape(B, nb, FPS_BLOCK),
                            ois.reshape(B, nb, FPS_BLOCK))
    return BlockState(xs, ys, zs, ois, mind, bbox.contiguous(), bmax, barg, ws, bmind)


def _block_max(mind, ois):
    """(..., FPS_BLOCK) -> the maximum and the least original index attaining it."""
    bmax = mind.amax(-1)
    barg = torch.where(mind == bmax[..., None], ois, torch.full_like(ois, _BIG_IDX)).amin(-1)
    return bmax, barg


def _gap(lo, hi, q):
    return torch.clamp(torch.maximum(lo - q, q - hi), min=0.0)


def _block_pruned_plain(xyz, npoint, valid_mask, weights=None):
    """The pruned update step by step on tensors. Returns (idx (B, npoint)
    i32, visits (B,) i64: the (step, block) updates each scan made)."""
    B, N, _ = xyz.shape
    dev = xyz.device
    st = block_prep(xyz, valid_mask, weights)
    nb = st.bmax.shape[1]
    xs, ys, zs, ois, mind = (a.reshape(B, nb, FPS_BLOCK)
                             for a in (st.xs, st.ys, st.zs, st.ois, st.mind.clone()))
    ws = None if weights is None else st.ws.reshape(B, nb, FPS_BLOCK)
    lox, hix, loy, hiy, loz, hiz = st.bbox.unbind(1)
    bmax, barg = st.bmax.clone(), st.barg.clone()
    bmind = bmax if weights is None else st.bmind.clone()
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=dev)
    visits = torch.zeros((B,), dtype=torch.int64, device=dev)
    last = torch.zeros((B,), dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)
    xyz = xyz.detach().float()
    for i in range(1, npoint):
        q = xyz[rows, last]                                       # (B, 3)
        gx = _gap(lox, hix, q[:, 0:1])
        gy = _gap(loy, hiy, q[:, 1:2])
        gz = _gap(loz, hiz, q[:, 2:3])
        act = ((gx * gx + gy * gy) + gz * gz) < bmind             # (B, NB)
        visits += act.sum(1)
        bi, gi = act.nonzero(as_tuple=True)
        sel = q[bi][:, None, :]
        d2 = _sq_dist(torch.stack([xs[bi, gi], ys[bi, gi], zs[bi, gi]], -1), sel)
        m = mind[bi, gi]
        m = torch.where(m >= 0, torch.minimum(m, d2), m)          # -1 / -2 stay pinned
        mind[bi, gi] = m
        bmax[bi, gi], barg[bi, gi] = _block_max(_keys(m, None if ws is None else ws[bi, gi]),
                                                ois[bi, gi])
        if weights is not None:
            bmind[bi, gi] = m.amax(-1)
        kmax = bmax.amax(1, keepdim=True)
        last = torch.where(bmax == kmax, barg, torch.full_like(barg, _BIG_IDX)
                           ).amin(1).long()
        idxs[:, i] = last.to(torch.int32)
    return idxs, visits


def fps_block_plan(n_blocks, weighted=False):
    """K6's launch plan for rows of `n_blocks` Morton blocks on the current
    card, d-fps or (`weighted`) s-fps: cluster size (CTAs a scan: 8 up to
    FPS_BLOCK_SMALL_POINTS points a row, 16 above), the most clusters
    resident at once (cudaOccupancyMaxActiveClusters; a larger batch runs in
    waves) and the dynamic shared memory of a CTA."""
    out = (ctypes.c_int * 3)()
    _kernels.check(_kernels.func("fps_block_plan")(n_blocks, int(weighted),
                                                   ctypes.addressof(out)),
                   "fps_block_plan")
    return {"cluster_size": out[0], "active_clusters": out[1], "smem_bytes": out[2]}


def _fps_block_launch(xyz, st, npoint):
    """K6's one launch on a prepared `BlockState` (read, not written), its
    weighted instantiation when the state holds weights (counted as
    "fps_block_weighted"). Returns (idx (B, npoint) i32, visits (B,) i64)."""
    B, N = xyz.shape[:2]
    _kernels.require_cuda(xyz, *st)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    visits = torch.zeros((B,), dtype=torch.int64, device=xyz.device)  # summed by atomics
    fn = _kernels.func("fps_block")
    err = fn(xyz.data_ptr(), st.xs.data_ptr(), st.ys.data_ptr(), st.zs.data_ptr(),
             st.ois.data_ptr(), st.mind.data_ptr(), _kernels.ptr(st.ws), st.bbox.data_ptr(),
             st.bmax.data_ptr(), st.barg.data_ptr(), _kernels.ptr(st.bmind), B, N,
             st.bmax.shape[1], npoint, out.data_ptr(), visits.data_ptr(),
             _kernels.stream_ptr(xyz.device))
    name = "fps_block" if st.ws is None else "fps_block_weighted"
    _kernels.check(err, name)
    _kernels.count(name)
    return out, visits


def _fps_block_kernel(xyz, npoint, valid_mask, weights=None):
    """K6 on a CUDA tensor: the prep in PyTorch on the card, then one launch
    (weighted with `weights`). Returns (idx (B, npoint) i32, visits (B,)
    i64)."""
    B, N = xyz.shape[:2]
    _kernels.check_shape(xyz, (B, N, 3), "fps_block xyz")
    _kernels.check_shape(valid_mask, (B, N), "fps_block valid_mask")
    _kernels.check_shape(weights, (B, N), "fps_block weights")
    if N > FPS_BLOCK_MAX_POINTS:
        raise ValueError(f"fps_block takes at most FPS_BLOCK_MAX_POINTS = "
                         f"{FPS_BLOCK_MAX_POINTS} points per row (got {N}): K6 holds a "
                         f"scan in one cluster of at most 16 CTAs, 16 blocks a warp")
    xyz = xyz.detach().contiguous().float()
    _kernels.require_cuda(xyz, None if weights is None else weights.contiguous())
    return _fps_block_launch(xyz, block_prep(xyz, valid_mask, weights), npoint)


def furthest_point_sample_block_pruned_plain(xyz, npoint, valid_mask=None, weights=None):
    """Plain PyTorch block-pruned exact FPS (s-fps with `weights`):
    (B, N, 3) -> (B, npoint) i32."""
    return _block_pruned_plain(xyz, npoint, valid_mask, weights)[0]


def furthest_point_sample_block_pruned(xyz, npoint, valid_mask=None, weights=None):
    """Exact FPS by Morton-block pruning, d-fps or (with `weights`) s-fps:
    (B, N, 3) -> (B, npoint) i32, index-equal to
    `furthest_point_sample_plain`. Kernel K6 on a CUDA tensor (rows above
    FPS_BLOCK_MAX_POINTS raise), the plain block-pruned version, any N, on
    a CPU tensor."""
    if xyz.is_cuda:
        return _fps_block_kernel(xyz, npoint, valid_mask, weights)[0]
    return furthest_point_sample_block_pruned_plain(xyz, npoint, valid_mask, weights)


def furthest_point_sample(xyz, npoint, valid_mask=None):
    """(B, N, 3) -> (B, npoint) int32 indices (d-fps). On the card K1 takes
    rows of up to 16384 points and K6 longer ones up to FPS_BLOCK_MAX_POINTS;
    longer rows raise."""
    if xyz.is_cuda:
        if xyz.shape[1] > FPS_MAX_POINTS:
            return _fps_block_kernel(xyz, npoint, valid_mask)[0]
        return _fps_kernel(xyz, npoint, valid_mask, None)
    return furthest_point_sample_plain(xyz, npoint, valid_mask)


def furthest_point_sample_weights(xyz, weights, npoint, valid_mask=None):
    """s-fps: key = weights * running min-distance. xyz (B, N, 3),
    weights (B, N) -> (B, npoint). On the card K1 up to 16384 points a row,
    K6's weighted instantiation above, up to FPS_BLOCK_MAX_POINTS."""
    if xyz.is_cuda:
        if xyz.shape[1] > FPS_MAX_POINTS:
            return _fps_block_kernel(xyz, npoint, valid_mask, weights)[0]
        return _fps_kernel(xyz, npoint, valid_mask, weights)
    return furthest_point_sample_plain(xyz, npoint, valid_mask, weights)


def gather_points(points, idx):
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, points.shape[-1]))
