"""Point sampling ops: d-fps, s-fps and the point gather.

Counterpart of tsm_det_pointcloud_tpu/ops/sampling.py:48-166. Semantics:
the seed pick is index 0; invalid lanes hold -1 so they are never picked
while a valid lane remains; s-fps carries the raw min-distance and applies
the weight only at the argmax; ties go to the first maximum.

On a CUDA tensor both samplers launch kernel K1 (csrc/fps.cu, replacing the
Pallas `_fps_kernel_batched` / `_fps_kernel`, ops/fps_pallas.py:28, :67);
on a CPU tensor they run the plain version below, which repeats the
kernel's arithmetic step by step.
"""
from __future__ import annotations

import torch

from . import _kernels

FPS_MAX_POINTS = 16384  # one row's xyz must fit one block's shared memory


def _sq_dist(xyz, sel):
    """((dx*dx + dy*dy) + dz*dz) in that order, each op rounded."""
    d = xyz - sel
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def furthest_point_sample_plain(xyz, npoint, valid_mask=None, weights=None):
    """Plain PyTorch FPS (d-fps, or s-fps when `weights` is given)."""
    B, N, _ = xyz.shape
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    if valid_mask is not None:
        mind = torch.where(valid_mask, mind, torch.full_like(mind, -1.0))
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    neg = torch.full_like(mind, -1.0)
    for i in range(1, npoint):
        sel = xyz[rows, last][:, None, :]
        d2 = _sq_dist(xyz, sel)
        if weights is None:
            mind = torch.minimum(mind, d2)
            if valid_mask is not None:
                mind = torch.where(valid_mask, mind, neg)
            key = mind
        else:
            mind = torch.minimum(mind, d2)
            key = weights * mind
            if valid_mask is not None:
                key = torch.where(valid_mask, key, neg)
        # first maximum: argmax over (key, -index) made explicit
        kmax = key.max(dim=-1, keepdim=True).values
        lanes = torch.arange(N, device=xyz.device).expand(B, N)
        last = torch.where(key == kmax, lanes, N).min(dim=-1).values
        idxs[:, i] = last.to(torch.int32)
    return idxs


def _fps_kernel(xyz, npoint, valid_mask, weights):
    B, N = xyz.shape[:2]
    _kernels.check_shape(xyz, (B, N, 3), "fps xyz")
    _kernels.check_shape(valid_mask, (B, N), "fps valid_mask")
    _kernels.check_shape(weights, (B, N), "fps weights")
    if N > FPS_MAX_POINTS:
        raise NotImplementedError(
            f"FPS kernel K1 takes at most {FPS_MAX_POINTS} points per row "
            f"(got {N}); larger clouds need the block-pruned FPS kernel, "
            f"which is not ported yet")
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


def furthest_point_sample(xyz, npoint, valid_mask=None):
    """(B, N, 3) -> (B, npoint) int32 indices (d-fps)."""
    if xyz.is_cuda:
        return _fps_kernel(xyz, npoint, valid_mask, None)
    return furthest_point_sample_plain(xyz, npoint, valid_mask)


def furthest_point_sample_weights(xyz, weights, npoint, valid_mask=None):
    """s-fps: key = weights * running min-distance. xyz (B, N, 3),
    weights (B, N) -> (B, npoint)."""
    if xyz.is_cuda:
        return _fps_kernel(xyz, npoint, valid_mask, weights)
    return furthest_point_sample_plain(xyz, npoint, valid_mask, weights)


def gather_points(points, idx):
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, points.shape[-1]))
