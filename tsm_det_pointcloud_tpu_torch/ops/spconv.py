"""Sparse 3D convolution on sorted voxel keys.

Counterpart of tsm_det_pointcloud_tpu/ops/spconv.py:49-543. A sparse tensor
is fixed-capacity (features (B, V, C), coords (B, V, 3) int zyx with -1 pad,
valid (B, V)) with rows sorted by linearized voxel key.

A conv takes one of two routes, chosen by the rulebook it is handed (the
rulebook builders' `lazy` keyword), as the JAX package dispatches on
`isinstance(rulebook, LazyRulebook)`:
  * by key (`lazy=True`, the default; the TSM U-Nets): the rulebook is never
    materialised; a `LazyRulebook` carries the sorted source keys and the
    per-tap target keys, and the conv matches them inside the gather-GEMM;
  * materialised (`lazy=False`; SECOND's VoxelBackBone8x, where one subm
    rulebook serves two convs): the builder probes once and returns
    `(idx, found)`; the conv gathers by index (`_gather_conv`).
On a CUDA tensor:
  * `_lookup_batched` launches kernel K3 (csrc/probe.cu, replacing the
    Pallas `_kernel` of ops/searchsorted_pallas.py:55);
  * `gather_matmul_bykey` launches kernel K4 (csrc/spconv_bykey.cu,
    replacing the Pallas `_bykey_kernel` of ops/spconv_pallas.py:132);
  * the backward of the by-key conv, `gather_matmul_bykey_bwd`, launches
    kernel K5 (csrc/spconv_bykey_bwd.cu, replacing the Pallas
    `_bykey_bwd_kernel` of ops/spconv_pallas.py:383); it takes maps that are
    injective per tap, and computes df through each tap's inverse, whose CPU
    twin is `gather_matmul_bykey_df_plain`;
  * `gather_matmul` launches kernel K7 (csrc/spconv_gather.cu, replacing the
    Pallas `_kernel` of ops/spconv_pallas.py:45).
On a CPU tensor all four run their plain versions below. Every by-key conv
goes through `_ByKeyConv`, the autograd counterpart of the JAX `_bykey_conv`
custom VJP (ops/spconv.py:149-193): K4 forward, K5 backward, no gradient
for the keys. The materialised route is eval only on the card: K7 has no
backward yet, and asking for one raises. A 1x1x1 conv stays a plain GEMM.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels


class LazyRulebook(NamedTuple):
    """Probe inputs of a conv: source keys (B, V) ascending with a sentinel
    tail, and target keys (B, K, Q) with sentinel = contributes nothing."""
    skeys: torch.Tensor
    qkeys: torch.Tensor


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def linearize(coords_zyx, grid, valid=None):
    """(..., 3) zyx -> int32 keys; invalid / out-of-grid -> sentinel. Both
    bounds are checked, so a neighbour past the grid edge cannot alias. Keys
    are per scan (the batch is a leading axis, not folded into the key)."""
    gz, gy, gx = grid
    if gz * gy * gx >= 2 ** 31:
        raise ValueError(f"grid {tuple(grid)} has {gz * gy * gx} cells: its keys and "
                         f"sentinel do not fit int32")
    c = coords_zyx.long()
    key = (c[..., 0] * gy + c[..., 1]) * gx + c[..., 2]
    sentinel = gz * gy * gx
    hi = torch.tensor([gz, gy, gx], device=c.device)
    bad = (c < 0).any(-1) | (c >= hi).any(-1)
    if valid is not None:
        bad = bad | ~valid
    return torch.where(bad, torch.full_like(key, sentinel), key).to(torch.int32)


def kernel_offsets(kernel_size):
    """Static (K, 3) zyx offsets, centred (k odd) or from 0 (k even)."""
    ranges = []
    for k in _triple(kernel_size):
        lo = -(k // 2) if k % 2 == 1 else 0
        ranges.append(np.arange(lo, lo + k))
    off = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1).reshape(-1, 3)
    return off.astype(np.int32)


# ---------------------------------------------------------------------------
# K3: the rulebook probe
# ---------------------------------------------------------------------------

def probe_plain(skeys, queries, sentinel):
    """skeys (B, V) int32 ascending, queries (B, Q) int32 -> idx (B, Q)
    int32 = max(#{skeys <= q} - 1, 0) and found (B, Q) bool."""
    rank = torch.searchsorted(skeys.contiguous(), queries.contiguous(), right=True)
    idx = torch.clamp(rank - 1, min=0)
    hit = torch.gather(skeys, 1, idx) == queries
    found = (rank > 0) & hit & (queries < sentinel)
    return idx.to(torch.int32), found


def probe(skeys, queries, sentinel):
    """Rank-and-membership probe (see probe_plain); kernel K3 on the card,
    one launch: it writes `found` straight into a bool tensor."""
    if not skeys.is_cuda:
        return probe_plain(skeys, queries, sentinel)
    sk = _kernels.as_int32(skeys)
    q = _kernels.as_int32(queries)
    _kernels.require_cuda(sk, q)
    B, V = sk.shape
    Q = q.shape[1]
    _kernels.check_shape(q, (B, Q), "probe queries")
    idx = torch.empty((B, Q), dtype=torch.int32, device=sk.device)
    found = torch.empty((B, Q), dtype=torch.bool, device=sk.device)
    err = _kernels.func("probe")(sk.data_ptr(), q.data_ptr(), B, V, Q,
                                 int(min(sentinel, 2**31 - 1)), idx.data_ptr(),
                                 found.data_ptr(), _kernels.stream_ptr(sk.device))
    _kernels.check(err, "probe")
    _kernels.count("probe")
    return idx, found


def _lookup_batched(skeys, query_keys, sentinel):
    """Batched rulebook probe. skeys (B, V); query_keys (B, K, Q); returns
    idx / found (B, K, Q). `idx` is the slot where found."""
    B, K, Q = query_keys.shape
    idx, found = probe(skeys, query_keys.reshape(B, K * Q), sentinel)
    return idx.reshape(B, K, Q), found.reshape(B, K, Q)


# ---------------------------------------------------------------------------
# K4: the by-key gather-GEMM
# ---------------------------------------------------------------------------

def gather_matmul_bykey_plain(features, skeys, qkeys, weight, sentinel):
    """out[b, q] = sum_k weight[k]^T f[b, row(skeys == qkeys[b, k, q])]:
    the probe, a gather and a per-tap product."""
    B, V, C = features.shape
    _, K, Q = qkeys.shape
    idx, found = _lookup_plain(skeys, qkeys, sentinel)
    out = torch.zeros((B, Q, weight.shape[-1]), dtype=features.dtype,
                      device=features.device)
    for k in range(K):
        g = torch.gather(features, 1, idx[:, k].long()[..., None].expand(-1, -1, C))
        g = torch.where(found[:, k, :, None], g, torch.zeros_like(g))
        out = out + torch.matmul(g, weight[k])
    return out


def _lookup_plain(skeys, qkeys, sentinel):
    B, K, Q = qkeys.shape
    idx, found = probe_plain(skeys, qkeys.reshape(B, K * Q), sentinel)
    return idx.reshape(B, K, Q), found.reshape(B, K, Q)


def gather_matmul_bykey(features, skeys, qkeys, weight, sentinel):
    """Fused probe + gather + GEMM; kernel K4 on the card. features
    (B, V, C) key-sorted, skeys (B, V), qkeys (B, K, Q), weight (K, C, Co)
    -> (B, Q, Co)."""
    if not features.is_cuda:
        return gather_matmul_bykey_plain(features, skeys, qkeys, weight, sentinel)
    f = features.contiguous().float()
    sk = skeys.contiguous().to(torch.int32)
    qk = qkeys.contiguous().to(torch.int32)
    w = weight.contiguous().float()
    _kernels.require_cuda(f, sk, qk, w)
    B, V, C = f.shape
    K, Q, Co = qk.shape[1], qk.shape[2], w.shape[-1]
    _kernels.check_shape(sk, (B, V), "bykey skeys")
    _kernels.check_shape(qk, (B, K, Q), "bykey qkeys")
    _kernels.check_shape(w, (K, C, Co), "bykey weight")
    out = torch.empty((B, Q, Co), dtype=torch.float32, device=f.device)
    err = _kernels.func("spconv_bykey")(
        f.data_ptr(), sk.data_ptr(), qk.data_ptr(), w.data_ptr(), B, V, C, K,
        Q, Co, int(min(sentinel, 2**31 - 1)), out.data_ptr(),
        _kernels.stream_ptr(f.device))
    _kernels.check(err, "spconv_bykey")
    _kernels.count("spconv_bykey")
    return out


# ---------------------------------------------------------------------------
# K5: the by-key gather-GEMM backward
# ---------------------------------------------------------------------------

def gather_matmul_bykey_bwd_plain(features, skeys, qkeys, weight, g, sentinel):
    """(df, dW) of gather_matmul_bykey given the output cotangent g
    (B, Q, Co): per tap, the probe, a gather, dW[k] = G^T g and an
    index_add_ of g W[k]^T onto the found rows."""
    B, V, C = features.shape
    _, K, Q = qkeys.shape
    idx, found = _lookup_plain(skeys, qkeys, sentinel)
    rows = idx.long() + torch.arange(B, device=idx.device)[:, None, None] * V
    df = torch.zeros((B * V, C), dtype=g.dtype, device=g.device)
    dw = torch.zeros_like(weight, dtype=g.dtype)
    for k in range(K):
        hit = found[:, k, :, None]
        gk = torch.where(hit, g, torch.zeros_like(g))
        gath = torch.gather(features, 1, idx[:, k].long()[..., None].expand(-1, -1, C))
        gath = torch.where(hit, gath, torch.zeros_like(gath))
        dw[k] = torch.einsum("bqc,bqo->co", gath, gk)
        df.index_add_(0, rows[:, k].reshape(-1),
                      torch.matmul(gk, weight[k].t()).reshape(-1, C))
    return df.reshape(B, V, C), dw


def bykey_inverse_plain(skeys, qkeys, sentinel):
    """The per-tap inverse of a by-key map: inv (B, K, V) int64 with
    inv[b, k, row] = the target q whose key qkeys[b, k, q] names source row
    `row` of skeys[b], or -1 where none does. Raises ValueError if a tap names
    a row twice: K5's df route takes only maps that are injective per tap,
    as every rulebook the builders below make is."""
    B, K, Q = qkeys.shape
    V = skeys.shape[1]
    idx, found = _lookup_plain(skeys, qkeys, sentinel)
    dev = qkeys.device
    slot = (torch.arange(B * K, device=dev).reshape(B, K, 1) * V + idx.long())[found]
    if torch.unique(slot).numel() != slot.numel():
        raise ValueError("a tap of the map names a source row twice: the map is not "
                         "injective per tap")
    inv = torch.full((B * K * V,), -1, dtype=torch.int64, device=dev)
    inv[slot] = torch.arange(Q, device=dev).expand(B, K, Q)[found]
    return inv.reshape(B, K, V)


def gather_matmul_bykey_df_plain(skeys, qkeys, weight, g, sentinel):
    """df of gather_matmul_bykey as K5 computes it on the card: the per-tap
    inverse table (`bykey_inverse_plain`, which raises on a map that is not
    injective per tap), then df[b, row] = sum_k g[b, inv[b, k, row]] W[k]^T,
    summed in tap order, zero where no tap names the row. g (B, Q, Co),
    weight (K, C, Co) -> (B, V, C)."""
    inv = bykey_inverse_plain(skeys, qkeys, sentinel)
    B, K, V = inv.shape
    Co = g.shape[-1]
    df = torch.zeros((B, V, weight.shape[1]), dtype=g.dtype, device=g.device)
    for k in range(K):
        i = inv[:, k]
        gk = torch.gather(g, 1, torch.clamp(i, min=0)[..., None].expand(-1, -1, Co))
        gk = torch.where((i >= 0)[..., None], gk, torch.zeros_like(gk))
        df = df + torch.matmul(gk, weight[k].t())
    return df


def gather_matmul_bykey_bwd(features, skeys, qkeys, weight, g, sentinel):
    """Backward of gather_matmul_bykey; kernel K5 on the card. Returns
    df (B, V, C) and dW (K, C, Co), both f32, bit-equal from launch to
    launch. On the card the map must be injective per tap (no tap names a
    source row twice), as every rulebook of `build_subm_rulebook`,
    `build_conv_plan` and `build_inverse_rulebook` is: K5 inverts each tap's
    map, and a map that is not injective fails its launch. The plain
    version, taken for CPU tensors, accepts any map."""
    if not features.is_cuda:
        return gather_matmul_bykey_bwd_plain(features, skeys, qkeys, weight, g,
                                             sentinel)
    f = features.contiguous().float()
    sk = skeys.contiguous().to(torch.int32)
    qk = qkeys.contiguous().to(torch.int32)
    w = weight.contiguous().float()
    gg = g.contiguous().float()
    _kernels.require_cuda(f, sk, qk, w, gg)
    B, V, C = f.shape
    K, Q, Co = qk.shape[1], qk.shape[2], w.shape[-1]
    _kernels.check_shape(sk, (B, V), "bykey_bwd skeys")
    _kernels.check_shape(qk, (B, K, Q), "bykey_bwd qkeys")
    _kernels.check_shape(w, (K, C, Co), "bykey_bwd weight")
    _kernels.check_shape(gg, (B, Q, Co), "bykey_bwd g")
    slots = (ctypes.c_int * 1)()
    _kernels.check(_kernels.func("spconv_bykey_bwd_plan")(B, V, C, K, Co,
                                                          ctypes.addressof(slots)),
                   "spconv_bykey_bwd_plan")
    dev = f.device
    wt = w.transpose(1, 2).contiguous()   # W^T (K, Co, C): df's weights
    # scratch: the inverse table and, with several slots, dW's partial tiles;
    # the kernel writes every element of df and dW
    inv = torch.empty((B, K, V), dtype=torch.int32, device=dev)
    part = (torch.empty((slots[0], K, C, Co), dtype=torch.float32, device=dev)
            if slots[0] > 1 else None)
    df = torch.empty((B, V, C), dtype=torch.float32, device=dev)
    dw = torch.empty((K, C, Co), dtype=torch.float32, device=dev)
    err = _kernels.func("spconv_bykey_bwd")(
        f.data_ptr(), sk.data_ptr(), qk.data_ptr(), wt.data_ptr(), gg.data_ptr(), B, V, C,
        K, Q, Co, int(min(sentinel, 2**31 - 1)), slots[0], inv.data_ptr(), _kernels.ptr(part),
        df.data_ptr(), dw.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.check(err, "spconv_bykey_bwd")
    _kernels.count("spconv_bykey_bwd")
    return df, dw


class _ByKeyConv(torch.autograd.Function):
    """gather_matmul_bykey with its gradient: K4 forward and K5 backward on
    the card, the plain versions on the CPU (each wrapper dispatches on the
    tensor's device). The keys get no gradient."""

    @staticmethod
    def forward(ctx, features, weight, skeys, qkeys, sentinel):
        ctx.save_for_backward(features, weight, skeys, qkeys)
        ctx.sentinel = sentinel
        return gather_matmul_bykey(features, skeys, qkeys, weight, sentinel)

    @staticmethod
    def backward(ctx, g):
        features, weight, skeys, qkeys = ctx.saved_tensors
        df, dw = gather_matmul_bykey_bwd(features, skeys, qkeys, weight, g,
                                         ctx.sentinel)
        return df.to(features.dtype), dw.to(weight.dtype), None, None, None


def _gather_conv_bykey(features, rulebook, weight, out_valid, grid):
    out = _ByKeyConv.apply(features, weight, rulebook.skeys, rulebook.qkeys,
                           int(np.prod(grid)))
    return torch.where(out_valid[..., None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# K7: the index gather-GEMM (materialised rulebooks)
# ---------------------------------------------------------------------------

def gather_matmul_plain(features, idx, weight):
    """out[b, q] = sum_k weight[k]^T features[b, idx[b, k, q]], an index of
    -1 contributing zero (the JAX `_xla_reference`, ops/spconv_pallas.py:576):
    per tap a gather and a product. features (B, V, C), idx (B, K, Q) int,
    weight (K, C, Co) -> (B, Q, Co)."""
    B, V, C = features.shape
    _, K, Q = idx.shape
    out = torch.zeros((B, Q, weight.shape[-1]), dtype=features.dtype,
                      device=features.device)
    for k in range(K):
        i = idx[:, k].long()
        g = torch.gather(features, 1, torch.clamp(i, min=0)[..., None].expand(-1, -1, C))
        g = torch.where((i >= 0)[..., None], g, torch.zeros_like(g))
        out = out + torch.matmul(g, weight[k])
    return out


def gather_matmul(features, idx, weight):
    """Index gather + GEMM; kernel K7 on the card. features (B, V, C), idx
    (B, K, Q) int32 in [0, V) or -1, weight (K, C, Co) -> (B, Q, Co) f32."""
    if not features.is_cuda:
        return gather_matmul_plain(features, idx, weight)
    if torch.is_grad_enabled() and (features.requires_grad or weight.requires_grad):
        raise NotImplementedError("kernel K7 (spconv_gather) has no backward yet: "
                                  "the materialised route runs under no_grad")
    f = features.contiguous().float()
    ix = idx.contiguous().to(torch.int32)
    w = weight.contiguous().float()
    _kernels.require_cuda(f, ix, w)
    B, V, C = f.shape
    K, Q, Co = ix.shape[1], ix.shape[2], w.shape[-1]
    _kernels.check_shape(ix, (B, K, Q), "gather idx")
    _kernels.check_shape(w, (K, C, Co), "gather weight")
    out = torch.empty((B, Q, Co), dtype=torch.float32, device=f.device)
    err = _kernels.func("spconv_gather")(
        f.data_ptr(), ix.data_ptr(), w.data_ptr(), B, V, C, K, Q, Co,
        out.data_ptr(), _kernels.stream_ptr(f.device))
    _kernels.check(err, "spconv_gather")
    _kernels.count("spconv_gather")
    return out


def _gather_conv(features, idx, found, weight, out_valid):
    """The materialised route (JAX ops/spconv.py:209-219): the rulebook's
    misses become -1, then K7, then the output mask."""
    idxm = torch.where(found, idx, torch.full_like(idx, -1))
    out = gather_matmul(features, idxm, weight)
    return torch.where(out_valid[..., None], out, torch.zeros_like(out))


def _conv(features, rulebook, weight, out_valid, grid):
    """Dispatch on the rulebook's kind, as the JAX package does."""
    if isinstance(rulebook, LazyRulebook):
        return _gather_conv_bykey(features, rulebook, weight, out_valid, grid)
    idx, found = rulebook
    return _gather_conv(features, idx, found, weight, out_valid)


# ---------------------------------------------------------------------------
# rulebooks and convs
# ---------------------------------------------------------------------------

def build_subm_rulebook(coords, valid, grid, kernel_size=3, lazy=True):
    """The rulebook of a submanifold conv: a `LazyRulebook`, or with
    lazy=False the probed (idx, found) (B, K, V), found & valid."""
    offs = torch.as_tensor(kernel_offsets(kernel_size), device=coords.device)
    keys = linearize(coords, grid, valid)                          # (B, V)
    qc = coords[:, None, :, :].long() + offs[None, :, None, :]     # (B, K, V, 3)
    qk = linearize(qc, grid, valid[:, None, :])
    if lazy:
        return LazyRulebook(keys, qk)
    idx, found = _lookup_batched(keys, qk, int(np.prod(grid)))
    return idx, found & valid[:, None, :]


def subm_conv3d(features, coords, valid, weight, grid, rulebook=None):
    """Submanifold sparse conv: output at the input positions. weight
    (K, Cin, Cout), taps ordered like kernel_offsets(). Returns (B, V, Cout)."""
    K = weight.shape[0]
    if K == 1:
        out = torch.matmul(features, weight[0])
        return torch.where(valid[..., None], out, torch.zeros_like(out))
    if rulebook is None:
        rulebook = build_subm_rulebook(coords, valid, grid, round(K ** (1 / 3)))
    return _conv(features, rulebook, weight, valid, grid)


def _downsample_out_coords(coords, valid, grid, out_grid, kernel_size, stride,
                           padding, out_capacity):
    """Exact strided-conv output set: the union over inputs of every output
    whose receptive field covers them, sorted-unique to `out_capacity`.
    coords (B, V, 3). Returns out_coords (B, Vo, 3) int32, out_valid (B, Vo)."""
    dev = coords.device
    ks = np.asarray(_triple(kernel_size))
    st = np.asarray(_triple(stride))
    pd = np.asarray(_triple(padding))
    n_cand = [int(np.ceil(k / s)) for k, s in zip(ks, st)]
    cand_offsets = np.stack(
        np.meshgrid(*[np.arange(n) for n in n_cand], indexing="ij"), axis=-1
    ).reshape(-1, 3)
    st_t = torch.as_tensor(st, device=dev)
    pd_t = torch.as_tensor(pd, device=dev)
    ks_t = torch.as_tensor(ks, device=dev)
    c = coords.long()
    num = c + pd_t - ks_t + 1
    o_min = torch.where(num >= 0, (num + st_t - 1) // st_t, -((-num) // st_t))
    o_max = (c + pd_t) // st_t
    cands = o_min[:, :, None, :] + torch.as_tensor(cand_offsets, device=dev)
    og = torch.as_tensor(out_grid, device=dev)
    ok = (valid[:, :, None] & (cands <= o_max[:, :, None, :]).all(-1)
          & (cands >= 0).all(-1) & (cands < og).all(-1))
    B = coords.shape[0]
    cands = cands.reshape(B, -1, 3)
    ok = ok.reshape(B, -1)

    keys = linearize(cands, out_grid, ok).long()
    skeys, order = torch.sort(keys, dim=1, stable=True)
    scoords = torch.gather(cands, 1, order[..., None].expand(-1, -1, 3))
    sentinel = int(np.prod(out_grid))
    svalid = skeys < sentinel
    is_start = torch.cat(
        [svalid[:, :1], (skeys[:, 1:] != skeys[:, :-1]) & svalid[:, 1:]], 1)
    slot = torch.cumsum(is_start.long(), 1) - 1
    big = 2**31 - 1
    ckey = torch.where(is_start, slot, torch.full_like(slot, big))
    if ckey.shape[1] < out_capacity:
        pad = out_capacity - ckey.shape[1]
        ckey = torch.cat([ckey, torch.full((B, pad), big, dtype=ckey.dtype,
                                           device=dev)], 1)
        scoords = torch.cat([scoords, torch.zeros((B, pad, 3),
                                                  dtype=scoords.dtype,
                                                  device=dev)], 1)
    _, corder = torch.sort(ckey, dim=1, stable=True)
    corder = corder[:, :out_capacity]
    out_coords = torch.gather(scoords, 1, corder[..., None].expand(-1, -1, 3))
    n_out = torch.clamp(is_start.sum(1), max=out_capacity)
    out_valid = torch.arange(out_capacity, device=dev)[None, :] < n_out[:, None]
    out_coords = torch.where(out_valid[..., None], out_coords,
                             torch.full_like(out_coords, -1))
    return out_coords.to(torch.int32), out_valid


def build_conv_plan(coords, valid, grid, out_grid, kernel_size, stride,
                    padding, out_capacity, lazy=True):
    """Weight-independent part of a strided conv: (out_coords (B, Vo, 3),
    out_valid (B, Vo), rulebook): a LazyRulebook, or with lazy=False the
    probed (idx, found) (B, K, Vo), found & out_valid."""
    dev = coords.device
    offs = torch.as_tensor(kernel_offsets(kernel_size), device=dev).long()
    ks = _triple(kernel_size)
    st = torch.as_tensor(_triple(stride), device=dev)
    pd = torch.as_tensor(_triple(padding), device=dev)
    lo = torch.as_tensor([-(k // 2) if k % 2 == 1 else 0 for k in ks], device=dev)
    oc, ov = _downsample_out_coords(coords, valid, grid, out_grid, kernel_size,
                                    stride, padding, out_capacity)
    in_keys = linearize(coords, grid, valid)
    # input position for tap t at output o: i = o*s - p + tap, tap in [0, k)
    taps = offs - lo[None, :]
    qc = oc[:, None, :, :].long() * st - pd + taps[None, :, None, :]
    qk = linearize(qc, grid, ov[:, None, :])
    if lazy:
        return oc, ov, LazyRulebook(in_keys, qk)
    idx, found = _lookup_batched(in_keys, qk, int(np.prod(grid)))
    return oc, ov, (idx, found & ov[:, None, :])


def sparse_conv3d(features, coords, valid, weight, grid, out_grid,
                  kernel_size, stride, padding, out_capacity, plan=None):
    """Strided sparse conv. Returns (features (B, Vo, Cout), out_coords,
    out_valid) with out coords in out_grid units, sorted."""
    if plan is None:
        plan = build_conv_plan(coords, valid, grid, out_grid, kernel_size,
                               stride, padding, out_capacity)
    oc, ov, rulebook = plan
    return _conv(features, rulebook, weight, ov, grid), oc, ov


def build_inverse_rulebook(coarse_coords, coarse_valid, fine_coords,
                           fine_valid, coarse_grid, kernel_size, stride,
                           padding, lazy=True):
    """Fine o receives coarse c with tap = o - (c*s - p) when 0 <= tap < k.
    A LazyRulebook, or with lazy=False the probed (idx, found) (B, K, Vf),
    found & fine_valid & exact."""
    dev = coarse_coords.device
    ks = _triple(kernel_size)
    offs = torch.as_tensor(kernel_offsets(kernel_size), device=dev).long()
    lo = torch.as_tensor([-(k // 2) if k % 2 == 1 else 0 for k in ks], device=dev)
    st = torch.as_tensor(_triple(stride), device=dev)
    pd = torch.as_tensor(_triple(padding), device=dev)
    ckeys = linearize(coarse_coords, coarse_grid, coarse_valid)
    taps = offs - lo[None, :]
    num = fine_coords[:, None, :, :].long() + pd - taps[None, :, None, :]
    c_cand = num // st
    exact = (c_cand * st == num).all(-1)
    qk = linearize(c_cand, coarse_grid, fine_valid[:, None, :] & exact)
    if lazy:
        return LazyRulebook(ckeys, qk)
    idx, found = _lookup_batched(ckeys, qk, int(np.prod(coarse_grid)))
    return idx, found & fine_valid[:, None, :] & exact


def inverse_conv3d(coarse_features, coarse_coords, coarse_valid, weight,
                   fine_coords, fine_valid, coarse_grid, kernel_size, stride,
                   padding, rulebook=None):
    """Sparse inverse conv back onto a known fine position set. Returns
    (B, Vf, Cout)."""
    if rulebook is None:
        rulebook = build_inverse_rulebook(
            coarse_coords, coarse_valid, fine_coords, fine_valid,
            coarse_grid, kernel_size, stride, padding)
    return _conv(coarse_features, rulebook, weight, fine_valid, coarse_grid)


def sparse_to_dense(features, coords, valid, grid):
    """(B, V, C) sparse -> (B, gz, gy, gx, C) dense (spconv's .dense()); the
    invalid rows are dropped, not written."""
    gz, gy, gx = grid
    B, V, C = features.shape
    cells = gz * gy * gx
    key = linearize(coords, grid, valid).long()                   # sentinel = cells
    flat = key + torch.arange(B, device=key.device)[:, None] * (cells + 1)
    dense = torch.zeros((B * (cells + 1), C), dtype=features.dtype,
                        device=features.device)
    # every invalid row lands on its scan's drop row (cells), which is cut off
    dense.index_copy_(0, flat.reshape(-1), features.reshape(-1, C))
    return dense.reshape(B, cells + 1, C)[:, :cells].reshape(B, gz, gy, gx, C)
