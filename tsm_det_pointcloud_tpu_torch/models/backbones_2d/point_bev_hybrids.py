"""The TSM project's BEV / point hybrid 2D backbones (counterpart of
tsm_det_pointcloud_tpu/models/backbones_2d/point_bev_hybrids.py):
`SparsePointBackbone`, `PointFromVoxel`, `VoxelPointCross` and `BEVPoint`,
and the parts they share.

Each takes the sparse trunk's pyramid (`multi_scale_3d_features`, the
`SparseTensor`s of VoxelBackBone8x) or its height-compressed BEV map
(`spatial_features`, NHWC) and the raw points, and writes a point set for
the heads (`point_coords`, `point_valid`, `point_features`) beside the BEV
map (`spatial_features_2d`, NHWC). Flax infers every layer's input width;
here each module is built from `pyramid`, {source: (channels, grid
(gz, gy, gx), stride)} of the trunk's levels, and the widths of its
inputs, and reports the widths it writes (`bev_channels`,
`point_channels`).

The hand-written kernels these modules reach: d-fps and s-fps
(`sampling.furthest_point_sample[_weights]`: K1 up to 16384 points a row,
K6 past that), the window and ball queries (`grouping.query_group`: K2),
the containing-voxel lookups (`spconv.probe`: K3). The 2D convs are
`nn.Conv2d` (cuDNN on the card; the JAX package leaves them to XLA, outside
any Pallas kernel) with flax's SAME padding: a stride-2 3 x 3 conv on an
even side pads 0 before and 1 after (`ddn.same_pads`, `_same_conv`). BN is flax's
(`base_bev_backbone._BatchNorm2d`, 1e-3 / 0.99), GroupNorm flax's epsilon
1e-6 (torch's default is 1e-5).

Selection follows the JAX package's tie rules: its stable argsorts keep the
lower index first and +0.0 above -0.0 (`split_select`, `_desc_order`, the
partitions of `subset_fps`), its top-k too (`_top_k`); `subset_fps` seeds at the
first row of the stably partitioned order. The per-class statistics
(`ClassStatistics`) are a buffer of the module, updated in train mode from
`accumulated_iter` on (`STAT_START_ITER`), with the per-class sums, counts
and maxima over the data group (`parallel.comm`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import grouping, sampling
from ...ops import spconv as sp
from ...ops.voxel import voxel_centroids, voxel_query
from ...parallel import comm
from ..backbones_3d.ddn import same_pads
from ..backbones_3d.pfe.voxel_set_abstraction import _clip01, voxel_centers
from ..backbones_3d.pointnet2_modules import SharedMLP
from .base_bev_backbone import _BatchNorm2d

# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def _pixels(pts, voxel_size, pcr, bev_stride):
    """(B, N, 3) metric -> (B, N) fractional pixel x / y at `bev_stride`."""
    px = (pts[..., 0] - pcr[0]) / (voxel_size[0] * bev_stride)
    py = (pts[..., 1] - pcr[1]) / (voxel_size[1] * bev_stride)
    return px, py


def _z_index(pts, voxel_size, pcr, z_stride):
    return (pts[..., 2] - pcr[2]) / (voxel_size[2] * z_stride)


def _take(vol, *idx):
    """vol (B, D1, .., Dk, C) at int64 indices idx (k tensors (B, N)) ->
    (B, N, C)."""
    B, C = vol.shape[0], vol.shape[-1]
    flat = idx[0]
    for d, i in zip(vol.shape[2:-1], idx[1:]):
        flat = flat * d + i
    return torch.gather(vol.reshape(B, -1, C), 1, flat[..., None].expand(-1, -1, C))


def _floor_index(x, hi):
    return torch.clamp(torch.floor(x).to(torch.int64), 0, hi)


def interp_bev(bev, px, py):
    """Bilinear (B, H, W, C) at (B, N) pixels -> (B, N, C): the low corner
    clipped to W - 2 / H - 2, the weights to [0, 1] (VSA's
    `bilinear_interpolate`, batched)."""
    _, H, W, _ = bev.shape
    x0, y0 = _floor_index(px, W - 2), _floor_index(py, H - 2)
    x1, y1 = x0 + 1, y0 + 1
    wx = _clip01(px - x0.to(px.dtype))[..., None]
    wy = _clip01(py - y0.to(py.dtype))[..., None]
    return (_take(bev, y0, x0) * ((1 - wx) * (1 - wy)) + _take(bev, y0, x1) * (wx * (1 - wy))
            + _take(bev, y1, x0) * ((1 - wx) * wy) + _take(bev, y1, x1) * (wx * wy))


def interp_bev3d(vol, px, py, pz):
    """Trilinear (B, H, W, G, C) at (B, N) pixel and z-slot indices: each low
    corner clipped to the last cell (W - 1), its neighbour too."""
    _, H, W, G, _ = vol.shape
    x0, y0, z0 = _floor_index(px, W - 1), _floor_index(py, H - 1), _floor_index(pz, G - 1)
    x1, y1, z1 = (torch.clamp(x0 + 1, 0, W - 1), torch.clamp(y0 + 1, 0, H - 1),
                  torch.clamp(z0 + 1, 0, G - 1))
    u = _clip01(px - x0.to(px.dtype))[..., None]
    w = _clip01(py - y0.to(py.dtype))[..., None]
    t = _clip01(pz - z0.to(pz.dtype))[..., None]
    return ((1 - u) * (1 - w) * (1 - t) * _take(vol, y0, x0, z0)
            + (1 - u) * (1 - w) * t * _take(vol, y0, x0, z1)
            + (1 - u) * w * (1 - t) * _take(vol, y1, x0, z0)
            + (1 - u) * w * t * _take(vol, y1, x0, z1)
            + u * (1 - w) * (1 - t) * _take(vol, y0, x1, z0)
            + u * (1 - w) * t * _take(vol, y0, x1, z1)
            + u * w * (1 - t) * _take(vol, y1, x1, z0)
            + u * w * t * _take(vol, y1, x1, z1))


def nearest_cell(vol, px, py, pz):
    """The floor cell of (B, H, W, G, C) (clipped to the last) and the
    sub-cell offsets: (feat (B, N, C), offs (B, N, 3))."""
    _, H, W, G, _ = vol.shape
    x0, y0, z0 = _floor_index(px, W - 1), _floor_index(py, H - 1), _floor_index(pz, G - 1)
    offs = torch.stack([px - x0.to(px.dtype) - 0.5, py - y0.to(py.dtype) - 0.5,
                        pz - z0.to(pz.dtype) - 0.5], -1)
    return _take(vol, y0, x0, z0), offs


def bev_from_sparse(st):
    """The dense BEV map of a SparseTensor, z folded into the channels
    (channel z * C + c): (B, gy, gx, gz * C)."""
    gz, gy, gx = st.grid
    dense = sp.sparse_to_dense(st.features, st.coords, st.valid, st.grid)
    return dense.permute(0, 2, 3, 1, 4).reshape(dense.shape[0], gy, gx, gz * st.features.shape[-1])


def _partition(mask):
    """The stable partition order of each row: the True lanes first."""
    return torch.argsort((~mask).to(torch.int32), dim=1, stable=True)


def subset_fps(xyz, mask, k):
    """d-fps over the rows where `mask` (B, N), seeded at the first of them;
    (B, k) int64 indices into the full axis."""
    order = _partition(mask)
    gx = sampling.gather_points(xyz.detach(), order).contiguous()
    vm = torch.arange(xyz.shape[1], device=xyz.device)[None] < mask.sum(1)[:, None]
    idx = sampling.furthest_point_sample(gx, int(k), vm)
    return torch.gather(order, 1, idx.long())


def subset_fps_weighted(xyz, weights, mask, k):
    """s-fps (weights times the running distance) over the rows where
    `mask`, indices into the full axis."""
    order = _partition(mask)
    gx = sampling.gather_points(xyz.detach(), order).contiguous()
    gw = torch.gather(weights.detach(), 1, order).contiguous()
    vm = torch.arange(xyz.shape[1], device=xyz.device)[None] < mask.sum(1)[:, None]
    idx = sampling.furthest_point_sample_weights(gx, gw, int(k), vm)
    return torch.gather(order, 1, idx.long())


def _desc_order(s):
    """(B, N) -> the indices that sort each row descending in XLA's order:
    equal values by index, +0.0 above -0.0 (two stable sorts)."""
    by_sign = torch.argsort(torch.signbit(s).to(torch.int8), dim=1, stable=True)
    order = torch.sort(torch.gather(s, 1, by_sign), dim=1, descending=True, stable=True).indices
    return torch.gather(by_sign, 1, order)


def _top_k(s, k):
    """(B, N) -> (B, k) int64 indices of the k largest in lax.top_k's
    order."""
    return _desc_order(s)[:, :k]


def split_select(xyz, score, valid, n_top, n_rest, training, fps_top=False, n_eval=None):
    """The fg / candidate selection. Training: the points by score (stable,
    descending); the first `n_top` valid ones are "confident"; keep them and
    d-fps `n_rest` of the other valid points, or with `fps_top` d-fps
    `n_rest` from each partition. Eval: the top `n_eval` (default n_top +
    n_rest) by score. (B, K) int64 indices."""
    s = torch.where(valid, score, torch.full_like(score, float("-inf")))
    if not training:
        return _top_k(s, int(n_eval if n_eval is not None else n_top + n_rest))
    order = _desc_order(s)                     # jnp.argsort(-s): ascending -s, stable
    lanes = torch.arange(xyz.shape[1], device=xyz.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, lanes)
    in_top = (rank < n_top) & valid
    rest = ~in_top & valid
    sel1 = subset_fps(xyz, in_top, n_rest) if fps_top else order[:, :n_top]
    return torch.cat([sel1, subset_fps(xyz, rest, n_rest)], 1)


def _rows(t, idx):
    """t (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    idx = idx.long()
    if t.dim() == 2:
        return torch.gather(t, 1, idx)
    return torch.gather(t, 1, idx.reshape(*idx.shape, *[1] * (t.dim() - 2)).expand(
        *idx.shape, *t.shape[2:]))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# shared modules
# ---------------------------------------------------------------------------

def _same_conv(conv, x):
    """A grouped `conv` (padding 0, no bias) on NCHW x with flax SAME
    padding, explicit (`F.pad`) where it is asymmetric."""
    k, s = conv.kernel_size[0], conv.stride[0]
    (t, b), (l, r) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    if t != b or l != r:
        x, t, l = F.pad(x, (l, r, t, b)), 0, 0
    return F.conv2d(x, conv.weight, None, s, (t, l), 1, conv.groups)


class ConvBlock(nn.Module):
    """`conv{i}` (no bias, `groups`, SAME padding, `stride` on the first) +
    `bn{i}` (or `gn{i}`, GroupNorm of `groups` groups) + ReLU a width in
    `channels`; NCHW in and out. No widths: the identity."""

    def __init__(self, in_channels, channels, kernel=3, stride=1, groups=1, group_norm=False):
        super().__init__()
        self.n = len(channels)
        self.group_norm = group_norm
        c = int(in_channels)
        for i, co in enumerate(channels):
            setattr(self, f"conv{i}", nn.Conv2d(c, int(co), kernel, stride=stride if i == 0 else 1,
                                                groups=groups, bias=False))
            setattr(self, f"gn{i}" if group_norm else f"bn{i}",
                    nn.GroupNorm(groups, int(co), eps=1e-6) if group_norm
                    else _BatchNorm2d(int(co)))
            c = int(co)
        self.out_channels = c

    def forward(self, x):
        for i in range(self.n):
            x = _same_conv(getattr(self, f"conv{i}"), x)
            x = torch.relu(getattr(self, f"gn{i}" if self.group_norm else f"bn{i}")(x))
        return x


class SEBlock(nn.Module):
    """Squeeze-excitation: the map's mean a channel, `fc1` (hidden) + ReLU,
    `fc2` + sigmoid; NCHW in, (B, C, 1, 1) gates out."""

    def __init__(self, channels, hidden=16):
        super().__init__()
        self.fc1 = nn.Linear(int(channels), int(hidden))
        self.fc2 = nn.Linear(int(hidden), int(channels))

    def forward(self, x):
        s = torch.relu(self.fc1(x.mean((2, 3))))
        return torch.sigmoid(self.fc2(s))[:, :, None, None]


X_CONV_CHANNELS = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64, "x_conv4": 64}


class PointGridPool(nn.Module):
    """Multi-scale voxel-neighbour pooling at query points: for each
    FEATURES_SOURCE and each of its POOL_RADIUS / NSAMPLE, a K2 window query
    (QUERY_RANGES voxels a side, default 4) of the points' voxel coordinates
    against the level's voxel centres, `pool_<src>_<i>` (SharedMLP over [the
    centres' xyz - the point, the voxel features]) max-pooled over the
    filled slots; 0 for an invalid point or an empty window. Returns
    (pooled (B, N, out_channels), density (B, N): the mean over the scales
    of the filled share of their slots). `source_channels`: the levels'
    feature widths."""

    def __init__(self, pool_cfg, voxel_size, point_cloud_range, source_channels=None):
        super().__init__()
        chans = source_channels or X_CONV_CHANNELS
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.sources = list(pool_cfg["FEATURES_SOURCE"])
        self.scales = {}
        self.out_channels = 0
        for src in self.sources:
            sc = pool_cfg["POOL_LAYERS"][src]
            n = len(sc["POOL_RADIUS"])
            ranges = sc.get("QUERY_RANGES", [[4, 4, 4]] * n)
            self.scales[src] = [(float(r), int(ns), tuple(int(v) for v in ranges[i]))
                                for i, (r, ns) in enumerate(zip(sc["POOL_RADIUS"], sc["NSAMPLE"]))]
            for i in range(n):
                m = SharedMLP(3 + int(chans[src]), sc["MLPS"][i])
                setattr(self, f"pool_{src}_{i}", m)
                self.out_channels += m.channels[-1]

    def forward(self, batch_dict, pts, pvalid):
        pooled, density = [], []
        origin = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32, device=pts.device)
        for src in self.sources:
            st = batch_dict["multi_scale_3d_features"][src]
            stride = batch_dict["multi_scale_3d_strides"][src]
            vs = torch.tensor(np.asarray(self.voxel_size) * stride, dtype=torch.float32,
                              device=pts.device)
            centers = voxel_centers(st.coords, stride, self.voxel_size, self.point_cloud_range)
            gcoords = torch.floor((pts.detach() - origin) / vs).to(torch.int32).flip(-1)
            for i, (radius, ns, qr) in enumerate(self.scales[src]):
                idx, cnt = voxel_query(pts.detach().float(), gcoords, centers, st.coords,
                                       st.valid, radius, ns, qr)
                slot_ok = (torch.arange(ns, device=pts.device) < cnt[..., None]) & pvalid[..., None]
                g = torch.cat([grouping.group_points(centers, idx) - pts[:, :, None, :],
                               grouping.group_points(st.features, idx)], -1)
                g = torch.where(slot_ok[..., None], g, torch.zeros_like(g))
                h = getattr(self, f"pool_{src}_{i}")(g, slot_ok)
                h = torch.where(slot_ok[..., None], h, torch.full_like(h, -1e9)).amax(2)
                keep = pvalid[..., None] & (cnt[..., None] > 0)
                pooled.append(torch.where(keep, h, torch.zeros_like(h)))
                density.append(cnt.to(torch.float32) / float(ns))
        return torch.cat(pooled, -1), torch.stack(density, -1).mean(-1)


def _grid_coords(pts, voxel_size, stride, pcr):
    """(B, N, 3) -> (B, N, 3) int32 xyz voxel coordinates at `stride`."""
    vs = torch.tensor(np.asarray(voxel_size, np.float64) * stride, dtype=torch.float32,
                      device=pts.device)
    origin = torch.tensor(pcr[:3], dtype=torch.float32, device=pts.device)
    return torch.floor((pts - origin) / vs).to(torch.int32)


def lookup_sp_at_points(st, stride, pts, pvalid, voxel_size, pcr):
    """Each point's containing voxel of `st` (a point outside the grid
    clamped onto its border voxel) by one K3 probe: (feat (B, N, C), the
    point's offset from the voxel's centre (B, N, 3), hit (B, N)); 0 where
    the voxel is empty or the point invalid."""
    gz, gy, gx = st.grid
    hi = torch.tensor([gx - 1, gy - 1, gz - 1], dtype=torch.int32, device=pts.device)
    g = torch.minimum(torch.maximum(_grid_coords(pts.detach(), voxel_size, stride, pcr),
                                    torch.zeros_like(hi)), hi)
    skeys = sp.linearize(st.coords, st.grid, st.valid)
    qkeys = sp.linearize(g.flip(-1), st.grid, pvalid)
    pos, hit = sp.probe(skeys, qkeys, gz * gy * gx)
    hit = hit & pvalid
    pos = torch.clamp(pos.long(), 0, st.features.shape[1] - 1)
    feat = _rows(st.features, pos)
    offset = pts - _rows(voxel_centers(st.coords, stride, voxel_size, pcr), pos)
    return (torch.where(hit[..., None], feat, torch.zeros_like(feat)),
            torch.where(hit[..., None], offset, torch.zeros_like(offset)), hit)


def scale_centroids(points, points_mask, st, stride, voxel_size, pcr):
    """The raw points' centroid in each voxel of `st`, aligned with its rows
    (points outside the grid dropped; the voxels' keys probed by K3):
    (centroid_xyz (B, V, 3), has_centroid (B, V))."""
    gz, gy, gx = st.grid
    g = _grid_coords(points[..., :3], voxel_size, stride, pcr)
    ext = torch.tensor([gx, gy, gz], dtype=torch.int32, device=points.device)
    inb = (g >= 0).all(-1) & (g < ext).all(-1) & points_mask
    V = st.coords.shape[1]
    out = voxel_centroids(g.flip(-1), points[..., :3], inb, num_voxels=V, grid_dims=st.grid)
    skeys = sp.linearize(st.coords, st.grid, st.valid)
    ckeys = sp.linearize(out["coordinates"], st.grid, out["valid"])
    pos, hit = sp.probe(skeys, ckeys, gz * gy * gx)
    hit = hit & out["valid"]
    B = points.shape[0]
    tgt = torch.where(hit, pos.long(), torch.full_like(pos, V, dtype=torch.int64))
    buf = out["centroids"].new_zeros(B, V + 1, 3).scatter_(
        1, tgt[..., None].expand(-1, -1, 3), out["centroids"])
    ok = torch.zeros(B, V + 1, dtype=torch.bool, device=points.device).scatter_(1, tgt, hit)
    return buf[:, :V], ok[:, :V]


class ClassStatistics(nn.Module):
    """The per-class feature statistics buffer `object_statistic_features`
    (num_class, feat_dim). In train mode, once `accumulated_iter` reaches
    `start_iter`, each class's row moves to the statistic of the rows of
    that class (weights `weight`): their mean ("mean") or their maximum
    minus their mean ("maxmean"), as `buf * momentum + new * (1 -
    momentum)` (or `buf * momentum + new` with `decay_only`), replaced at
    the first iteration, kept where the class has no row. Returns (each
    row's statistic by `class_idx`, the (num_class, C) statistics), both 0
    before `start_iter`; neither carries a gradient."""

    def __init__(self, num_class, feat_dim, start_iter, momentum=0.7, mode="mean",
                 decay_only=False):
        super().__init__()
        self.num_class = int(num_class)
        self.start_iter = int(start_iter)
        self.momentum = float(momentum)
        self.mode = mode
        self.decay_only = decay_only
        self.register_buffer("object_statistic_features",
                             torch.zeros(self.num_class, int(feat_dim)))

    @torch.no_grad()
    def _update(self, features, class_idx, weight, it):
        C = features.shape[-1]
        feats = features.detach().reshape(-1, C)
        one_hot = F.one_hot(class_idx.reshape(-1).long(), self.num_class).to(feats.dtype)
        one_hot = one_hot * weight.reshape(-1, 1).to(feats.dtype)
        packed = comm.global_sum(torch.cat([one_hot.T @ feats, one_hot.sum(0)[:, None]], 1))
        sums, cnts = packed[:, :C], packed[:, C]
        mean = sums / torch.clamp(cnts[:, None], min=1.0)
        if self.mode == "maxmean":
            big = torch.where((one_hot.T > 0)[..., None], feats[None],
                              torch.full((), float("-inf"), device=feats.device)).amax(1)
            big = comm.global_max(big)
            new = torch.where(torch.isfinite(big), big, torch.zeros_like(big)) - mean
        else:
            new = mean
        stat = self.object_statistic_features
        m = self.momentum
        upd = stat * m + new if self.decay_only else stat * m + new * (1 - m)
        if it == self.start_iter:
            upd = new
        stat.copy_(torch.where((cnts > 0)[:, None], upd, stat))

    def forward(self, features, class_idx, weight, accumulated_iter=0):
        it = int(accumulated_iter)
        active = it >= self.start_iter
        if self.training and active:
            self._update(features, class_idx, weight, it)
        rows = self.object_statistic_features.detach().clone()
        if not active:
            rows = torch.zeros_like(rows)
        return rows[torch.clamp(class_idx.long(), 0, self.num_class - 1)], rows


def _raw_features(points, pts):
    """The points' features after xyz, or one zero column when they have
    none."""
    raw = points[..., 3:]
    return raw if raw.shape[-1] else pts.new_zeros(*pts.shape[:2], 1)


# ---------------------------------------------------------------------------
# BEVPoint
# ---------------------------------------------------------------------------

def _bev_scales(pyramid):
    """x_conv3 / 4 / 5 where the trunk has them all, else its three coarsest
    levels."""
    scales = [s for s in ("x_conv3", "x_conv4", "x_conv5") if s in pyramid]
    if len(scales) < 3:
        scales = sorted(pyramid, key=lambda s: pyramid[s][2])[-3:]
    return scales


class BEVPoint(nn.Module):
    """Multi-scale BEV trunks over three levels' dense BEV maps
    (`bev_from_sparse`): `v_input_scale{i}`, a strided shortcut of the
    previous scale (`v_short_scale{i}`), `v_block{i}` (N_BLOCK convs); each
    scale to the finest one's stride by `scale{i}_deconv` (a ConvTranspose
    with `scale{i}_deconv_bn`, or a 1 x 1 ConvBlock at that stride) and the
    three concatenated (3 * NUM_FILTERS, `spatial_features_2d`). Every
    level's voxels get `point_features{i}` of their features plus the fused
    map sampled at their centres (levels x_conv1-3 refreshed with them in
    `multi_scale_3d_features`); the raw levels' (x_conv1-2) best
    NUM_RAW_KEYPOINTS by `raw_fg_pred` and the three BEV levels' voxels are
    the point set."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range, pyramid):
        super().__init__()
        cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        ch = int(cfg.get("NUM_FILTERS", 128))
        n_block = list(cfg.get("N_BLOCK", [1, 1, 1]))
        self.k_raw = int(cfg.get("NUM_RAW_KEYPOINTS", 1000))
        self.scales = _bev_scales(pyramid)
        self.all_sc = sorted(pyramid, key=lambda s: pyramid[s][2])
        strides = {s: pyramid[s][2] for s in pyramid}
        self.factors = []
        for i, s in enumerate(self.scales):
            c, (gz, _, _), _ = pyramid[s]
            setattr(self, f"v_input_scale{i + 1}", ConvBlock(gz * c, (ch,)))
            if i:
                setattr(self, f"v_short_scale{i}", ConvBlock(ch, (ch,), stride=2))
            setattr(self, f"v_block{i + 1}", ConvBlock(ch, (ch,) * int(n_block[i])))
            f = strides[s] // strides[self.scales[0]]
            self.factors.append(f)
            if f > 1:
                setattr(self, f"scale{i + 1}_deconv",
                        nn.ConvTranspose2d(ch, ch, f, stride=f, bias=False))
                setattr(self, f"scale{i + 1}_deconv_bn", _BatchNorm2d(ch))
            else:
                setattr(self, f"scale{i + 1}_deconv", ConvBlock(ch, (ch,), kernel=1))
        for i, s in enumerate(self.all_sc):
            setattr(self, f"point_features{i + 1}", SharedMLP(pyramid[s][0], [3 * ch]))
        self.raw_fg_pred = nn.Linear(3 * ch, 3, bias=False)
        self.bev_channels = self.point_channels = 3 * ch

    def forward(self, batch_dict):
        msf = batch_dict["multi_scale_3d_features"]
        strides = batch_dict["multi_scale_3d_strides"]
        ms2d = batch_dict.get("multi_scale_2d_features")
        prev, ups = None, []
        for i, s in enumerate(self.scales):
            m = ms2d[s] if ms2d and s in ms2d else bev_from_sparse(msf[s])
            m = getattr(self, f"v_input_scale{i + 1}")(_nchw(m))
            if prev is not None:
                m = m + getattr(self, f"v_short_scale{i}")(prev)
            m = getattr(self, f"v_block{i + 1}")(m)
            prev = m
            if self.factors[i] > 1:
                m = torch.relu(getattr(self, f"scale{i + 1}_deconv_bn")(
                    getattr(self, f"scale{i + 1}_deconv")(m)))
            else:
                m = getattr(self, f"scale{i + 1}_deconv")(m)
            ups.append(m)
        all_bev = _nhwc(torch.cat(ups, 1))                    # (B, H, W, 3 ch)
        base_stride = strides[self.scales[0]]

        updates, valids, coords_by = {}, {}, {}
        msf = dict(msf)
        for i, s in enumerate(self.all_sc):
            st = msf[s]
            centers = voxel_centers(st.coords, strides[s], self.voxel_size,
                                    self.point_cloud_range)
            px, py = _pixels(centers, self.voxel_size, self.point_cloud_range, base_stride)
            pf = getattr(self, f"point_features{i + 1}")(st.features, st.valid)
            upd = pf + interp_bev(all_bev, px, py)
            upd = torch.where(st.valid[..., None], upd, torch.zeros_like(upd))
            updates[s], valids[s], coords_by[s] = upd, st.valid, centers
            if s in ("x_conv1", "x_conv2", "x_conv3"):
                msf[s] = st._replace(features=upd)
        batch_dict["multi_scale_3d_features"] = msf

        raw_sc = [s for s in ("x_conv1", "x_conv2") if s in updates] or self.all_sc[:1]
        raw_feat = torch.cat([updates[s] for s in raw_sc], 1)
        raw_valid = torch.cat([valids[s] for s in raw_sc], 1)
        raw_xyz = torch.cat([coords_by[s] for s in raw_sc], 1)
        raw_fg = self.raw_fg_pred(raw_feat)
        raw_score = torch.where(raw_valid, raw_fg.amax(-1),
                                torch.full_like(raw_valid, float("-inf"), dtype=raw_fg.dtype))
        idx = _top_k(raw_score.detach(), min(self.k_raw, raw_feat.shape[1]))
        pyr_sc = [s for s in self.scales if s in updates]
        pts = torch.cat([_rows(raw_xyz, idx)] + [coords_by[s] for s in pyr_sc], 1)
        feats = torch.cat([_rows(raw_feat, idx)] + [updates[s] for s in pyr_sc], 1)
        pvalid = torch.cat([_rows(raw_valid, idx)] + [valids[s] for s in pyr_sc], 1)

        batch_dict["spatial_features_2d"] = all_bev
        batch_dict["encoded_bev_features"] = all_bev
        batch_dict["point_coords"] = pts
        batch_dict["point_features"] = feats
        batch_dict["encoded_point_features"] = feats
        batch_dict["point_valid"] = pvalid
        batch_dict["raw_fg_preds"] = raw_fg
        batch_dict["raw_fg_valid"] = raw_valid
        batch_dict["raw_coords"] = raw_xyz
        return batch_dict


# ---------------------------------------------------------------------------
# PointFromVoxel
# ---------------------------------------------------------------------------

class PointFromVoxel(nn.Module):
    """The BEV map as Z_GROUPS z-slabs of LOCAL_CH channels: grouped convs
    (`v_input`, the scale-1 GroupNorm block, `channel_wise_scale{1,2}`,
    scale 2 at stride 2) with a grouped `local_*` branch read trilinearly
    and a dense `global_*` branch (GLOBAL_CH) read bilinearly at points.
    Scale 0 scores the raw points (`fg_hidden`, `fg_pred_out`); the split
    selection (FG_CORNER_POINTS[0], SAMPLE_FPS) picks 2 x n_fps of them;
    scales 1-2 read at them give `point_features` (128); the vote offsets
    (`center_out`) move them, gradient stopped, to the candidates, read
    again and joined with their predicted class's statistic (`mean`,
    momentum STAT_MOMENTUM from STAT_START_ITER) as `candidate_features`.
    `spatial_features_2d`: scale 2's local and global maps (Z_GROUPS x
    LOCAL_CH + GLOBAL_CH channels at twice the trunk's stride)."""

    def __init__(self, model_cfg, input_channels, voxel_size, point_cloud_range,
                 raw_channels=1):
        super().__init__()
        cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        G = self.G = int(cfg.get("Z_GROUPS", 10))
        cl = self.cl = int(cfg.get("LOCAL_CH", 32))
        cg = int(cfg.get("GLOBAL_CH", 32))
        fgp = cfg.get("FG_CORNER_POINTS", [[2048, 1024], [512, 256]])
        self.n_top, self.n_fps = int(fgp[0][0]), int(fgp[0][1])
        self.sample_fps = bool(cfg.get("SAMPLE_FPS", True))
        self.z_stride = int(cfg.get("Z_STRIDE", 4))
        width = G * cl
        if int(input_channels) % G:
            raise ValueError(f"PointFromVoxel: Z_GROUPS {G} does not divide the BEV map's "
                             f"{input_channels} channels")
        self.raw_point_features = SharedMLP(raw_channels, [64])
        self.v_input = ConvBlock(input_channels, (width,), groups=G)
        for tag in ("scale0", "scale1", "scale2"):
            setattr(self, f"local_{tag}", ConvBlock(width, (width,), groups=G))
            setattr(self, f"global_{tag}", ConvBlock(width, (cg,)))
        self.point_features = SharedMLP(64 + cl + cg, [64])
        self.fg_hidden = SharedMLP(64, [64])
        self.fg_pred_out = nn.Linear(64, 3)
        self.v_input_scale1 = ConvBlock(width, (width,), groups=G, group_norm=True)
        self.channel_wise_scale1 = ConvBlock(width, (width,) * 3, groups=G)
        self.point_features_scale1 = SharedMLP(cl + cg, [64])
        self.v_input_scale2 = ConvBlock(width, (width,), stride=2, groups=G)
        self.channel_wise_scale2 = ConvBlock(width, (width,) * 3, groups=G)
        self.point_features_scale2 = SharedMLP(cl + cg, [64])
        self.center_hidden = SharedMLP(128, [64])
        self.center_out = nn.Linear(64, 3)
        self.candidate_hidden = SharedMLP(128, [64])
        self.candidate_out = nn.Linear(64, 1)
        self.center_point_features_scale1 = SharedMLP(cl + cg, [64])
        self.center_point_features_scale2 = SharedMLP(cl + cg, [64])
        self.object_statistics = ClassStatistics(
            3, 128, int(cfg.get("STAT_START_ITER", 928)),
            momentum=float(cfg.get("STAT_MOMENTUM", 0.7)), mode="mean")
        self.bev_channels = width + cg
        self.point_channels = 128

    def _local_global(self, x, tag):
        loc = _nhwc(getattr(self, f"local_{tag}")(x))
        B, H, W, _ = loc.shape
        return loc.reshape(B, H, W, self.G, self.cl), _nhwc(getattr(self, f"global_{tag}")(x))

    def _read(self, loc, glo, p, stride):
        px, py = _pixels(p, self.voxel_size, self.point_cloud_range, stride)
        pz = _z_index(p, self.voxel_size, self.point_cloud_range, self.z_stride)
        return torch.cat([interp_bev3d(loc, px, py, pz), interp_bev(glo, px, py)], -1)

    def forward(self, batch_dict):
        bev = batch_dict["spatial_features"]
        stride = int(batch_dict.get("encoded_spconv_tensor_stride", 8))
        pts = batch_dict["points"][..., :3]
        pmask = batch_dict["points_mask"]
        it = batch_dict.get("accumulated_iter", 0)
        raw_pf = self.raw_point_features(_raw_features(batch_dict["points"], pts), pmask)

        x = self.v_input(_nchw(bev))
        loc0, glo0 = self._local_global(x, "scale0")
        pf_init = self.point_features(torch.cat([raw_pf, self._read(loc0, glo0, pts, stride)], -1),
                                      pmask)
        fg_preds = self.fg_pred_out(self.fg_hidden(pf_init, pmask))
        fg_score = fg_preds.detach().amax(-1)

        if self.sample_fps:
            idx = split_select(pts, fg_score, pmask, self.n_top, self.n_fps, self.training,
                               fps_top=True, n_eval=2 * self.n_fps)
        else:
            idx = split_select(pts, fg_score, pmask, self.n_fps, self.n_fps, self.training,
                               n_eval=2 * self.n_fps)
        sel_xyz = _rows(pts, idx)
        sel_valid = _rows(pmask, idx)
        sel_fg = _rows(fg_preds, idx)
        class_idx = torch.argmax(sel_fg, -1)

        x = self.channel_wise_scale1(self.v_input_scale1(x))
        loc1, glo1 = self._local_global(x, "scale1")
        p1 = self.point_features_scale1(self._read(loc1, glo1, sel_xyz, stride), sel_valid)
        x = self.channel_wise_scale2(self.v_input_scale2(x))
        loc2, glo2 = self._local_global(x, "scale2")
        p2 = self.point_features_scale2(self._read(loc2, glo2, sel_xyz, stride * 2), sel_valid)
        pf_end = torch.cat([p1, p2], -1)                      # (B, K, 128)

        center_preds = self.center_out(self.center_hidden(pf_end, sel_valid))
        candidate_preds = self.candidate_out(self.candidate_hidden(pf_end, sel_valid))
        cand_xyz = sel_xyz + center_preds.detach()
        c1 = self.center_point_features_scale1(self._read(loc1, glo1, cand_xyz, stride),
                                               sel_valid)
        c2 = self.center_point_features_scale2(self._read(loc2, glo2, cand_xyz, stride * 2),
                                               sel_valid)
        cand_feat = torch.cat([c1, c2], -1)
        stats, _ = self.object_statistics(cand_feat, class_idx, sel_valid.to(cand_feat.dtype), it)
        cand_feat = torch.cat([cand_feat, stats], -1)        # 256

        B, H2, W2 = loc2.shape[:3]
        batch_dict["point_coords"] = sel_xyz
        batch_dict["point_valid"] = sel_valid
        batch_dict["point_features"] = pf_end
        batch_dict["encoded_point_features"] = pf_end
        batch_dict["fg_preds"] = fg_preds
        batch_dict["fg_valid"] = pmask
        batch_dict["point_center_preds"] = center_preds
        batch_dict["point_candidate_preds"] = candidate_preds
        batch_dict["scores_fg"] = sel_fg
        batch_dict["candidate_score"] = candidate_preds
        batch_dict["candidate_coords"] = cand_xyz
        batch_dict["candidate_features"] = cand_feat
        batch_dict["spatial_features_2d"] = torch.cat([loc2.reshape(B, H2, W2, -1), glo2], -1)
        return batch_dict


# ---------------------------------------------------------------------------
# SparsePointBackbone
# ---------------------------------------------------------------------------

class SparsePointBackbone(nn.Module):
    """Point-centric stage over the sparse pyramid: d-fps of FG_CORNER_POINTS[0]
    raw points; each point's containing voxel of SP_SOURCE (K3) and its
    offset (`features_raw`, `pos_raw`) beside the window-pooled levels
    (`point_grid_pool`, K2); fg scores (`features_fg`, `fg_hidden`,
    `fg_pred_out`) weight two s-fps stages (PTS_NUM_SAMPLE; the second over
    the points not taken, its weights 0 inside NEAR_RADIUS); the key
    points' votes (`center_out`, clamped to MAX_TRANSLATION_RANGE, with
    gradient) are read again the same way; the per-class cls blocks
    condition on the max-minus-mean statistics (`object_statistics`,
    momentum 0.98 on the key points scoring 0.3 or more, `temp_features`).
    `point_features`: `features_reg` (NUM_POINT_FEATURES) at the key points.
    The JAX module computes the levels' raw-point centroids
    (`scale_centroids`) and hands them to no pool, so XLA drops them; here
    they are not computed."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range, pyramid):
        super().__init__()
        cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.n0, n1 = (int(v) for v in cfg.get("FG_CORNER_POINTS", [4096, 2048]))
        self.n_fir, self.n_sec = (int(v) for v in cfg.get("PTS_NUM_SAMPLE", [1536, 512]))
        if self.n_fir + self.n_sec != n1:
            raise ValueError("PTS_NUM_SAMPLE must sum to FG_CORNER_POINTS[1]")
        self.translation = [float(v) for v in cfg.get("MAX_TRANSLATION_RANGE", [3.0, 3.0, 2.0])]
        self.num_class = int(cfg.get("N_CLS", 3))
        ch = int(cfg.get("NUM_POINT_FEATURES", 128))
        self.src_sp = cfg.get("SP_SOURCE", "x_conv4")
        self.near_radius = float(cfg.get("NEAR_RADIUS", 40.0))
        self.point_grid_pool = PointGridPool(dict(cfg["POINT_GRID_POOL"]), voxel_size,
                                             point_cloud_range,
                                             {s: pyramid[s][0] for s in pyramid})
        c_feat = 64 + self.point_grid_pool.out_channels
        self.features_raw = SharedMLP(pyramid[self.src_sp][0], [64])
        self.pos_raw = SharedMLP(3, [64])
        self.features_fg = SharedMLP(c_feat, [ch])
        self.fg_hidden = SharedMLP(ch, [64])
        self.fg_pred_out = nn.Linear(64, self.num_class)
        self.features_center = SharedMLP(c_feat, [ch])
        self.center_hidden = SharedMLP(ch, [64])
        self.center_out = nn.Linear(64, 3)
        self.object_statistics = ClassStatistics(self.num_class, ch,
                                                 int(cfg.get("STAT_START_ITER", 0)),
                                                 momentum=0.98, mode="maxmean", decay_only=True)
        self.temp_features = SharedMLP(ch, [ch, ch])
        self.features_cls = SharedMLP(c_feat, [ch])
        for i in range(self.num_class):
            setattr(self, f"cls_block{i}", SharedMLP(ch, [64]))
            setattr(self, f"cls_out{i}", nn.Linear(64, 1))
        self.features_reg = SharedMLP(c_feat, [ch])
        self.point_channels = ch
        self.bev_channels = None   # spatial_features_2d is the map it was given

    def _single(self, sp_st, sp_stride, p, pv):
        feat, offs, _ = lookup_sp_at_points(sp_st, sp_stride, p, pv, self.voxel_size,
                                            self.point_cloud_range)
        return torch.relu(self.features_raw(feat, pv) + self.pos_raw(offs, pv))

    def forward(self, batch_dict):
        it = batch_dict.get("accumulated_iter", 0)
        pts_all = batch_dict["points"][..., :3]
        pmask_all = batch_dict["points_mask"]
        msf = batch_dict["multi_scale_3d_features"]
        strides = batch_dict["multi_scale_3d_strides"]
        sp_st, sp_stride = msf[self.src_sp], strides[self.src_sp]

        idx0 = sampling.furthest_point_sample(pts_all.detach().contiguous(), self.n0, pmask_all)
        pts = _rows(pts_all, idx0)
        pvalid = _rows(pmask_all, idx0)

        raw_single = self._single(sp_st, sp_stride, pts, pvalid)
        raw_multi, _ = self.point_grid_pool(batch_dict, pts, pvalid)
        features_raw = torch.cat([raw_single, raw_multi], -1)
        f_fg = self.features_fg(features_raw, pvalid)
        fg_preds = self.fg_pred_out(self.fg_hidden(f_fg, pvalid))
        fg_norm = torch.sigmoid(fg_preds)
        fg_score = fg_norm.amax(-1)
        fg_idx = torch.argmax(fg_norm, -1)

        zero = torch.zeros((), dtype=fg_score.dtype, device=fg_score.device)
        sel1 = subset_fps_weighted(pts, torch.where(pvalid, fg_score, zero), pvalid, self.n_fir)
        taken = torch.zeros_like(pvalid).scatter_(1, sel1, True)
        depth = torch.linalg.norm(pts[..., :2], dim=-1)
        near = torch.sqrt(depth ** 2 + pts[..., 2] ** 2) < self.near_radius
        rest = pvalid & ~taken
        w2 = torch.where(rest, torch.where(near, zero, fg_score), zero)
        sel2 = subset_fps_weighted(pts, w2, rest, self.n_sec)
        sel = torch.cat([sel1, sel2], 1)

        key_xyz = _rows(pts, sel)
        key_valid = _rows(pvalid, sel)
        key_depth = _rows(torch.linalg.norm(pts, dim=-1), sel)
        key_raw = _rows(features_raw, sel)
        fg_score_key = _rows(fg_score, sel)
        f_fg_key = _rows(f_fg, sel)

        f_center = self.features_center(key_raw, key_valid)
        center_preds = self.center_out(self.center_hidden(f_center, key_valid))
        tr = torch.tensor(self.translation, dtype=center_preds.dtype, device=center_preds.device)
        center_preds = torch.minimum(torch.maximum(center_preds, -tr), tr)
        vote_xyz = key_xyz + center_preds

        stat_w = (key_valid & (fg_score_key >= 0.3)).to(f_fg_key.dtype)
        _, stat_rows = self.object_statistics(f_fg_key, _rows(fg_idx, sel), stat_w, it)
        temp_tag = self.temp_features(stat_rows)             # (num_class, ch)

        vote_single = self._single(sp_st, sp_stride, vote_xyz, key_valid)
        vote_multi, density_vote = self.point_grid_pool(batch_dict, vote_xyz, key_valid)
        features_vote = torch.cat([vote_single, vote_multi], -1)
        features_cls = self.features_cls(features_vote, key_valid)
        point_cls_preds = torch.cat([
            getattr(self, f"cls_out{i}")(getattr(self, f"cls_block{i}")(
                features_cls * temp_tag[i][None, None, :], key_valid))
            for i in range(self.num_class)], -1)
        features_for_reg = self.features_reg(features_vote, key_valid)
        cls_idx = torch.argmax(torch.sigmoid(point_cls_preds), -1)
        vote_cls_aware = torch.cat([features_cls, temp_tag[cls_idx]], -1)

        inf = torch.full((), float("inf"), dtype=key_depth.dtype, device=key_depth.device)
        dmax = torch.where(key_valid, key_depth, -inf).amax(1, keepdim=True)
        dmin = torch.where(key_valid, key_depth, inf).amin(1, keepdim=True)
        dnorm = (key_depth - dmin) / torch.clamp(dmax - dmin, min=1e-6)
        pts_depth = torch.pow(1.2, torch.clamp(dnorm, 0.0, 1.0))

        batch_dict["point_coords"] = key_xyz
        batch_dict["point_valid"] = key_valid
        batch_dict["point_features"] = features_for_reg
        batch_dict["vote_coords"] = vote_xyz
        batch_dict["pool_coords"] = vote_xyz
        batch_dict["fg_preds"] = fg_preds
        batch_dict["fg_valid"] = pvalid
        batch_dict["fg_coords"] = pts
        batch_dict["point_center_preds"] = center_preds
        batch_dict["scores_fg"] = _rows(fg_norm, sel)
        batch_dict["point_cls_preds"] = point_cls_preds
        batch_dict["features_for_reg"] = features_for_reg
        batch_dict["pts_depth"] = pts_depth
        batch_dict["vote_cls_aware"] = vote_cls_aware
        batch_dict["score_density"] = density_vote
        batch_dict["spatial_features_2d"] = batch_dict.get(
            "spatial_features_2d", batch_dict.get("spatial_features"))
        return batch_dict


# ---------------------------------------------------------------------------
# VoxelPointCross (the 2D backbone)
# ---------------------------------------------------------------------------

class VoxelPointCross(nn.Module):
    """Z-grouped local / global SE cross trunk with point cross-updates. The
    raw points read their floor cell of the BEV map viewed as Z_GROUPS
    z-slabs (`neighborhood_offset`, `offset`, `raw_features`,
    `point_features`); fg scores (`fg_pred_out`) pick FG_CORNER_POINTS[0]
    (the top n and d-fps of the rest in training, the top n + m at eval);
    N_BLOCK[0] cross blocks at the trunk's stride and N_BLOCK[1] at twice it
    (`v_input_scale2`, stride 2) each run a grouped `channel_wise{i}` and a
    dense `channel_agg{i}` path, SE-gated `local{i}` / `global{i}` maps
    (TRUNK_CH), read at the points' floor cells with an attention split
    and an offset code, folded into the points' features (`p_block{i}`).
    The two scales' point features (256) give corner and candidate
    predictions; the candidates (FG_CORNER_POINTS[1]) group the selected
    points by a K2 ball query (SA_CONFIG) into `candidate_features`.
    `spatial_features_2d`: the last block's local and global maps (2 x
    TRUNK_CH channels at twice the trunk's stride)."""

    def __init__(self, model_cfg, input_channels, voxel_size, point_cloud_range,
                 raw_channels=1):
        super().__init__()
        cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        G = self.G = int(cfg.get("Z_GROUPS", 5))
        self.n_blocks = [int(v) for v in cfg.get("N_BLOCK", [2, 2])]
        fgp = cfg.get("FG_CORNER_POINTS", [[1024, 512], [512, 256]])
        self.fg_top, self.fg_fps = int(fgp[0][0]), int(fgp[0][1])
        self.c_top, self.c_fps = int(fgp[1][0]), int(fgp[1][1])
        self.sample_fps = bool(cfg.get("SAMPLE_FPS", True))
        width = self.width = int(cfg.get("TRUNK_CH", 160))
        half = self.half = width // G
        C = int(input_channels)
        if C % G:
            raise ValueError(f"VoxelPointCross: Z_GROUPS {G} does not divide the BEV map's "
                             f"{C} channels")
        self.neighborhood_offset = SharedMLP(C // G, [64])
        self.offset = SharedMLP(3, [64])
        self.raw_features = SharedMLP(raw_channels, [32])
        self.point_features = SharedMLP(96, [128])
        self.fg_hidden = SharedMLP(128, [64])
        self.fg_pred_out = nn.Linear(64, 3)
        self.v_input_scale1 = ConvBlock(C, (width,), groups=G)
        self.p_input_scale1 = SharedMLP(131, [128])
        self.v_input_scale2 = ConvBlock(2 * width, (width,), stride=2, groups=G)
        self.p_input_scale2 = SharedMLP(131, [128])
        for i in range(sum(self.n_blocks)):
            c_in = width if i in (0, self.n_blocks[0]) else 2 * width
            setattr(self, f"channel_wise{i}", ConvBlock(c_in, (width,) * 3, groups=G))
            setattr(self, f"channel_agg{i}", ConvBlock(c_in, (width, 2 * width, width)))
            setattr(self, f"local{i}", ConvBlock(width, (width,), groups=G))
            setattr(self, f"global{i}", ConvBlock(width, (width,), groups=G))
            setattr(self, f"local_se{i}", SEBlock(width))
            setattr(self, f"global_se{i}", SEBlock(width))
            setattr(self, f"lg_att_hidden{i}", SharedMLP(2 * half, [32]))
            setattr(self, f"lg_att_out{i}", nn.Linear(32, 2))
            setattr(self, f"neighborhood_offset{i}", SharedMLP(2 * half, [128]))
            setattr(self, f"offset{i}", SharedMLP(3, [128]))
            setattr(self, f"p_block{i}", SharedMLP(256, [128]))
        self.corner_hidden = SharedMLP(256, [64])
        self.corner_out = nn.Linear(64, 24)
        self.candidate_hidden = SharedMLP(256, [64])
        self.candidate_out = nn.Linear(64, 1)
        sa = cfg.get("SA_CONFIG", {"RADIUS": [1.6], "NSAMPLE": [16], "MLPS": [[128, 128]]})
        self.sa_scales = [(0.0, float(r), int(ns)) for r, ns in zip(sa["RADIUS"], sa["NSAMPLE"])]
        c_sa = 0
        for si, mlp in enumerate(sa["MLPS"][:len(self.sa_scales)]):
            m = SharedMLP(3 + 256, mlp)
            setattr(self, f"sa_mlp{si}", m)
            c_sa += m.channels[-1]
        self.candidate_features = SharedMLP(256 + c_sa + 1, [256, 256])
        self.bev_channels = 2 * width
        self.point_channels = 256

    def _cross_block(self, x, pfeat, sel_xyz, sel_valid, i, bev_stride):
        G, half = self.G, self.half
        cw = getattr(self, f"channel_wise{i}")(x)
        ag = getattr(self, f"channel_agg{i}")(x)
        loc = getattr(self, f"local{i}")(cw)
        glo = getattr(self, f"global{i}")(ag)
        loc = loc * getattr(self, f"local_se{i}")(loc) + loc
        glo = glo * getattr(self, f"global_se{i}")(glo) + glo
        B, _, h2, w2 = loc.shape
        vol = torch.cat([_nhwc(loc).reshape(B, h2, w2, G, half),
                         _nhwc(glo).reshape(B, h2, w2, G, half)], -1)
        qx, qy = _pixels(sel_xyz, self.voxel_size, self.point_cloud_range, bev_stride)
        qz = _z_index(sel_xyz, self.voxel_size, self.point_cloud_range, 8)
        feat, offs = nearest_cell(vol, qx, qy, qz)
        att = torch.sigmoid(getattr(self, f"lg_att_out{i}")(
            getattr(self, f"lg_att_hidden{i}")(feat, sel_valid)))
        feat = torch.cat([att[..., :1] * feat[..., :half], att[..., 1:] * feat[..., half:]], -1)
        nb = getattr(self, f"neighborhood_offset{i}")(feat, sel_valid)
        of = getattr(self, f"offset{i}")(offs, sel_valid)
        pfeat = getattr(self, f"p_block{i}")(torch.cat([pfeat, nb + of], -1), sel_valid)
        return torch.cat([loc, glo], 1), pfeat

    def forward(self, batch_dict):
        G = self.G
        bev = batch_dict["spatial_features"]
        stride = int(batch_dict.get("encoded_spconv_tensor_stride", 8))
        B, H, W, C = bev.shape
        pts = batch_dict["points"][..., :3]
        pmask = batch_dict["points_mask"]

        px, py = _pixels(pts, self.voxel_size, self.point_cloud_range, stride)
        pz = _z_index(pts, self.voxel_size, self.point_cloud_range, 8)
        feat0, offs0 = nearest_cell(bev.reshape(B, H, W, G, C // G), px, py, pz)
        nb0 = self.neighborhood_offset(feat0, pmask)
        of0 = self.offset(offs0, pmask)
        raw_pf = self.raw_features(_raw_features(batch_dict["points"], pts), pmask)
        pf = self.point_features(torch.cat([raw_pf, nb0 + of0], -1), pmask)
        fg_preds = self.fg_pred_out(self.fg_hidden(pf, pmask))
        fg_score = fg_preds.detach().amax(-1)

        n = self.fg_top + self.fg_fps
        if self.sample_fps:
            idx = split_select(pts, fg_score, pmask, self.fg_top, self.fg_fps, self.training,
                               n_eval=n)
        else:
            idx = split_select(pts, fg_score, pmask, n, 0, False, n_eval=n)
        sel_xyz = _rows(pts, idx)
        sel_valid = _rows(pmask, idx)
        scores = _rows(fg_preds, idx)
        scores_sig = torch.sigmoid(scores)
        point_features = self.p_input_scale1(torch.cat([_rows(pf, idx), scores_sig], -1),
                                             sel_valid)

        x = self.v_input_scale1(_nchw(bev))
        for i in range(self.n_blocks[0]):
            x, point_features = self._cross_block(x, point_features, sel_xyz, sel_valid, i,
                                                  stride)
        point_list = [point_features]
        x = self.v_input_scale2(x)
        point_features = self.p_input_scale2(torch.cat([point_features, scores_sig], -1),
                                             sel_valid)
        for i in range(self.n_blocks[0], sum(self.n_blocks)):
            x, point_features = self._cross_block(x, point_features, sel_xyz, sel_valid, i,
                                                  stride * 2)
        point_list.append(point_features)
        pf_end = torch.cat(point_list, -1)                     # (B, K, 256)

        corner_preds = self.corner_out(self.corner_hidden(pf_end, sel_valid))
        candidate_preds = self.candidate_out(self.candidate_hidden(pf_end, sel_valid))
        cidx = split_select(sel_xyz, candidate_preds[..., 0].detach(), sel_valid, self.c_top,
                            self.c_fps, self.training, n_eval=self.c_top + self.c_fps)
        cand_xyz = _rows(sel_xyz, cidx)
        cand_valid = _rows(sel_valid, cidx)
        cand_feat = _rows(pf_end, cidx)
        cand_score = _rows(candidate_preds, cidx)

        groups = grouping.query_group(sel_xyz.detach().float().contiguous(), sel_valid,
                                      cand_xyz.detach().float().contiguous(), self.sa_scales,
                                      payload=torch.cat([sel_xyz, pf_end], -1))
        sa_outs = []
        for si, (_, cnt, grouped) in enumerate(groups):
            ns = self.sa_scales[si][2]
            slot_ok = (torch.arange(ns, device=pts.device) < cnt[..., None]) & cand_valid[..., None]
            g = torch.cat([grouped[..., :3] - cand_xyz[:, :, None, :], grouped[..., 3:]], -1)
            g = torch.where(slot_ok[..., None], g, torch.zeros_like(g))
            h = getattr(self, f"sa_mlp{si}")(g, slot_ok)
            h = torch.where(slot_ok[..., None], h, torch.full_like(h, -1e9)).amax(2)
            keep = cand_valid[..., None] & (cnt[..., None] > 0)
            sa_outs.append(torch.where(keep, h, torch.zeros_like(h)))
        cand_full = self.candidate_features(
            torch.cat([cand_feat, torch.cat(sa_outs, -1), cand_score], -1), cand_valid)

        batch_dict["point_coords"] = sel_xyz
        batch_dict["point_valid"] = sel_valid
        batch_dict["point_features"] = pf_end
        batch_dict["encoded_point_features"] = pf_end
        batch_dict["fg_preds"] = fg_preds
        batch_dict["fg_valid"] = pmask
        batch_dict["point_corner_preds"] = corner_preds
        batch_dict["point_candidate_preds"] = candidate_preds
        batch_dict["scores_fg"] = _rows(scores, cidx)
        batch_dict["candidate_score"] = cand_score
        batch_dict["candidate_coords"] = cand_xyz
        batch_dict["candidate_valid"] = cand_valid
        batch_dict["candidate_features"] = cand_full
        batch_dict["spatial_features_2d"] = _nhwc(x)
        return batch_dict


HYBRIDS = {"SparsePointBackbone": SparsePointBackbone, "PointFromVoxel": PointFromVoxel,
           "VoxelPointCross": VoxelPointCross, "BEVPoint": BEVPoint}
