"""Voxel-hash PointNet++ backbone of the TSM model.

Counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/voxel_pointnet2_backbone.py.
`VoxelSAModule` behaves by `sa_layer_idx`:
   0     : d-fps over raw points, multi-scale dilated ball query + point
           MLPs, then the voxel-centroid sparse tensor and its confidence;
   1..2  : s-fps, voxel query against the centroid tensor, point + position
           MLPs, the 3-level sparse mini U-Net and the confidence;
   >= 3  : voxel-query aggregation only (the head's VSA, new_xyz given).
Layers are built with explicit channel counts (flax infers them); the
parameter names follow the flax module names. In train mode every BN takes
its batch stats over the elements the JAX call masks (`mask=`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...ops import grouping, sampling, spconv as sp_ops
from ...ops.voxel import voxel_centroids
from .pointnet2_modules import BatchNorm, SharedMLP, safe_bn_mask
from .spconv_backbone import (
    SparseConv,
    SparseInverseConv,
    SparseTensor,
    SubMConv,
    _out_grid,
)


def build_unet_plan(sp: SparseTensor, capacity: int):
    """Weight-independent pieces of the mini U-Net on `sp`'s position set,
    shared by every conv that runs on the same positions."""
    rb4 = sp_ops.build_subm_rulebook(sp.coords, sp.valid, sp.grid)
    g8 = _out_grid(sp.grid, 3, 2, 1)
    ds8 = sp_ops.build_conv_plan(sp.coords, sp.valid, sp.grid, g8, 3, 2, 1, capacity)
    oc8, ov8, _ = ds8
    rb8 = sp_ops.build_subm_rulebook(oc8, ov8, g8)
    g16 = _out_grid(g8, 3, 2, 1)
    ds16 = sp_ops.build_conv_plan(oc8, ov8, g8, g16, 3, 2, 1, capacity)
    oc16, ov16, _ = ds16
    rb16 = sp_ops.build_subm_rulebook(oc16, ov16, g16)
    inv16to8 = sp_ops.build_inverse_rulebook(oc16, ov16, oc8, ov8, g16, 3, 2, 1)
    inv8to4 = sp_ops.build_inverse_rulebook(oc8, ov8, sp.coords, sp.valid, g8, 3, 2, 1)
    return dict(rb4=rb4, ds8=ds8, rb8=rb8, ds16=ds16, rb16=rb16,
                inv16to8=inv16to8, inv8to4=inv8to4)


def factored_grid(point_cloud_range, voxel_size):
    """(gz, gy, gx) ints for the already-FACTOR-multiplied voxel size."""
    pc = np.asarray(point_cloud_range, np.float64)
    vs = np.asarray(voxel_size, np.float64)
    g = np.round((pc[3:6] - pc[0:3]) / vs).astype(np.int64)
    return int(g[2]), int(g[1]), int(g[0])


def points_to_voxel_coords(xyz, point_cloud_range, voxel_size):
    """(..., 3) xyz -> int32 zyx coords on the factored grid."""
    pc = torch.tensor(np.asarray(point_cloud_range[:3], np.float32), device=xyz.device)
    vs = torch.tensor(np.asarray(voxel_size, np.float32), device=xyz.device)
    cxyz = torch.floor((xyz - pc) / vs).to(torch.int32)
    return cxyz.flip(-1)


class _MLPNoFinalRelu(nn.Module):
    """Dense + BN (+ ReLU) stack whose last layer has BN but no ReLU."""

    def __init__(self, in_channels, channels: Sequence[int]):
        super().__init__()
        self.n = len(channels)
        c_in = int(in_channels)
        for i, c in enumerate(channels):
            setattr(self, f"fc{i}", nn.Linear(c_in, int(c), bias=False))
            setattr(self, f"bn{i}", BatchNorm(int(c), eps=1e-3))
            c_in = int(c)

    def forward(self, x, mask=None):
        mask = safe_bn_mask(mask)
        for i in range(self.n):
            x = getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x), mask)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


def _masked_max(h, slot_ok, keep):
    h = torch.where(slot_ok[..., None], h, torch.full_like(h, -1e9)).amax(dim=2)
    return torch.where(keep[..., None], h, torch.zeros_like(h))


class VoxelSAModule(nn.Module):
    """One voxel-hash SA layer (see the module docstring).

    point_channels: feature channels of the input points (layer 0);
    sp_in_channels: feature channels of the input sparse tensor (layers
    > 0)."""

    def __init__(self, sa_layer_idx, radii, nsamples, mlps, query_ranges=None,
                 npoint_list=None, sample_range_list=None,
                 sample_method_list=None, dilated_group=False,
                 aggregation_mlp=None, confidence_mlp=None, sp_channels=None,
                 num_class=3, weight_gamma=1.0, voxel_size=None,
                 point_cloud_range=None, grid=None, voxel_capacity=4096,
                 point_channels=0, sp_in_channels=None):
        super().__init__()
        self.sa_layer_idx = int(sa_layer_idx)
        self.radii = [float(r) for r in radii]
        self.nsamples = [int(n) for n in nsamples]
        self.mlps = [list(m) for m in mlps]
        self.query_ranges = query_ranges
        self.npoint_list = npoint_list
        self.sample_range_list = sample_range_list
        self.sample_method_list = sample_method_list
        self.dilated_group = dilated_group
        self.weight_gamma = float(weight_gamma)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.grid = tuple(grid)
        self.voxel_capacity = int(voxel_capacity)
        self.num_class = num_class
        self.has_aggregation = bool(aggregation_mlp)
        self.has_confidence = bool(confidence_mlp)

        k = self.sa_layer_idx
        if k == 0:
            for i, m in enumerate(self.mlps):
                setattr(self, f"point_mlp{i}", SharedMLP(3 + point_channels, m))
        else:
            for i, m in enumerate(self.mlps):
                setattr(self, f"point_mlp{i}", _MLPNoFinalRelu(sp_in_channels, m))
                c_last = int(m[-1])
                setattr(self, f"pos_mlp{i}", _MLPNoFinalRelu(3, [c_last // 2, c_last]))
        new_ch = sum(int(m[-1]) for m in self.mlps)
        if self.has_aggregation:
            self.aggregation = SharedMLP(new_ch, aggregation_mlp)
            new_ch = int(aggregation_mlp[-1])
        self.out_channels = new_ch

        if k == 0:
            conf_in = new_ch
        elif 0 < k < 3:
            n_out, n_en = new_ch, new_ch // 2
            self.spconv4x = SubMConv(n_out, n_en, kernel_size=1)
            self.spconv8x = SparseConv(n_en, n_en, out_capacity=self.voxel_capacity)
            self.spconv16x = SparseConv(n_en, 2 * n_en, out_capacity=self.voxel_capacity)
            self.inv16x_a = SubMConv(2 * n_en, 2 * n_en)
            self.inv16x_b = SubMConv(2 * n_en, 2 * n_en)
            self.inv8x = SparseInverseConv(2 * n_en, n_en)
            self.inv8x_a = SubMConv(n_en, n_en)
            self.inv8x_b = SubMConv(n_en, n_en)
            self.inv4x = SparseInverseConv(n_en, n_en)
            self.inv4x_a = SubMConv(n_en, n_en)
            self.inv4x_b = SubMConv(n_en, n_en)
            self.spconv_out = SubMConv(n_en, n_out, kernel_size=1, use_relu=False)
            sp_out_ch = int(sp_channels[-1])
            self.sp_update = SubMConv(sp_in_channels, sp_out_ch, kernel_size=1,
                                      use_relu=False)
            conf_in = sp_out_ch
        else:
            conf_in = None
        if self.has_confidence:
            self.confidence = SharedMLP(conf_in, confidence_mlp)
            self.confidence_out = nn.Linear(int(confidence_mlp[-1]), num_class)

    # ---- sampling ----
    def _sample(self, xyz, scores_point, valid):
        out = []
        for npoint, (lo, hi), method in zip(
                self.npoint_list, self.sample_range_list, self.sample_method_list):
            sub_xyz = xyz[:, lo:hi]
            sub_valid = valid[:, lo:hi]
            if method in ("d-fps", "D-FPS"):
                if self.sa_layer_idx == 0:
                    idx = sampling.furthest_point_sample(sub_xyz, npoint, sub_valid)
                else:
                    # layers > 0 reuse the previous ordering: take the first N
                    idx = torch.arange(npoint, dtype=torch.int32, device=xyz.device
                                       ).expand(xyz.shape[0], npoint)
            elif method in ("s-fps", "S-FPS"):
                w = torch.sigmoid(scores_point[:, lo:hi]) ** self.weight_gamma
                idx = sampling.furthest_point_sample_weights(sub_xyz, w, npoint, sub_valid)
            else:
                raise NotImplementedError(f"sample method {method} is not ported")
            out.append(idx + lo)
        return torch.cat(out, dim=1)

    def _voxel_scales(self):
        scales = []
        for i, (r, ns) in enumerate(zip(self.radii, self.nsamples)):
            min_r = self.radii[i - 1] if (self.dilated_group and i > 0) else 0.0
            qr = tuple(int(v) for v in self.query_ranges[i])
            scales.append((float(min_r), float(r), int(ns), qr))
        return scales

    def forward(self, xyz, features, valid, scores_voxel=None, point_slot=None,
                sp=None, centroid_xyz=None, new_xyz=None, unet_plan=None):
        # ---- per-point scores from the previous layer's voxel confidence ----
        scores_point = None
        ori_scores_voxel = None
        if scores_voxel is not None:
            smax = scores_voxel.amax(dim=-1)
            ori_scores_voxel = torch.sigmoid(smax)[..., None]
            if point_slot is not None:
                safe = torch.clamp(point_slot.long(), 0, smax.shape[1] - 1)
                gathered = torch.gather(smax, 1, safe)
                scores_point = torch.where(point_slot >= 0, gathered,
                                           torch.full_like(gathered, -1e9))

        # ---- sampling ----
        if new_xyz is None:
            idx_s = self._sample(xyz, scores_point, valid)
            new_xyz = sampling.gather_points(xyz, idx_s)
            new_valid = torch.gather(valid, 1, idx_s.long())
        else:
            new_valid = torch.ones(new_xyz.shape[:2], dtype=torch.bool,
                                   device=new_xyz.device)

        # ---- grouping + per-scale MLPs ----
        outs = []
        if sp is None:
            scales = []
            for i, (r, ns) in enumerate(zip(self.radii, self.nsamples)):
                lo = self.radii[i - 1] if (self.dilated_group and i > 0) else 0.0
                scales.append((float(lo), float(r), int(ns)))
            payload = xyz if features is None else torch.cat([xyz, features], -1)
            groups = grouping.query_group(xyz, valid, new_xyz, scales, payload=payload)
            for i, (_, cnt, grouped) in enumerate(groups):
                ns = self.nsamples[i]
                slot_ok = ((torch.arange(ns, device=xyz.device) < cnt[..., None])
                           & new_valid[..., None])
                g = torch.cat([grouped[..., :3] - new_xyz[:, :, None, :],
                               grouped[..., 3:]], -1)
                g = torch.where(slot_ok[..., None], g, torch.zeros_like(g))
                h = getattr(self, f"point_mlp{i}")(g, slot_ok)
                outs.append(_masked_max(h, slot_ok, new_valid & (cnt > 0)))
        else:
            new_coords = points_to_voxel_coords(new_xyz, self.point_cloud_range,
                                                self.voxel_size)
            payload = torch.cat([centroid_xyz, sp.features], -1)
            groups = grouping.query_group(
                centroid_xyz, sp.valid, new_xyz, self._voxel_scales(),
                payload=payload, src_coords=sp.coords, q_coords=new_coords)
            for i, (_, cnt, grouped) in enumerate(groups):
                ns = self.nsamples[i]
                slot_ok = ((torch.arange(ns, device=xyz.device) < cnt[..., None])
                           & new_valid[..., None])
                zero = torch.zeros((), dtype=grouped.dtype, device=grouped.device)
                g_xyz = torch.where(slot_ok[..., None],
                                    grouped[..., :3] - new_xyz[:, :, None, :], zero)
                g_feat = torch.where(slot_ok[..., None], grouped[..., 3:], zero)
                hf = getattr(self, f"point_mlp{i}")(g_feat, slot_ok)
                hx = getattr(self, f"pos_mlp{i}")(g_xyz, slot_ok)
                h = torch.relu(hf + hx)
                outs.append(_masked_max(h, slot_ok, new_valid & (cnt > 0)))

        new_features = torch.cat(outs, -1)
        if self.has_aggregation:
            new_features = self.aggregation(new_features, new_valid)
            new_features = torch.where(new_valid[..., None], new_features,
                                       torch.zeros_like(new_features))

        # ---- sparse-tensor construction / update ----
        new_point_slot = None
        new_centroid_xyz = centroid_xyz
        sp_out = sp
        if self.sa_layer_idx == 0:
            coords = points_to_voxel_coords(new_xyz, self.point_cloud_range,
                                            self.voxel_size)
            out = voxel_centroids(coords, torch.cat([new_xyz, new_features], -1),
                                  new_valid, self.voxel_capacity, self.grid)
            new_centroid_xyz = out["centroids"][..., :3]
            sp_out = SparseTensor(out["centroids"][..., 3:], out["coordinates"],
                                  out["valid"], self.grid, 1)
            new_point_slot = out["point_slot"]
        elif 0 < self.sa_layer_idx < 3:
            sp_out, new_point_slot = self._unet_update(
                sp, new_xyz, new_features, new_valid, ori_scores_voxel, unet_plan)

        # ---- per-voxel confidence ----
        new_scores_voxel = None
        if self.has_confidence:
            logits = self.confidence_out(self.confidence(sp_out.features,
                                                         sp_out.valid))
            new_scores_voxel = torch.where(sp_out.valid[..., None], logits,
                                           torch.full_like(logits, -1e9))

        return dict(
            new_xyz=new_xyz, new_features=new_features, new_valid=new_valid,
            scores_voxel=new_scores_voxel, sp=sp_out,
            centroid_xyz=new_centroid_xyz, point_slot=new_point_slot,
        )

    def _unet_update(self, sp, new_xyz, new_features, new_valid,
                     ori_scores_voxel, unet_plan):
        coords = points_to_voxel_coords(new_xyz, self.point_cloud_range,
                                        self.voxel_size)
        upd = voxel_centroids(coords, new_features, new_valid, new_xyz.shape[1],
                              self.grid)
        gz, gy, gx = self.grid
        sentinel = gz * gy * gx

        # rank-align the update rows onto the sp rows (shared keys): probe K3
        sp_keys = sp_ops.linearize(sp.coords, self.grid, sp.valid)
        u_keys = sp_ops.linearize(upd["coordinates"], self.grid, upd["valid"])
        pos, hit = sp_ops._lookup_batched(sp_keys, u_keys[:, None, :], sentinel)
        pos, hit = pos[:, 0].long(), hit[:, 0]
        B, V = sp.coords.shape[:2]
        C = upd["centroids"].shape[-1]
        rows = torch.where(hit, pos + torch.arange(B, device=pos.device)[:, None] * V,
                           torch.full_like(pos, B * V))
        source = torch.zeros((B * V + 1, C), dtype=new_features.dtype,
                             device=new_features.device)
        source[rows.reshape(-1)] = upd["centroids"].reshape(-1, C)
        source = source[:B * V].reshape(B, V, C)
        src_st = SparseTensor(source, sp.coords, sp.valid, sp.grid, sp.stride)

        cap = self.voxel_capacity
        if unet_plan is not None and unet_plan["ds8"][0].shape[1] != cap:
            unet_plan = None
        if unet_plan is None:
            unet_plan = build_unet_plan(sp, cap)
        sp4x = self.spconv4x(src_st)
        sp8x = self.spconv8x(sp4x, plan=unet_plan["ds8"])
        sp16x = self.spconv16x(sp8x, plan=unet_plan["ds16"])
        rb16 = unet_plan["rb16"]
        h16 = self.inv16x_a(sp16x, rulebook=rb16)
        h16 = self.inv16x_b(h16, rulebook=rb16)
        h16 = h16._replace(features=h16.features + sp16x.features)
        h8 = self.inv8x(h16, sp8x, rulebook=unet_plan["inv16to8"])
        rb8 = unet_plan["rb8"]
        h8 = self.inv8x_a(h8, rulebook=rb8)
        h8 = self.inv8x_b(h8, rulebook=rb8)
        h8 = h8._replace(features=h8.features + sp8x.features)
        h4 = self.inv4x(h8, sp4x, rulebook=unet_plan["inv8to4"])
        rb4 = unet_plan["rb4"]
        h4 = self.inv4x_a(h4, rulebook=rb4)
        h4 = self.inv4x_b(h4, rulebook=rb4)
        h4 = h4._replace(features=h4.features + sp4x.features)
        dest = self.spconv_out(h4)

        sp_upd = self.sp_update(sp)
        fused = torch.relu(sp_upd.features + ori_scores_voxel * dest.features)
        fused = torch.where(sp.valid[..., None], fused, torch.zeros_like(fused))
        sp_out = sp._replace(features=fused)

        # the sampled points' voxel slots in the sp row order: probe K3
        pkeys = sp_ops.linearize(coords, self.grid, new_valid)
        ppos, phit = sp_ops._lookup_batched(sp_keys, pkeys[:, None, :], sentinel)
        new_point_slot = torch.where(phit[:, 0], ppos[:, 0],
                                     torch.full_like(ppos[:, 0], -1))
        return sp_out, new_point_slot


def _sa_kwargs(cfg, k, voxel_size, point_cloud_range, grid, num_class, capacity):
    """cfg -> VoxelSAModule kwargs for SA layer k."""
    agg = cfg.get("AGGREGATION_MLPS")
    conf = cfg.get("CONFIDENCE_MLPS")
    return dict(
        sa_layer_idx=k,
        npoint_list=[int(n) for n in cfg["NPOINT_LIST"][k]],
        sample_range_list=[list(r) for r in cfg["SAMPLE_RANGE_LIST"][k]],
        sample_method_list=list(cfg["SAMPLE_METHOD_LIST"][k]),
        radii=[float(r) for r in cfg["RADIUS"][k]],
        nsamples=[int(n) for n in cfg["NSAMPLE"][k]],
        mlps=[list(m) for m in cfg["MLPS"][k]],
        query_ranges=([list(q) for q in cfg["QUERY_RANGE"][k]]
                      if cfg.get("QUERY_RANGE") else None),
        dilated_group=bool(cfg.get("DILATED_RADIUS_GROUP", False)),
        aggregation_mlp=list(agg[k]) if agg and agg[k] else None,
        confidence_mlp=list(conf[k]) if conf and conf[k] else None,
        sp_channels=None,
        num_class=num_class,
        weight_gamma=float(cfg.get("WEIGHT_GAMMA", 1.0)),
        voxel_size=tuple(voxel_size),
        point_cloud_range=tuple(point_cloud_range),
        grid=grid,
        voxel_capacity=capacity,
    )


def _out_channels(cfg, k):
    agg = cfg.get("AGGREGATION_MLPS")
    if agg and agg[k]:
        return int(agg[k][-1])
    return sum(int(m[-1]) for m in cfg["MLPS"][k])


class _VoxelFSBase(nn.Module):
    """Shared plumbing: build and run a list of SA layers in order."""

    def __init__(self, model_cfg, input_channels, meta=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.input_channels = int(input_channels)
        voxel_cfg = model_cfg["VOXEL_CONFIG"]
        base_vs = np.asarray(voxel_cfg["VOXEL_SIZE"], np.float64)
        factor = float(model_cfg.get("FACTOR", 4))
        self.vs = tuple(base_vs * factor)
        self.pcr = tuple(voxel_cfg["POINT_CLOUD_RANGE"])
        self.grid = factored_grid(self.pcr, self.vs)

    def _build_layers(self, cfg_key, n_layers):
        cfg = self.model_cfg[cfg_key]
        num_class = int(cfg.get("NUM_CLASS", 3))
        capacity = sum(int(n) for n in cfg["NPOINT_LIST"][0])
        prefix = "s_sa" if cfg_key == "S_SA_CONFIG" else "sa"
        sp_ch = None
        for k in range(n_layers):
            kw = _sa_kwargs(cfg, k, self.vs, self.pcr, self.grid, num_class, capacity)
            if k > 0:
                kw["sp_channels"] = (_out_channels(cfg, 0), _out_channels(cfg, k))
            m = VoxelSAModule(**kw, point_channels=self.input_channels - 3,
                              sp_in_channels=sp_ch)
            setattr(self, f"{prefix}{k}", m)
            sp_ch = _out_channels(cfg, 0) if k == 0 else int(kw["sp_channels"][-1])

    def _run_layers(self, cfg_key, batch_dict, n_layers, unet_plan=None):
        cfg = self.model_cfg[cfg_key]
        points = batch_dict["points"]
        xyz = points[..., :3]
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        state = dict(xyz=xyz, features=feats, valid=batch_dict["points_mask"],
                     scores_voxel=None, point_slot=None, sp=None, centroid_xyz=None)
        capacity = sum(int(n) for n in cfg["NPOINT_LIST"][0])
        prefix = "s_sa" if cfg_key == "S_SA_CONFIG" else "sa"
        outs = []
        for k in range(n_layers):
            if 0 < k < 3 and unet_plan is None and state["sp"] is not None:
                unet_plan = build_unet_plan(state["sp"], capacity)
            r = getattr(self, f"{prefix}{k}")(
                state["xyz"], state["features"], state["valid"],
                scores_voxel=state["scores_voxel"], point_slot=state["point_slot"],
                sp=state["sp"], centroid_xyz=state["centroid_xyz"],
                unet_plan=unet_plan if 0 < k < 3 else None)
            state = dict(xyz=r["new_xyz"], features=r["new_features"],
                         valid=r["new_valid"], scores_voxel=r["scores_voxel"],
                         point_slot=r["point_slot"], sp=r["sp"],
                         centroid_xyz=r["centroid_xyz"])
            outs.append(r)
        return outs, unet_plan


class VoxelPointNet2FSMSGDistillation(_VoxelFSBase):
    """Frozen-teacher / student backbone. Eval: the teacher runs its first
    len(SA_CONFIG.NPOINT_LIST) - 1 layers (layer 0 for the TSM configs),
    then the student layer `s_sa1` runs on teacher layer 0's outputs.
    Train: the teacher runs all its layers in train mode (batch-stat BN,
    running stats updated) under `torch.no_grad()` — the counterpart of the
    JAX `stop_gradient` (voxel_pointnet2_backbone.py:734-738) — and
    `s_sa1` reuses the teacher's U-Net plan."""

    def __init__(self, model_cfg, input_channels, meta=None):
        super().__init__(model_cfg, input_channels, meta)
        self.n_teacher = len(model_cfg["SA_CONFIG"]["NPOINT_LIST"])
        if self.n_teacher != 2:
            raise NotImplementedError(
                "only configs whose eval teacher is SA layer 0 alone are ported")
        self._build_layers("SA_CONFIG", self.n_teacher)
        cfg = model_cfg["S_SA_CONFIG"]
        capacity = sum(int(n) for n in cfg["NPOINT_LIST"][0])
        kw = _sa_kwargs(cfg, 1, self.vs, self.pcr, self.grid, 3, capacity)
        sp_in = int(model_cfg["SA_CONFIG"]["AGGREGATION_MLPS"][0][-1])
        kw["sp_channels"] = (sp_in, int(cfg["AGGREGATION_MLPS"][1][-1]))
        self.s_sa1 = VoxelSAModule(**kw, sp_in_channels=sp_in)

    @property
    def num_point_features(self):
        return int(self.model_cfg["S_SA_CONFIG"]["AGGREGATION_MLPS"][-1][-1])

    @property
    def teacher_point_features(self):
        return _out_channels(self.model_cfg["SA_CONFIG"], self.n_teacher - 1)

    def forward(self, batch_dict):
        if self.training:
            with torch.no_grad():
                t_outs, unet_plan = self._run_layers("SA_CONFIG", batch_dict,
                                                     self.n_teacher)
        else:
            t_outs, unet_plan = self._run_layers("SA_CONFIG", batch_dict,
                                                 self.n_teacher - 1)
        t0 = t_outs[0]
        if unet_plan is None:
            unet_plan = build_unet_plan(t0["sp"], self.s_sa1.voxel_capacity)
        s_out = self.s_sa1(
            t0["new_xyz"], t0["new_features"], t0["new_valid"],
            scores_voxel=t0["scores_voxel"], point_slot=t0["point_slot"],
            sp=t0["sp"], centroid_xyz=t0["centroid_xyz"], unet_plan=unet_plan)

        if self.training:
            tl = t_outs[-1]
            batch_dict["point_features"] = tl["new_features"]
            batch_dict["point_coords"] = tl["new_xyz"]
            batch_dict["point_valid"] = tl["new_valid"]
            batch_dict["point_scores"] = tl["scores_voxel"]
            batch_dict["last_sp_tensor"] = tl["sp"]
            batch_dict["last_centroid_xyz"] = tl["centroid_xyz"]
            batch_dict["last_point_slot"] = tl["point_slot"]
            batch_dict["statistic_feature"] = tl["sp"].features

        batch_dict["s_point_features"] = s_out["new_features"]
        batch_dict["s_point_coords"] = s_out["new_xyz"]
        batch_dict["s_point_valid"] = s_out["new_valid"]
        batch_dict["s_point_scores"] = s_out["scores_voxel"]
        batch_dict["s_last_sp_tensor"] = s_out["sp"]
        batch_dict["s_last_centroid_xyz"] = s_out["centroid_xyz"]
        batch_dict["s_last_point_slot"] = s_out["point_slot"]
        batch_dict["s_statistic_feature"] = s_out["sp"].features
        outs = t_outs + [s_out]
        batch_dict["point_coords_list"] = [o["centroid_xyz"] for o in outs]
        batch_dict["point_scores_list"] = [o["scores_voxel"] for o in outs]
        batch_dict["point_valid_list"] = [o["sp"].valid for o in outs]
        return batch_dict
