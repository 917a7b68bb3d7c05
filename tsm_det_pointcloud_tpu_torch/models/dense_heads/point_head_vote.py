"""TSM vote heads with transferable class statistics.

Counterpart of tsm_det_pointcloud_tpu/models/dense_heads/point_head_vote.py:
`VoteHeadBranch` (student route: plain REG_FC regression; teacher route:
the statistic-gated dynamic-weight regression; with no external statistics
it owns the three class-statistics buffers and updates them in train mode),
the vectorised target assignment, the branch losses on both routes and the
SASA loss; `PointHeadVoteSASAStatistic`, the teacher-training head, and
`PointHeadVoteSASAStatisticDistillation` with its three shared
`statistics` buffers (transferred from the teacher checkpoint, never
updated by this head). Every `stop_gradient` of the reference is a
`.detach()` at the same place.

In a multi-process run every reduction over the batch axis is the global
batch's, as under the JAX package's jit over a data mesh: the normalizers
(positives, vote weights), the statistic update's counts and feature sums
through `comm.global_sum`, and each loss term that is a sum over the batch
divided by such a normalizer is the rank's partial sum scaled by
`comm.scale_to_global`, so that the ranks' mean is the JAX loss and DDP's
mean of the rank gradients its gradient.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import loss_utils
from ...parallel import comm
from ...ops.box_coder_utils import PointBinResidualCoder
from ...ops.boxes import boxes_to_corners_3d, points_in_boxes
from ..backbones_3d.pointnet2_modules import BatchNorm, SharedMLP
from ..backbones_3d.voxel_pointnet2_backbone import VoxelSAModule, factored_grid


# the class-statistics buffers, in the order the JAX package declares them
STATISTIC_BUFFERS = ("object_statistic_features", "object_momentum", "object_mean")


# ---------------------------------------------------------------------------
# target assignment (point_head_vote.py:38-80), batched
# ---------------------------------------------------------------------------

def _take_boxes(boxes, idx):
    """boxes (B, M, D), idx (B, N) >= 0 -> (B, N, D)."""
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))


def assign_targets_simple(points_xyz, gt_boxes, gt_valid, extra_width=None):
    """Vote targets: class of the (enlarged) containing box and its centre.
    Returns labels (B, N) (0 bg) and centers (B, N, 3)."""
    idx = points_in_boxes(points_xyz, gt_boxes[..., :7], extra_width=extra_width,
                          valid_mask=gt_valid)
    fg = idx >= 0
    box = _take_boxes(gt_boxes, torch.clamp(idx, min=0))
    labels = torch.where(fg, box[..., 7].long(), torch.zeros_like(idx))
    centers = torch.where(fg[..., None], box[..., 0:3], torch.zeros_like(box[..., 0:3]))
    return labels, centers


def assign_targets_mask(points_xyz, gt_boxes, gt_valid, box_coder,
                        central_radius=10.0):
    """Box / cls targets at vote positions with the ball constraint.
    Returns cls_labels (B, N) {-1 ignore, 0 bg, 1..C}, reg_labels
    (B, N, code) and box_labels (B, N, 7)."""
    idx = points_in_boxes(points_xyz, gt_boxes[..., :7], valid_mask=gt_valid)
    box_fg = idx >= 0
    box = _take_boxes(gt_boxes, torch.clamp(idx, min=0))
    ball = torch.linalg.norm(box[..., 0:3] - points_xyz[..., :3], dim=-1) < central_radius
    fg = box_fg & ball
    ignore = box_fg & ~ball
    labels = torch.where(fg, box[..., 7].long(), torch.zeros_like(idx))
    labels = torch.where(ignore, torch.full_like(labels, -1), labels)
    gt_of_pt = box[..., :7]
    reg = box_coder.encode(gt_of_pt, points_xyz[..., :3], box[..., 7].long())
    reg = torch.where(fg[..., None], reg, torch.zeros_like(reg))
    box_lab = torch.where(fg[..., None], gt_of_pt, torch.zeros_like(gt_of_pt))
    return labels, reg, box_lab


def corner_loss_points(pred_boxes, gt_boxes, weights):
    """Per-point corner Huber loss with the flipped heading; (B, N, 7)."""
    pc = boxes_to_corners_3d(pred_boxes)
    gc = boxes_to_corners_3d(gt_boxes)
    flip = torch.cat([gt_boxes[..., :6], gt_boxes[..., 6:7] + np.pi], -1)
    gcf = boxes_to_corners_3d(flip)
    d = torch.minimum(torch.sqrt(((pc - gc) ** 2).sum(-1) + 1e-12),
                      torch.sqrt(((pc - gcf) ** 2).sum(-1) + 1e-12))
    abs_d = d.abs()
    c = torch.clamp(abs_d, max=1.0)
    huber = 0.5 * c * c + (abs_d - c)
    return huber.mean(-1) * weights


# ---------------------------------------------------------------------------
# branch
# ---------------------------------------------------------------------------

class VoteHeadBranch(nn.Module):
    """One vote-head branch: votes, VSA aggregation over the backbone's
    centroid sparse tensor, statistic-conditioned cls, and the regression:
    a plain REG_FC MLP (student) or the statistic-gated dynamic-weight
    regression (teacher, gated_reg=True). in_channels: point feature
    channels; sp_channels: the sparse tensor's feature channels.

    own_statistics=True (the teacher-training head): the branch owns the
    buffers `object_statistic_features`, `object_momentum` and
    `object_mean`, (num_class, SHARED_FC[-1]), zeros at init, and in train
    mode updates them from the backbone's point features before its cls
    and regression read them (`_update_statistics`)."""

    def __init__(self, model_cfg, vote_cfg, vsa_cfg, num_class, box_coder,
                 in_channels, sp_channels, gated_reg=False, own_statistics=False):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_class = num_class
        self.box_coder = box_coder
        self.gated_reg = gated_reg
        self.sample_range = tuple(cfg["SAMPLE_RANGE"])
        self.vote_fc = SharedMLP(in_channels, list(vote_cfg["VOTE_FC"]))
        self.vote_out = nn.Linear(int(vote_cfg["VOTE_FC"][-1]), 3)
        self.register_buffer(
            "max_translation",
            torch.tensor(vote_cfg["MAX_TRANSLATION_RANGE"], dtype=torch.float32),
            persistent=False)
        vs = (np.asarray(cfg["VOXEL_CONFIG"]["VOXEL_SIZE"], np.float64)
              * float(vsa_cfg.get("SPARSE_TENSOR_STRIDE", 4)))
        pcr = tuple(cfg["VOXEL_CONFIG"]["POINT_CLOUD_RANGE"])
        self.vsa = VoxelSAModule(
            sa_layer_idx=6,
            radii=[float(r) for r in vsa_cfg["RADIUS"]],
            nsamples=[int(n) for n in vsa_cfg["NSAMPLE"]],
            mlps=[list(m) for m in vsa_cfg["MLPS"]],
            query_ranges=[list(q) for q in vsa_cfg["QUERY_RANGE"]],
            dilated_group=bool(vsa_cfg.get("DILATED_RADIUS_GROUP", False)),
            aggregation_mlp=None, confidence_mlp=None, num_class=num_class,
            voxel_size=tuple(vs), point_cloud_range=pcr,
            grid=factored_grid(pcr, vs), sp_in_channels=sp_channels,
        )
        self.shared_fc = SharedMLP(self.vsa.out_channels, list(cfg["SHARED_FC"]))
        C = int(cfg["SHARED_FC"][-1])
        if own_statistics:
            # the update averages backbone point features into (C,) rows
            # (the reference's implicit 256 == 256, code_board.py:93)
            if int(in_channels) != C:
                raise ValueError(f"statistic buffers need point features of SHARED_FC[-1] "
                                 f"= {C} channels, not {in_channels}")
            for name in STATISTIC_BUFFERS:
                self.register_buffer(name, torch.zeros(num_class, C))
        for i in range(num_class):
            setattr(self, f"cls{i}_fc", nn.Linear(C, 64, bias=False))
            setattr(self, f"cls{i}_bn", BatchNorm(64, eps=1e-3))
            setattr(self, f"cls{i}_out", nn.Linear(64, 1))
        code = box_coder.code_size
        if not gated_reg:
            self.reg_fc = SharedMLP(C, list(cfg["REG_FC"]))
            self.reg_out = nn.Linear(int(cfg["REG_FC"][-1]), code)
            return
        self.reg_feat_fc = nn.Linear(C, 64, bias=False)
        self.reg_feat_bn = BatchNorm(64, eps=1e-5, momentum=0.9)
        self.gate_fc = nn.Linear(C, 512, bias=False)
        self.gate_bn = BatchNorm(512, eps=1e-5, momentum=0.9)
        self.gate_out = nn.Linear(512, 64 * code, bias=False)
        self.wbias_fc = nn.Linear(C, 64, bias=False)
        self.wbias_bn = BatchNorm(64, eps=1e-5, momentum=0.9)
        self.wbias_out = nn.Linear(64, code)
        self.reg_weight = nn.Parameter(torch.zeros(1, 1, 64, code))

    def forward(self, point_coords, point_features, point_valid, sp,
                centroid_xyz, statistics=None, cache=None, p_cls=None, p_val=None):
        """statistics: the (num_class, C) class statistics of a head that
        shares one set between its branches, or None for the branch's own
        buffers; p_cls / p_val (B, N): each point's predicted class (-1
        outside) and score, which the train-mode update of the branch's own
        buffers reads."""
        lo, hi = self.sample_range
        cand_xyz = point_coords[:, lo:hi]
        cand_feat = point_features[:, lo:hi]
        cand_valid = point_valid[:, lo:hi]

        offsets = self.vote_out(self.vote_fc(cand_feat, cand_valid))
        rng = self.max_translation
        offsets = torch.maximum(torch.minimum(offsets, rng), -rng)
        vote_xyz = cand_xyz + offsets

        feats = self.vsa(vote_xyz, None, cand_valid, sp=sp,
                         centroid_xyz=centroid_xyz, new_xyz=vote_xyz,
                         cache=cache)["new_features"]
        shared = self.shared_fc(feats, cand_valid)

        counts = None
        if statistics is None:
            statistics = self.object_statistic_features
            if self.training:
                statistics, counts = self._update_statistics(
                    point_features, p_cls, p_val, point_valid)

        cls_list = []
        for i in range(self.num_class):
            cond = shared * statistics[i][None, None, :]
            h = getattr(self, f"cls{i}_bn")(getattr(self, f"cls{i}_fc")(cond), cand_valid)
            cls_list.append(getattr(self, f"cls{i}_out")(torch.relu(h)))
        cls_preds = torch.cat(cls_list, -1)

        if self.gated_reg:
            reg_preds = self._gated_reg(shared, cls_preds, statistics, cand_valid)
        else:
            reg_preds = self.reg_out(self.reg_fc(shared, cand_valid))
        box_preds = self.box_coder.decode(reg_preds, vote_xyz)
        return dict(candidate_xyz=cand_xyz, candidate_valid=cand_valid,
                    vote_xyz=vote_xyz, cls_preds=cls_preds, reg_preds=reg_preds,
                    box_preds=box_preds, shared=shared, statistic_counts=counts)

    def _update_statistics(self, point_features, p_cls, p_val, point_valid):
        """The momentum update of the branch's buffers (point_head_vote.py:
        205-237; code_board.py:884-901): for each class i, the mean of the
        backbone features of the valid points predicted i with a score of
        at least 0.3; with no such point the old values stay. The new
        statistics are computed in the graph and returned for this
        forward's cls conditioning and gated regression, so the gradient
        reaches the backbone through them, as `jax.grad` does through the
        JAX package's traced update; the buffers keep detached copies.
        Returns (statistics (num_class, C), counts (num_class,))."""
        C = self.object_statistic_features.shape[1]
        feats = point_features.reshape(-1, C)
        cls = p_cls.reshape(-1)
        val = p_val.reshape(-1)
        ok = point_valid.reshape(-1)
        stat, mom, mean = (getattr(self, name).clone() for name in STATISTIC_BUFFERS)
        masks = [(cls == i) & (val >= 0.3) & ok for i in range(self.num_class)]
        sums = [(feats * m[:, None].to(feats.dtype)).sum(0) for m in masks]
        cnts = [m.sum() for m in masks]
        if comm.data_world_size() > 1:
            packed = comm.global_sum(torch.cat(
                [torch.stack(sums), torch.stack(cnts).to(feats.dtype)[:, None]], 1))
            sums = list(packed[:, :C])
            cnts = list(packed[:, C].round().to(cnts[0].dtype))
        new_stat, new_mom, new_mean, counts = [], [], [], []
        for i in range(self.num_class):
            cnt = cnts[i]
            seen = cnt > 0
            mu = torch.where(seen, sums[i] / torch.clamp(cnt, min=1), mean[i])
            mom_i = torch.where(seen, 0.9 * mom[i] + (mu - mean[i]), mom[i])
            new_stat.append(torch.where(seen, stat[i] + mom_i, stat[i]))
            new_mom.append(mom_i)
            new_mean.append(mu)
            counts.append(cnt)
        new = [torch.stack(t) for t in (new_stat, new_mom, new_mean)]
        with torch.no_grad():
            for name, t in zip(STATISTIC_BUFFERS, new):
                getattr(self, name).copy_(t.detach())
        return new[0], torch.stack(counts)

    def _gated_reg(self, shared, cls_preds, statistics, cand_valid):
        """Statistic-gated dynamic-weight regression (point_head_vote.py:
        273-313)."""
        B, M, _ = shared.shape
        code = self.box_coder.code_size
        prob = torch.sigmoid(cls_preds)
        score_val, score_cls = prob.amax(-1), prob.argmax(-1)
        stat_ext = torch.where((score_val >= 0.1)[..., None], statistics[score_cls],
                               torch.zeros_like(shared))
        aware = stat_ext + shared
        reg_feat = torch.relu(self.reg_feat_bn(self.reg_feat_fc(shared), cand_valid))
        g = torch.relu(self.gate_bn(self.gate_fc(aware), cand_valid))
        gate = torch.sigmoid(self.gate_out(g)).reshape(B, M, 64, code)
        bias_h = torch.relu(self.wbias_bn(self.wbias_fc(aware), cand_valid))
        wbias = self.wbias_out(bias_h)
        return torch.einsum("bnc,bnck->bnk", reg_feat, self.reg_weight * gate) + wbias


# ---------------------------------------------------------------------------
# losses (point_head_vote.py:323-511)
# ---------------------------------------------------------------------------

def _branch_losses(out, teacher_out, gt_boxes, gt_valid, box_coder, cfg,
                   num_class):
    """Vote + cls (centerness x rdiou) + box (offset / angle / rdiou /
    corner) losses of one branch. Returns (targets, loss, tb_dict).

    teacher_out=None: the teacher-training route (code_board.py): quality
    labels to the power 0.5, the gt terms at full weight; tb keys without a
    prefix. teacher_out given: the distillation route of the student branch
    (...distillation.py:682-882): quality labels to the power 0.25, each
    loss blended with the teacher's outputs (cls 0.5 / 0.5 with both logit
    sets tempered by /3, offsets 0.5 / 0.5, rdiou 0.5 / 0.5, corner 0.3 gt
    + 0.7 teacher); tb keys prefixed "s_"."""
    w = cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    tb = {}
    distill = teacher_out is not None
    qpow = 0.25 if distill else 0.5
    prefix = "s_" if distill else ""

    def quality(x):
        return (x + 1e-8) ** qpow

    cand_valid = out["candidate_valid"]
    extra = cfg["TARGET_CONFIG"].get("VOTE_EXTRA_WIDTH")
    v_labels, v_centers = assign_targets_simple(out["candidate_xyz"], gt_boxes,
                                                gt_valid, extra_width=extra)
    vw = ((v_labels > 0) & cand_valid).float()
    vw = vw / torch.clamp(comm.global_sum(vw.sum()), min=1.0)
    vote_loss = comm.scale_to_global(loss_utils.weighted_smooth_l1(
        out["vote_xyz"], v_centers, weights=vw).sum()) * w["vote_reg_weight"]
    tb[prefix + "vote_loss"] = vote_loss

    # the targets at vote positions are constants (stop_gradient on the
    # assignment input, point_head_vote.py:356-368)
    vote_c = out["vote_xyz"].detach()
    radius = float(cfg["TARGET_CONFIG"].get("GT_CENTRAL_RADIUS", 10.0))
    labels, reg_labels, box_labels = assign_targets_mask(
        vote_c, gt_boxes, gt_valid, box_coder, radius)
    labels = torch.where(cand_valid, labels, torch.full_like(labels, -1))
    pos = labels > 0
    cls_w = (labels >= 0).float()

    # the quality label is a constant: centerness and rdiou on detached
    # predictions
    cent = loss_utils.centerness_label(vote_c, box_labels, pos)
    _, rd = loss_utils.rdiou(out["box_preds"].detach(), box_labels)
    cent = torch.where(pos, quality(cent * rd), cent)
    one_hot = F.one_hot(torch.clamp(labels, min=0), num_class + 1)[..., 1:].float()
    one_hot = one_hot * cent[..., None]
    cls_loss_pt = loss_utils.bce_with_logits(out["cls_preds"], one_hot).sum(-1) * cls_w
    if distill:
        t_soft = torch.sigmoid(teacher_out["cls_preds"].detach() / 3.0)
        distill_pt = loss_utils.bce_with_logits(out["cls_preds"] / 3.0,
                                                t_soft).sum(-1) * cls_w
        cls_loss_pt = 0.5 * cls_loss_pt + 0.5 * distill_pt
    n_pos = comm.global_sum(pos.sum().float())
    cls_norm = torch.clamp(n_pos, min=1.0)
    cls_loss = comm.scale_to_global(cls_loss_pt.sum()) / cls_norm * w["point_cls_weight"]
    tb[prefix + "cls_loss"] = cls_loss

    rw = pos.float()
    nbin = box_coder.angle_bin_num
    reg = out["reg_preds"]
    off_l = loss_utils.weighted_smooth_l1(reg[..., :6], reg_labels[..., :6],
                                          weights=rw).sum(-1)
    if distill:
        t_off = loss_utils.weighted_smooth_l1(
            reg[..., :6], teacher_out["reg_preds"][..., :6].detach(),
            weights=rw).sum(-1)
        off_l = 0.5 * off_l + 0.5 * t_off
    off_l = off_l * w["point_offset_reg_weight"]
    ang_cls_lab = reg_labels[..., 6:6 + nbin]
    ce = -F.log_softmax(reg[..., 6:6 + nbin], dim=-1) * ang_cls_lab
    ang_cls_l = ce.sum(-1) * rw * w["point_angle_cls_weight"]
    ang_res_p = (reg[..., 6 + nbin:6 + 2 * nbin] * ang_cls_lab).sum(-1)
    ang_res_l = (reg_labels[..., 6 + nbin:6 + 2 * nbin] * ang_cls_lab).sum(-1)
    ang_reg_l = loss_utils.weighted_smooth_l1(
        ang_res_p[..., None], ang_res_l[..., None], weights=rw
    ).sum(-1) * w["point_angle_reg_weight"]
    box_loss_pt = off_l + ang_cls_l + ang_reg_l

    aux = torch.zeros_like(box_loss_pt)
    lc = cfg["LOSS_CONFIG"]
    if lc.get("RDIOU_REGRESS_REGULARIZATION", False):
        cent2 = loss_utils.centerness_label(vote_c, box_labels, pos)
        _, rd2 = loss_utils.rdiou(out["box_preds"], box_labels)
        iou_l = 1.0 - quality(rd2 * cent2)
        if distill:
            t_box = teacher_out["box_preds"].detach()
            t_cent = loss_utils.centerness_label(vote_c, t_box, pos)
            _, t_rd = loss_utils.rdiou(out["box_preds"], t_box)
            iou_l = 0.5 * iou_l + 0.5 * (1.0 - quality(t_rd * t_cent))
        aux = aux + torch.where(pos, iou_l * w["point_iou_weight"],
                                torch.zeros_like(iou_l))
    if lc.get("CORNER_LOSS_REGULARIZATION", False):
        corner = corner_loss_points(out["box_preds"], box_labels, rw) \
            * w["point_corner_weight"]
        if distill:
            t_corner = corner_loss_points(out["box_preds"],
                                          teacher_out["box_preds"].detach(),
                                          rw) * w["point_corner_weight"]
            corner = 0.3 * corner + 0.7 * t_corner
        aux = aux + corner
    box_norm = torch.clamp(n_pos, min=1.0)
    part = comm.scale_to_global
    box_loss = part((box_loss_pt * rw + aux).sum()) / box_norm
    tb[prefix + "box_loss"] = box_loss
    tb[prefix + "box_off"] = part((off_l * rw).sum()) / box_norm
    tb[prefix + "box_ang"] = part(((ang_cls_l + ang_reg_l) * rw).sum()) / box_norm
    tb[prefix + "box_aux"] = part(aux.sum()) / box_norm
    tb[prefix + "n_pos"] = n_pos

    targets = dict(labels=labels, reg_labels=reg_labels, box_labels=box_labels,
                   pos=pos)
    return targets, vote_loss + cls_loss + box_loss, tb


def _sasa_loss(batch_dict, gt_boxes, gt_valid, cfg, num_class):
    sasa_cfg = cfg["LOSS_CONFIG"].get("LOSS_SASA_CONFIG")
    if not sasa_cfg:
        return 0.0, {}
    lw = list(sasa_cfg["layer_weights"])
    extra = sasa_cfg.get("extra_width")
    total = 0.0
    for i, (xyz, sc, vl) in enumerate(zip(batch_dict.get("point_coords_list", []),
                                          batch_dict.get("point_scores_list", []),
                                          batch_dict.get("point_valid_list", []))):
        if sc is None or i >= len(lw):
            continue
        labels = loss_utils.sasa_assign_targets(
            xyz, gt_boxes, extra_width=extra,
            set_ignore_flag=bool(sasa_cfg.get("set_ignore_flag", True)),
            num_class=num_class, gt_valid=gt_valid)
        labels = torch.where(vl, labels, torch.full_like(labels, -1))
        total = total + lw[i] * loss_utils.sasa_layer_loss(sc, labels,
                                                           num_class=num_class)
    return total, {"sasa_loss": total}


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

def _point_scores(scores_voxel, slot):
    """Each point's predicted class (argmax of its voxel's confidence) and
    score (the largest sigmoid), through the backbone's point -> voxel slot:
    (-1, 0) for a point without a voxel (point_head_vote.py:530-535). Only
    compared, so without a gradient."""
    scores_voxel = scores_voxel.detach()
    smax = torch.sigmoid(scores_voxel).amax(-1)
    scls = scores_voxel.argmax(-1)
    safe = torch.clamp(slot.long(), 0, smax.shape[1] - 1)
    inside = slot >= 0
    p_val = torch.where(inside, torch.gather(smax, 1, safe), 0.0)
    p_cls = torch.where(inside, torch.gather(scls, 1, safe), -1)
    return p_cls, p_val


def _need_gt(batch_dict):
    if "gt_boxes" not in batch_dict or "gt_boxes_mask" not in batch_dict:
        raise ValueError("training needs gt_boxes and gt_boxes_mask in the batch")
    return batch_dict["gt_boxes"], batch_dict["gt_boxes_mask"]


class PointHeadVoteSASAStatistic(nn.Module):
    """Teacher-training head (counterpart of point_head_vote.py:514-561):
    one gated branch `head` that owns and, in train mode, updates the class
    statistics from the backbone's point features and per-point confidence.
    In train mode the batch dict gains `loss` (the branch losses on the
    teacher route plus the SASA loss), `tb_dict` and `statistic_counts`
    (num_class,), the points each class's update averaged."""

    def __init__(self, model_cfg, num_class, input_channels, meta=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        tc = model_cfg["TARGET_CONFIG"]
        self.box_coder = PointBinResidualCoder(**dict(tc.get("BOX_CODER_CONFIG", {})))
        ch = int(input_channels)
        self.head = VoteHeadBranch(
            model_cfg, dict(model_cfg["VOTE_CONFIG"]), dict(model_cfg["VSA_CONFIG"]),
            num_class, self.box_coder, in_channels=ch, sp_channels=ch,
            gated_reg=True, own_statistics=True)

    def forward(self, batch_dict):
        p_cls, p_val = _point_scores(batch_dict["point_scores"],
                                     batch_dict["last_point_slot"])
        out = self.head(
            batch_dict["point_coords"], batch_dict["point_features"],
            batch_dict["point_valid"], batch_dict["last_sp_tensor"],
            batch_dict["last_centroid_xyz"], None, batch_dict.get("group_cache"),
            p_cls=p_cls, p_val=p_val)
        batch_dict["batch_cls_preds"] = out["cls_preds"]
        batch_dict["batch_box_preds"] = out["box_preds"]
        batch_dict["cls_preds_normalized"] = False
        batch_dict["point_vote_coords"] = out["vote_xyz"]
        if not self.training:
            return batch_dict

        gt, gv = _need_gt(batch_dict)
        _, loss, tb = _branch_losses(out, None, gt, gv, self.box_coder,
                                     self.model_cfg, self.num_class)
        sasa, tb2 = _sasa_loss(batch_dict, gt, gv, self.model_cfg, self.num_class)
        batch_dict["loss"] = loss + sasa
        batch_dict["tb_dict"] = {**tb, **tb2}
        batch_dict["statistic_counts"] = out["statistic_counts"]
        return batch_dict


class PointHeadVoteSASAStatisticDistillation(nn.Module):
    """Distillation head: the student branch `s_head` (the deployed model),
    the frozen teacher branch `head` (training only) and the shared
    statistics buffers. In train mode the teacher branch runs in train mode
    (its BN running stats update) under `torch.no_grad()`, and the batch
    dict gains `loss` and `tb_dict`."""

    def __init__(self, model_cfg, num_class, input_channels, meta=None,
                 teacher_channels=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        tc = model_cfg["TARGET_CONFIG"]
        self.box_coder = PointBinResidualCoder(**dict(tc.get("BOX_CODER_CONFIG", {})))
        t_ch = int(teacher_channels or input_channels)
        self.head = VoteHeadBranch(
            model_cfg, dict(model_cfg["VOTE_CONFIG"]), dict(model_cfg["VSA_CONFIG"]),
            num_class, self.box_coder, in_channels=t_ch, sp_channels=t_ch,
            gated_reg=True)
        self.s_head = VoteHeadBranch(
            model_cfg, dict(model_cfg["S_VOTE_CONFIG"]),
            dict(model_cfg["S_VSA_CONFIG"]), num_class, self.box_coder,
            in_channels=input_channels, sp_channels=input_channels)
        C = int(model_cfg["SHARED_FC"][-1])
        for name in STATISTIC_BUFFERS:
            self.register_buffer(name, torch.zeros(num_class, C))

    def forward(self, batch_dict):
        stats = self.object_statistic_features
        s_out = self.s_head(
            batch_dict["s_point_coords"], batch_dict["s_point_features"],
            batch_dict["s_point_valid"], batch_dict["s_last_sp_tensor"],
            batch_dict["s_last_centroid_xyz"], stats, batch_dict.get("group_cache"))
        batch_dict["batch_cls_preds"] = s_out["cls_preds"]
        batch_dict["batch_box_preds"] = s_out["box_preds"]
        batch_dict["cls_preds_normalized"] = False
        batch_dict["point_vote_coords"] = s_out["vote_xyz"]
        if not self.training:
            return batch_dict

        gt, gv = _need_gt(batch_dict)
        with torch.no_grad():
            t_out = self.head(
                batch_dict["point_coords"], batch_dict["point_features"],
                batch_dict["point_valid"], batch_dict["last_sp_tensor"],
                batch_dict["last_centroid_xyz"], stats, batch_dict.get("group_cache"))
        _, s_loss, tb = _branch_losses(s_out, t_out, gt, gv, self.box_coder,
                                       self.model_cfg, self.num_class)
        sasa, tb2 = _sasa_loss(batch_dict, gt, gv, self.model_cfg, self.num_class)
        batch_dict["loss"] = s_loss + sasa
        batch_dict["tb_dict"] = {**tb, **tb2}
        return batch_dict
