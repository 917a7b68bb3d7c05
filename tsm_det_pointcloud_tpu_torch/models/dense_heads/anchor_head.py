"""Anchor-based dense head (counterpart of
tsm_det_pointcloud_tpu/models/dense_heads/anchor_head.py:29-150, 152-313).

`AnchorHeadSingle` runs three 1x1 convs (cls, box, direction) over the NHWC
BEV features, permutes their outputs to NHWC before flattening, so that
prediction i pairs with anchor i of `generate_anchors`' layout. At eval it
decodes the boxes with the direction correction; in training it leaves
them out unless `predict_boxes_when_training` (the JAX head's flag, set for
the first stage of a two-stage detector, whose RoI head reads the decoded
boxes; the decode keeps its gradient to the box regression), and
`loss` assigns the targets (`assign_targets`, vectorised over anchors and
boxes, a loop over the scans) and computes the focal cls, smooth-L1 box
(with the sine difference on the heading) and direction losses.

The JAX registry's variants (its anchor_head.py:316-520): `AnchorHeadMulti`
(AnchorHeadSingle behind an optional 3x3 `shared_conv` + ReLU), the
classification-only `AnchorHeadSingleCls` (over the stride-8 sparse level
`x_conv4`, densified, z folded into channels) and `AnchorHeadMultiCls`
(one cls conv a class group, each group's logits written at its classes'
columns, zero elsewhere), both with `loss` the focal cls term alone; and
`atss_assign_targets`, the ATSS target assignment.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_coder_utils, loss_utils
from ...ops import spconv as sp
from ...ops.iou3d import boxes_iou3d
from ...utils.common_utils import limit_period


def generate_anchors(anchor_range, grid_sizes, anchor_generator_configs):
    """(anchors (nz*ny*nx*A, 7) f32, anchors per location). Layout, slowest
    to fastest: z, y, x, class, size, rotation; each anchor's bottom height
    moved to its centre."""
    per_class = []
    for grid_size, cfg in zip(grid_sizes, anchor_generator_configs):
        sizes = np.array(cfg["anchor_sizes"], np.float32)           # (S, 3)
        rotations = np.array(cfg["anchor_rotations"], np.float32)   # (R,)
        heights = np.array(cfg["anchor_bottom_heights"], np.float32)  # (Z,)
        nx, ny = int(grid_size[0]), int(grid_size[1])
        if cfg.get("align_center", False):
            x_stride = (anchor_range[3] - anchor_range[0]) / nx
            y_stride = (anchor_range[4] - anchor_range[1]) / ny
            x_offset, y_offset = x_stride / 2, y_stride / 2
        else:
            x_stride = (anchor_range[3] - anchor_range[0]) / (nx - 1)
            y_stride = (anchor_range[4] - anchor_range[1]) / (ny - 1)
            x_offset = y_offset = 0.0
        xs = anchor_range[0] + x_offset + x_stride * np.arange(nx, dtype=np.float32)
        ys = anchor_range[1] + y_offset + y_stride * np.arange(ny, dtype=np.float32)
        Z, S, R = len(heights), len(sizes), len(rotations)
        a = np.zeros((Z, ny, nx, S, R, 7), np.float32)
        a[..., 0] = xs[None, None, :, None, None]
        a[..., 1] = ys[None, :, None, None, None]
        a[..., 2] = heights[:, None, None, None, None]
        a[..., 3:6] = sizes[None, None, None, :, None, :]
        a[..., 6] = rotations[None, None, None, None, :]
        a[..., 2] += a[..., 5] / 2
        per_class.append(a)
    num_per_loc = sum(a.shape[3] * a.shape[4] for a in per_class)
    flat = [a.reshape(a.shape[0], a.shape[1], a.shape[2], -1, 7) for a in per_class]
    return np.concatenate(flat, axis=3).reshape(-1, 7), num_per_loc


def nearest_bev_iou(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) axis-aligned IoU of the heading-snapped BEV
    boxes (each box's dx, dy swapped where its |heading| wraps past pi / 4),
    in the JAX expression order, so that equal IoUs stay equal."""

    def to_aabb(b):
        rot = limit_period(b[:, 6].abs(), 0.5, np.pi)
        cond = (rot > np.pi / 4)[:, None]
        dxy = torch.where(cond, b[:, [4, 3]], b[:, [3, 4]])
        return torch.cat([b[:, :2] - dxy / 2, b[:, :2] + dxy / 2], -1)

    aa, bb = to_aabb(boxes_a), to_aabb(boxes_b)
    lt = torch.maximum(aa[:, None, :2], bb[None, :, :2])
    rb = torch.minimum(aa[:, None, 2:], bb[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (aa[:, 2] - aa[:, 0]) * (aa[:, 3] - aa[:, 1])
    area_b = (bb[:, 2] - bb[:, 0]) * (bb[:, 3] - bb[:, 1])
    return inter / torch.clamp(area_a[:, None] + area_b[None] - inter, min=1e-6)


def assign_targets(anchors, gt_boxes, gt_valid, anchor_class_ids, matched_thresholds,
                   unmatched_thresholds, box_coder, match_height=False):
    """The axis-aligned target assignment (JAX anchor_head.py:98-150): each
    scan in turn, over all anchors, boxes and classes at once. anchors
    (A, 7); gt_boxes (B, M, 8)
    with the 1-based class at [..., 7]; gt_valid (B, M); anchor_class_ids
    (A,) 1-based; matched / unmatched_thresholds (A,). An anchor is positive
    at IoU >= its matched threshold with a box of its class, or as a box's
    best anchor (ties all taken); background below its unmatched threshold;
    else ignored (-1). Returns box_cls_labels (B, A) int32, box_reg_targets
    (B, A, code) and reg_weights (B, A)."""
    labels, targets, weights = [], [], []
    for gts, valid in zip(gt_boxes, gt_valid):
        gt_cls = gts[:, 7].to(torch.int32)
        iou = (boxes_iou3d if match_height else nearest_bev_iou)(anchors, gts[:, :7])
        class_ok = anchor_class_ids[:, None] == gt_cls[None, :]
        iou = torch.where(class_ok & valid[None, :], iou, torch.zeros_like(iou))
        a2g_max = iou.amax(dim=1)
        a2g_arg = torch.argmax(iou, dim=1)      # the first maximum, as jnp.argmax
        g2a_max = torch.where(valid, iou.amax(dim=0), torch.full_like(a2g_max[:1], -1.0))
        g2a_max = torch.where(g2a_max == 0, torch.full_like(g2a_max, -1.0), g2a_max)
        force = (iou == g2a_max[None, :]).any(dim=1) & (a2g_max > 0)
        pos = a2g_max >= matched_thresholds
        bg = a2g_max < unmatched_thresholds
        lab = torch.full_like(a2g_arg, -1, dtype=torch.int32)
        lab = torch.where(bg, torch.zeros_like(lab), lab)
        lab = torch.where(pos | force, gt_cls[a2g_arg], lab)
        fg = lab > 0
        reg = box_coder.encode(gts[a2g_arg][:, :7], anchors)
        labels.append(lab)
        targets.append(torch.where(fg[:, None], reg, torch.zeros_like(reg)))
        weights.append(fg.to(anchors.dtype))
    return {"box_cls_labels": torch.stack(labels), "box_reg_targets": torch.stack(targets),
            "reg_weights": torch.stack(weights)}


def atss_assign_targets(anchors, gt_boxes, gt_valid, class_ids, anchor_class_ids,
                        box_coder, topk=9):
    """ATSS target assignment (JAX anchor_head.py:316-381), each scan in
    turn: a gt box's candidates are its `topk` anchors of its class nearest
    by centre (ties to the lower index, as lax.top_k); its IoU threshold is
    the mean + (population) std of their 3D IoUs; a candidate above it whose
    centre lies inside the box is positive. An anchor positive for several
    boxes takes the one of highest IoU, and of equal IoUs the last
    (candidate order, box-major), as the JAX scatter writes. `class_ids` is
    unused, as in the JAX function. Returns box_cls_labels (B, A) int32,
    box_reg_targets (B, A, code) and reg_weights (B, A)."""
    labels, targets, weights = [], [], []
    A = anchors.shape[0]
    for gts, valid in zip(gt_boxes, gt_valid):
        gt_cls = gts[:, 7].to(torch.int32)
        mask = (anchor_class_ids[:, None] == gt_cls[None, :]) & valid[None, :]
        iou = torch.where(mask, boxes_iou3d(anchors, gts[:, :7]), torch.zeros((), device=gts.device))
        d2 = torch.sum((anchors[:, None, :3] - gts[None, :, :3]) ** 2, -1)
        d2 = torch.where(mask, d2, torch.full((), 1e10, device=gts.device))
        cand = torch.sort(d2.T, dim=1, stable=True)[1][:, :topk]            # (M, k)
        cand_iou = torch.gather(iou.T, 1, cand)
        thr = cand_iou.mean(1) + cand_iou.std(1, unbiased=False)
        rel = anchors[:, :3][cand] - gts[:, None, :3]                        # (M, k, 3)
        cosa = torch.cos(-gts[:, 6])[:, None]
        sina = torch.sin(-gts[:, 6])[:, None]
        lx = rel[..., 0] * cosa - rel[..., 1] * sina
        ly = rel[..., 0] * sina + rel[..., 1] * cosa
        inside = ((lx.abs() < gts[:, None, 3] / 2) & (ly.abs() < gts[:, None, 4] / 2)
                  & (rel[..., 2].abs() < gts[:, None, 5] / 2))
        is_pos = (cand_iou >= thr[:, None]) & inside & valid[:, None]
        M, K = cand.shape
        flat_c = cand.reshape(-1)
        flat_i = torch.where(is_pos, cand_iou, torch.full((), -1.0, device=gts.device)).reshape(-1)
        best = torch.full((A,), float("-inf"), device=gts.device).scatter_reduce(
            0, flat_c, flat_i, "amax")
        chosen = (flat_i == best[flat_c]) & (flat_i > 0)
        slot = torch.where(chosen, torch.arange(M * K, device=gts.device),
                           torch.full((), -1, device=gts.device))
        winner = torch.full((A,), -1, dtype=slot.dtype, device=gts.device).scatter_reduce(
            0, flat_c, slot, "amax")
        fg = winner >= 0
        gt_idx = torch.where(fg, winner // K, torch.zeros_like(winner))
        lab = torch.where(fg, gt_cls[gt_idx], torch.zeros_like(gt_cls[gt_idx]))
        fg = lab > 0
        reg = box_coder.encode(gts[gt_idx][:, :7], anchors)
        labels.append(lab)
        targets.append(torch.where(fg[:, None], reg, torch.zeros_like(reg)))
        weights.append(fg.to(anchors.dtype))
    return {"box_cls_labels": torch.stack(labels), "box_reg_targets": torch.stack(targets),
            "reg_weights": torch.stack(weights)}


class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range, predict_boxes_when_training=False):
        super().__init__()
        cfg = model_cfg
        self.predict_boxes_when_training = bool(predict_boxes_when_training)
        self.model_cfg = cfg
        self.num_class = int(num_class)
        anchor_cfgs = cfg["ANCHOR_GENERATOR_CONFIG"]
        stride = anchor_cfgs[0].get("feature_map_stride", 2)
        grid_xy = [(grid_size[0] // stride, grid_size[1] // stride) for _ in anchor_cfgs]
        anchors, self.num_anchors_per_location = generate_anchors(
            point_cloud_range, grid_xy, anchor_cfgs)
        self.register_buffer("anchors", torch.from_numpy(anchors), persistent=False)
        # per anchor, in generate_anchors' order: its 1-based class and the
        # matched / unmatched IoU thresholds of its class
        per_loc = []
        for ci, acfg in enumerate(anchor_cfgs):
            n = (len(acfg["anchor_sizes"]) * len(acfg["anchor_rotations"])
                 * len(acfg["anchor_bottom_heights"]))
            per_loc += [(ci + 1, acfg["matched_threshold"], acfg["unmatched_threshold"])] * n
        n_loc = anchors.shape[0] // len(per_loc)
        cls_ids, matched, unmatched = zip(*per_loc)
        for name, vals, dtype in (("anchor_class_ids", cls_ids, torch.int32),
                                  ("matched_thresholds", matched, torch.float32),
                                  ("unmatched_thresholds", unmatched, torch.float32)):
            self.register_buffer(name, torch.tensor(vals, dtype=dtype).repeat(n_loc),
                                 persistent=False)
        self.match_height = cfg.get("TARGET_ASSIGNER_CONFIG", {}).get("MATCH_HEIGHT", False)
        self.box_coder = getattr(box_coder_utils, cfg.get("BOX_CODER", "ResidualCoder"))(
            **cfg.get("BOX_CODER_CONFIG", {}))
        self.use_dir = cfg.get("USE_DIRECTION_CLASSIFIER", False)
        self.num_dir_bins = cfg.get("NUM_DIR_BINS", 2)
        self.dir_offset = cfg.get("DIR_OFFSET", 0.78539)
        self.dir_limit_offset = cfg.get("DIR_LIMIT_OFFSET", 0.0)
        self.class_names = tuple(class_names)
        self._make_convs(int(input_channels))

    def _make_convs(self, c):
        A = self.num_anchors_per_location
        self.conv_cls = nn.Conv2d(c, A * self.num_class, 1)
        self.conv_box = nn.Conv2d(c, A * self.box_coder.code_size, 1)
        if self.use_dir:
            self.conv_dir_cls = nn.Conv2d(c, A * self.num_dir_bins, 1)

    @staticmethod
    def _nhwc(conv, x):
        """A 1x1 conv of the NCHW view, its output back to NHWC."""
        return conv(x).permute(0, 2, 3, 1)

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"].permute(0, 3, 1, 2)   # NHWC -> NCHW
        B = x.shape[0]
        cls_preds = self._nhwc(self.conv_cls, x).reshape(B, -1, self.num_class)
        box_preds = self._nhwc(self.conv_box, x).reshape(B, -1, self.box_coder.code_size)
        dir_preds = None
        if self.use_dir:
            dir_preds = self._nhwc(self.conv_dir_cls, x).reshape(B, -1, self.num_dir_bins)
            batch_dict["dir_cls_preds"] = dir_preds
        batch_dict["cls_preds"] = cls_preds
        batch_dict["box_preds"] = box_preds
        if self.training and not self.predict_boxes_when_training:
            return batch_dict
        batch_cls, batch_box = self.generate_predicted_boxes(cls_preds, box_preds, dir_preds)
        batch_dict["batch_cls_preds"] = batch_cls
        batch_dict["batch_box_preds"] = batch_box
        batch_dict["cls_preds_normalized"] = False
        return batch_dict

    def generate_predicted_boxes(self, cls_preds, box_preds, dir_cls_preds=None):
        boxes = self.box_coder.decode(box_preds, self.anchors[None])
        if self.use_dir and dir_cls_preds is not None:
            dir_labels = torch.argmax(dir_cls_preds, dim=-1)   # the first maximum
            period = 2 * np.pi / self.num_dir_bins
            val = limit_period(boxes[..., 6] - self.dir_offset, self.dir_limit_offset,
                               period)
            rot = val + self.dir_offset + period * dir_labels.to(boxes.dtype)
            boxes = torch.cat([boxes[..., :6], rot[..., None], boxes[..., 7:]], -1)
        return cls_preds, boxes

    def assign(self, gt_boxes, gt_valid):
        return assign_targets(self.anchors, gt_boxes, gt_valid, self.anchor_class_ids,
                              self.matched_thresholds, self.unmatched_thresholds,
                              self.box_coder, self.match_height)

    def get_direction_target(self, reg_targets):
        """The direction bin of each anchor's target heading (int64)."""
        rot_gt = reg_targets[..., 6] + self.anchors[None, :, 6]
        offset_rot = limit_period(rot_gt - self.dir_offset, 0, 2 * np.pi)
        bins = torch.floor(offset_rot / (2 * np.pi / self.num_dir_bins))
        return torch.clamp(bins, 0, self.num_dir_bins - 1).to(torch.int64)

    def loss(self, batch_dict):
        """(total head loss, tb_dict) of the batch's predictions against the
        targets assigned from its gt boxes (JAX anchor_head.py:262-304):
        focal cls over the cared anchors, smooth-L1 box over the positives
        (sine difference on the heading, the config's code weights),
        direction cross-entropy over the positives; each normalised by the
        scan's positives and summed over the batch / batch_size."""
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        # each scan is normalised by its own positives and the sum divided by
        # the local batch: in a multi-process run of equal local batches the
        # ranks' mean, and DDP's mean of their gradients, is the global
        # batch's, so no reduction goes through parallel.comm here
        bs = batch_dict["batch_size"]
        targets = self.assign(batch_dict["gt_boxes"], batch_dict["gt_boxes_mask"])
        cls_labels = targets["box_cls_labels"]
        reg_targets = targets["box_reg_targets"]
        cls_preds = batch_dict["cls_preds"]
        box_preds = batch_dict["box_preds"]

        cared = cls_labels >= 0
        positives = (cls_labels > 0).to(cls_preds.dtype)
        negatives = (cls_labels == 0).to(cls_preds.dtype)
        pos_normalizer = torch.clamp(positives.sum(dim=1, keepdim=True), min=1.0)
        cls_weights = (negatives + positives) / pos_normalizer
        reg_weights = positives / pos_normalizer

        cls_targets = torch.where(cared, cls_labels, torch.zeros_like(cls_labels))
        one_hot = F.one_hot(cls_targets.long(), self.num_class + 1)[..., 1:].to(cls_preds.dtype)
        cls_loss = loss_utils.sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum() / bs
        cls_loss = cls_loss * lw["cls_weight"]

        bp, rt = self._add_sin_difference(box_preds, reg_targets)
        loc_loss = loss_utils.weighted_smooth_l1(
            bp, rt, reg_weights, code_weights=lw.get("code_weights")).sum() / bs
        loc_loss = loc_loss * lw["loc_weight"]

        tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
        total = cls_loss + loc_loss
        if self.use_dir and "dir_cls_preds" in batch_dict:
            dir_one_hot = F.one_hot(self.get_direction_target(reg_targets),
                                    self.num_dir_bins).to(cls_preds.dtype)
            dir_loss = loss_utils.weighted_cross_entropy(
                batch_dict["dir_cls_preds"], dir_one_hot, positives / pos_normalizer).sum() / bs
            dir_loss = dir_loss * lw["dir_weight"]
            tb["rpn_loss_dir"] = dir_loss
            total = total + dir_loss
        tb["rpn_loss"] = total
        return total, tb

    @staticmethod
    def _add_sin_difference(boxes1, boxes2):
        rad_pred = torch.sin(boxes1[..., 6:7]) * torch.cos(boxes2[..., 6:7])
        rad_tg = torch.cos(boxes1[..., 6:7]) * torch.sin(boxes2[..., 6:7])
        b1 = torch.cat([boxes1[..., :6], rad_pred, boxes1[..., 7:]], -1)
        b2 = torch.cat([boxes2[..., :6], rad_tg, boxes2[..., 7:]], -1)
        return b1, b2


class AnchorHeadMulti(AnchorHeadSingle):
    """AnchorHeadSingle behind an optional 3x3 SAME conv `shared_conv` (with
    bias) of SHARED_CONV_NUM_FILTER channels and a ReLU, whose output
    replaces spatial_features_2d (JAX anchor_head.py:384-412)."""

    def _make_convs(self, c):
        shared = int(self.model_cfg.get("SHARED_CONV_NUM_FILTER", 0) or 0)
        self.shared_conv = nn.Conv2d(c, shared, 3, padding=1) if shared else None
        super()._make_convs(shared or c)

    def forward(self, batch_dict):
        if self.shared_conv is not None:
            x = batch_dict["spatial_features_2d"].permute(0, 3, 1, 2)
            batch_dict = dict(batch_dict)
            batch_dict["spatial_features_2d"] = torch.relu(self.shared_conv(x)).permute(0, 2, 3, 1)
        return super().forward(batch_dict)


def cls_only_loss(head, batch_dict):
    """The focal classification term alone of the cls-only heads (JAX
    anchor_head.py:415-433): over the cared anchors, each scan normalised by
    its positives, the sum over the batch / batch_size times cls_weight
    (1.0 where LOSS_CONFIG states none). Returns (loss, {rpn_loss_cls,
    rpn_loss})."""
    targets = head.assign(batch_dict["gt_boxes"], batch_dict["gt_boxes_mask"])
    cls_labels = targets["box_cls_labels"]
    cls_preds = batch_dict["cls_preds"]
    positives = (cls_labels > 0).to(cls_preds.dtype)
    negatives = (cls_labels == 0).to(cls_preds.dtype)
    cls_weights = (negatives + positives) / torch.clamp(positives.sum(1, keepdim=True), min=1.0)
    cls_targets = torch.where(cls_labels >= 0, cls_labels, torch.zeros_like(cls_labels))
    one_hot = F.one_hot(cls_targets.long(), head.num_class + 1)[..., 1:].to(cls_preds.dtype)
    lw = head.model_cfg.get("LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {})
    cls_loss = (loss_utils.sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum()
                / batch_dict["batch_size"] * lw.get("cls_weight", 1.0))
    return cls_loss, {"rpn_loss_cls": cls_loss, "rpn_loss": cls_loss}


class AnchorHeadSingleCls(AnchorHeadSingle):
    """Classification-only RPN over the stride-8 sparse level (JAX
    anchor_head.py:436-466): `x_conv4` of multi_scale_3d_features densified
    (ops.spconv.sparse_to_dense), z folded into channels (z * C + c), one
    1x1 `conv_cls`; input_channels is that fold's width (nz * C). Out:
    cls_preds only, in eval too; the anchors' feature_map_stride must be
    x_conv4's. `loss` is `cls_only_loss`."""

    def _make_convs(self, c):
        self.conv_cls = nn.Conv2d(c, self.num_anchors_per_location * self.num_class, 1)

    def forward(self, batch_dict):
        t = batch_dict["multi_scale_3d_features"]["x_conv4"]
        dense = sp.sparse_to_dense(t.features, t.coords, t.valid, t.grid)
        B, nz, ny, nx, C = dense.shape
        x = dense.permute(0, 1, 4, 2, 3).reshape(B, nz * C, ny, nx)   # channel z * C + c
        batch_dict["cls_preds"] = self._nhwc(self.conv_cls, x).reshape(B, -1, self.num_class)
        return batch_dict

    def loss(self, batch_dict):
        return cls_only_loss(self, batch_dict)


class AnchorHeadMultiCls(AnchorHeadSingle):
    """Classification-only grouped RPN (JAX anchor_head.py:469-520): the
    class groups of RPN_HEAD_CFGS' HEAD_CLS_NAME (else one a class) must
    partition CLASS_NAMES in order (else ValueError); an optional 3x3
    `shared_conv` + ReLU, then a 1x1 `conv_cls_g<i>` a group (its bias at
    the -log(99) prior) whose (anchor, class) logits land in the group's
    classes' columns of the per-anchor logits, zero in the others. Out:
    cls_preds only; `loss` is `cls_only_loss`."""

    def _make_convs(self, c):
        cfg = self.model_cfg
        head_cfgs = cfg.get("RPN_HEAD_CFGS")
        self.group_classes = ([list(h["HEAD_CLS_NAME"]) for h in head_cfgs] if head_cfgs
                              else [[n] for n in self.class_names])
        if [n for g in self.group_classes for n in g] != list(self.class_names):
            raise ValueError("RPN_HEAD_CFGS must partition CLASS_NAMES in order")
        shared = int(cfg.get("SHARED_CONV_NUM_FILTER", 0) or 0)
        self.shared_conv = nn.Conv2d(c, shared, 3, padding=1) if shared else None
        self.a_per_class = self.num_anchors_per_location // self.num_class
        for gi, names in enumerate(self.group_classes):
            self.add_module(f"conv_cls_g{gi}",
                            nn.Conv2d(shared or c, self.a_per_class * len(names), 1))

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"].permute(0, 3, 1, 2)
        if self.shared_conv is not None:
            x = torch.relu(self.shared_conv(x))
        B, _, H, W = x.shape
        a, col, per_loc = self.a_per_class, 0, []
        for gi, names in enumerate(self.group_classes):
            n_g = len(names)
            g = self._nhwc(getattr(self, f"conv_cls_g{gi}"), x).reshape(B, H * W, n_g * a)
            full = g.new_zeros(B, H * W, n_g * a, self.num_class)
            cols = col + torch.arange(n_g, device=g.device).repeat_interleave(a)
            full[:, :, torch.arange(n_g * a, device=g.device), cols] = g
            per_loc.append(full)
            col += n_g
        batch_dict["cls_preds"] = torch.cat(per_loc, 2).reshape(B, -1, self.num_class)
        return batch_dict

    def loss(self, batch_dict):
        return cls_only_loss(self, batch_dict)
