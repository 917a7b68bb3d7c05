"""The RoI heads' shared machinery (counterpart of
tsm_det_pointcloud_tpu/models/roi_heads/roi_head_template.py): proposals,
target assignment, the canonical box encoding and the RCNN losses.

As in the JAX package:
  * `proposal_layer` fills a fixed number of RoI slots a scan (zeros past the
    kept count) by per-scan rotated NMS over each anchor's best class score;
  * `assign_targets` samples ROI_PER_IMAGE RoIs a scan by a deterministic
    priority top-k (foreground by IoU, then hard background, then easy
    background), where the reference draws them at random; `sampled` is
    all-or-nothing per scan: when fewer than ROI_PER_IMAGE RoIs have a
    positive priority, no RoI of the scan is sampled;
  * nothing stops the gradient at the RoIs: the RCNN losses reach the dense
    head's box regression through the gathered RoIs, the regression targets,
    the IoU-guided class labels and the corner loss (the reference's proposal
    layer runs under no_grad). Only the NMS itself, which picks indices, runs
    on detached boxes.
The RCNN losses are normalised by the global batch's counts in a
multi-process run (`parallel.comm`), as the JAX data mesh's jit sees one
batch. `RoIHeadTemplate` runs the flow both heads share around their own
`rcnn` (pooling and FC layers); `fc_stack` / `run_fc_stack` build and run
their Dense + BN + ReLU stacks under flax's names.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import iou3d, loss_utils
from ...ops.boxes import boxes_to_corners_3d
from ...parallel import comm
from ...utils.common_utils import limit_period
from ..backbones_3d.pointnet2_modules import BatchNorm


def proposal_layer(batch_cls_preds, batch_box_preds, nms_cfg, score_normalized=False):
    """(B, N, C) cls + (B, N, 7+) boxes -> rois (B, R, 7), roi_scores (B, R),
    roi_labels (B, R) int32 1-based, roi_valid (B, R) bool; R the kept slots
    (NMS_POST_MAXSIZE, or fewer when the scan has fewer boxes)."""
    post = int(nms_cfg["NMS_POST_MAXSIZE"])
    pre = int(nms_cfg["NMS_PRE_MAXSIZE"])
    thresh = float(nms_cfg["NMS_THRESH"])
    scores = batch_cls_preds if score_normalized else torch.sigmoid(batch_cls_preds)
    max_scores = scores.amax(-1)
    labels = torch.argmax(scores, dim=-1).to(torch.int32) + 1
    out = {"rois": [], "roi_scores": [], "roi_labels": [], "roi_valid": []}
    for sc, bx, lb in zip(max_scores, batch_box_preds, labels):
        keep_idx, cnt, kept = iou3d.nms_bev(bx[:, :7].detach(), sc.detach(), thresh,
                                            pre_maxsize=pre, post_maxsize=post)
        slot_ok = torch.arange(keep_idx.shape[0], device=bx.device) < cnt
        rois = bx[keep_idx][:, :7]
        out["rois"].append(torch.where(slot_ok[:, None], rois, torch.zeros_like(rois)))
        out["roi_scores"].append(torch.where(slot_ok, kept, torch.zeros_like(kept)))
        out["roi_labels"].append(torch.where(slot_ok, lb[keep_idx], torch.zeros_like(lb[keep_idx])))
        out["roi_valid"].append(slot_ok)
    return tuple(torch.stack(out[k]) for k in ("rois", "roi_scores", "roi_labels", "roi_valid"))


def assign_targets(rois, roi_labels, roi_valid, gt_boxes, gt_valid, target_cfg):
    """Match each RoI to the gt box of its class with the largest 3D IoU and
    sample ROI_PER_IMAGE RoIs a scan. Returns a dict of (B, R) tensors:
    gt_of_roi (B, R, 7), gt_cls, max_iou, fg (IoU >= REG_FG_THRESH),
    sampled, cls_label (IoU-guided, in [0, 1]) and cls_interval (the IoUs
    strictly between CLS_BG_THRESH and CLS_FG_THRESH, which the cls loss
    ignores). max_iou and cls_label keep their gradient to the RoIs."""
    R = rois.shape[1]
    roi_per_image = int(target_cfg.get("ROI_PER_IMAGE", R))
    fg_ratio = float(target_cfg.get("FG_RATIO", 0.5))
    fg_thresh = float(target_cfg.get("REG_FG_THRESH", 0.55))
    cls_fg = float(target_cfg.get("CLS_FG_THRESH", 0.75))
    cls_bg = float(target_cfg.get("CLS_BG_THRESH", 0.25))
    hard_bg_lo = float(target_cfg.get("CLS_BG_THRESH_LO", 0.1))
    keys = ("gt_of_roi", "gt_cls", "max_iou", "fg", "sampled", "cls_label", "cls_interval")
    out = {k: [] for k in keys}
    for r, rl, rv, g, gv in zip(rois, roi_labels, roi_valid, gt_boxes, gt_valid):
        iou = iou3d.boxes_iou3d(r, g[:, :7])                       # (R, M)
        zero = torch.zeros((), dtype=iou.dtype, device=iou.device)
        iou = torch.where(gv[None, :] & rv[:, None], iou, zero)
        same = rl[:, None] == g[None, :, 7].to(torch.int32)
        iou_cls = torch.where(same, iou, zero)
        # amax: at ties the gradient splits evenly, as jnp.max's does
        max_iou = iou_cls.amax(-1)
        gt_idx = torch.argmax(iou_cls, dim=-1)                     # the first maximum
        gt_of_roi = g[gt_idx][:, :7]
        gt_cls = g[gt_idx][:, 7].to(torch.int32)
        with torch.no_grad():
            fg = (max_iou >= fg_thresh) & rv
            hard_bg = (max_iou < cls_bg) & (max_iou >= hard_bg_lo) & rv
            easy_bg = (max_iou < hard_bg_lo) & rv
            n_fg = torch.clamp(fg.sum(), max=int(roi_per_image * fg_ratio))
            prio = torch.where(fg, 3.0 + max_iou, zero)
            prio = torch.where(hard_bg, 2.0 + max_iou, prio)
            prio = torch.where(easy_bg, 1.0 + max_iou, prio)
            fg_rank = torch.cumsum(fg.to(torch.int64), 0) - 1
            prio = torch.where(fg & (fg_rank >= n_fg), torch.full_like(prio, 0.5), prio)
            top, sel = iou3d.stable_top_k(prio, roi_per_image)
            sampled = torch.zeros((R,), dtype=torch.bool, device=rois.device)
            sampled[sel] = True
            sampled = sampled & (top.min() > 0)
        cls_label = torch.clamp((max_iou - cls_bg) / (cls_fg - cls_bg), 0.0, 1.0)
        cls_label = torch.where(max_iou >= cls_fg, torch.ones_like(cls_label), cls_label)
        cls_label = torch.where(max_iou <= cls_bg, torch.zeros_like(cls_label), cls_label)
        interval = (max_iou > cls_bg) & (max_iou < cls_fg)
        for k, v in zip(keys, (gt_of_roi, gt_cls, max_iou, fg, sampled, cls_label, interval)):
            out[k].append(v)
    return {k: torch.stack(v) for k, v in out.items()}


def canonical_reg_targets(rois, gt_of_roi):
    """The gt boxes' residuals in each RoI's canonical frame (centre at the
    origin, heading along x): the encoding with the RoI as the anchor."""
    heading = rois[..., 6]
    lx = gt_of_roi[..., 0] - rois[..., 0]
    ly = gt_of_roi[..., 1] - rois[..., 1]
    lz = gt_of_roi[..., 2] - rois[..., 2]
    cosa, sina = torch.cos(-heading), torch.sin(-heading)
    cx = lx * cosa - ly * sina
    cy = lx * sina + ly * cosa
    diag = torch.sqrt(rois[..., 3] ** 2 + rois[..., 4] ** 2)
    xt = cx / torch.clamp(diag, min=1e-5)
    yt = cy / torch.clamp(diag, min=1e-5)
    zt = lz / torch.clamp(rois[..., 5], min=1e-5)
    dims = [torch.log(torch.clamp(gt_of_roi[..., i], min=1e-5)
                      / torch.clamp(rois[..., i], min=1e-5)) for i in (3, 4, 5)]
    rt = limit_period(gt_of_roi[..., 6] - heading, offset=0.5, period=2 * np.pi)
    return torch.stack([xt, yt, zt, *dims, rt], -1)


def decode_roi_boxes(rois, rcnn_reg):
    """The inverse of canonical_reg_targets: the RoIs refined by the
    predicted residuals."""
    diag = torch.sqrt(rois[..., 3] ** 2 + rois[..., 4] ** 2)
    cx = rcnn_reg[..., 0] * diag
    cy = rcnn_reg[..., 1] * diag
    cz = rcnn_reg[..., 2] * rois[..., 5]
    heading = rois[..., 6]
    cosa, sina = torch.cos(heading), torch.sin(heading)
    x = cx * cosa - cy * sina + rois[..., 0]
    y = cx * sina + cy * cosa + rois[..., 1]
    z = cz + rois[..., 2]
    dims = [torch.exp(rcnn_reg[..., i]) * rois[..., i] for i in (3, 4, 5)]
    return torch.stack([x, y, z, *dims, rcnn_reg[..., 6] + heading], -1)


def _global_mean(values, weights):
    """sum(values * weights) / max(sum(weights), 1) over the global batch."""
    return (comm.scale_to_global((values * weights).sum())
            / torch.clamp(comm.global_sum(weights.sum()), min=1.0))


def roi_losses(rcnn_cls, rcnn_reg, targets, rois, loss_cfg):
    """rcnn_cls (B, R) logits, rcnn_reg (B, R, 7) -> (loss, tb_dict): BCE
    over the sampled RoIs outside the IoU interval, smooth-L1 of the
    canonical residuals and, with CORNER_LOSS_REGULARIZATION, the corner
    loss (the nearer of the gt's corners and its flipped corners, Huber
    delta 1) over the sampled foreground."""
    w = loss_cfg["LOSS_WEIGHTS"]
    sampled = targets["sampled"]
    cls_w = (sampled & ~targets["cls_interval"]).to(rcnn_cls.dtype)
    cls_loss = _global_mean(loss_utils.bce_with_logits(rcnn_cls, targets["cls_label"]), cls_w)
    reg_t = canonical_reg_targets(rois, targets["gt_of_roi"])
    fg = (targets["fg"] & sampled).to(rcnn_reg.dtype)
    reg = loss_utils.weighted_smooth_l1(rcnn_reg, reg_t,
                                        code_weights=w.get("code_weights", [1.0] * 7))
    reg_loss = _global_mean(reg.sum(-1), fg)
    total = cls_loss * w.get("rcnn_cls_weight", 1.0) + reg_loss * w.get("rcnn_reg_weight", 1.0)
    tb = {"rcnn_cls_loss": cls_loss, "rcnn_reg_loss": reg_loss}
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        gt = targets["gt_of_roi"]
        pc = boxes_to_corners_3d(decode_roi_boxes(rois, rcnn_reg))
        gc = boxes_to_corners_3d(gt)
        flip = torch.cat([gt[..., :6], gt[..., 6:7] + np.pi], -1)
        gcf = boxes_to_corners_3d(flip)
        # eps-normed (a plain norm's gradient is NaN at 0) and overflow-safe
        d = torch.minimum(torch.sqrt(((pc - gc) ** 2).sum(-1) + 1e-12),
                          torch.sqrt(((pc - gcf) ** 2).sum(-1) + 1e-12))
        c = torch.clamp(d, max=1.0)
        corner = (0.5 * c * c + (d - c)).mean(-1)
        corner_loss = _global_mean(corner, fg)
        total = total + corner_loss * w.get("rcnn_corner_weight", 1.0)
        tb["rcnn_corner_loss"] = corner_loss
    return total, tb


def fc_stack(module, prefix, in_channels, channels):
    """`{prefix}_fc{k}` (Dense without bias) and `{prefix}_bn{k}` on `module`
    for each width of `channels`, as the flax heads name them; returns the
    stack's output width."""
    c = in_channels
    for k, w in enumerate(channels):
        setattr(module, f"{prefix}_fc{k}", nn.Linear(c, w, bias=False))
        setattr(module, f"{prefix}_bn{k}", BatchNorm(w, eps=1e-3))
        c = w
    return c


def run_fc_stack(module, prefix, n, h, mask):
    """The first n layers of a `fc_stack`: Dense, BN masked by `mask`, ReLU."""
    for k in range(n):
        h = getattr(module, f"{prefix}_fc{k}")(h)
        h = torch.relu(getattr(module, f"{prefix}_bn{k}")(h, mask))
    return h


class RoIHeadTemplate(nn.Module):
    """The flow both RoI heads share: proposals (NMS_CONFIG of the mode),
    in training their targets, the subclass's `rcnn(batch_dict, rois,
    roi_valid)` -> (rcnn_cls (B, R), rcnn_reg (B, R, 7)), in training the
    RCNN losses (`loss_rcnn`, `tb_dict_rcnn`, and `roi_targets`), then the
    refined boxes as batch_box_preds / batch_cls_preds with `roi_labels`,
    `rois` and `roi_valid`."""

    def forward(self, batch_dict):
        cfg = self.model_cfg
        nms_cfg = cfg["NMS_CONFIG"]["TRAIN" if self.training else "TEST"]
        rois, _, roi_labels, roi_valid = proposal_layer(
            batch_dict["batch_cls_preds"], batch_dict["batch_box_preds"], nms_cfg,
            score_normalized=bool(batch_dict.get("cls_preds_normalized", False)))
        if self.training:
            targets = assign_targets(rois, roi_labels, roi_valid, batch_dict["gt_boxes"],
                                     batch_dict["gt_boxes_mask"], cfg["TARGET_CONFIG"])
        rcnn_cls, rcnn_reg = self.rcnn(batch_dict, rois, roi_valid)
        if self.training:
            batch_dict["loss_rcnn"], batch_dict["tb_dict_rcnn"] = roi_losses(
                rcnn_cls, rcnn_reg, targets, rois, cfg["LOSS_CONFIG"])
            batch_dict["roi_targets"] = targets
        batch_dict["batch_box_preds"] = decode_roi_boxes(rois, rcnn_reg)
        batch_dict["batch_cls_preds"] = rcnn_cls[..., None]
        batch_dict["cls_preds_normalized"] = False
        batch_dict["roi_labels"] = roi_labels
        batch_dict["rois"] = rois
        batch_dict["roi_valid"] = roi_valid
        batch_dict["has_class_labels"] = True
        return batch_dict
