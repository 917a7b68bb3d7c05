"""CenterPoint's dense head (counterpart of
tsm_det_pointcloud_tpu/models/dense_heads/center_head.py).

A shared 3x3 conv (with bias) + BN + ReLU over the NHWC BEV map, then per
class group (CLASS_NAMES_EACH_HEAD) a `SeparateHead` of 3x3 branches: `hm`
(a channel per class of the group) and the HEAD_DICT entries (center,
center_z, dim, rot and, in the nuScenes configs, vel).
The convs run in NCHW on the channels-last view of the map, as
`BaseBEVBackbone`'s do. Module names follow the flax ones
(`shared_conv`, `shared_bn`, `head_{g}` with `{name}_conv{i}`,
`{name}_bn{i}`, `{name}_out`).

Training: per group, the gaussian heatmap targets of its classes
(`centernet_utils.assign_center_targets`), the focal loss on
clip(sigmoid(hm), 1e-4, 1 - 1e-4), and the L1 of the HEAD_ORDER maps
gathered at each gt's cell against its box targets, normalised by the
batch's count of gts on the map (with a vel head the targets are 10 wide,
the gt's vx, vy last, and every column weighs 1: code_weights is read
nowhere, as in the JAX head); the group's loss is cls_weight * hm +
loc_weight * reg, the head's their sum. Both normalisers are the global
batch's in a multi-process run (`parallel.comm`). Eval: each group's
heatmap decoded over C x H x W (MAX_OBJ_PER_SAMPLE boxes a scan; 7
columns, 9 with the velocity read off the vel map), its
group-local labels mapped to the global 1-based class ids, the groups
concatenated (final_boxes, final_scores, final_labels). As in the JAX head,
POST_CENTER_LIMIT_RANGE, NUM_MAX_OBJS, code_weights and USE_BIAS_BEFORE_NORM
are read nowhere.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import loss_utils
from ...parallel import comm
from ..backbones_2d.base_bev_backbone import _BatchNorm2d
from ..model_utils import centernet_utils

# the hm_out bias at init (the flax SeparateHead's init_bias)
HM_INIT_BIAS = -2.19


class SeparateHead(nn.Module):
    """Per target, num_conv - 1 3x3 convs (bias, BN, ReLU) at the input's
    width, then a 3x3 output conv; `forward` gives {name: (B, c, H, W)}."""

    def __init__(self, head_dict, channels):
        super().__init__()
        self.head_dict = head_dict
        for name, spec in head_dict.items():
            for i in range(int(spec["num_conv"]) - 1):
                self.add_module(f"{name}_conv{i}", nn.Conv2d(channels, channels, 3, padding=1))
                self.add_module(f"{name}_bn{i}", _BatchNorm2d(channels))
            self.add_module(f"{name}_out", nn.Conv2d(channels, int(spec["out_channels"]), 3,
                                                     padding=1))

    def forward(self, x):
        out = {}
        for name, spec in self.head_dict.items():
            h = x
            for i in range(int(spec["num_conv"]) - 1):
                h = torch.relu(getattr(self, f"{name}_bn{i}")(getattr(self, f"{name}_conv{i}")(h)))
            out[name] = getattr(self, f"{name}_out")(h)
        return out


class CenterHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names, grid_size,
                 point_cloud_range, voxel_size):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.class_names = tuple(class_names)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.groups = [list(g) for g in (cfg.get("CLASS_NAMES_EACH_HEAD")
                                         or [list(class_names)])]
        tgt_cfg = cfg.get("TARGET_ASSIGNER_CONFIG", {})
        self.stride = int(tgt_cfg.get("FEATURE_MAP_STRIDE", 8))
        self.gaussian_overlap = float(tgt_cfg.get("GAUSSIAN_OVERLAP", 0.1))
        self.min_radius = int(tgt_cfg.get("MIN_RADIUS", 2))
        self.max_obj = int(cfg.get("POST_PROCESSING", {}).get("MAX_OBJ_PER_SAMPLE", 500))
        head_dict = dict(cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"])
        self.code_size = 8 + (2 if "vel" in head_dict else 0)
        self.head_order = list(cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"])
        c = int(cfg.get("SHARED_CONV_CHANNEL", 64))
        self.shared_conv = nn.Conv2d(int(input_channels), c, 3, padding=1)
        self.shared_bn = _BatchNorm2d(c)
        name_to_id = {n: i + 1 for i, n in enumerate(self.class_names)}
        self.group_ids = [[name_to_id[n] for n in group] for group in self.groups]
        for gi, group in enumerate(self.groups):
            hd = {"hm": {"out_channels": len(group), "num_conv": int(cfg.get("NUM_HM_CONV", 2))}}
            hd.update(head_dict)
            self.add_module(f"head_{gi}", SeparateHead(hd, c))
            self.register_buffer(f"label_lut_{gi}", torch.tensor(
                self.group_ids[gi], dtype=torch.int64), persistent=False)

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"].permute(0, 3, 1, 2)   # NHWC -> NCHW
        shared = torch.relu(self.shared_bn(self.shared_conv(x)))
        boxes, scores, labels = [], [], []
        total, tb = 0.0, {}
        for gi in range(len(self.groups)):
            pm = getattr(self, f"head_{gi}")(shared)
            if self.training:
                hm_loss, reg_loss = self._group_loss(gi, pm, batch_dict)
                w = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
                total = (total + hm_loss * w.get("cls_weight", 1.0)
                         + reg_loss * w.get("loc_weight", 2.0))
                tb[f"hm_loss_{gi}"] = hm_loss
                tb[f"reg_loss_{gi}"] = reg_loss
                continue
            b, s, lab = centernet_utils.decode_bbox_from_heatmap(
                torch.sigmoid(pm["hm"]), pm["rot"][:, 1:2], pm["rot"][:, 0:1], pm["center"],
                pm["center_z"], pm["dim"], self.point_cloud_range, self.voxel_size,
                self.stride, vel=pm.get("vel"), K=self.max_obj)
            boxes.append(b)
            scores.append(s)
            labels.append(getattr(self, f"label_lut_{gi}")[lab])
        if self.training:
            batch_dict["loss_center"] = total
            batch_dict["tb_dict_center"] = tb
        else:
            batch_dict["final_boxes"] = torch.cat(boxes, 1)
            batch_dict["final_scores"] = torch.cat(scores, 1)
            batch_dict["final_labels"] = torch.cat(labels, 1)
        return batch_dict

    def _group_loss(self, gi, pm, batch_dict):
        """(focal heatmap loss, gathered L1 regression loss) of group gi."""
        gt, gv = batch_dict["gt_boxes"], batch_dict["gt_boxes_mask"]
        B, _, H, W = pm["hm"].shape
        cls_ids = gt[..., -1].to(torch.int64)
        local = torch.zeros_like(cls_ids)
        for li, gid in enumerate(self.group_ids[gi]):
            local = torch.where(cls_ids == gid, torch.full_like(local, li + 1), local)
        tgts = centernet_utils.assign_center_targets(
            gt, gv & (local > 0), local, len(self.groups[gi]), self.point_cloud_range,
            self.voxel_size, self.stride, (H, W), gaussian_overlap=self.gaussian_overlap,
            min_radius=self.min_radius, code_size=self.code_size)
        hm_loss = loss_utils.centernet_focal(
            torch.clamp(torch.sigmoid(pm["hm"]), 1e-4, 1 - 1e-4), tgts["heatmap"])
        reg_map = torch.cat([pm[k] for k in self.head_order], 1)    # (B, code, H, W)
        code = reg_map.shape[1]
        reg_at = torch.gather(reg_map.reshape(B, code, H * W), 2,
                              tgts["inds"][:, None, :].expand(-1, code, -1)).transpose(1, 2)
        mask = tgts["mask"].to(reg_map.dtype)
        reg_loss = (comm.scale_to_global(
            ((reg_at - tgts["box_targets"]).abs() * mask[..., None]).sum())
            / torch.clamp(comm.global_sum(mask.sum()), min=1.0))
        return hm_loss, reg_loss
