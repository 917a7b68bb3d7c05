"""Anchor-based dense head, eval path (counterpart of
tsm_det_pointcloud_tpu/models/dense_heads/anchor_head.py:29-73, 152-238).

`AnchorHeadSingle` runs three 1x1 convs (cls, box, direction) over the NHWC
BEV features, permutes their outputs to NHWC before flattening, so that
prediction i pairs with anchor i of `generate_anchors`' layout, and decodes
the boxes with the direction correction. Target assignment and the losses
(the training path) are not ported.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import box_coder_utils
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


class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range):
        super().__init__()
        cfg = model_cfg
        self.num_class = int(num_class)
        anchor_cfgs = cfg["ANCHOR_GENERATOR_CONFIG"]
        stride = anchor_cfgs[0].get("feature_map_stride", 2)
        grid_xy = [(grid_size[0] // stride, grid_size[1] // stride) for _ in anchor_cfgs]
        anchors, self.num_anchors_per_location = generate_anchors(
            point_cloud_range, grid_xy, anchor_cfgs)
        self.register_buffer("anchors", torch.from_numpy(anchors), persistent=False)
        self.box_coder = getattr(box_coder_utils, cfg.get("BOX_CODER", "ResidualCoder"))(
            **cfg.get("BOX_CODER_CONFIG", {}))
        self.use_dir = cfg.get("USE_DIRECTION_CLASSIFIER", False)
        self.num_dir_bins = cfg.get("NUM_DIR_BINS", 2)
        self.dir_offset = cfg.get("DIR_OFFSET", 0.78539)
        self.dir_limit_offset = cfg.get("DIR_LIMIT_OFFSET", 0.0)
        A = self.num_anchors_per_location
        c = int(input_channels)
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
