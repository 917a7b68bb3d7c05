"""Box decoding for the point heads.

Counterpart of tsm_det_pointcloud_tpu/ops/box_coder_utils.py:144
(`PointBinResidualCoder.decode`): xyz offsets + log sizes + a binned angle
(bin logits + normalized residuals); decode is (bin + residual) * delta.
"""
from __future__ import annotations

import numpy as np
import torch

LOG_SIZE_CLAMP = 4.0


def _safe_exp(t):
    return torch.exp(torch.clamp(t, -LOG_SIZE_CLAMP, LOG_SIZE_CLAMP))


class PointBinResidualCoder:
    def __init__(self, code_size=30, use_mean_size=False, angle_bin_num=12,
                 **kwargs):
        if use_mean_size:
            raise NotImplementedError("use_mean_size is not on the ported path")
        self.angle_bin_num = angle_bin_num
        self.use_mean_size = use_mean_size
        self.code_size = 6 + 2 * self.angle_bin_num

    def decode_angle(self, angle_cls, angle_res):
        bin_id = torch.argmax(angle_cls, dim=-1, keepdim=True)
        res = torch.gather(angle_res, -1, bin_id)
        delta = 2 * np.pi / self.angle_bin_num
        return (bin_id.to(angle_res.dtype) + res) * delta

    def decode(self, box_encodings, points, pred_classes=None):
        e = box_encodings
        p = points[..., :3]
        xyz = e[..., 0:3] + p
        size = _safe_exp(e[..., 3:6])
        nb = self.angle_bin_num
        rg = self.decode_angle(e[..., 6:6 + nb], e[..., 6 + nb:6 + 2 * nb])
        return torch.cat([xyz, size, rg], dim=-1)
