"""Box coding for the heads.

Counterpart of tsm_det_pointcloud_tpu/ops/box_coder_utils.py:
  * `ResidualCoder` (:31-90), the anchor head's: xyz residuals over the
    anchor's BEV diagonal / height, log size ratios, the heading residual;
    decode only (the eval path);
  * `PointBinResidualCoder` (:144): xyz offsets + log sizes + a binned
    angle (bin one-hot / logits + residuals normalised to [-0.5, 0.5)
    within the bin); decode is (bin + residual) * delta.
Decoded log sizes are clamped to [-4, 4] before exp, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

LOG_SIZE_CLAMP = 4.0


def _safe_exp(t):
    return torch.exp(torch.clamp(t, -LOG_SIZE_CLAMP, LOG_SIZE_CLAMP))


class ResidualCoder:
    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        if encode_angle_by_sincos:
            raise NotImplementedError("encode_angle_by_sincos is not on a ported path")
        self.code_size = code_size

    def decode(self, box_encodings, anchors):
        """box_encodings (..., 7 + E), anchors (..., 7 + E) -> boxes."""
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        xt, yt, zt, dxt, dyt, dzt, rt = torch.split(box_encodings[..., :7], 1, dim=-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * dza + za
        dxg = _safe_exp(dxt) * dxa
        dyg = _safe_exp(dyt) * dya
        dzg = _safe_exp(dzt) * dza
        rg = rt + ra
        extra = box_encodings[..., 7:] + anchors[..., 7:]
        return torch.cat([xg, yg, zg, dxg, dyg, dzg, rg, extra], dim=-1)


class PointBinResidualCoder:
    def __init__(self, code_size=30, use_mean_size=False, angle_bin_num=12,
                 **kwargs):
        if use_mean_size:
            raise NotImplementedError("use_mean_size is not on the ported path")
        self.angle_bin_num = angle_bin_num
        self.use_mean_size = use_mean_size
        self.code_size = 6 + 2 * self.angle_bin_num

    def encode_angle(self, angle):
        """(...,) angles -> bin one-hot (..., bins) and the residual on the
        hot bin (..., bins)."""
        angle = torch.remainder(angle, 2 * np.pi)
        delta = 2 * np.pi / self.angle_bin_num
        shifted = torch.remainder(angle + delta / 2, 2 * np.pi)
        bin_id = torch.floor(shifted / delta).to(torch.int64)
        res = shifted / delta - bin_id.to(angle.dtype) - 0.5
        one_hot = torch.nn.functional.one_hot(bin_id, self.angle_bin_num).to(angle.dtype)
        return one_hot, one_hot * res[..., None]

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt_boxes (..., 7+), points (..., 3+) -> (..., code_size)."""
        sizes = torch.clamp(gt_boxes[..., 3:6], min=1e-5)
        xyz = gt_boxes[..., 0:3] - points[..., 0:3]
        bin_oh, res_oh = self.encode_angle(gt_boxes[..., 6])
        return torch.cat([xyz, torch.log(sizes), bin_oh, res_oh], -1)

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
