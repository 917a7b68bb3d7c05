"""Box coding for the heads.

Counterpart of tsm_det_pointcloud_tpu/ops/box_coder_utils.py:
  * `ResidualCoder` (:31-90), the anchor head's: xyz residuals over the
    anchor's BEV diagonal / height, log size ratios, the heading residual
    (encode for the training targets, decode for the boxes); with
    `encode_angle_by_sincos` the heading is two columns, (cos - cos,
    sin - sin), decoded by atan2 (code size + 1, extra columns after
    column 8);
  * `PointResidualCoder` (:93), PointRCNN's point head's: with
    `use_mean_size` (pointrcnn.yaml's) xyz offsets over the class's mean
    size (BEV diagonal, height) and log size ratios, without it plain xyz
    offsets and log sizes; the heading as its cosine and sine (code size 8);
  * `PointBinResidualCoder` (:144): xyz offsets + log sizes + a binned
    angle (bin one-hot / logits + residuals normalised to [-0.5, 0.5)
    within the bin); decode is (bin + residual) * delta; with
    `use_mean_size` the xyz offsets and sizes are relative to the class's
    mean size, as PointResidualCoder's;
  * `PreviousResidualDecoder` (:224) and `PreviousResidualRoIDecoder`
    (:250): the reference's legacy decoders, whose size residuals come in
    (w, l, h) order; the RoI one wraps the heading to [-pi, pi).
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
        self.code_size = code_size + int(bool(encode_angle_by_sincos))
        self.encode_angle_by_sincos = bool(encode_angle_by_sincos)

    def encode(self, boxes, anchors):
        """boxes, anchors (..., 7 + E) -> box_encodings (..., 7 + E), or
        (..., 8 + E) with sin / cos; sizes clipped at 1e-5 on both sides
        first, as the JAX package does."""
        anchors = torch.cat([anchors[..., :3], torch.clamp(anchors[..., 3:6], min=1e-5),
                             anchors[..., 6:]], -1)
        boxes = torch.cat([boxes[..., :3], torch.clamp(boxes[..., 3:6], min=1e-5),
                           boxes[..., 6:]], -1)
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        xg, yg, zg, dxg, dyg, dzg, rg = torch.split(boxes[..., :7], 1, dim=-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xt = (xg - xa) / diagonal
        yt = (yg - ya) / diagonal
        zt = (zg - za) / dza
        dxt = torch.log(dxg / dxa)
        dyt = torch.log(dyg / dya)
        dzt = torch.log(dzg / dza)
        extra = boxes[..., 7:] - anchors[..., 7:]
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        return torch.cat([xt, yt, zt, dxt, dyt, dzt, *rts, extra], dim=-1)

    def decode(self, box_encodings, anchors):
        """box_encodings (..., code_size + E), anchors (..., 7 + E) -> boxes
        (..., 7 + E)."""
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        nr = 2 if self.encode_angle_by_sincos else 1
        xt, yt, zt, dxt, dyt, dzt = torch.split(box_encodings[..., :6], 1, dim=-1)
        rts = torch.split(box_encodings[..., 6:6 + nr], 1, dim=-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * dza + za
        dxg = _safe_exp(dxt) * dxa
        dyg = _safe_exp(dyt) * dya
        dzg = _safe_exp(dzt) * dza
        if self.encode_angle_by_sincos:
            rg = torch.atan2(rts[1] + torch.sin(ra), rts[0] + torch.cos(ra))
        else:
            rg = rts[0] + ra
        extra = box_encodings[..., 6 + nr:] + anchors[..., 7:]
        return torch.cat([xg, yg, zg, dxg, dyg, dzg, rg, extra], dim=-1)


class PointResidualCoder:
    def __init__(self, code_size=8, use_mean_size=True, **kwargs):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        if use_mean_size:
            self.mean_size = torch.tensor(kwargs["mean_size"], dtype=torch.float32)

    def _mean_size(self, classes, like):
        """(..., 3) mean sizes of the 1-based classes (class 0 reads the
        last row, as the JAX coder's index -1 does). Without classes it
        raises TypeError, as the JAX coder's `None - 1` does."""
        if classes is None:
            raise TypeError("use_mean_size codes by class: the classes are None")
        return self.mean_size.to(like.device)[classes.long() - 1]

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt_boxes (..., 7+), points (..., 3+), gt_classes (...,) 1-based ->
        (..., 8 + extra); sizes clipped at 1e-5 first."""
        sizes = torch.clamp(gt_boxes[..., 3:6], min=1e-5)
        xg, yg, zg = torch.split(gt_boxes[..., 0:3], 1, dim=-1)
        dxg, dyg, dzg = torch.split(sizes, 1, dim=-1)
        rg = gt_boxes[..., 6:7]
        xa, ya, za = torch.split(points[..., 0:3], 1, dim=-1)
        if self.use_mean_size:
            dxa, dya, dza = torch.split(self._mean_size(gt_classes, gt_boxes), 1, dim=-1)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            xt = (xg - xa) / diagonal
            yt = (yg - ya) / diagonal
            zt = (zg - za) / dza
            dxt = torch.log(dxg / dxa)
            dyt = torch.log(dyg / dya)
            dzt = torch.log(dzg / dza)
        else:
            xt, yt, zt = xg - xa, yg - ya, zg - za
            dxt, dyt, dzt = torch.log(dxg), torch.log(dyg), torch.log(dzg)
        return torch.cat([xt, yt, zt, dxt, dyt, dzt, torch.cos(rg), torch.sin(rg),
                          gt_boxes[..., 7:]], dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        """box_encodings (..., 8+), points (..., 3+), pred_classes (...,)
        1-based -> boxes (..., 7 + extra); log sizes clamped before exp."""
        xt, yt, zt, dxt, dyt, dzt, cost, sint = torch.split(box_encodings[..., :8], 1, dim=-1)
        xa, ya, za = torch.split(points[..., 0:3], 1, dim=-1)
        if self.use_mean_size:
            dxa, dya, dza = torch.split(self._mean_size(pred_classes, box_encodings), 1, dim=-1)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            xg = xt * diagonal + xa
            yg = yt * diagonal + ya
            zg = zt * dza + za
            dxg = _safe_exp(dxt) * dxa
            dyg = _safe_exp(dyt) * dya
            dzg = _safe_exp(dzt) * dza
        else:
            xg, yg, zg = xt + xa, yt + ya, zt + za
            dxg, dyg, dzg = _safe_exp(dxt), _safe_exp(dyt), _safe_exp(dzt)
        rg = torch.atan2(sint, cost)
        return torch.cat([xg, yg, zg, dxg, dyg, dzg, rg, box_encodings[..., 8:]], dim=-1)


class PointBinResidualCoder:
    def __init__(self, code_size=30, use_mean_size=False, angle_bin_num=12,
                 **kwargs):
        self.angle_bin_num = angle_bin_num
        self.use_mean_size = use_mean_size
        if use_mean_size:
            self.mean_size = torch.tensor(kwargs["mean_size"], dtype=torch.float32)
        self.code_size = 6 + 2 * self.angle_bin_num

    _mean_size = PointResidualCoder._mean_size

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
        """gt_boxes (..., 7+), points (..., 3+), gt_classes (...,) 1-based
        (read with use_mean_size) -> (..., code_size)."""
        sizes = torch.clamp(gt_boxes[..., 3:6], min=1e-5)
        xyz = gt_boxes[..., 0:3] - points[..., 0:3]
        if self.use_mean_size:
            anchor = self._mean_size(gt_classes, gt_boxes)
            diagonal = torch.sqrt(anchor[..., 0:1] ** 2 + anchor[..., 1:2] ** 2)
            xyz = torch.cat([xyz[..., 0:2] / diagonal, xyz[..., 2:3] / anchor[..., 2:3]], -1)
            log_size = torch.log(sizes / anchor)
        else:
            log_size = torch.log(sizes)
        bin_oh, res_oh = self.encode_angle(gt_boxes[..., 6])
        return torch.cat([xyz, log_size, bin_oh, res_oh], -1)

    def decode_angle(self, angle_cls, angle_res):
        bin_id = torch.argmax(angle_cls, dim=-1, keepdim=True)
        res = torch.gather(angle_res, -1, bin_id)
        delta = 2 * np.pi / self.angle_bin_num
        return (bin_id.to(angle_res.dtype) + res) * delta

    def decode(self, box_encodings, points, pred_classes=None):
        e = box_encodings
        p = points[..., :3]
        if self.use_mean_size:
            anchor = self._mean_size(pred_classes, e)
            diagonal = torch.sqrt(anchor[..., 0:1] ** 2 + anchor[..., 1:2] ** 2)
            xyz = torch.cat([e[..., 0:2] * diagonal, e[..., 2:3] * anchor[..., 2:3]], -1) + p
            size = _safe_exp(e[..., 3:6]) * anchor
        else:
            xyz = e[..., 0:3] + p
            size = _safe_exp(e[..., 3:6])
        nb = self.angle_bin_num
        rg = self.decode_angle(e[..., 6:6 + nb], e[..., 6 + nb:6 + 2 * nb])
        return torch.cat([xyz, size, rg], dim=-1)


class PreviousResidualDecoder:
    """The legacy anchor decoder: size residuals in (w, l, h) order, so the
    box's dx takes the exp of the code's 5th channel and dy of its 4th."""

    def __init__(self, code_size=7, **kwargs):
        self.code_size = code_size

    @staticmethod
    def decode(box_encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = torch.split(anchors[..., :7], 1, dim=-1)
        xt, yt, zt, wt, lt, ht, rt = torch.split(box_encodings[..., :7], 1, dim=-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        extra_t = box_encodings[..., 7:]
        extra_a = anchors[..., 7:7 + extra_t.shape[-1]]
        return torch.cat([xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                          _safe_exp(lt) * dxa, _safe_exp(wt) * dya, _safe_exp(ht) * dza,
                          rt + ra, extra_t + extra_a], dim=-1)


class PreviousResidualRoIDecoder(PreviousResidualDecoder):
    """PreviousResidualDecoder with the heading wrapped to [-pi, pi)."""

    @staticmethod
    def decode(box_encodings, anchors):
        out = PreviousResidualDecoder.decode(box_encodings, anchors)
        rg = torch.remainder(out[..., 6:7] + np.pi, 2 * np.pi) - np.pi
        return torch.cat([out[..., :6], rg, out[..., 7:]], dim=-1)
