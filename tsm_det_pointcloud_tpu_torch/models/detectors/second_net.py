"""SECOND detector (counterpart of
tsm_det_pointcloud_tpu/models/detectors/second_net.py)."""
from __future__ import annotations

from .detector3d_template import Detector3DTemplate


class SECONDNet(Detector3DTemplate):
    """MeanVFE -> VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone ->
    AnchorHeadSingle. At eval the head's decoded boxes feed the template's
    class-agnostic post-processing; in training (`.train()`, a batch with
    gt_boxes and gt_boxes_mask) the forward adds the head's `loss` and its
    `tb_dict` to the batch dict, as the JAX PointPillar / SECONDNet do."""

    def forward(self, batch_dict):
        batch_dict = self.forward_modules(batch_dict)
        if self.training:
            batch_dict["loss"], batch_dict["tb_dict"] = self.module_list[-1].loss(batch_dict)
        return batch_dict
