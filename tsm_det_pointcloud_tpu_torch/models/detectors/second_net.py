"""SECOND detector (counterpart of
tsm_det_pointcloud_tpu/models/detectors/second_net.py and pointpillar.py)."""
from __future__ import annotations

from .detector3d_template import Detector3DTemplate


class SECONDNet(Detector3DTemplate):
    """MeanVFE -> VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone ->
    AnchorHeadSingle; the head's outputs feed the template's class-agnostic
    post-processing. Eval only: the target assignment, the losses and K7's
    backward are not ported, so a training forward raises."""

    def forward(self, batch_dict):
        if self.training:
            raise NotImplementedError("SECOND training (target assignment, losses, "
                                      "K7's backward) is not ported")
        return self.forward_modules(batch_dict)
