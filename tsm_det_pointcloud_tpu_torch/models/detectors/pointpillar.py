"""PointPillars detector (counterpart of
tsm_det_pointcloud_tpu/models/detectors/pointpillar.py)."""
from __future__ import annotations

from .second_net import SECONDNet


class PointPillar(SECONDNet):
    """PillarVFE -> PointPillarScatter -> BaseBEVBackbone -> AnchorHeadSingle
    (module_list 0-3, the flax indices; the scatter has no parameters). At
    eval the head's decoded boxes feed the template's class-agnostic
    post-processing; in training the forward adds the head's `loss` and
    `tb_dict`, as SECONDNet's does."""
