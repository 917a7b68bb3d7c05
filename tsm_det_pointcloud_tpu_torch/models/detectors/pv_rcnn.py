"""PV-RCNN and PV-RCNN++ (counterpart of
tsm_det_pointcloud_tpu/models/detectors/pv_rcnn.py)."""
from __future__ import annotations

from .two_stage import TwoStageBase


class PVRCNN(TwoStageBase):
    """MeanVFE -> VoxelBackBone8x -> HeightCompression ->
    VoxelSetAbstraction -> BaseBEVBackbone -> AnchorHeadSingle (RPN) ->
    PointHeadSimple -> PVRCNNHead (module_list 0-7, the flax indices: the
    PFE comes before the BEV backbone, as in the JAX topology). Its training
    loss is the RPN's, the keypoint segmentation's and the RCNN's, as
    TwoStageBase sums them."""


class PVRCNNPlusPlus(PVRCNN):
    """PV-RCNN++: PV-RCNN's flow unchanged; its PFE config selects the
    sector keypoint sampling (SAMPLE_METHOD SPC) and VectorPool sources (a
    source NAME VectorPoolAggregationModuleMSG)."""
