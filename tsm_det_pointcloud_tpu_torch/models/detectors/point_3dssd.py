"""3DSSD / TSM detector (counterpart of
tsm_det_pointcloud_tpu/models/detectors/point_3dssd.py)."""
from __future__ import annotations

from .detector3d_template import Detector3DTemplate


class Point3DSSD(Detector3DTemplate):
    """backbone_3d -> point_head. Eval: the head's outputs feed
    post_processing. Train: the point head computes the vote / cls / box /
    SASA losses inline and sets batch_dict["loss"] and ["tb_dict"]."""
