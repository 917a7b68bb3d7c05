"""Detector registry: the ported detectors by config NAME."""
from __future__ import annotations

from .caddn import CaDDN
from .centerpoint import CenterPoint
from .detector3d_template import DatasetMeta, Detector3DTemplate
from .point_3dssd import Point3DSSD
from .pointpillar import PointPillar
from .pv_rcnn import PVRCNN, PVRCNNPlusPlus
from .second_net import SECONDNet
from .two_stage import PVSSDA, DSASNet, PartA2Net, PointRCNN, SECONDNetIoU, VoxelRCNN

__all__ = {
    "3DSSD": Point3DSSD,
    "Point3DSSD": Point3DSSD,
    "SECONDNet": SECONDNet,
    "PointPillar": PointPillar,
    "CenterPoint": CenterPoint,
    "PartA2Net": PartA2Net,
    "PVRCNN": PVRCNN,
    "PVRCNNPlusPlus": PVRCNNPlusPlus,
    "PointRCNN": PointRCNN,
    "VoxelRCNN": VoxelRCNN,
    "SECONDNetIoU": SECONDNetIoU,
    "CaDDN": CaDDN,
    "PVSSDA": PVSSDA,
    "DSASNet": DSASNet,
    "Detector3DTemplate": Detector3DTemplate,
}
