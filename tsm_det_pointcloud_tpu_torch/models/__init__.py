"""Model builder (counterpart of tsm_det_pointcloud_tpu/models/__init__.py).

`build_network(model_cfg, num_class, dataset, device="cuda", seed=0)` builds
one of the ported detectors with seeded random weights, in eval mode, on
`device`; `dataset` is a DatasetMeta or a dataset (`meta_from_dataset`, the
JAX models/__init__.py:14-29):
  * NAME 3DSSD with the VoxelPointNet2FSMSGDistillation backbone and the
    PointHeadVoteSASAStatisticDistillation head, teacher and student;
    `.train()` turns on the distillation training path;
  * NAME 3DSSD with the VoxelPointNet2FSMSG backbone and the
    PointHeadVoteSASAStatistic head: the TSM teacher
    (fast_cpc_teacher.yaml); `.train()` turns on its training path, which
    updates the head's class statistics;
  * NAME SECONDNet: MeanVFE, VoxelBackBone8x, HeightCompression,
    BaseBEVBackbone, AnchorHeadSingle; `.train()` turns on its training
    forward (target assignment and the head's losses);
  * NAME PointPillar: PillarVFE, PointPillarScatter, BaseBEVBackbone,
    AnchorHeadSingle; training as SECONDNet's;
  * on these two topologies the JAX registry's variants: the VFEs
    DynamicMeanVFE, MeanDensityVFE, SPVFE and VPCVFE (and MeanVFE on
    PointPillars' scatter, DynamicPillarVFE on its own), SECOND's trunk
    under the name SpaceVoxelBackBone8x, and the dense heads AnchorHeadMulti
    and the classification-only AnchorHeadMultiCls and (SECOND only: it
    reads the sparse x_conv4) AnchorHeadSingleCls, which give cls_preds and
    a cls-only training loss and no boxes to post-process;
  * NAME CaDDN: ImageVFE (a DDNDeepLabV3 or CompactDDN depth network and
    the frustum-to-voxel gather), Conv2DCollapse, BaseBEVBackbone,
    AnchorHeadSingle; `.train()` adds the depth loss;
  * NAME CenterPoint: MeanVFE, VoxelResBackBone8x, HeightCompression,
    BaseBEVBackbone, CenterHead; `.train()` turns on the head's heatmap
    targets and losses;
  * NAME PartA2Net: MeanVFE, UNetV2, HeightCompression, BaseBEVBackbone,
    AnchorHeadSingle, PointIntraPartOffsetHead, PartA2FCHead;
  * NAME PVRCNN: MeanVFE, VoxelBackBone8x, HeightCompression,
    VoxelSetAbstraction, BaseBEVBackbone, AnchorHeadSingle, PointHeadSimple,
    PVRCNNHead; for both `.train()` turns on the anchor head's decode in
    training, the target assignment of all three heads and their losses;
  * NAME PVRCNNPlusPlus: PV-RCNN's modules, its VoxelSetAbstraction with
    the sector keypoint sampling (SAMPLE_METHOD SPC) and VectorPool
    sources; training as PV-RCNN's;
  * NAME PointRCNN: PointNet2MSG, PointHeadBox, PointRCNNHead; `.train()`
    turns on the point head's and the RoI head's targets and losses;
  * NAME DSASNet and NAME PVSSDA (the TSM project's detectors) on the
    module list their config wires, in the JAX `build_module_list`'s
    sections and order (VFE, BACKBONE_3D, MAP_TO_BEV, BACKBONE_2D, NECK,
    DENSE_HEAD, POINT_HEAD, ROI_HEAD; `_generic_modules`): DSASNet's
    dsasnet.yaml (MeanVFE, DSASNetVoxelBackBone8x, HeightCompression, the
    hybrid SparsePointBackbone, DSASNetHead, DSASNetRoIHead) and its 2D
    backbone swapped for the hybrids PointFromVoxel, VoxelPointCross or
    BEVPoint; PVSSDA on its point topology (PointNet2MSG or 3DSSD's
    PointNet2FSMSG, pvssda_3dssd.yaml, then PointHeadBox or its aliases
    PVSSDAHead, VPCNetHead, DSASNetHead, a box a point) and on its BEV
    topology (PillarVFE, PointNet2MSG, PointPillarScatter, BaseBEVBackbone,
    the VoxelPointCross neck, an anchor head). Each section takes the
    ported modules of its JAX registry (`_GENERIC_SECTIONS`: the voxel and
    pillar VFEs, the VoxelBackBone8x trunk under its three names and
    VoxelResBackBone8x, the PointNet++ backbones, the RoI head PVRCNNHead
    and its aliases EPointRoIHead, EPointRoIHeadV2, DSASNetRoIHead); each
    module's input width is that of the tensor it is given, as flax infers
    it; `.train()` turns on the heads' targets and losses; NAME
    Detector3DTemplate, the JAX registry's base detector, runs such a module
    list and sums no loss;
  * NAME VoxelRCNN: MeanVFE, VoxelBackBone8x, HeightCompression,
    BaseBEVBackbone, AnchorHeadSingle, VoxelRCNNHead; NAME SECONDNetIoU: the
    same with SECONDHead; for both `.train()` turns on the anchor head's
    decode in training, the RoI head's targets (VoxelRCNN) and the losses;
    the detectors on VoxelBackBone8x also take it as SpaceVoxelBackBone8x.
Any other configuration raises. Matmuls and convolutions run in full
float32: TF32 is switched off here. cuDNN times its algorithms for each
convolution shape at first use (`cudnn.benchmark`): left to its heuristics,
it ran SECOND's f32 BEV convs as FFT convolutions, which took most of a
batch's device time on an H100 (PERF.md, PR 4).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.common_utils import resolve_device
from .backbones_2d.base_bev_backbone import BaseBEVBackbone
from .backbones_2d.point_bev_hybrids import HYBRIDS
from .backbones_2d.map_to_bev import Conv2DCollapse, HeightCompression, PointPillarScatter
from .backbones_3d.pointnet2_modules import BatchNorm
from .backbones_3d.pfe.voxel_set_abstraction import VoxelSetAbstraction
from .backbones_3d.pointnet2_backbone import PointNet2FSMSG, PointNet2MSG
from .backbones_3d.image_vfe import ImageVFE
from .backbones_3d.spconv_backbone import (
    DSASNetVoxelBackBone8x,
    SpaceVoxelBackBone8x,
    VoxelBackBone8x,
    VoxelResBackBone8x,
    _ConvBase,
)
from .backbones_3d.spconv_unet import UNetV2
from .backbones_3d.vfe import PILLAR_VFES, VOXEL_VFES, MeanVFE
from .backbones_3d.voxel_pointnet2_backbone import (
    VoxelPointNet2FSMSG,
    VoxelPointNet2FSMSGDistillation,
)
from .dense_heads.anchor_head import (
    AnchorHeadMulti,
    AnchorHeadMultiCls,
    AnchorHeadSingle,
    AnchorHeadSingleCls,
)
from .dense_heads.center_head import HM_INIT_BIAS, CenterHead
from .dense_heads.point_head_box import POINT_BOX_HEADS, PointHeadBox
from .dense_heads.point_head_simple import PointHeadSimple
from .dense_heads.point_intra_part_head import CLS_PRIOR_BIAS, PointIntraPartOffsetHead
from .dense_heads.point_head_vote import (
    PointHeadVoteSASAStatistic,
    PointHeadVoteSASAStatisticDistillation,
    VoteHeadBranch,
)
from .detectors import DatasetMeta, __all__ as detector_registry
from .roi_heads.partA2_head import PartA2FCHead
from .roi_heads.pointrcnn_head import PointRCNNHead
from .neck.voxel_point_cross import NECKS
from .roi_heads.pvrcnn_head import PVRCNN_HEADS, PVRCNNHead
from .roi_heads.second_head import SECONDHead
from .roi_heads.voxelrcnn_head import VoxelRCNNHead

_NEG_LOG99 = -float(np.log(99.0))
_SECOND_TRUNKS = {"VoxelBackBone8x": VoxelBackBone8x,
                  "SpaceVoxelBackBone8x": SpaceVoxelBackBone8x}
_ANCHOR_HEADS = {"AnchorHeadSingle": AnchorHeadSingle, "AnchorHeadMulti": AnchorHeadMulti,
                 "AnchorHeadMultiCls": AnchorHeadMultiCls,
                 "AnchorHeadSingleCls": AnchorHeadSingleCls}
# the sections each ported detector reads, and the module NAMEs each may give
# (3DSSD's backbone and head come in pairs: `_TSM_PAIRS`)
_PORTED = {
    "3DSSD": {"BACKBONE_3D": ("VoxelPointNet2FSMSGDistillation", "VoxelPointNet2FSMSG"),
              "POINT_HEAD": ("PointHeadVoteSASAStatisticDistillation",
                             "PointHeadVoteSASAStatistic")},
    "SECONDNet": {"VFE": tuple(VOXEL_VFES), "BACKBONE_3D": tuple(_SECOND_TRUNKS),
                  "MAP_TO_BEV": ("HeightCompression",), "BACKBONE_2D": ("BaseBEVBackbone",),
                  "DENSE_HEAD": tuple(_ANCHOR_HEADS)},
    "PointPillar": {"VFE": tuple(PILLAR_VFES) + tuple(VOXEL_VFES),
                    "MAP_TO_BEV": ("PointPillarScatter",), "BACKBONE_2D": ("BaseBEVBackbone",),
                    "DENSE_HEAD": tuple(n for n in _ANCHOR_HEADS if n != "AnchorHeadSingleCls")},
    "CaDDN": {"VFE": ("ImageVFE",), "MAP_TO_BEV": ("Conv2DCollapse",),
              "BACKBONE_2D": ("BaseBEVBackbone",), "DENSE_HEAD": ("AnchorHeadSingle",)},
    "CenterPoint": {"VFE": ("MeanVFE",), "BACKBONE_3D": ("VoxelResBackBone8x",),
                    "MAP_TO_BEV": ("HeightCompression",), "BACKBONE_2D": ("BaseBEVBackbone",),
                    "DENSE_HEAD": ("CenterHead",)},
    "PartA2Net": {"VFE": ("MeanVFE",), "BACKBONE_3D": ("UNetV2",),
                  "MAP_TO_BEV": ("HeightCompression",), "BACKBONE_2D": ("BaseBEVBackbone",),
                  "DENSE_HEAD": ("AnchorHeadSingle",),
                  "POINT_HEAD": ("PointIntraPartOffsetHead",), "ROI_HEAD": ("PartA2FCHead",)},
    "PVRCNN": {"VFE": ("MeanVFE",), "BACKBONE_3D": tuple(_SECOND_TRUNKS),
               "MAP_TO_BEV": ("HeightCompression",), "PFE": ("VoxelSetAbstraction",),
               "BACKBONE_2D": ("BaseBEVBackbone",), "DENSE_HEAD": ("AnchorHeadSingle",),
               "POINT_HEAD": ("PointHeadSimple",), "ROI_HEAD": ("PVRCNNHead",)},
    "PointRCNN": {"BACKBONE_3D": ("PointNet2MSG",), "POINT_HEAD": ("PointHeadBox",),
                  "ROI_HEAD": ("PointRCNNHead",)},
    "VoxelRCNN": {"VFE": ("MeanVFE",), "BACKBONE_3D": tuple(_SECOND_TRUNKS),
                  "MAP_TO_BEV": ("HeightCompression",), "BACKBONE_2D": ("BaseBEVBackbone",),
                  "DENSE_HEAD": ("AnchorHeadSingle",), "ROI_HEAD": ("VoxelRCNNHead",)},
    "SECONDNetIoU": {"VFE": ("MeanVFE",), "BACKBONE_3D": tuple(_SECOND_TRUNKS),
                     "MAP_TO_BEV": ("HeightCompression",), "BACKBONE_2D": ("BaseBEVBackbone",),
                     "DENSE_HEAD": ("AnchorHeadSingle",), "ROI_HEAD": ("SECONDHead",)},
}
_POINT_BACKBONES = {"PointNet2MSG": PointNet2MSG, "PointNet2FSMSG": PointNet2FSMSG}
_VOXEL_TRUNKS = {**_SECOND_TRUNKS, "DSASNetVoxelBackBone8x": DSASNetVoxelBackBone8x,
                 "VoxelResBackBone8x": VoxelResBackBone8x}
# the module NAMEs each section of DSASNet and PVSSDA may give (the JAX
# registries' ported modules on the topologies `_generic_modules` wires)
_GENERIC_SECTIONS = {
    "VFE": tuple(VOXEL_VFES) + tuple(PILLAR_VFES),
    "BACKBONE_3D": tuple(_VOXEL_TRUNKS) + tuple(_POINT_BACKBONES),
    "MAP_TO_BEV": ("HeightCompression", "PointPillarScatter"),
    "BACKBONE_2D": ("BaseBEVBackbone",) + tuple(HYBRIDS),
    "NECK": tuple(NECKS),
    "DENSE_HEAD": tuple(n for n in _ANCHOR_HEADS if n != "AnchorHeadSingleCls"),
    "POINT_HEAD": tuple(POINT_BOX_HEADS),
    "ROI_HEAD": tuple(PVRCNN_HEADS),
}
_PORTED["PVSSDA"] = _PORTED["DSASNet"] = _PORTED["Detector3DTemplate"] = _GENERIC_SECTIONS
# (backbone, head) NAMEs -> classes: the distillation pair and the teacher's
_TSM_PAIRS = {
    ("VoxelPointNet2FSMSGDistillation", "PointHeadVoteSASAStatisticDistillation"):
        (VoxelPointNet2FSMSGDistillation, PointHeadVoteSASAStatisticDistillation),
    ("VoxelPointNet2FSMSG", "PointHeadVoteSASAStatistic"):
        (VoxelPointNet2FSMSG, PointHeadVoteSASAStatistic),
}
_PORTED["Point3DSSD"] = _PORTED["3DSSD"]
_PORTED["PVRCNNPlusPlus"] = _PORTED["PVRCNN"]
_COMMON_SECTIONS = {"NAME", "POST_PROCESSING", "FACTOR"}


def init_weights(model, seed=0):
    """Seeded random weights from a torch.Generator: Dense and 2D conv
    kernels lecun normal, sparse-conv kernels N(0, 2 / (K * Cin)), the
    teacher's dynamic regression weight N(0, 2 / 64), biases 0 except the
    confidence / cls output biases at -log(99) (the TSM heads' `cls*_out`,
    the anchor heads' `conv_cls` and `conv_cls_g<i>`, the PointNet2FSMSG levels'
    `confidence_out`, the hybrids' `fg_pred_out` and `candidate_out`, and
    Part-A2's, PointRCNN's, PVSSDA's and DSASNet's point
    heads' `cls_out`, set after the loop, since a module comes before its
    layers in `named_modules`; the other `cls_out`, PV-RCNN's point head's
    and the RoI heads', and SECONDHead's `iou_out` start at 0, as flax's
    Dense), CenterPoint's heatmap
    output bias at HM_INIT_BIAS, BN at the identity. CaDDN's depth
    networks take the 2D conv and BN rules (their `classifier` /
    `depth_head` biases 0, as flax's)."""
    g = torch.Generator().manual_seed(int(seed))
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            fan_in = m.weight.shape[1]
            w = torch.randn(m.weight.shape, generator=g) / np.sqrt(fan_in)
            m.weight.data.copy_(w)
            if m.bias is not None:
                tail = name.rsplit(".", 1)[-1]
                prior = tail in ("confidence_out", "fg_pred_out", "candidate_out") or (
                    tail.startswith("cls") and tail.endswith("_out") and tail != "cls_out")
                m.bias.data.fill_(_NEG_LOG99 if prior else 0.0)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            # fan in: Cin * kh * kw (ConvTranspose2d keeps Cin first too)
            cin = m.weight.shape[1] if isinstance(m, nn.Conv2d) else m.weight.shape[0]
            fan_in = cin * m.weight.shape[2] * m.weight.shape[3]
            m.weight.data.copy_(torch.randn(m.weight.shape, generator=g) / np.sqrt(fan_in))
            if m.bias is not None:
                tail = name.rsplit(".", 1)[-1]
                m.bias.data.fill_(_NEG_LOG99 if tail.startswith("conv_cls")
                                  else HM_INIT_BIAS if tail == "hm_out" else 0.0)
        elif isinstance(m, _ConvBase):
            K, cin, _ = m.weight.shape
            w = torch.randn(m.weight.shape, generator=g) * np.sqrt(2.0 / (K * cin))
            m.weight.data.copy_(w)
            if not m.use_norm:
                m.bias.data.zero_()
        elif isinstance(m, (BatchNorm, nn.BatchNorm2d)):
            m.weight.data.fill_(1.0)
            m.bias.data.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, VoteHeadBranch) and m.gated_reg:
            w = torch.randn(m.reg_weight.shape, generator=g) * np.sqrt(2.0 / 64)
            m.reg_weight.data.copy_(w)
    for m in model.modules():
        if isinstance(m, (PointIntraPartOffsetHead, PointHeadBox)):
            m.cls_out.bias.data.fill_(CLS_PRIOR_BIAS)
    return model


def meta_from_dataset(dataset):
    """The DatasetMeta of a dataset (one of `datasets`): its classes, range,
    point features and sampled points, and the grid its data processor
    records (for a TSM config `repository_info`'s stride-FACTOR grid; the
    TSM modules read their geometry from VOXEL_CONFIG, SECOND's anchors this
    grid)."""
    if isinstance(dataset, DatasetMeta):
        return dataset
    grid = getattr(dataset, "grid_size", None)
    vs = getattr(dataset, "voxel_size", None)
    dp = getattr(dataset, "data_processor", None)
    return DatasetMeta(
        class_names=tuple(dataset.class_names),
        point_cloud_range=tuple(np.asarray(dataset.point_cloud_range).tolist()),
        voxel_size=tuple(np.asarray(vs).tolist()) if vs is not None else None,
        grid_size=tuple(np.asarray(grid).tolist()) if grid is not None else None,
        max_voxels=int(getattr(dp, "max_voxels", None) or 16000),
        max_points_per_voxel=int(getattr(dp, "max_points_per_voxel", None) or 5),
        num_point_features=int(dataset.point_feature_encoder.num_point_features),
        max_points=int(getattr(dataset, "max_points", 16384)),
    )


def build_network(model_cfg, num_class, dataset, device="cuda", seed=0):
    """Build the detector (eval mode). `dataset` is a DatasetMeta or a
    dataset."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    name = model_cfg["NAME"]
    if name not in detector_registry or name not in _PORTED:
        raise NotImplementedError(f"detector {name} is not ported")
    sections = _PORTED[name]
    extra = set(model_cfg.keys()) - _COMMON_SECTIONS - set(sections)
    if extra:
        raise NotImplementedError(f"model sections {sorted(extra)} are not ported")
    for section, modules in sections.items():
        if model_cfg.get(section) is not None and model_cfg[section]["NAME"] not in modules:
            raise NotImplementedError(
                f"{section} {model_cfg[section]['NAME']} is not ported")
    dataset = meta_from_dataset(dataset)
    build = {"SECONDNet": _second_modules, "PointPillar": _pointpillar_modules,
             "CaDDN": _caddn_modules,
             "CenterPoint": _centerpoint_modules, "PartA2Net": _two_stage_modules,
             "PVRCNN": _two_stage_modules, "PVRCNNPlusPlus": _two_stage_modules,
             "PointRCNN": _pointrcnn_modules, "PVSSDA": _generic_modules,
             "DSASNet": _generic_modules, "Detector3DTemplate": _generic_modules,
             "VoxelRCNN": _two_stage_modules, "SECONDNetIoU": _two_stage_modules}.get(
                 name, _tsm_modules)
    model = detector_registry[name](model_cfg, num_class, dataset,
                                    build(model_cfg, num_class, dataset))
    init_weights(model, seed)
    return model.to(dev).eval()


def _tsm_modules(model_cfg, num_class, meta):
    names = (model_cfg["BACKBONE_3D"]["NAME"], model_cfg["POINT_HEAD"]["NAME"])
    if names not in _TSM_PAIRS:
        raise NotImplementedError(f"3DSSD backbone / head pair {names} is not ported")
    backbone_cls, head_cls = _TSM_PAIRS[names]
    backbone = backbone_cls(
        dict(model_cfg["BACKBONE_3D"]), input_channels=meta.num_point_features, meta=meta)
    kw = ({"teacher_channels": backbone.teacher_point_features}
          if head_cls is PointHeadVoteSASAStatisticDistillation else {})
    head = head_cls(dict(model_cfg["POINT_HEAD"]), num_class=num_class,
                    input_channels=backbone.num_point_features, meta=meta, **kw)
    return [backbone, head]


def _vfe(model_cfg, meta):
    """The point VFE the config names (`vfe.VOXEL_VFES`, `vfe.PILLAR_VFES`)."""
    cls = {**VOXEL_VFES, **PILLAR_VFES}[model_cfg["VFE"]["NAME"]]
    return cls(dict(model_cfg["VFE"]), meta.num_point_features, meta.voxel_size,
               meta.point_cloud_range, meta.max_voxels, meta.max_points_per_voxel)


def _anchor_head(model_cfg, num_class, meta, input_channels, **kwargs):
    cfg = dict(model_cfg["DENSE_HEAD"])
    return _ANCHOR_HEADS[cfg["NAME"]](cfg, input_channels, num_class,
                                      tuple(meta.class_names), meta.grid_size,
                                      meta.point_cloud_range, **kwargs)


def _second_modules(model_cfg, num_class, meta):
    """The SECOND topology, in the JAX package's module order (its flax
    module_list_0..4): VFE, BACKBONE_3D, MAP_TO_BEV, BACKBONE_2D, DENSE_HEAD.
    AnchorHeadSingleCls reads the trunk's x_conv4 (64 channels a z cell)."""
    vfe = _vfe(model_cfg, meta)
    b3d = _SECOND_TRUNKS[model_cfg["BACKBONE_3D"]["NAME"]](
        dict(model_cfg["BACKBONE_3D"]), vfe.get_output_feature_dim(), meta)
    map_cfg = dict(model_cfg["MAP_TO_BEV"])
    to_bev = HeightCompression(map_cfg)
    b2d = BaseBEVBackbone(dict(model_cfg["BACKBONE_2D"]), map_cfg["NUM_BEV_FEATURES"])
    head_in = (b3d.x_conv4_grid[0] * 64
               if model_cfg["DENSE_HEAD"]["NAME"] == "AnchorHeadSingleCls"
               else b2d.get_output_feature_dim())
    return [vfe, b3d, to_bev, b2d, _anchor_head(model_cfg, num_class, meta, head_in)]


def _pointpillar_modules(model_cfg, num_class, meta):
    """The PointPillars topology in the JAX package's module order: VFE,
    MAP_TO_BEV, BACKBONE_2D, DENSE_HEAD (flax module_list_0..3)."""
    vfe = _vfe(model_cfg, meta)
    map_cfg = dict(model_cfg["MAP_TO_BEV"])
    to_bev = PointPillarScatter(map_cfg, meta.grid_size)
    b2d = BaseBEVBackbone(dict(model_cfg["BACKBONE_2D"]),
                          map_cfg.get("NUM_BEV_FEATURES", vfe.get_output_feature_dim()))
    return [vfe, to_bev, b2d,
            _anchor_head(model_cfg, num_class, meta, b2d.get_output_feature_dim())]


def _caddn_modules(model_cfg, num_class, meta):
    """CaDDN's topology in the JAX package's module order (its
    models/__init__.py:156-166): VFE (ImageVFE at the depth network's
    stride, meta.depth_downsample_factor or 8), MAP_TO_BEV, BACKBONE_2D,
    DENSE_HEAD (flax module_list_0..3)."""
    vfe = ImageVFE(dict(model_cfg["VFE"]), meta.grid_size, meta.point_cloud_range,
                   meta.voxel_size, int(meta.depth_downsample_factor or 8))
    map_cfg = dict(model_cfg["MAP_TO_BEV"])
    to_bev = Conv2DCollapse(map_cfg, vfe.get_output_feature_dim(), meta.grid_size)
    b2d = BaseBEVBackbone(dict(model_cfg["BACKBONE_2D"]), map_cfg.get("NUM_BEV_FEATURES", 64))
    return [vfe, to_bev, b2d,
            _anchor_head(model_cfg, num_class, meta, b2d.get_output_feature_dim())]


def _centerpoint_modules(model_cfg, num_class, meta):
    """The CenterPoint topology in the JAX package's module order: VFE,
    BACKBONE_3D, MAP_TO_BEV, BACKBONE_2D, DENSE_HEAD (flax
    module_list_0..4)."""
    vfe = MeanVFE(dict(model_cfg["VFE"]), meta.num_point_features, meta.voxel_size,
                  meta.point_cloud_range, meta.max_voxels, meta.max_points_per_voxel)
    b3d = VoxelResBackBone8x(dict(model_cfg["BACKBONE_3D"]), vfe.get_output_feature_dim(),
                             meta)
    map_cfg = dict(model_cfg["MAP_TO_BEV"])
    to_bev = HeightCompression(map_cfg)
    b2d = BaseBEVBackbone(dict(model_cfg["BACKBONE_2D"]), map_cfg["NUM_BEV_FEATURES"])
    head = CenterHead(dict(model_cfg["DENSE_HEAD"]), b2d.get_output_feature_dim(), num_class,
                      tuple(meta.class_names), meta.grid_size, meta.point_cloud_range,
                      meta.voxel_size)
    return [vfe, b3d, to_bev, b2d, head]


def _two_stage_modules(model_cfg, num_class, meta):
    """The anchor-RPN two-stage topology in the JAX package's module order
    (its `build_module_list`): VFE, BACKBONE_3D, MAP_TO_BEV, PFE (PV-RCNN),
    BACKBONE_2D, DENSE_HEAD (decoding its boxes in training too, for the
    RoI head), POINT_HEAD (Part-A2, PV-RCNN), ROI_HEAD: flax
    module_list_0..6 (Part-A2), 0..7 (PV-RCNN, PV-RCNN++), 0..5 (Voxel R-CNN,
    SECONDNetIoU)."""
    vfe = MeanVFE(dict(model_cfg["VFE"]), meta.num_point_features, meta.voxel_size,
                  meta.point_cloud_range, meta.max_voxels, meta.max_points_per_voxel)
    b3d_cls = {"UNetV2": UNetV2, **_SECOND_TRUNKS}[model_cfg["BACKBONE_3D"]["NAME"]]
    b3d = b3d_cls(dict(model_cfg["BACKBONE_3D"]), vfe.get_output_feature_dim(), meta)
    map_cfg = dict(model_cfg["MAP_TO_BEV"])
    modules = [vfe, b3d, HeightCompression(map_cfg)]
    pfe = None
    if model_cfg.get("PFE") is not None:
        pfe = VoxelSetAbstraction(dict(model_cfg["PFE"]), meta.voxel_size,
                                  meta.point_cloud_range, map_cfg["NUM_BEV_FEATURES"],
                                  meta.num_point_features)
        modules.append(pfe)
    b2d = BaseBEVBackbone(dict(model_cfg["BACKBONE_2D"]), map_cfg["NUM_BEV_FEATURES"])
    head = AnchorHeadSingle(dict(model_cfg["DENSE_HEAD"]), b2d.get_output_feature_dim(),
                            num_class, tuple(meta.class_names), meta.grid_size,
                            meta.point_cloud_range, predict_boxes_when_training=True)
    modules += [b2d, head]
    roi_cfg = dict(model_cfg["ROI_HEAD"])
    geometry = dict(voxel_size=meta.voxel_size, point_cloud_range=meta.point_cloud_range)
    if roi_cfg["NAME"] == "VoxelRCNNHead":
        return modules + [VoxelRCNNHead(roi_cfg, num_class, **geometry)]
    if roi_cfg["NAME"] == "SECONDHead":
        return modules + [SECONDHead(roi_cfg, b2d.get_output_feature_dim(), num_class,
                                     **geometry)]
    point_cfg = dict(model_cfg["POINT_HEAD"])
    if point_cfg["NAME"] == "PointIntraPartOffsetHead":
        point = PointIntraPartOffsetHead(point_cfg, num_class, b3d.num_point_features, meta)
        roi = PartA2FCHead(roi_cfg, b3d.num_point_features, num_class)
    else:
        c = (pfe.num_point_features_before_fusion
             if point_cfg.get("USE_POINT_FEATURES_BEFORE_FUSION") else pfe.num_point_features)
        point = PointHeadSimple(point_cfg, num_class, c, meta)
        roi = PVRCNNHead(roi_cfg, pfe.num_point_features, num_class)
    return modules + [point, roi]


def _pointrcnn_modules(model_cfg, num_class, meta):
    """PointRCNN's topology in the JAX package's module order: BACKBONE_3D,
    POINT_HEAD, ROI_HEAD (flax module_list_0..2)."""
    backbone = PointNet2MSG(dict(model_cfg["BACKBONE_3D"]), meta.num_point_features, meta)
    c = backbone.num_point_features
    point = PointHeadBox(dict(model_cfg["POINT_HEAD"]), num_class, c, meta)
    roi = PointRCNNHead(dict(model_cfg["ROI_HEAD"]), c, num_class)
    return [backbone, point, roi]


def _generic_modules(model_cfg, num_class, meta):
    """DSASNet's and PVSSDA's module list: the sections the config has, in
    the JAX `build_module_list`'s order (VFE, BACKBONE_3D, MAP_TO_BEV,
    BACKBONE_2D, NECK, DENSE_HEAD, POINT_HEAD, ROI_HEAD; flax
    module_list_0.. in turn). Each module is built for the width of the
    tensor it will be given: a PointNet++ backbone the raw points', the
    hybrids the trunk's pyramid and the BEV map's, the neck the BEV map's
    and the point features', the heads the width of the map or the point
    features the module before them writes (PointFromVoxel reports 256 in
    the JAX package and writes 128-wide point features)."""
    sec = lambda name: dict(model_cfg[name]) if model_cfg.get(name) is not None else None
    geometry = dict(voxel_size=meta.voxel_size, point_cloud_range=meta.point_cloud_range)
    modules, pyramid = [], None
    width = meta.num_point_features                   # the VFE's output width
    bev_ch = point_ch = None
    if sec("VFE"):
        vfe = _vfe(model_cfg, meta)
        modules.append(vfe)
        width = vfe.get_output_feature_dim()
    if cfg := sec("BACKBONE_3D"):
        if cfg["NAME"] in _POINT_BACKBONES:
            b3d = _POINT_BACKBONES[cfg["NAME"]](cfg, meta.num_point_features, meta)
            point_ch = b3d.num_point_features
        else:
            b3d = _VOXEL_TRUNKS[cfg["NAME"]](cfg, width, meta)
            pyramid = b3d.pyramid
        modules.append(b3d)
    if cfg := sec("MAP_TO_BEV"):
        if cfg["NAME"] == "HeightCompression":
            modules.append(HeightCompression(cfg))
            bev_ch = int(cfg["NUM_BEV_FEATURES"])
        else:
            modules.append(PointPillarScatter(cfg, meta.grid_size))
            bev_ch = width
    if cfg := sec("BACKBONE_2D"):
        if cfg["NAME"] == "BaseBEVBackbone":
            b2d = BaseBEVBackbone(cfg, bev_ch)
            bev_ch = b2d.get_output_feature_dim()
        elif pyramid is None:
            raise NotImplementedError(f"BACKBONE_2D {cfg['NAME']} needs a sparse trunk's pyramid")
        elif cfg["NAME"] in ("SparsePointBackbone", "BEVPoint"):
            b2d = HYBRIDS[cfg["NAME"]](cfg, pyramid=pyramid, **geometry)
        else:
            b2d = HYBRIDS[cfg["NAME"]](cfg, bev_ch, raw_channels=max(meta.num_point_features - 3, 1),
                                       **geometry)
        bev_ch = getattr(b2d, "bev_channels", None) or bev_ch
        point_ch = getattr(b2d, "point_channels", point_ch)
        modules.append(b2d)
    if cfg := sec("NECK"):
        neck = NECKS[cfg["NAME"]](cfg, bev_channels=bev_ch, point_channels=point_ch,
                                  source_channels=pyramid and {s: v[0] for s, v in pyramid.items()},
                                  **geometry)
        bev_ch = point_ch = neck.ch
        modules.append(neck)
    if sec("DENSE_HEAD"):
        modules.append(_anchor_head(model_cfg, num_class, meta, bev_ch,
                                    predict_boxes_when_training=sec("ROI_HEAD") is not None))
    if cfg := sec("POINT_HEAD"):
        modules.append(POINT_BOX_HEADS[cfg["NAME"]](cfg, num_class, point_ch, meta))
    if cfg := sec("ROI_HEAD"):
        modules.append(PVRCNN_HEADS[cfg["NAME"]](cfg, point_ch, num_class))
    return modules
