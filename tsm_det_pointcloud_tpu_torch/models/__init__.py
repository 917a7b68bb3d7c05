"""Model builder (counterpart of tsm_det_pointcloud_tpu/models/__init__.py).

`build_network(model_cfg, num_class, dataset, device="cuda", seed=0)` builds
one of the ported detectors with seeded random weights, in eval mode, on
`device`:
  * NAME 3DSSD with the VoxelPointNet2FSMSGDistillation backbone and the
    PointHeadVoteSASAStatisticDistillation head, teacher and student;
    `.train()` turns on the distillation training path;
  * NAME SECONDNet: MeanVFE, VoxelBackBone8x, HeightCompression,
    BaseBEVBackbone, AnchorHeadSingle (eval only; a training forward
    raises).
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
from .backbones_2d.map_to_bev import HeightCompression
from .backbones_3d.pointnet2_modules import BatchNorm
from .backbones_3d.spconv_backbone import VoxelBackBone8x, _ConvBase
from .backbones_3d.vfe import MeanVFE
from .backbones_3d.voxel_pointnet2_backbone import VoxelPointNet2FSMSGDistillation
from .dense_heads.anchor_head import AnchorHeadSingle
from .dense_heads.point_head_vote import (
    PointHeadVoteSASAStatisticDistillation,
    VoteHeadBranch,
)
from .detectors import DatasetMeta, __all__ as detector_registry

_NEG_LOG99 = -float(np.log(99.0))
# the sections each ported detector reads, and the module NAME each must give
_PORTED = {
    "3DSSD": {"BACKBONE_3D": "VoxelPointNet2FSMSGDistillation",
              "POINT_HEAD": "PointHeadVoteSASAStatisticDistillation"},
    "SECONDNet": {"VFE": "MeanVFE", "BACKBONE_3D": "VoxelBackBone8x",
                  "MAP_TO_BEV": "HeightCompression", "BACKBONE_2D": "BaseBEVBackbone",
                  "DENSE_HEAD": "AnchorHeadSingle"},
}
_PORTED["Point3DSSD"] = _PORTED["3DSSD"]
_COMMON_SECTIONS = {"NAME", "POST_PROCESSING", "FACTOR"}


def init_weights(model, seed=0):
    """Seeded random weights from a torch.Generator: Dense and 2D conv
    kernels lecun normal, sparse-conv kernels N(0, 2 / (K * Cin)), the
    teacher's dynamic regression weight N(0, 2 / 64), biases 0 except the
    confidence / cls output biases at -log(99), BN at the identity."""
    g = torch.Generator().manual_seed(int(seed))
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            fan_in = m.weight.shape[1]
            w = torch.randn(m.weight.shape, generator=g) / np.sqrt(fan_in)
            m.weight.data.copy_(w)
            if m.bias is not None:
                tail = name.rsplit(".", 1)[-1]
                prior = tail == "confidence_out" or (
                    tail.startswith("cls") and tail.endswith("_out"))
                m.bias.data.fill_(_NEG_LOG99 if prior else 0.0)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            # fan in: Cin * kh * kw (ConvTranspose2d keeps Cin first too)
            cin = m.weight.shape[1] if isinstance(m, nn.Conv2d) else m.weight.shape[0]
            fan_in = cin * m.weight.shape[2] * m.weight.shape[3]
            m.weight.data.copy_(torch.randn(m.weight.shape, generator=g) / np.sqrt(fan_in))
            if m.bias is not None:
                prior = name.rsplit(".", 1)[-1] == "conv_cls"
                m.bias.data.fill_(_NEG_LOG99 if prior else 0.0)
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
    return model


def build_network(model_cfg, num_class, dataset, device="cuda", seed=0):
    """Build the detector (eval mode). `dataset` is a DatasetMeta."""
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
    for section, module in sections.items():
        if model_cfg[section]["NAME"] != module:
            raise NotImplementedError(
                f"{section} {model_cfg[section]['NAME']} is not ported")
    if not isinstance(dataset, DatasetMeta):
        raise TypeError("dataset must be a DatasetMeta")
    build = _second_modules if name == "SECONDNet" else _tsm_modules
    model = detector_registry[name](model_cfg, num_class, dataset,
                                    build(model_cfg, num_class, dataset))
    init_weights(model, seed)
    return model.to(dev).eval()


def _tsm_modules(model_cfg, num_class, meta):
    backbone = VoxelPointNet2FSMSGDistillation(
        dict(model_cfg["BACKBONE_3D"]), input_channels=meta.num_point_features, meta=meta)
    head = PointHeadVoteSASAStatisticDistillation(
        dict(model_cfg["POINT_HEAD"]), num_class=num_class,
        input_channels=backbone.num_point_features, meta=meta,
        teacher_channels=backbone.teacher_point_features)
    return [backbone, head]


def _second_modules(model_cfg, num_class, meta):
    """The SECOND topology, in the JAX package's module order (its flax
    module_list_0..4): VFE, BACKBONE_3D, MAP_TO_BEV, BACKBONE_2D, DENSE_HEAD."""
    vfe = MeanVFE(dict(model_cfg["VFE"]), meta.num_point_features, meta.voxel_size,
                  meta.point_cloud_range, meta.max_voxels, meta.max_points_per_voxel)
    b3d = VoxelBackBone8x(dict(model_cfg["BACKBONE_3D"]), vfe.get_output_feature_dim(),
                          meta)
    map_cfg = dict(model_cfg["MAP_TO_BEV"])
    to_bev = HeightCompression(map_cfg)
    b2d = BaseBEVBackbone(dict(model_cfg["BACKBONE_2D"]), map_cfg["NUM_BEV_FEATURES"])
    head = AnchorHeadSingle(dict(model_cfg["DENSE_HEAD"]), b2d.get_output_feature_dim(),
                            num_class, tuple(meta.class_names), meta.grid_size,
                            meta.point_cloud_range)
    return [vfe, b3d, to_bev, b2d, head]
