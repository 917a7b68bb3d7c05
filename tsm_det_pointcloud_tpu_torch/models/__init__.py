"""Model builder (counterpart of tsm_det_pointcloud_tpu/models/__init__.py).

`build_network(model_cfg, num_class, dataset, device="cuda", seed=0)` builds
the ported detector — NAME 3DSSD with the VoxelPointNet2FSMSGDistillation
backbone and the PointHeadVoteSASAStatisticDistillation head — with seeded
random weights, in eval mode, on `device`. Any other configuration raises.
Matmuls and convolutions run in full float32: TF32 is switched off here.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.common_utils import resolve_device
from .backbones_3d.pointnet2_modules import BatchNorm
from .backbones_3d.spconv_backbone import _ConvBase
from .backbones_3d.voxel_pointnet2_backbone import VoxelPointNet2FSMSGDistillation
from .dense_heads.point_head_vote import PointHeadVoteSASAStatisticDistillation
from .detectors import DatasetMeta, __all__ as detector_registry

_NEG_LOG99 = -float(np.log(99.0))
_PORTED_SECTIONS = {"NAME", "BACKBONE_3D", "POINT_HEAD", "POST_PROCESSING",
                    "FACTOR"}


def init_weights(model, seed=0):
    """Seeded random weights from a torch.Generator: Dense kernels lecun
    normal, sparse-conv kernels N(0, 2 / (K * Cin)), biases 0 except the
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
        elif isinstance(m, _ConvBase):
            K, cin, _ = m.weight.shape
            w = torch.randn(m.weight.shape, generator=g) * np.sqrt(2.0 / (K * cin))
            m.weight.data.copy_(w)
            if not m.use_norm:
                m.bias.data.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.data.fill_(1.0)
            m.bias.data.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


def build_network(model_cfg, num_class, dataset, device="cuda", seed=0):
    """Build the eval-path detector. `dataset` is a DatasetMeta."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = model_cfg["NAME"]
    if name not in detector_registry:
        raise NotImplementedError(f"detector {name} is not ported")
    extra = set(model_cfg.keys()) - _PORTED_SECTIONS
    if extra:
        raise NotImplementedError(f"model sections {sorted(extra)} are not ported")
    if not isinstance(dataset, DatasetMeta):
        raise TypeError("dataset must be a DatasetMeta")
    b3d = model_cfg["BACKBONE_3D"]
    if b3d["NAME"] != "VoxelPointNet2FSMSGDistillation":
        raise NotImplementedError(f"backbone {b3d['NAME']} is not ported")
    head_cfg = model_cfg["POINT_HEAD"]
    if head_cfg["NAME"] != "PointHeadVoteSASAStatisticDistillation":
        raise NotImplementedError(f"point head {head_cfg['NAME']} is not ported")

    backbone = VoxelPointNet2FSMSGDistillation(
        dict(b3d), input_channels=dataset.num_point_features, meta=dataset)
    head = PointHeadVoteSASAStatisticDistillation(
        dict(head_cfg), num_class=num_class,
        input_channels=backbone.num_point_features, meta=dataset)
    model = detector_registry[name](model_cfg, num_class, dataset, [backbone, head])
    init_weights(model, seed)
    return model.to(dev).eval()
