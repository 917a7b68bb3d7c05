"""BEV scatter from a dense 3D volume (counterpart of
tsm_det_pointcloud_tpu/models/backbones_2d/map_to_bev.py:60-75)."""
from __future__ import annotations

from torch import nn


class HeightCompression(nn.Module):
    """Collapse the z axis of the dense (B, nz, ny, nx, C) volume into
    channels, in the JAX package's order: channel z * C + c. (The
    reference's NCDHW `view` is C-major; following it would permute the
    channels that the first BEV conv reads.) Out: spatial_features
    (B, ny, nx, nz * C), NHWC."""

    def __init__(self, model_cfg):
        super().__init__()
        self.model_cfg = model_cfg

    def forward(self, batch_dict):
        dense = batch_dict["encoded_spconv_tensor"]
        B, nz, ny, nx, C = dense.shape
        batch_dict["spatial_features"] = dense.permute(0, 2, 3, 1, 4).reshape(
            B, ny, nx, nz * C)
        batch_dict["spatial_features_stride"] = batch_dict.get(
            "encoded_spconv_tensor_stride", 8)
        return batch_dict
