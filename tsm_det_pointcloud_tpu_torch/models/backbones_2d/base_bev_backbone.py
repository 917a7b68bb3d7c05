"""2D BEV backbone (counterpart of
tsm_det_pointcloud_tpu/models/backbones_2d/base_bev_backbone.py): per level
a stride-S conv stack, a transposed-conv upsampling to a common resolution,
and a channel concat.

Layout: `spatial_features` comes in and `spatial_features_2d` goes out NHWC,
as in the JAX package; inside, the module works in NCHW, converting once in
and once out (`permute`, which PyTorch's convolutions take as channels-last
memory without a copy). Convs are `nn.Conv2d` / `nn.ConvTranspose2d`
without bias and `nn.BatchNorm2d` (eps 1e-3); `build_network` keeps TF32
off, so they run in full float32. The JAX package leaves these convs to
XLA, outside any Pallas kernel. The `s < 1` deblock and the `deblock_final`
branch are not on a ported path and raise.
"""
from __future__ import annotations

import torch
from torch import nn


class _BatchNorm2d(nn.BatchNorm2d):
    """flax's BatchNorm(epsilon=1e-3, momentum=0.99) in torch's terms,
    without torch's update counter: flax keeps none, so a converted state
    has none to load."""

    def __init__(self, c):
        super().__init__(int(c), eps=1e-3, momentum=0.01)
        self.register_buffer("num_batches_tracked", None)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, *args):
        # a state without metadata reads as torch's version 1, whose loader
        # would add the counter back
        super()._load_from_state_dict(state_dict, prefix,
                                      {**local_metadata, "version": self._version}, *args)



class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels):
        super().__init__()
        cfg = model_cfg
        self.layer_nums = list(cfg.get("LAYER_NUMS", []))
        layer_strides = list(cfg.get("LAYER_STRIDES", []))
        num_filters = list(cfg.get("NUM_FILTERS", []))
        self.upsample_strides = list(cfg.get("UPSAMPLE_STRIDES", []))
        num_up = list(cfg.get("NUM_UPSAMPLE_FILTERS", []))
        if len(self.upsample_strides) > len(self.layer_nums):
            raise NotImplementedError("BaseBEVBackbone: deblock_final is not ported")
        if any(s < 1 for s in self.upsample_strides):
            raise NotImplementedError("BaseBEVBackbone: strided (s < 1) deblocks are "
                                      "not ported")
        c_in = int(input_channels)
        for i, n_layers in enumerate(self.layer_nums):
            c = int(num_filters[i])
            s = int(layer_strides[i])
            self.add_module(f"block{i}_down", nn.Conv2d(c_in, c, 3, stride=s, padding=1,
                                                        bias=False))
            self.add_module(f"block{i}_down_bn", _BatchNorm2d(c))
            for j in range(n_layers):
                self.add_module(f"block{i}_conv{j}", nn.Conv2d(c, c, 3, padding=1,
                                                               bias=False))
                self.add_module(f"block{i}_bn{j}", _BatchNorm2d(c))
            if i < len(self.upsample_strides):
                u = int(self.upsample_strides[i])
                self.add_module(f"deblock{i}", nn.ConvTranspose2d(
                    c, int(num_up[i]), u, stride=u, bias=False))
                self.add_module(f"deblock{i}_bn", _BatchNorm2d(num_up[i]))
            c_in = c
        self.num_bev_features = sum(int(n) for n in num_up) if num_up else c_in

    def forward(self, batch_dict):
        x = batch_dict["spatial_features"].permute(0, 3, 1, 2)   # NHWC -> NCHW
        ups = []
        for i, n_layers in enumerate(self.layer_nums):
            x = torch.relu(getattr(self, f"block{i}_down_bn")(
                getattr(self, f"block{i}_down")(x)))
            for j in range(n_layers):
                x = torch.relu(getattr(self, f"block{i}_bn{j}")(
                    getattr(self, f"block{i}_conv{j}")(x)))
            if i < len(self.upsample_strides):
                ups.append(torch.relu(getattr(self, f"deblock{i}_bn")(
                    getattr(self, f"deblock{i}")(x))))
            else:
                ups.append(x)
        x = torch.cat(ups, 1) if len(ups) > 1 else ups[0]
        batch_dict["spatial_features_2d"] = x.permute(0, 2, 3, 1)   # NCHW -> NHWC
        return batch_dict

    def get_output_feature_dim(self):
        return self.num_bev_features
