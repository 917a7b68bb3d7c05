"""2D BEV backbone (counterpart of
tsm_det_pointcloud_tpu/models/backbones_2d/base_bev_backbone.py): per level
a stride-S conv stack, a transposed-conv upsampling to a common resolution,
and a channel concat.

Layout: `spatial_features` comes in and `spatial_features_2d` goes out NHWC,
as in the JAX package; inside, the module works in NCHW, converting once in
and once out (`permute`, which PyTorch's convolutions take as channels-last
memory without a copy). Convs are `nn.Conv2d` / `nn.ConvTranspose2d`
without bias and `nn.BatchNorm2d` (eps 1e-3, flax's batch statistics in
train mode); `build_network` keeps TF32 off, so they run in full float32.
The JAX package leaves these convs to XLA, outside any Pallas kernel. An
upsample stride s < 1 makes `deblock{i}` a strided `nn.Conv2d` (kernel and
stride round(1 / s), no bias) where s >= 1 makes it a transposed conv; an
UPSAMPLE_STRIDES one longer than LAYER_NUMS adds `deblock_final`, a
transposed conv of its last stride over the concatenated map, keeping its
channels, then `deblock_final_bn` and a ReLU.
"""
from __future__ import annotations

import torch
from torch import nn

from ...parallel import comm


class _BatchNorm2d(nn.BatchNorm2d):
    """flax's BatchNorm(epsilon=eps, momentum=momentum) in torch's terms (by
    default the BEV layers' 1e-3 / 0.99), without torch's update counter:
    flax keeps none, so a converted state has none to load. In train mode it
    normalises by the batch's statistics over (N, H, W) and moves the
    running ones as flax's `batch_stats` move: `running = momentum * running
    + (1 - momentum) * batch`, with the biased batch variance (torch's own
    update takes the unbiased one). One value per channel (CaDDN's ASPP
    pooling branch at batch 1) has variance 0 and normalises to the bias,
    as flax does, where `F.batch_norm` raises. In a multi-process run the
    statistics are the global batch's (`comm.global_sum` of the sums,
    squared sums and count, flax's fast variance), so this is not
    `nn.SyncBatchNorm`, which stores the unbiased variance."""

    def __init__(self, c, eps=1e-3, momentum=0.99):
        super().__init__(int(c), eps=float(eps), momentum=1.0 - float(momentum))
        self.register_buffer("num_batches_tracked", None)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if comm.data_world_size() > 1 or x.numel() == x.shape[1]:
            return self._global_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
        return nn.functional.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                                        self.eps)

    def _global_forward(self, x):
        C = x.shape[1]
        n = torch.full((1,), x.numel() // C, dtype=x.dtype, device=x.device)
        sums = comm.global_sum(torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)), n]))
        mean = sums[:C] / sums[2 * C]
        var = torch.clamp(sums[C:2 * C] / sums[2 * C] - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])

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
                u = self.upsample_strides[i]
                if u >= 1:
                    deblock = nn.ConvTranspose2d(c, int(num_up[i]), int(u), stride=int(u),
                                                 bias=False)
                else:
                    k = int(round(1 / u))
                    deblock = nn.Conv2d(c, int(num_up[i]), k, stride=k, bias=False)
                self.add_module(f"deblock{i}", deblock)
                self.add_module(f"deblock{i}_bn", _BatchNorm2d(num_up[i]))
            c_in = c
        self.num_bev_features = sum(int(n) for n in num_up) if num_up else c_in
        self.has_final = len(self.upsample_strides) > len(self.layer_nums)
        if self.has_final:
            # the JAX get_output_feature_dim says twice these channels; the
            # flax conv keeps the concatenation's, as this one does
            u = int(self.upsample_strides[-1])
            self.deblock_final = nn.ConvTranspose2d(self.num_bev_features,
                                                    self.num_bev_features, u, stride=u,
                                                    bias=False)
            self.deblock_final_bn = _BatchNorm2d(self.num_bev_features)

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
        if self.has_final:
            x = torch.relu(self.deblock_final_bn(self.deblock_final(x)))
        batch_dict["spatial_features_2d"] = x.permute(0, 2, 3, 1)   # NCHW -> NHWC
        return batch_dict

    def get_output_feature_dim(self):
        return self.num_bev_features
