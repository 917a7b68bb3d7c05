"""CaDDN's depth distribution networks (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/ddn.py): `DDNDeepLabV3`, a
ResNet bottleneck trunk at output stride 8 (layer3 and layer4 dilated 2 and
4 in place of their strides) with an ASPP of rates 12 / 24 / 36 and an
image-pooling branch, and `CompactDDN`, six conv blocks. Each takes NHWC
images (B, H, W, 3) and returns NHWC image features (B, hf, wf, num_feat)
and depth logits (B, hl, wl, num_logits), both at stride 8.

Inside, the networks run in NCHW on `nn.Conv2d` (cuDNN on the card; the JAX
package leaves them to XLA, outside any Pallas kernel). Submodules carry the
flax auto-names (`_ConvBN_0`, `Bottleneck_3`, `ASPP_0`, `Conv_0`,
`BatchNorm_0`, `classifier`, `depth_head`, ...) so that
`convert.from_flax_variables` places a JAX state on them.

Padding is flax's `SAME`: along a side of n with kernel k, dilation d and
stride s it pads max((ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0) in all,
half of it (rounded down) before. A stride-2 3 x 3 conv or max-pool on an
even side pads 0 before and 1 after, the 7 x 7 stem 2 and 3: there the pad
is explicit (`F.pad`, -inf for the max-pool), since torch's `padding` is
symmetric. Layer1's features are average-pooled 2 x 2 `VALID` to stride 8;
on an odd side that gives one column or row fewer than the logits (at
375 x 1242: features 47 x 155, logits 47 x 156).

BN: `_ConvBN`'s is 1e-5 / 0.9 (eps / flax momentum), `CompactDDN`'s 1e-3 /
0.99; in train mode each normalises by the batch's statistics
(`base_bev_backbone._BatchNorm2d`, which also takes the ASPP pooling
branch's one value per channel at batch 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones_2d.base_bev_backbone import _BatchNorm2d


def same_pads(n, k, s=1, d=1):
    """flax SAME padding (before, after) of a side of n."""
    total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def _same_conv(conv, x):
    """`conv` (padding 0) on NCHW x with flax SAME padding."""
    k, s, d = conv.kernel_size[0], conv.stride[0], conv.dilation[0]
    (t, b), (l, r) = same_pads(x.shape[2], k, s, d), same_pads(x.shape[3], k, s, d)
    if t == b and l == r:
        return F.conv2d(x, conv.weight, conv.bias, s, (t, l), d)
    return conv(F.pad(x, (l, r, t, b)))


def _same_max_pool(x, k=3, s=2):
    (t, b), (l, r) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), k, s)


class _ConvBN(nn.Module):
    """Bias-free SAME conv, BN (1e-5 / 0.9), optional ReLU."""

    def __init__(self, cin, ch, kernel=3, stride=1, dilation=1, act=True):
        super().__init__()
        self.act = act
        self.Conv_0 = nn.Conv2d(cin, ch, kernel, stride, 0, dilation, bias=False)
        self.BatchNorm_0 = _BatchNorm2d(ch, eps=1e-5, momentum=0.9)

    def forward(self, x):
        x = self.BatchNorm_0(_same_conv(self.Conv_0, x))
        return torch.relu(x) if self.act else x


class Bottleneck(nn.Module):
    """ResNet bottleneck: 1x1 -> 3x3 (the stride and dilation) -> 1x1 to
    4 * ch, with a 1x1 projection skip where the width or stride changes."""

    def __init__(self, cin, ch, stride=1, dilation=1):
        super().__init__()
        out_ch = ch * 4
        self._ConvBN_0 = _ConvBN(cin, ch, 1)
        self._ConvBN_1 = _ConvBN(ch, ch, 3, stride, dilation)
        self._ConvBN_2 = _ConvBN(ch, out_ch, 1, act=False)
        self.project = cin != out_ch or stride != 1
        if self.project:
            self._ConvBN_3 = _ConvBN(cin, out_ch, 1, stride, act=False)

    def forward(self, x):
        h = self._ConvBN_2(self._ConvBN_1(self._ConvBN_0(x)))
        return torch.relu(h + (self._ConvBN_3(x) if self.project else x))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, one 3x3 branch a rate,
    the image-pooling branch (mean over H, W, 1x1, broadcast back), then a
    1x1 projection of their concatenation."""

    def __init__(self, cin, ch=256, rates=(12, 24, 36)):
        super().__init__()
        self.n_rates = len(rates)
        self._ConvBN_0 = _ConvBN(cin, ch, 1)
        for i, r in enumerate(rates):
            self.add_module(f"_ConvBN_{i + 1}", _ConvBN(cin, ch, 3, dilation=r))
        self.add_module(f"_ConvBN_{len(rates) + 1}", _ConvBN(cin, ch, 1))
        self.add_module(f"_ConvBN_{len(rates) + 2}", _ConvBN(ch * (len(rates) + 2), ch, 1))

    def forward(self, x):
        n = self.n_rates
        branches = [getattr(self, f"_ConvBN_{i}")(x) for i in range(n + 1)]
        g = getattr(self, f"_ConvBN_{n + 1}")(x.mean((2, 3), keepdim=True))
        branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        return getattr(self, f"_ConvBN_{n + 2}")(torch.cat(branches, 1))


class DDNDeepLabV3(nn.Module):
    """ResNet (LAYERS bottlenecks a stage at WIDTH; [3, 4, 23, 3] at 64 is
    ResNet-101) + ASPP at output stride 8. Depth logits: a 3x3 `_ConvBN` to
    256 and the 1x1 `classifier` (with bias). Image features: layer1
    (stride 4) through a 1x1 `_ConvBN` to num_feat, average-pooled to
    stride 8."""

    def __init__(self, num_feat, num_logits, layers=(3, 4, 23, 3), width=64):
        super().__init__()
        w = int(width)
        self._ConvBN_0 = _ConvBN(3, w, 7, 2)
        plan = [(layers[0], w, 1, 1), (layers[1], w * 2, 2, 1),
                (layers[2], w * 4, 1, 2), (layers[3], w * 8, 1, 4)]
        cin, k = w, 0
        self.stage_ends = []
        for n, ch, stride, dil in plan:
            for bi in range(int(n)):
                self.add_module(f"Bottleneck_{k}",
                                Bottleneck(cin, ch, stride if bi == 0 else 1, dil))
                cin, k = ch * 4, k + 1
            self.stage_ends.append(k)
        self.n_blocks = k
        self.ASPP_0 = ASPP(cin)
        self._ConvBN_1 = _ConvBN(256, 256, 3)
        self.classifier = nn.Conv2d(256, int(num_logits), 1)
        self._ConvBN_2 = _ConvBN(w * 4, int(num_feat), 1)

    def forward(self, images):
        x = _same_max_pool(self._ConvBN_0(images.permute(0, 3, 1, 2).contiguous()))
        layer1 = None
        for k in range(self.n_blocks):
            x = getattr(self, f"Bottleneck_{k}")(x)
            if k + 1 == self.stage_ends[0]:
                layer1 = x
        logits = self.classifier(self._ConvBN_1(self.ASPP_0(x)))
        feats = F.avg_pool2d(self._ConvBN_2(layer1), 2, 2)
        return feats.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1)


class CompactDDN(nn.Module):
    """Six SAME conv blocks (bias-free conv, BN 1e-3 / 0.99, ReLU): 32 /2,
    32, 64 /2, 64, num_feat /2, num_feat; features the last block's, logits
    its 1x1 `depth_head` (with bias)."""

    def __init__(self, num_feat, num_logits):
        super().__init__()
        plan = [(32, 2), (32, 1), (64, 2), (64, 1), (int(num_feat), 2), (int(num_feat), 1)]
        cin = 3
        for i, (ch, s) in enumerate(plan):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, ch, 3, s, bias=False))
            self.add_module(f"BatchNorm_{i}", _BatchNorm2d(ch))
            cin = ch
        self.depth_head = nn.Conv2d(cin, int(num_logits), 1)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).contiguous()
        for i in range(6):
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(
                _same_conv(getattr(self, f"Conv_{i}"), x)))
        logits = self.depth_head(x)
        return x.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1)


DDN_REGISTRY = {"CompactDDN": CompactDDN, "DDNDeepLabV3": DDNDeepLabV3}
