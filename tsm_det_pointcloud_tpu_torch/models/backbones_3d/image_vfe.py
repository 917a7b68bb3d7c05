"""CaDDN's image VFE (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/image_vfe.py): a depth
distribution network (ddn.py) gives image features and depth logits at
stride `downsample_factor`; each voxel centre of the grid projects into the
image once and takes the feature at its pixel times the softmax probability
of its depth's bin there (`lid_to_bin`), zero outside the image or the depth
range. In training the scan's points project the same way to depth targets,
and a focal term over the bins (optionally balanced by the 2D gt boxes) is
the depth loss.

batch_dict in: images (B, H, W, 3) in [0, 1], trans_lidar_to_cam_img
(B, 3, 4); in training also points (B, N, >= 3), points_mask (B, N), and
optionally gt_boxes2d (B, M, 4) u1 v1 u2 v2 with gt_boxes2d_mask (B, M).
Out: spatial_features_3d and voxel_features_dense, the volume
(B, nx, ny, nz, C) (a permuted view of (B, ny, nx, nz, C) memory, the
layout Conv2DCollapse reads without a copy), and voxels_in_frustum (B,),
the count of voxels that take a feature; in training loss_depth.

The projection is computed elementwise, ((x P0 + y P1) + z P2) + P3 a row,
so that it rounds alike on the CPU and the card; a pixel index is the
projected coordinate truncated toward zero, as the JAX `astype(int32)`
(a point at u in (-1, 0) lands in column 0, and its depth target counts).
Pixel indices are bounded by the feature map's width, which at an odd
stride-4 width is one less than the logits' (the last logit column is read
nowhere). The gather is PyTorch indexing (`index_select`; its backward
accumulates into the feature map with float atomics on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import comm
from .ddn import DDN_REGISTRY


def lid_to_bin(depth, num_bins, depth_min, depth_max):
    """LID discretisation (CaDDN eq. 2, bin sizes growing linearly): the
    int32 bin of each depth, clipped to [0, num_bins - 1]."""
    bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    idx = -0.5 + 0.5 * torch.sqrt(1 + 8 * torch.clamp(depth - depth_min, min=0.0) / bin_size)
    return torch.clamp(idx, 0, num_bins - 1).to(torch.int32)


def project(x, y, z, P):
    """[u, v, depth] of points (x, y, z), tensors whose leading axis is the
    batch's or 1, under the per-scan 3 x 4 matrices P (B, 3, 4);
    elementwise, each row in the order ((x P0 + y P1) + z P2) + P3."""
    shape = (P.shape[0],) + (1,) * (x.dim() - 1)
    return [((x * P[:, r, 0].view(shape) + y * P[:, r, 1].view(shape))
             + z * P[:, r, 2].view(shape)) + P[:, r, 3].view(shape) for r in range(3)]


class ImageVFE(nn.Module):
    def __init__(self, model_cfg, grid_size, point_cloud_range, voxel_size,
                 downsample_factor=8):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_bins = int(cfg.get("NUM_DEPTH_BINS", 80))
        self.depth_min, self.depth_max = cfg.get("DEPTH_RANGE", (2.0, 46.8))
        self.num_features = int(cfg.get("NUM_OUTPUT_FEATURES", 64))
        self.downsample_factor = int(downsample_factor)
        self.fg_weight = float(cfg.get("FG_WEIGHT", 13.0))
        self.bg_weight = float(cfg.get("BG_WEIGHT", 1.0))
        ddn_cfg = dict(cfg.get("DDN", {}))
        name = ddn_cfg.pop("NAME", "CompactDDN")
        self.ddn = DDN_REGISTRY[name](num_feat=self.num_features, num_logits=self.num_bins,
                                      **{k.lower(): v for k, v in ddn_cfg.items()})
        self.grid = tuple(int(g) for g in grid_size)
        # voxel centres a grid axis, as the JAX module computes them (f32)
        for axis, n, size, lo in zip("xyz", self.grid, voxel_size, point_cloud_range[:3]):
            self.register_buffer(f"centre_{axis}",
                                 (torch.arange(n, dtype=torch.float32) + 0.5) * size + lo,
                                 persistent=False)

    def get_output_feature_dim(self):
        return self.num_features

    def _image_coords(self, u, v, depth):
        """(u, v) of projected coordinates on the stride-`downsample_factor`
        map, whether each depth lies inside the range, and its bin."""
        d = torch.clamp(depth, min=1e-3)
        ds = self.downsample_factor
        depth_ok = (depth > self.depth_min) & (depth < self.depth_max)
        return (u / d / ds, v / d / ds, depth_ok,
                lid_to_bin(depth, self.num_bins, self.depth_min, self.depth_max))

    def forward(self, batch_dict):
        P = batch_dict["trans_lidar_to_cam_img"]
        feats, logits = self.ddn(batch_dict["images"])   # (B, hf, wf, C), (B, hl, wl, D)
        B, hf, wf, C = feats.shape
        hl, wl, D = logits.shape[1:]
        nx, ny, nz = self.grid

        # frustum to voxels, over the grid in (y, x, z) order
        u, v, depth = project(self.centre_x[None, None, :, None],
                              self.centre_y[None, :, None, None],
                              self.centre_z[None, None, None, :], P)   # (B, ny, nx, nz)
        u, v, depth_ok, dbin = self._image_coords(u, v, depth)
        inside = ((u >= 0) & (u < wf) & (v >= 0) & (v < hf) & depth_ok).reshape(B, -1)
        ui = torch.clamp(u.to(torch.int32), 0, wf - 1).reshape(B, -1).long()
        vi = torch.clamp(v.to(torch.int32), 0, hf - 1).reshape(B, -1).long()
        prob = torch.softmax(logits, dim=-1).reshape(B, -1)
        p = torch.gather(prob, 1, (vi * wl + ui) * D + dbin.reshape(B, -1).long())
        p = torch.where(inside, p, torch.zeros((), dtype=p.dtype, device=p.device))
        rows = torch.arange(B, device=ui.device)[:, None] * (hf * wf) + vi * wf + ui
        f = feats.reshape(B * hf * wf, C).index_select(0, rows.reshape(-1))
        vox = (f.view(B, -1, C) * p[..., None]).view(B, ny, nx, nz, C)
        vox = vox.permute(0, 2, 1, 3, 4)                            # (B, nx, ny, nz, C)
        batch_dict["voxel_features_dense"] = vox
        batch_dict["spatial_features_3d"] = vox
        batch_dict["voxels_in_frustum"] = inside.sum(1)
        if self.training and "points" in batch_dict:
            batch_dict["loss_depth"] = self.depth_loss(batch_dict, logits, hf, wf)
        return batch_dict

    def depth_loss(self, batch_dict, logits, hf, wf):
        """The focal depth loss of the points' projections (JAX
        image_vfe.py:105-165): each point in the image and the depth range is
        a target, its bin under the logits at its pixel; (1 - pt)^2 * nll.
        With gt_boxes2d, points whose pixel (times the stride) lies in a
        valid 2D box weigh FG_WEIGHT and the others BG_WEIGHT; the fg and bg
        sums each divide by the batch's supervised count (a global sum in a
        multi-process run, the sums a rank's part scaled)."""
        pts = batch_dict["points"][..., :3]
        B, N = pts.shape[:2]
        pmask = batch_dict.get("points_mask")
        if pmask is None:
            pmask = torch.ones((B, N), dtype=torch.bool, device=pts.device)
        u, v, depth = project(pts[..., 0], pts[..., 1], pts[..., 2],
                              batch_dict["trans_lidar_to_cam_img"])
        u, v, depth_ok, bins = self._image_coords(u, v, depth)
        us, vs = u.to(torch.int32), v.to(torch.int32)
        ok = pmask & (us >= 0) & (us < wf) & (vs >= 0) & (vs < hf) & depth_ok
        hl, wl, D = logits.shape[1:]
        cell = torch.clamp(vs, 0, hf - 1).long() * wl + torch.clamp(us, 0, wf - 1).long()
        at = torch.gather(logits.reshape(B, hl * wl, D), 1, cell[..., None].expand(-1, -1, D))
        logp = F.log_softmax(at, dim=-1)
        nll = -torch.gather(logp, -1, bins.long()[..., None])[..., 0]
        pt = torch.exp(-nll)
        focal = ((1 - pt) ** 2) * nll
        total = torch.clamp(comm.global_sum(ok.sum().to(focal.dtype)), min=1.0)
        if "gt_boxes2d" not in batch_dict:
            return comm.scale_to_global((focal * ok).sum()) / total
        b2d = batch_dict["gt_boxes2d"]
        b2m = batch_dict.get("gt_boxes2d_mask")
        if b2m is None:
            b2m = (b2d != 0).any(-1)
        ds = self.downsample_factor
        uf = us.to(b2d.dtype)[..., None] * ds
        vf = vs.to(b2d.dtype)[..., None] * ds
        inb = ((uf >= b2d[:, None, :, 0]) & (uf < b2d[:, None, :, 2])
               & (vf >= b2d[:, None, :, 1]) & (vf < b2d[:, None, :, 3])
               & b2m[:, None, :]).any(-1)
        fg, bg = inb & ok, ~inb & ok
        return (comm.scale_to_global((focal * fg * self.fg_weight).sum()) / total
                + comm.scale_to_global((focal * bg * self.bg_weight).sum()) / total)
