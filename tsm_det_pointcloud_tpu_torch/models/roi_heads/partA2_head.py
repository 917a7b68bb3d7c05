"""Part-A2's RoI head and RoI-aware pooling (counterpart of
tsm_det_pointcloud_tpu/models/roi_heads/partA2_head.py).

`roiaware_pool` puts each valid point into the cell of a G x G x G grid of
every RoI that contains it, and pools each cell: the average or the maximum
of its points' features, 0 for an empty cell. The JAX package repeats every
point for every RoI, (N * R, C), and segment-reduces; here the containment
test runs on the (N, R) grid without a gradient, its (point, RoI) pairs are
compacted (`nonzero`) and only they are gathered and scatter-reduced: the
same maximum exactly, the same average within f32 summation order. The
maximum's gradient splits evenly among a cell's tied points, as
`segment_max`'s does (`scatter_reduce("amax")` from -inf).

`PartA2FCHead`: proposals and, in training, targets from the template; the
part offsets average-pooled and the score-weighted segmentation features
max-pooled into POOL_SIZE^3 cells a RoI; the flattened grid through
SHARED_FC (Dense without bias, BN masked by the RoIs' validity, ReLU), then
the CLS_FC and REG_FC SharedMLPs and the `cls_out` (1) and `reg_out` (7)
Denses. Module names follow the flax ones. As in the JAX head, the FC stack
stands where the reference runs sparse convs over the pooled grid, every
RoI is pooled (not only the sampled ones) and the BN statistics count every
valid RoI; DP_RATIO, DISABLE_PART, SEG_MASK_SCORE_THRESH and the pool's
MAX_POINTS_PER_VOXEL are read nowhere.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.boxes import in_box_frame
from ..backbones_3d.pointnet2_modules import SharedMLP
from . import roi_head_template as tmpl


def roiaware_cells(points_xyz, point_valid, rois, grid_size):
    """The (point, RoI) pairs of one scan where the RoI holds the valid
    point, and each pair's cell: (point index (P,), cell row r * G^3 + cell
    (P,)), int64, with cell = (ix * G + iy) * G + iz."""
    G = grid_size
    with torch.no_grad():
        local = in_box_frame(points_xyz, rois)                       # (N, R, 3)
        half = rois[:, 3:6] * 0.5
        inside = (local.abs() <= half[None]).all(-1) & point_valid[:, None]
        n_idx, r_idx = torch.nonzero(inside, as_tuple=True)
        loc = local[n_idx, r_idx]
        size = torch.clamp(rois[r_idx, 3:6], min=1e-5)
        frac = torch.clamp(loc / size + 0.5, 0.0, 1.0 - 1e-6)
        cell = (frac * G).to(torch.int64)
        cell_id = (cell[:, 0] * G + cell[:, 1]) * G + cell[:, 2]
    return n_idx, r_idx * G ** 3 + cell_id


def roiaware_pool(points_xyz, feats, point_valid, rois, grid_size, pool="max", cells=None):
    """points (N, 3), feats (N, C), point_valid (N,), rois (R, 7) -> (R,
    G^3, C): each cell's maximum ("max") or average ("avg") of the features
    of the valid points in it, 0 where it is empty. `cells`: the scan's
    `roiaware_cells`, when the caller pools twice over one set of RoIs."""
    R, G, C = rois.shape[0], grid_size, feats.shape[-1]
    n_idx, row = cells if cells is not None else roiaware_cells(points_xyz, point_valid,
                                                                rois, grid_size)
    src = feats[n_idx]
    if pool == "max":
        # from -inf, as segment_max: the backward counts a tie with the
        # initial value even with include_self=False, so it must never tie
        out = feats.new_full((R * G ** 3, C), -float("inf")).scatter_reduce(
            0, row[:, None].expand(-1, C), src, "amax", include_self=False)
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    else:
        cnt = feats.new_zeros((R * G ** 3,)).index_add_(0, row, torch.ones_like(row,
                                                                             dtype=feats.dtype))
        out = feats.new_zeros((R * G ** 3, C)).index_add(0, row, src) / torch.clamp(
            cnt, min=1.0)[:, None]
    return out.reshape(R, G ** 3, C)


class PartA2FCHead(tmpl.RoIHeadTemplate):
    def __init__(self, model_cfg, input_channels, num_class=1):
        super().__init__()
        self.model_cfg = model_cfg
        self.pool_size = int(model_cfg["ROI_AWARE_POOL"]["POOL_SIZE"])
        self.n_shared = len(model_cfg["SHARED_FC"])
        c = tmpl.fc_stack(self, "shared", self.pool_size ** 3 * (3 + int(input_channels)),
                          model_cfg["SHARED_FC"])
        self.cls_fc = SharedMLP(c, model_cfg["CLS_FC"])
        self.cls_out = nn.Linear(([c] + self.cls_fc.channels)[-1], 1)
        self.reg_fc = SharedMLP(c, model_cfg["REG_FC"])
        self.reg_out = nn.Linear(([c] + self.reg_fc.channels)[-1], 7)

    def rcnn(self, batch_dict, rois, roi_valid):
        g = self.pool_size
        seg = batch_dict["point_features"]
        if batch_dict.get("point_cls_scores") is not None:
            seg = seg * batch_dict["point_cls_scores"][..., None]
        pooled = []
        for p, f, part, v, r in zip(batch_dict["point_coords"], seg,
                                    batch_dict["point_part_offset"], batch_dict["point_valid"],
                                    rois):
            cells = roiaware_cells(p, v, r, g)
            pooled.append(torch.cat([roiaware_pool(p, part, v, r, g, "avg", cells),
                                     roiaware_pool(p, f, v, r, g, "max", cells)], -1))
        x = torch.stack(pooled)
        h = tmpl.run_fc_stack(self, "shared", self.n_shared, x.reshape(*x.shape[:2], -1),
                              roi_valid)
        return (self.cls_out(self.cls_fc(h, roi_valid))[..., 0],
                self.reg_out(self.reg_fc(h, roi_valid)))
