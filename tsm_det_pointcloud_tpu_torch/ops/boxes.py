"""Box geometry needed by the ported path (counterpart of
tsm_det_pointcloud_tpu/ops/boxes.py). Boxes are (x, y, z, dx, dy, dz,
heading), (x, y, z) the box centre, heading CCW about +z."""
from __future__ import annotations

import torch

# the first four corners of the reference template, xy only
_BEV_TEMPLATE = ((0.5, 0.5), (0.5, -0.5), (-0.5, -0.5), (-0.5, 0.5))


def boxes_to_corners_bev(boxes3d):
    """(N, 7[+]) boxes -> (N, 4, 2) BEV corners in a consistent winding."""
    template = torch.tensor(_BEV_TEMPLATE, dtype=boxes3d.dtype,
                            device=boxes3d.device)
    corners = boxes3d[:, None, 3:5] * template[None]
    cosa = torch.cos(boxes3d[:, 6])[:, None]
    sina = torch.sin(boxes3d[:, 6])[:, None]
    x = corners[..., 0] * cosa - corners[..., 1] * sina
    y = corners[..., 0] * sina + corners[..., 1] * cosa
    return torch.stack([x, y], dim=-1) + boxes3d[:, None, 0:2]
