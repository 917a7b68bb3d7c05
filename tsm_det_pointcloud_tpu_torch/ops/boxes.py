"""Box geometry needed by the ported path (counterpart of
tsm_det_pointcloud_tpu/ops/boxes.py:30-134). Boxes are (x, y, z, dx, dy,
dz, heading), (x, y, z) the box centre, heading CCW about +z. The functions
take any leading batch axes (the JAX versions are per sample and vmapped by
their callers)."""
from __future__ import annotations

import torch

# the reference corner template (pcdet box_utils.boxes_to_corners_3d)
_CORNER_TEMPLATE = ((1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
                    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1))
# the first four corners of the template, xy only
_BEV_TEMPLATE = ((0.5, 0.5), (0.5, -0.5), (-0.5, -0.5), (-0.5, 0.5))


def rotate_points_along_z(points, angle):
    """Rotate (..., P, 3+) points by (...,) angles about z, CCW
    (counterpart of utils/common_utils.py:44 of the JAX package)."""
    cosa = torch.cos(angle)[..., None]
    sina = torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    xn = x * cosa - y * sina
    yn = x * sina + y * cosa
    return torch.cat([xn[..., None], yn[..., None], points[..., 2:]], -1)


def boxes_to_corners_3d(boxes3d):
    """(..., 7[+]) boxes -> (..., 8, 3) corners."""
    template = torch.tensor(_CORNER_TEMPLATE, dtype=boxes3d.dtype,
                            device=boxes3d.device) / 2.0
    corners = boxes3d[..., None, 3:6] * template
    corners = rotate_points_along_z(corners, boxes3d[..., 6])
    return corners + boxes3d[..., None, 0:3]


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


def in_box_frame(points, boxes):
    """(..., N, 3) points into each of (..., M, 7) boxes' local frames:
    (..., N, M, 3), box centre at the origin, axes along the box."""
    rel = points[..., :, None, :3] - boxes[..., None, :, 0:3]
    cosa = torch.cos(-boxes[..., 6])[..., None, :]
    sina = torch.sin(-boxes[..., 6])[..., None, :]
    x = rel[..., 0] * cosa - rel[..., 1] * sina
    y = rel[..., 0] * sina + rel[..., 1] * cosa
    return torch.stack([x, y, rel[..., 2]], -1)


def points_in_boxes_mask(points, boxes, extra_width=None):
    """(..., N, 3+) points x (..., M, 7) boxes -> (..., N, M) containment."""
    local = in_box_frame(points, boxes)
    half = boxes[..., 3:6] * 0.5
    if extra_width is not None:
        half = half + torch.tensor(extra_width, dtype=half.dtype,
                                   device=half.device) * 0.5
    return (local.abs() <= half[..., None, :, :]).all(-1)


def points_in_boxes(points, boxes, extra_width=None, valid_mask=None):
    """First box index containing each point, -1 for background; a point
    in several boxes takes the lowest index. valid_mask (..., M) excludes
    padded boxes."""
    mask = points_in_boxes_mask(points, boxes, extra_width)
    if valid_mask is not None:
        mask = mask & valid_mask[..., None, :]
    first = torch.argmax(mask.to(torch.uint8), dim=-1)
    return torch.where(mask.any(-1), first, torch.full_like(first, -1))


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    """Grow dx / dy / dz by extra_width."""
    extra = torch.tensor(extra_width, dtype=boxes3d.dtype, device=boxes3d.device)
    return torch.cat([boxes3d[..., :3], boxes3d[..., 3:6] + extra,
                      boxes3d[..., 6:]], -1)
