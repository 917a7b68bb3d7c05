"""Box geometry needed by the ported path (counterpart of
tsm_det_pointcloud_tpu/ops/boxes.py). Boxes are (x, y, z, dx, dy, dz,
heading), (x, y, z) the box centre, heading CCW about +z. The torch
functions take any leading batch axes (the JAX versions are per sample and
vmapped by their callers); the `_np` functions are the host data
pipeline's numpy twins."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.common_utils import rotate_points_along_z_np

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


# ---------------------------------------------------------------------------
# numpy twins for the host data pipeline (counterparts of the JAX ops/boxes.py
# :39-229): gt-database creation, the augmentors, KITTI camera <-> lidar boxes
# ---------------------------------------------------------------------------

_CORNER_TEMPLATE_NP = np.array(_CORNER_TEMPLATE, dtype=np.float32) / 2.0

# below this many (point, box) pairs points_in_boxes_np runs its numpy body,
# above it the host library (ops/host_native.py), as the JAX package does
HOST_NATIVE_MIN_PAIRS = 1 << 14


def boxes_to_corners_3d_np(boxes3d: np.ndarray) -> np.ndarray:
    corners = boxes3d[:, None, 3:6] * _CORNER_TEMPLATE_NP[None]
    corners = rotate_points_along_z_np(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def points_in_boxes_np(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3+) points x (M, 7) boxes -> (N,) int64 index of the first box
    that holds each point, -1 for none. From HOST_NATIVE_MIN_PAIRS pairs on
    it runs the host library (float64, OpenMP), below that its numpy body
    (`points_in_boxes_np_plain`), the same split as the JAX package's."""
    if boxes.shape[0] == 0:
        return np.full(points.shape[0], -1, dtype=np.int64)
    if points.shape[0] * boxes.shape[0] >= HOST_NATIVE_MIN_PAIRS:
        from . import host_native

        return host_native.points_in_boxes(points, boxes)
    return points_in_boxes_np_plain(points, boxes)


def points_in_boxes_np_plain(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """The numpy body of points_in_boxes_np (the host library's plain
    version)."""
    if boxes.shape[0] == 0:
        return np.full(points.shape[0], -1, dtype=np.int64)
    rel = points[:, None, :3] - boxes[None, :, 0:3]
    cosa, sina = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    x = rel[..., 0] * cosa[None] - rel[..., 1] * sina[None]
    y = rel[..., 0] * sina[None] + rel[..., 1] * cosa[None]
    local = np.stack([x, y, rel[..., 2]], axis=-1)
    mask = np.all(np.abs(local) <= boxes[None, :, 3:6] * 0.5, axis=-1)
    any_hit = mask.any(axis=-1)
    first = mask.argmax(axis=-1)
    return np.where(any_hit, first, -1).astype(np.int64)


def mask_boxes_outside_range_np(boxes: np.ndarray, limit_range, min_num_corners=1) -> np.ndarray:
    """Keep boxes with >= min_num_corners BEV corners inside the range."""
    if boxes.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    if boxes.shape[1] > 7:
        boxes = boxes[:, :7]
    corners = boxes_to_corners_3d_np(boxes)  # (N, 8, 3)
    inside = ((corners[..., :2] >= np.array(limit_range[0:2])) &
              (corners[..., :2] <= np.array(limit_range[3:5]))).all(axis=-1)
    return inside.sum(axis=-1) >= min_num_corners


def remove_points_in_boxes3d_np(points: np.ndarray, boxes3d: np.ndarray) -> np.ndarray:
    idx = points_in_boxes_np(points, boxes3d)
    return points[idx < 0]


def boxes3d_lidar_to_aligned_bev_np(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 4) axis-aligned BEV [x1, y1, x2, y2] bounding the
    rotated box."""
    corners = boxes_to_corners_3d_np(boxes3d)[:, :4, :2]
    mins, maxs = corners.min(axis=1), corners.max(axis=1)
    return np.concatenate([mins, maxs], axis=-1)


def boxes3d_kitti_camera_to_lidar(boxes3d_camera: np.ndarray, calib) -> np.ndarray:
    """(N, 7) [x, y, z, l, h, w, ry] camera/rect -> (N, 7) lidar
    [x, y, z, dx(l), dy(w), dz(h), heading]."""
    boxes3d_camera = boxes3d_camera.copy()
    xyz_camera = boxes3d_camera[:, 0:3]
    l, h, w, r = (
        boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5],
        boxes3d_camera[:, 5:6], boxes3d_camera[:, 6:7],
    )
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(np.pi / 2 + r)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar: np.ndarray, calib) -> np.ndarray:
    """(N, 7) lidar -> (N, 7) [x, y, z, l, h, w, ry] camera (bottom centre)."""
    boxes3d_lidar = boxes3d_lidar.copy()
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    l, w, h, r = (
        boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5],
        boxes3d_lidar[:, 5:6], boxes3d_lidar[:, 6:7],
    )
    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    r_cam = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r_cam], axis=-1)


def boxes3d_kitti_camera_to_imageboxes(boxes3d: np.ndarray, calib,
                                       image_shape=None) -> np.ndarray:
    """(N, 7) camera boxes -> (N, 4) [x1, y1, x2, y2] image boxes."""
    if boxes3d.shape[0] == 0:
        return np.zeros((0, 4), np.float32)
    corners3d = _boxes3d_camera_corners(boxes3d)
    pts_img, _ = calib.corners3d_to_img_boxes(corners3d)
    boxes2d = pts_img
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], a_min=0, a_max=image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], a_min=0, a_max=image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], a_min=0, a_max=image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], a_min=0, a_max=image_shape[0] - 1)
    return boxes2d


def _boxes3d_camera_corners(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) camera boxes [x,y,z,l,h,w,ry] -> (N, 8, 3) rect corners
    (bottom-centre origin, y down)."""
    n = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_c = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32) / 2
    y_c = np.array([0, 0, 0, 0, -1, -1, -1, -1], np.float32)
    z_c = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32) / 2
    corners = np.stack(
        [x_c[None] * l[:, None], y_c[None] * h[:, None], z_c[None] * w[:, None]],
        axis=-1,
    )  # (N, 8, 3)
    ry = boxes3d[:, 6]
    c, s = np.cos(ry), np.sin(ry)
    rot = np.stack(
        [c, np.zeros_like(c), s, np.zeros_like(c), np.ones_like(c),
         np.zeros_like(c), -s, np.zeros_like(c), c], axis=-1
    ).reshape(n, 3, 3)
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return corners + boxes3d[:, None, 0:3]
