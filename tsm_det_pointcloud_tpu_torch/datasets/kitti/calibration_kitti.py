"""KITTI camera calibration (counterpart of
tsm_det_pointcloud_tpu/datasets/kitti/calibration_kitti.py).

The calib file is parsed by key; the rect <-> lidar chain is one
precomputed 4x4 product. Frames: `lidar` (velodyne), `rect` (rectified
camera 0), `img` (pixels of camera 2): rect = R0 @ (Tr_velo_to_cam @ lidar),
img ~ P2 @ rect.
"""
from __future__ import annotations

import numpy as np

# calib-file keys -> canonical names used throughout the codebase
_KEYS = {"P2": "P2", "P3": "P3", "R0_rect": "R0", "Tr_velo_to_cam": "Tr_velo2cam"}
_SHAPES = {"P2": (3, 4), "P3": (3, 4), "R0": (3, 3), "Tr_velo2cam": (3, 4)}


def _as_hom4(m):
    """Embed a (3,3) or (3,4) matrix into a 4x4 homogeneous transform."""
    out = np.eye(4, dtype=np.float32)
    out[:3, : m.shape[1]] = m
    return out


def get_calib_from_file(calib_file):
    """Parse a KITTI calib txt into {P2, P3, R0, Tr_velo2cam} float32 arrays."""
    entries = {}
    with open(calib_file) as f:
        for line in f:
            key, _, values = line.partition(":")
            key = key.strip()
            if key in _KEYS:
                name = _KEYS[key]
                entries[name] = np.fromstring(
                    values, dtype=np.float32, sep=" "
                ).reshape(_SHAPES[name])
    missing = set(_SHAPES) - set(entries)
    if missing:
        raise ValueError(f"{calib_file}: missing calib entries {sorted(missing)}")
    return entries


def _hom(pts):
    """(N, D) -> (N, D+1) with a trailing column of ones."""
    return np.concatenate(
        [pts, np.ones_like(pts[..., :1], dtype=np.float32)], axis=-1
    )


class Calibration:
    """Holds the per-frame projection matrices and converts between frames.

    Accepts a calib-file path or a pre-parsed dict (see get_calib_from_file).
    """

    def __init__(self, calib_file):
        calib = (
            get_calib_from_file(calib_file)
            if isinstance(calib_file, str)
            else calib_file
        )
        self.P2 = calib["P2"]  # (3, 4) camera-2 projection
        self.R0 = calib["R0"]  # (3, 3) rectifying rotation
        self.V2C = calib["Tr_velo2cam"]  # (3, 4) velodyne -> camera-0

        # lidar -> rect as one homogeneous matrix (and its inverse)
        self._lidar_to_rect_4x4 = _as_hom4(self.R0) @ _as_hom4(self.V2C)
        self._rect_to_lidar_4x4 = np.linalg.inv(self._lidar_to_rect_4x4)

        # intrinsics of camera 2 (principal point, focal lengths, baseline)
        (self.fu, _, self.cu, bx), (_, self.fv, self.cv, by) = self.P2[:2]
        self.tx = bx / -self.fu
        self.ty = by / -self.fv

    # -- frame conversions ---------------------------------------------------

    def cart_to_hom(self, pts):
        return _hom(pts)

    def rect_to_lidar(self, pts_rect):
        return (_hom(pts_rect) @ self._rect_to_lidar_4x4.T)[:, :3]

    def lidar_to_rect(self, pts_lidar):
        return (_hom(pts_lidar) @ self._lidar_to_rect_4x4.T)[:, :3]

    def rect_to_img(self, pts_rect):
        """rect -> (pixel coords (N,2), depth along the camera-2 axis (N,))."""
        proj = _hom(pts_rect) @ self.P2.T  # (N, 3) homogeneous pixels
        pts_img = proj[:, :2] / proj[:, 2:3]
        # P2[2, 3] shifts the projective depth off the rect-frame z; remove it
        depth = proj[:, 2] - self.P2[2, 3]
        return pts_img, depth

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        """Back-project pixels at known rect depth -> (N, 3) rect points."""
        x = (np.asarray(u) - self.cu) * depth_rect / self.fu + self.tx
        y = (np.asarray(v) - self.cv) * depth_rect / self.fv + self.ty
        return np.stack(
            [x.reshape(-1), y.reshape(-1), np.asarray(depth_rect).reshape(-1)],
            axis=1,
        )

    def corners3d_to_img_boxes(self, corners3d):
        """(N, 8, 3) rect corners -> ((N, 4) xyxy image boxes, (N, 8, 2))."""
        proj = _hom(corners3d) @ self.P2.T  # (N, 8, 3)
        uv = proj[..., :2] / proj[..., 2:3]
        boxes = np.concatenate([uv.min(axis=1), uv.max(axis=1)], axis=1)
        return boxes, uv
