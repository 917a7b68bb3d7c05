"""Config-driven point-cloud processing queue on the host, numpy
(counterpart of tsm_det_pointcloud_tpu/datasets/processor/data_processor.py).

`transform_points_to_voxels` and `repository_info` voxelize nothing: the
models voxelize on the card (ops/voxel.py, the TSM backbone's centroids), so
the host ships a fixed-size point tensor and these steps record the grid
geometry (grid_size, voxel_size, voxel limits) the model builder reads
(`models.meta_from_dataset`). `sample_points` splits the points at 40 m
depth and keeps every far point it can (:76 of the JAX module). CaDDN's
steps: `calculate_grid_size` records its grid, and `downsample_depth_map`
block-averages a sample's `depth_maps` (no ported dataset writes one yet).
"""
from __future__ import annotations

from functools import partial

import numpy as np

from ...ops.boxes import mask_boxes_outside_range_np
from ...utils.common_utils import mask_points_by_range_np


class DataProcessor:
    # the steps of the configs (kitti_dataset.yaml, fast_cpc*.yaml, second.yaml,
    # CaDDN.yaml, ...): every step of the JAX module
    PORTED = ("mask_points_and_boxes_outside_range", "shuffle_points",
              "transform_points_to_voxels", "sample_points", "repository_info",
              "downsample_depth_map", "calculate_grid_size")

    def __init__(self, processor_configs, point_cloud_range, training,
                 num_point_features):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.grid_size = self.voxel_size = None
        self.max_voxels = None
        self.max_points_per_voxel = None
        self.num_sampled_points = None
        self.depth_downsample_factor = None
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            if cur_cfg.NAME not in self.PORTED:
                raise NotImplementedError(f"data processor {cur_cfg.NAME} is not ported")
            self.data_processor_queue.append(
                getattr(self, cur_cfg.NAME)(config=cur_cfg)
            )

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        mask = mask_points_by_range_np(data_dict["points"], self.point_cloud_range)
        data_dict["points"] = data_dict["points"][mask]
        if data_dict.get("gt_boxes", None) is not None and config.REMOVE_OUTSIDE_BOXES and self.training:
            box_mask = mask_boxes_outside_range_np(
                data_dict["gt_boxes"], self.point_cloud_range,
                min_num_corners=config.get("min_num_corners", 1),
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][box_mask]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][box_mask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config.SHUFFLE_ENABLED[self.mode]:
            idx = (rng or np.random.default_rng()).permutation(
                data_dict["points"].shape[0]
            )
            data_dict["points"] = data_dict["points"][idx]
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None, rng=None):
        """Records the voxel grid; the model voxelizes on the card (see the
        module docstring)."""
        if data_dict is None:
            self.voxel_size = np.asarray(config.VOXEL_SIZE, np.float32)
            gsz = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / self.voxel_size
            self.grid_size = np.round(gsz).astype(np.int64)
            self.max_points_per_voxel = config.MAX_POINTS_PER_VOXEL
            mv = config.MAX_NUMBER_OF_VOXELS
            self.max_voxels = mv[self.mode] if isinstance(mv, dict) else mv
            return partial(self.transform_points_to_voxels, config=config)
        return data_dict

    def sample_points(self, data_dict=None, config=None, rng=None):
        """Fixed-size sampling that keeps the far points (depth >= 40 m)
        first; fewer points than NUM_POINTS are repeated."""
        if data_dict is None:
            self.num_sampled_points = config.NUM_POINTS[self.mode]
            return partial(self.sample_points, config=config)
        num_points = config.NUM_POINTS[self.mode]
        points = data_dict["points"]
        rng = rng or np.random.default_rng()
        if num_points < len(points):
            pts_depth = np.linalg.norm(points[:, 0:3], axis=1)
            far_idxs = np.where(pts_depth >= 40.0)[0]
            near_idxs = np.where(pts_depth < 40.0)[0]
            if num_points > len(far_idxs):
                near_choice = rng.choice(
                    near_idxs, num_points - len(far_idxs), replace=False
                )
                choice = (
                    np.concatenate((near_choice, far_idxs))
                    if len(far_idxs) > 0 else near_choice
                )
            else:
                choice = rng.choice(len(points), num_points, replace=False)
            rng.shuffle(choice)
        else:
            choice = np.arange(0, len(points), dtype=np.int64)
            if num_points > len(points) and len(points) > 0:
                extra = rng.choice(choice, num_points - len(points))
                choice = np.concatenate((choice, extra))
            rng.shuffle(choice)
        data_dict["points"] = points[choice]
        return data_dict

    def repository_info(self, data_dict=None, config=None, rng=None):
        """TSM: records the stride-FACTOR centroid grid's geometry; no
        voxelization."""
        if data_dict is None:
            self.voxel_size = np.asarray(config.VOXEL_SIZE, np.float32)
            factor = config.get("FACTOR", 1)
            gsz = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / (
                self.voxel_size * factor
            )
            self.grid_size = np.round(gsz).astype(np.int64)
            return partial(self.repository_info, config=config)
        return data_dict

    def downsample_depth_map(self, data_dict=None, config=None, rng=None):
        """The mean of each DOWNSAMPLE_FACTOR x DOWNSAMPLE_FACTOR block of the
        (H, W) depth map, edge blocks zero-padded (skimage's
        downscale_local_mean, as the JAX step computes it)."""
        if data_dict is None:
            self.depth_downsample_factor = int(config.DOWNSAMPLE_FACTOR)
            return partial(self.downsample_depth_map, config=config)
        f = self.depth_downsample_factor
        dm = np.asarray(data_dict["depth_maps"], np.float32)
        h, w = dm.shape[:2]
        ph, pw = (-h) % f, (-w) % f
        if ph or pw:
            dm = np.pad(dm, ((0, ph), (0, pw)))
        data_dict["depth_maps"] = dm.reshape((h + ph) // f, f, (w + pw) // f, f).mean(axis=(1, 3))
        return data_dict

    def calculate_grid_size(self, data_dict=None, config=None, rng=None):
        """Records the grid of VOXEL_SIZE over the range; changes no sample."""
        if data_dict is None:
            self.voxel_size = np.asarray(config.VOXEL_SIZE, np.float32)
            gsz = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / self.voxel_size
            self.grid_size = np.round(gsz).astype(np.int64)
            return partial(self.calculate_grid_size, config=config)
        return data_dict

    def forward(self, data_dict, rng=None):
        for processor in self.data_processor_queue:
            data_dict = processor(data_dict, rng=rng)
        return data_dict
