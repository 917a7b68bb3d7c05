"""GT-database sampling ("copy-paste") augmentation (counterpart of
tsm_det_pointcloud_tpu/datasets/augmentor/database_sampler.py).

Loads per-class pools of cropped gt objects (points + box), pastes a fixed
number per class into the scene, rejecting placements whose BEV hull
overlaps a box already there, optionally rests them on the road plane, and
removes the scene's points inside the pasted boxes.

One deliberate change: a group's draw is a function of the sample's
generator alone. The JAX sampler walks one permutation of a pool across the
samples a process loads and draws a new one when the walk runs out, so that
with a pool over twice a group's draw a sample's objects depend on which
samples the same worker loaded before it: on the worker count. Here every
call draws its permutation from the sample's generator and takes its head,
which is what the JAX sampler does on every call once the pool is at most
twice the draw (the case the tests hold the two against).

`USE_SHARED_MEMORY` (the JAX sampler's global-npy route): the objects'
points are one array, the single DB_DATA_PATH npy, published once to shared
memory (`datasets.shared_memory`) and mapped by every loader worker; each db
info's `global_data_offset` [start, end) names its rows. Where shared memory
is missing the sampler reads the per-object files, as the JAX one does.
`clean_shared_memory()` removes the published array. Every process of a
multi-process run publishes it where it is missing (`shared_memory.sa_create`
renames a finished file into place, so racing ranks leave one whole copy)
and reads it at once; the caller removes it after a barrier, once no rank
reads it.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...ops import boxes as box_ops
from .. import shared_memory as shm


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger

        self.db_infos = {c: [] for c in class_names}
        for db_info_path in sampler_cfg.DB_INFO_PATH:
            path = self.root_path / db_info_path
            if not path.exists():
                if logger is not None:
                    logger.warning("db info missing: %s" % path)
                continue
            with open(path, "rb") as f:
                infos = pickle.load(f)
                for cur_class in class_names:
                    if cur_class in infos:
                        self.db_infos[cur_class].extend(infos[cur_class])

        for func_name, val in sampler_cfg.get("PREPARE", {}).items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.use_shared_memory = sampler_cfg.get("USE_SHARED_MEMORY", False)
        self.gt_database_data_key = None
        if self.use_shared_memory:
            db_data_paths = list(sampler_cfg.get("DB_DATA_PATH", []))
            assert len(db_data_paths) == 1, "single DB_DATA_PATH supported"
            if shm.available():
                key = db_data_paths[0]
                if not shm.sa_exists(key):
                    shm.sa_create(key, np.load(self.root_path / db_data_paths[0]))
                self.gt_database_data_key = key
            else:
                self.use_shared_memory = False

        self.use_road_plane = sampler_cfg.get("USE_ROAD_PLANE", False)
        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)
        self.sample_class_num = {}
        for x in sampler_cfg.SAMPLE_GROUPS:
            class_name, sample_num = x.split(":")
            class_name = class_name.strip()
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = int(sample_num)

    def clean_shared_memory(self):
        if self.gt_database_data_key:
            shm.sa_delete(self.gt_database_data_key)

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        new_db_infos = {}
        for key, dinfos in db_infos.items():
            new_db_infos[key] = [
                info for info in dinfos if info["difficulty"] not in removed_difficulty
            ]
        return new_db_infos

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(":")
            name, min_num = name.strip(), int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [
                    info for info in db_infos[name]
                    if info["num_points_in_gt"] >= min_num
                ]
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_num, rng):
        """The head of a permutation of the class's pool drawn from `rng`
        (see the module docstring)."""
        pool = self.db_infos[class_name]
        if len(pool) == 0:
            return []
        return [pool[i] for i in rng.permutation(len(pool))[:sample_num]]

    @staticmethod
    def put_boxes_on_road_planes(gt_boxes, road_planes, calib):
        """Shift sampled boxes down/up so they rest on the road plane
        Plane: ax+by+cz+d=0 in the camera frame; the height goes through
        calib lidar->rect."""
        a, b, c, d = road_planes
        center_cam = calib.lidar_to_rect(gt_boxes[:, 0:3])
        cur_height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
        center_cam[:, 1] = cur_height_cam
        cur_lidar_height = calib.rect_to_lidar(center_cam)[:, 2]
        mv_height = gt_boxes[:, 2] - gt_boxes[:, 5] / 2 - cur_lidar_height
        gt_boxes = gt_boxes.copy()
        gt_boxes[:, 2] -= mv_height
        return gt_boxes, mv_height

    def __call__(self, data_dict, rng):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"]
        points = data_dict["points"]
        existed_boxes = gt_boxes

        sampled_infos_all, sampled_boxes_all = [], []
        for class_name, sample_num in self.sample_class_num.items():
            if self.limit_whole_scene:
                num_gt = int(np.sum(gt_names == class_name))
                sample_num = max(0, sample_num - num_gt)
            if sample_num <= 0:
                continue
            sampled = self.sample_with_fixed_number(class_name, sample_num, rng)
            if not sampled:
                continue
            sampled_boxes = np.stack(
                [x["box3d_lidar"] for x in sampled], axis=0
            ).astype(np.float32)

            # reject samples whose axis-aligned BEV hull overlaps a box
            # already there or kept before (the JAX sampler's test)
            all_prev = (
                np.concatenate([existed_boxes] + sampled_boxes_all, axis=0)
                if sampled_boxes_all
                else existed_boxes
            )
            keep = []
            for i, box in enumerate(sampled_boxes):
                if all_prev.shape[0] == 0:
                    ok = True
                else:
                    ious = _bev_iou_np(box[None, :7], all_prev[:, :7])
                    ok = float(ious.max()) < 1e-3
                if ok and not any(
                    _bev_iou_np(box[None, :7], sampled_boxes[j][None, :7]).max() > 1e-3
                    for j in keep
                ):
                    keep.append(i)
            if not keep:
                continue
            sampled_infos_all.extend([sampled[i] for i in keep])
            sampled_boxes_all.append(sampled_boxes[keep])

        if not sampled_infos_all:
            return data_dict

        sampled_boxes = np.concatenate(sampled_boxes_all, axis=0)
        if self.use_road_plane and "road_plane" in data_dict:
            sampled_boxes, mv_height = self.put_boxes_on_road_planes(
                sampled_boxes, data_dict["road_plane"], data_dict["calib"]
            )
        else:
            mv_height = np.zeros(sampled_boxes.shape[0], np.float32)

        db_data = None
        if self.use_shared_memory and self.gt_database_data_key:
            db_data = shm.sa_attach(self.gt_database_data_key, copy=False)

        obj_points_list = []
        for info, box, mh in zip(sampled_infos_all, sampled_boxes, mv_height):
            num_feats = self.sampler_cfg.get("NUM_POINT_FEATURES", 4)
            if db_data is not None:
                start, end = (int(x) for x in info["global_data_offset"])
                obj_points = np.array(db_data[start:end], np.float32).reshape(-1, num_feats)
            else:
                file_path = self.root_path / info["path"]
                obj_points = np.fromfile(
                    str(file_path), dtype=np.float32
                ).reshape(-1, num_feats).copy()
            obj_points[:, :3] += info["box3d_lidar"][:3].astype(np.float32)
            obj_points[:, 2] -= mh
            obj_points_list.append(obj_points)

        obj_points = np.concatenate(obj_points_list, axis=0)
        sampled_names = np.array([x["name"] for x in sampled_infos_all])

        # carve out original points occluded by the pasted objects
        points = box_ops.remove_points_in_boxes3d_np(points, sampled_boxes[:, :7])
        data_dict["points"] = np.concatenate([obj_points[:, : points.shape[1]], points], axis=0)
        data_dict["gt_boxes"] = np.concatenate([gt_boxes, sampled_boxes[:, : gt_boxes.shape[1]]], axis=0)
        data_dict["gt_names"] = np.concatenate([gt_names, sampled_names], axis=0)
        if "gt_boxes_mask" in data_dict:
            data_dict["gt_boxes_mask"] = np.concatenate(
                [data_dict["gt_boxes_mask"], np.ones(len(sampled_names), bool)]
            )
        return data_dict


def _bev_iou_np(boxes_a, boxes_b):
    """Cheap axis-aligned-hull BEV IoU for placement rejection (sampled
    placements only need the ==0 test; the hull test is conservative)."""
    aa = box_ops.boxes3d_lidar_to_aligned_bev_np(boxes_a)
    bb = box_ops.boxes3d_lidar_to_aligned_bev_np(boxes_b)
    lt = np.maximum(aa[:, None, :2], bb[None, :, :2])
    rb = np.minimum(aa[:, None, 2:], bb[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (aa[:, 2] - aa[:, 0]) * (aa[:, 3] - aa[:, 1])
    area_b = (bb[:, 2] - bb[:, 0]) * (bb[:, 3] - bb[:, 1])
    return inter / np.clip(area_a[:, None] + area_b[None] - inter, 1e-6, None)
