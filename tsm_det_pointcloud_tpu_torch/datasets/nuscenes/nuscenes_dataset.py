"""The nuScenes dataset (counterpart of
tsm_det_pointcloud_tpu/datasets/nuscenes/nuscenes_dataset.py).

Info pickles (`create_nuscenes_info`, from the JSON tables without the
devkit: `nuscenes_tables`), class-balanced resampling (CBGS,
arXiv:1908.09492; its draw from default_rng(0), as the JAX package's),
multi-sweep lidar: each of up to MAX_SWEEPS - 1 sweeps of the info read as
(x, y, z, intensity), the points within 1 m of the sensor in x and y
dropped, moved into the keyframe's sensor frame by its transform_matrix,
and every point given its sweep's time lag as a fifth column (0 for the
keyframe). Boxes are 9 columns (x, y, z, dx, dy, dz, heading, vx, vy); the
gt of fewer than FILTER_MIN_POINTS_IN_GT lidar points dropped,
SET_NAN_VELOCITY_TO_ZEROS zeroes the velocity of a box whose instance has
no neighbouring annotation, and PRED_VELOCITY False cuts the boxes to 7
columns + class. The evaluation is the official NDS (`eval.nuscenes_eval`),
or with eval_metric="waymo" the Waymo matcher (labelled as not NDS); the
gt database of copy-paste augmentation is cut from the MAX_SWEEPS cloud
(gt_database_<k>sweeps_withvelo, nuscenes_dbinfos_<k>sweeps_withvelo.pkl).

One deliberate change: the sweeps of a sample are drawn from a generator
spawned from the sample's generator (`self.rng`), where the JAX package
draws them from numpy's global state. A spawned child leaves the parent's
stream as it was, so the augmentors draw what the JAX package's draw, and
a sample stays a function of its (seed, epoch, index). Where an info holds
at most MAX_SWEEPS - 1 sweeps (a 10-sweep config on infos made with 10)
both take every sweep, and only the order of the points differs.

Infos and the gt database are made by
    python -m tsm_det_pointcloud_tpu_torch.datasets.nuscenes.nuscenes_dataset \\
        create_nuscenes_infos CFG DATA_PATH [VERSION]
(CFG a dataset config or a model config with a DATA_CONFIG; its MAX_SWEEPS
and VERSION, else v1.0-trainval), which writes under DATA_PATH/VERSION.
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ...ops import boxes as box_ops
from ..dataset import DatasetTemplate


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        root_path = (root_path if root_path is not None else Path(dataset_cfg.DATA_PATH))
        root_path = Path(root_path) / dataset_cfg.get("VERSION", "v1.0-trainval")
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                         root_path=root_path, logger=logger)
        self.infos = []
        self.include_nuscenes_data(self.mode)
        if self.training and self.dataset_cfg.get("BALANCED_RESAMPLING", False):
            self.infos = self.balanced_infos_resampling(self.infos)

    def include_nuscenes_data(self, mode):
        if self.logger:
            self.logger.info("Loading NuScenes dataset")
        infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            p = self.root_path / info_path
            if not p.exists():
                continue
            with open(p, "rb") as f:
                infos.extend(pickle.load(f))
        self.infos.extend(infos)
        if self.logger:
            self.logger.info("Total samples for NuScenes dataset: %d" % len(infos))

    def balanced_infos_resampling(self, infos):
        """CBGS: each class's infos (those holding a box of it) drawn with
        replacement, so that every class is about as frequent."""
        if self.class_names is None:
            return infos
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info.get("gt_names", [])):
                if name in cls_infos:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        frac = 1.0 / len(self.class_names)
        sampled = []
        ratios = [frac / max(len(v) / duplicated, 1e-9) for v in cls_infos.values()]
        rng = np.random.default_rng(0)
        for cur_infos, ratio in zip(cls_infos.values(), ratios):
            n = int(len(cur_infos) * ratio)
            if len(cur_infos) == 0 or n == 0:
                continue
            idx = rng.integers(0, len(cur_infos), n)
            sampled += [cur_infos[i] for i in idx]
        if self.logger:
            self.logger.info("Total samples after balanced resampling: %d" % len(sampled))
        return sampled or infos

    def get_sweep(self, sweep_info):
        """A sweep's points (N, 4) in the keyframe's sensor frame, the ones
        within 1 m of its sensor in x and y dropped, and their time lags
        (N, 1)."""
        lidar_path = self.root_path / sweep_info["lidar_path"]
        points_sweep = np.fromfile(str(lidar_path), dtype=np.float32).reshape(-1, 5)[:, :4]
        near = (np.abs(points_sweep[:, 0]) < 1.0) & (np.abs(points_sweep[:, 1]) < 1.0)
        points_sweep = points_sweep[~near].T
        if sweep_info.get("transform_matrix") is not None:
            num = points_sweep.shape[1]
            tm = sweep_info["transform_matrix"]
            points_sweep[:3, :] = tm.dot(np.vstack((points_sweep[:3, :], np.ones(num))))[:3, :]
        cur_times = sweep_info["time_lag"] * np.ones((1, points_sweep.shape[1]))
        return points_sweep.T, cur_times.T

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        """The keyframe's points and max_sweeps - 1 of its sweeps (fewer if
        the info has fewer), drawn without replacement from a generator
        spawned from the sample's: (N, 5) x, y, z, intensity, time lag."""
        info = self.infos[index]
        lidar_path = self.root_path / info["lidar_path"]
        points = np.fromfile(str(lidar_path), dtype=np.float32).reshape(-1, 5)[:, :4]
        sweep_points_list = [points]
        sweep_times_list = [np.zeros((points.shape[0], 1))]
        sweeps = info.get("sweeps", [])
        draw = self.rng.spawn(1)[0]
        for k in draw.choice(len(sweeps), min(max_sweeps - 1, len(sweeps)), replace=False):
            points_sweep, times_sweep = self.get_sweep(sweeps[k])
            sweep_points_list.append(points_sweep)
            sweep_times_list.append(times_sweep)
        points = np.concatenate(sweep_points_list, axis=0)
        times = np.concatenate(sweep_times_list, axis=0).astype(points.dtype)
        return np.concatenate((points, times), axis=1)

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * self.total_epochs
        return len(self.infos)

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        info = copy.deepcopy(self.infos[index])
        points = self.get_lidar_with_sweeps(index,
                                            max_sweeps=self.dataset_cfg.get("MAX_SWEEPS", 1))
        input_dict = {
            "points": points,
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info.get("token")},
        }
        if "gt_boxes" in info:
            mask = None
            if self.dataset_cfg.get("FILTER_MIN_POINTS_IN_GT", False):
                mask = info["num_lidar_pts"] > self.dataset_cfg.FILTER_MIN_POINTS_IN_GT - 1
            input_dict.update({
                "gt_names": info["gt_names"] if mask is None else info["gt_names"][mask],
                "gt_boxes": info["gt_boxes"] if mask is None else info["gt_boxes"][mask],
            })
        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:
            new_index = int(self.rng.integers(0, len(self)))
            return self.__getitem__(new_index)
        if self.dataset_cfg.get("SET_NAN_VELOCITY_TO_ZEROS", False) and "gt_boxes" in data_dict:
            gt_boxes = data_dict["gt_boxes"]
            gt_boxes[np.isnan(gt_boxes)] = 0
            data_dict["gt_boxes"] = gt_boxes
        # 9 box columns + class: the velocity goes unless the model predicts it
        if (not self.dataset_cfg.get("PRED_VELOCITY", True) and "gt_boxes" in data_dict
                and data_dict["gt_boxes"].shape[-1] > 8):
            data_dict["gt_boxes"] = data_dict["gt_boxes"][:, [0, 1, 2, 3, 4, 5, 6, -1]]
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names, output_path=None):
        annos = []
        for b, box_dict in enumerate(pred_dicts):
            boxes = np.asarray(box_dict["pred_boxes"])
            boxes = boxes.reshape(-1, boxes.shape[-1] if boxes.ndim else 7)
            scores = np.asarray(box_dict["pred_scores"]).reshape(-1)
            labels = np.asarray(box_dict["pred_labels"]).reshape(-1)
            keep = scores > 0
            metadata = batch_dict.get("metadata")
            annos.append({
                "name": np.array(class_names, dtype=object)[
                    np.clip(labels[keep] - 1, 0, len(class_names) - 1)
                ] if keep.any() else np.zeros(0, object),
                "score": scores[keep],
                "boxes_lidar": boxes[keep],
                "pred_labels": labels[keep],
                "metadata": metadata[b] if isinstance(metadata, (list, tuple)) else None,
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """The official nuScenes NDS (`eval.nuscenes_eval`) over the split's
        infos; eval_metric="waymo" runs the Waymo matcher instead, labelled
        as not comparable with NDS."""
        if "gt_boxes" not in self.infos[0]:
            return "No ground-truth boxes for evaluation", {}
        gt_annos = [{
            "name": np.asarray(info["gt_names"], object),
            "gt_boxes_lidar": np.asarray(info["gt_boxes"]),
            "num_lidar_pts": np.asarray(info.get("num_lidar_pts", [99] * len(info["gt_names"]))),
        } for info in self.infos]
        if kwargs.get("eval_metric") == "waymo":
            from ...eval.waymo_eval import waymo_evaluation

            s, d = waymo_evaluation(
                [{**g, "num_points_in_gt": g["num_lidar_pts"],
                  "gt_boxes_lidar": g["gt_boxes_lidar"][:, :7]} for g in gt_annos],
                det_annos, tuple(class_names))
            return ("[NON-OFFICIAL metric: Waymo matching protocol, NOT NuScenes NDS — do "
                    "not compare to published NDS]\n" + s, d)
        from ...eval.nuscenes_eval import nuscenes_evaluation

        return nuscenes_evaluation(gt_annos, det_annos, list(class_names))

    def create_groundtruth_database(self, used_classes=None, max_sweeps=10):
        """The gt database of copy-paste augmentation: each gt box's points
        of the max_sweeps cloud, box-centred, in
        gt_database_<max_sweeps>sweeps_withvelo/<token>_<name>_<i>.bin, and
        nuscenes_dbinfos_<max_sweeps>sweeps_withvelo.pkl."""
        database_save_path = self.root_path / ("gt_database_%dsweeps_withvelo" % max_sweeps)
        db_info_save_path = self.root_path / (
            "nuscenes_dbinfos_%dsweeps_withvelo.pkl" % max_sweeps)
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        for idx in range(len(self.infos)):
            info = self.infos[idx]
            points = self.get_lidar_with_sweeps(idx, max_sweeps=max_sweeps)
            gt_boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 9))))
            gt_names = np.asarray(info.get("gt_names", []))
            if gt_boxes.shape[0] == 0:
                continue
            box_idx = box_ops.points_in_boxes_np(points[:, :3], gt_boxes[:, :7])
            for i in range(gt_boxes.shape[0]):
                name = str(gt_names[i])
                if used_classes is not None and name not in used_classes:
                    continue
                gt_points = points[box_idx == i].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                filename = "%s_%s_%d.bin" % (info["token"], name, i)
                with open(database_save_path / filename, "w+b") as f:
                    gt_points.tofile(f)
                all_db_infos.setdefault(name, []).append({
                    "name": name,
                    "path": str((database_save_path / filename).relative_to(self.root_path)),
                    "image_idx": idx, "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": int(gt_points.shape[0]),
                })
        for k, v in all_db_infos.items():
            if self.logger:
                self.logger.info("Database %s: %d" % (k, len(v)))
        with open(db_info_save_path, "wb") as f:
            pickle.dump(all_db_infos, f)


def create_nuscenes_info(version, data_path, save_path, max_sweeps=10, splits=None):
    """The info pickles nuscenes_infos_<max_sweeps>sweeps_{train,val}.pkl
    (v1.0-test: _test.pkl) of the tables under data_path/version, written
    under save_path/version (`nuscenes_tables.create_nuscenes_info`)."""
    from .nuscenes_tables import create_nuscenes_info as _create

    return _create(version, data_path, save_path, max_sweeps=max_sweeps, splits=splits)


def create_nuscenes_infos(dataset_cfg, class_names, data_path, version=None, logger=None):
    """Infos, then the train split's gt database, of the nuScenes root
    data_path/version with the config's MAX_SWEEPS (the reference's
    nuscenes_dataset.py:383-412 `__main__`)."""
    version = version or dataset_cfg.get("VERSION", "v1.0-trainval")
    max_sweeps = int(dataset_cfg.get("MAX_SWEEPS", 10))
    create_nuscenes_info(version, data_path, data_path, max_sweeps=max_sweeps)
    cfg = copy.deepcopy(dataset_cfg)
    cfg.VERSION = version
    dataset = NuScenesDataset(cfg, class_names, training=True, root_path=Path(data_path),
                              logger=logger)
    dataset.infos = []
    dataset.include_nuscenes_data("train")   # the split's infos, not resampled
    dataset.create_groundtruth_database(max_sweeps=max_sweeps)


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 2 and sys.argv[1] == "create_nuscenes_infos":
        from ...config import cfg_from_yaml_file
        from ...utils.common_utils import create_logger
        from ...utils.edict import EDict

        cfg = cfg_from_yaml_file(sys.argv[2], EDict())
        dataset_cfg = cfg.DATA_CONFIG if "DATA_CONFIG" in cfg else cfg
        class_names = list(cfg.get("CLASS_NAMES", [
            "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
            "motorcycle", "bicycle", "pedestrian", "traffic_cone"]))
        ROOT_DIR = Path(sys.argv[3]) if len(sys.argv) > 3 else Path(dataset_cfg.DATA_PATH)
        create_nuscenes_infos(dataset_cfg, class_names, ROOT_DIR,
                              version=sys.argv[4] if len(sys.argv) > 4 else None,
                              logger=create_logger())
