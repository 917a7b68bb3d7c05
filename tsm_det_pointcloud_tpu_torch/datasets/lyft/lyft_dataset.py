"""The Lyft Level 5 dataset (counterpart of
tsm_det_pointcloud_tpu/datasets/lyft/lyft_dataset.py, `LyftDataset` :36).

Info pickles (`create_lyft_info`, from the JSON tables without the devkit:
`lyft_tables`), multi-sweep lidar: the key frame's points and MAX_SWEEPS - 1
of the info's sweeps, each read as (x, y, z, intensity) of a 5-column .bin,
the points within a 1 m square around its sensor dropped, moved into the
key frame's sensor frame by its transform_matrix, and every point given its
sweep's time lag as a fifth column (0 for the key frame). The sweeps are
drawn from numpy's global state, as the JAX package draws them; the loader
reseeds that state before each sample (`datasets.seed_for_sample`), so a
sample is a function of its (seed, epoch, index) and equal to the JAX
loader's. Boxes are 7 columns (x, y, z, dx, dy, dz, heading) and Lyft's
nine raw class names. The evaluation is the official Lyft mAP over
EVAL_LYFT_IOU_LIST (`eval.lyft_eval`); eval_metric="kitti" scores
pseudo-KITTI annos (`kitti.kitti_format`) of the five classes
MAP_NAME_TO_KITTI maps with the official KITTI AP, and eval_metric="waymo"
runs the Waymo matcher, labelled as not the Lyft mAP. The gt database of
copy-paste augmentation is cut from the max_sweeps cloud
(gt_database_<k>sweeps, lyft_dbinfos_<k>sweeps.pkl).

Infos and the gt database are made by
    python -m tsm_det_pointcloud_tpu_torch.datasets.lyft.lyft_dataset \\
        create_lyft_infos CFG DATA_PATH [VERSION]
(CFG a dataset config or a model config with a DATA_CONFIG; VERSION its
VERSION, else trainval), which reads the tables under DATA_PATH/data and the
scene splits of DATA_PATH/../ImageSets, and writes lyft_infos_{train,val}.pkl
(10 sweeps an info), the train split's 10-sweep gt database and its db infos
under DATA_PATH.
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ...ops import boxes as box_ops
from ..dataset import DatasetTemplate

MAP_NAME_TO_KITTI = {
    "car": "Car",
    "pedestrian": "Pedestrian",
    "truck": "Truck",
    "bicycle": "Cyclist",
    "motorcycle": "Cyclist",
}
# sweeps an info holds and the gt database is cut from (the JAX
# create_lyft_info's and create_groundtruth_database's default)
INFO_SWEEPS = 10


class LyftDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        root_path = root_path if root_path is not None else Path(dataset_cfg.DATA_PATH)
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                         root_path=root_path, logger=logger)
        self.infos = []
        for info_path in self.dataset_cfg.INFO_PATH[self.mode]:
            p = self.root_path / info_path
            if p.exists():
                with open(p, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if self.logger:
            self.logger.info("Total samples for Lyft dataset: %d" % len(self.infos))

    def get_sweep(self, sweep_info):
        """A sweep's points (N, 4) in the key frame's sensor frame, the ones
        within a 1 m square around its sensor dropped, and their time lags
        (N, 1)."""
        lidar_path = self.root_path / sweep_info["lidar_path"]
        pts = np.fromfile(str(lidar_path), dtype=np.float32).reshape(-1, 5)[:, :4]
        near = (np.abs(pts[:, 0]) < 1.0) & (np.abs(pts[:, 1]) < 1.0)
        pts = pts[~near]
        tm = sweep_info.get("transform_matrix")
        if tm is not None:
            hom = np.concatenate([pts[:, :3], np.ones((len(pts), 1), pts.dtype)], axis=1)
            pts[:, :3] = (hom @ np.asarray(tm, pts.dtype).T)[:, :3]
        times = np.full((len(pts), 1), sweep_info["time_lag"], pts.dtype)
        return pts, times

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        """The key frame's points and max_sweeps - 1 of its sweeps (fewer if
        the info has fewer), drawn without replacement from numpy's global
        state: (N, 5) x, y, z, intensity, time lag."""
        info = self.infos[index]
        pts = np.fromfile(str(self.root_path / info["lidar_path"]),
                          dtype=np.float32).reshape(-1, 5)[:, :4]
        sweep_points = [pts]
        sweep_times = [np.zeros((len(pts), 1), pts.dtype)]
        sweeps = info.get("sweeps", [])
        take = min(max_sweeps - 1, len(sweeps))
        for k in np.random.choice(len(sweeps), take, replace=False):
            p, t = self.get_sweep(sweeps[k])
            sweep_points.append(p)
            sweep_times.append(t)
        pts = np.concatenate(sweep_points, axis=0)
        times = np.concatenate(sweep_times, axis=0).astype(pts.dtype)
        return np.concatenate([pts, times], axis=1)

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
        input_dict = {"points": points, "frame_id": Path(info["lidar_path"]).stem}
        if "gt_boxes" in info:
            input_dict.update({"gt_names": info["gt_names"], "gt_boxes": info["gt_boxes"]})
        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:
            new_index = int(self.rng.integers(0, len(self)))
            return self.__getitem__(new_index)
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names, output_path=None):
        """nuScenes' prediction dicts (name, score, boxes_lidar,
        pred_labels, metadata), as the JAX package makes Lyft's."""
        from ..nuscenes.nuscenes_dataset import NuScenesDataset

        return NuScenesDataset.generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                                         output_path)

    def kitti_eval(self, det_annos, class_names):
        """The official KITTI AP over pseudo-KITTI annos of the classes
        MAP_NAME_TO_KITTI maps (the reference's lyft_dataset.py:189-213)."""
        from ...eval.kitti_eval import get_official_eval_result
        from ..kitti.kitti_format import to_kitti_format

        dt = to_kitti_format(det_annos, MAP_NAME_TO_KITTI)
        gt = to_kitti_format(
            [{"name": np.asarray(i["gt_names"], object),
              "gt_boxes_lidar": np.asarray(i["gt_boxes"])[:, :7]} for i in self.infos],
            MAP_NAME_TO_KITTI)
        kitti_classes = sorted({MAP_NAME_TO_KITTI[c] for c in class_names
                                if c in MAP_NAME_TO_KITTI})
        return get_official_eval_result(gt, dt, kitti_classes)

    def _gt_annos(self):
        return [{"name": np.asarray(info["gt_names"], object),
                 "gt_boxes_lidar": np.asarray(info["gt_boxes"])[:, :7]} for info in self.infos]

    def evaluation(self, det_annos, class_names, **kwargs):
        """The Lyft mAP (eval_metric "lyft", the default), the KITTI AP of
        pseudo-KITTI annos ("kitti") or the Waymo matcher ("waymo")."""
        if "gt_boxes" not in self.infos[0]:
            return "No ground-truth boxes for evaluation", {}
        metric = kwargs.get("eval_metric", "lyft")
        if metric == "kitti":
            return self.kitti_eval(copy.deepcopy(det_annos), class_names)
        if metric == "lyft":
            from ...eval.lyft_eval import lyft_evaluation

            return lyft_evaluation(
                self._gt_annos(), det_annos, list(class_names),
                iou_thresholds=self.dataset_cfg.get(
                    "EVAL_LYFT_IOU_LIST", [0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95]),
                version=self.dataset_cfg.get("VERSION", "trainval"))
        if metric == "waymo":
            from ...eval.waymo_eval import waymo_evaluation

            s, d = waymo_evaluation(self._gt_annos(), det_annos, tuple(class_names))
            return ("[NON-OFFICIAL metric: Waymo matching protocol, NOT Lyft mAP — do not "
                    "compare to published numbers]\n" + s, d)
        raise NotImplementedError(metric)

    def create_groundtruth_database(self, used_classes=None, max_sweeps=INFO_SWEEPS):
        """The gt database of copy-paste augmentation: each gt box's points
        of the max_sweeps cloud, box-centred, in
        gt_database_<max_sweeps>sweeps/<token>_<name>_<i>.bin, and
        lyft_dbinfos_<max_sweeps>sweeps.pkl (the reference's
        lyft_dataset.py:206-249)."""
        database_save_path = self.root_path / ("gt_database_%dsweeps" % max_sweeps)
        db_info_save_path = self.root_path / ("lyft_dbinfos_%dsweeps.pkl" % max_sweeps)
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        for idx in range(len(self.infos)):
            info = self.infos[idx]
            points = self.get_lidar_with_sweeps(idx, max_sweeps=max_sweeps)
            gt_boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))))
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


def create_lyft_info(version, data_path, save_path, split=None, max_sweeps=INFO_SWEEPS):
    """lyft_infos_{train,val}.pkl (version test: lyft_infos_test.pkl) of the
    tables under data_path/data, written under save_path
    (`lyft_tables.create_lyft_info`)."""
    from .lyft_tables import create_lyft_info as _create

    return _create(version, data_path, save_path, split=split, max_sweeps=max_sweeps)


def create_lyft_infos(dataset_cfg, class_names, data_path, version=None, logger=None):
    """Infos, then the train split's gt database, of the Lyft root
    data_path, both of INFO_SWEEPS sweeps (the `__main__` of the
    reference's lyft_dataset.py)."""
    version = version or dataset_cfg.get("VERSION", "trainval")
    create_lyft_info(version, data_path, data_path)
    cfg = copy.deepcopy(dataset_cfg)
    cfg.INFO_PATH = {"train": ["lyft_infos_train.pkl"]}
    dataset = LyftDataset(cfg, class_names, training=True, root_path=Path(data_path),
                          logger=logger)
    dataset.create_groundtruth_database()


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 2 and sys.argv[1] == "create_lyft_infos":
        from ...config import cfg_from_yaml_file
        from ...utils.common_utils import create_logger
        from ...utils.edict import EDict

        cfg = cfg_from_yaml_file(sys.argv[2], EDict())
        dataset_cfg = cfg.DATA_CONFIG if "DATA_CONFIG" in cfg else cfg
        class_names = list(cfg.get("CLASS_NAMES", [
            "car", "truck", "bus", "emergency_vehicle", "other_vehicle", "motorcycle",
            "bicycle", "pedestrian", "animal"]))
        ROOT_DIR = Path(sys.argv[3]) if len(sys.argv) > 3 else Path(dataset_cfg.DATA_PATH)
        create_lyft_infos(dataset_cfg, class_names, ROOT_DIR,
                          version=sys.argv[4] if len(sys.argv) > 4 else None,
                          logger=create_logger())
