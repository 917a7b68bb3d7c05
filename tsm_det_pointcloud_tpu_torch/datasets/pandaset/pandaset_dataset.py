"""The PandaSet dataset (counterpart of
tsm_det_pointcloud_tpu/datasets/pandaset/pandaset_dataset.py,
`PandasetDataset` :75), without the pandaset-devkit: the sequence and pose
discovery (`poses.json`) and the two quaternion transforms
(`lidar_points_to_ego`, `ego_to_lidar_points`) are numpy on the port's
`nuscenes_tables.quat_rotation_matrix`, and the frames, which the dataset
releases as pandas pickles, are read with pandas, imported inside the
functions that read or write them (the package imports without pandas).

Layout (as released): ROOT/dataset/<seq>/lidar/{NN.pkl.gz, poses.json},
ROOT/dataset/<seq>/annotations/cuboids/NN.pkl.gz. Frames are in the world
frame; a sample maps them to the normative ego frame (x forward, y left,
z up), the yaw under the negligible-pitch approximation, with its warning
(the reference's pandaset_dataset.py:150-254). LIDAR_DEVICE picks the
lidar (0 the 360-degree Pandar64, 1 the forward PandarGT, -1 both); the
intensity goes from [0, 255] to [0, 1]; TRAINING_CATEGORIES renames the
labels, and the template drops those not in the class names. A sample
also carries its `sequence`, `frame_idx`, `pose` (7 floats) and
`zrot_world_to_ego`, which `generate_prediction_dicts` needs to put the
predictions back in the world frame: the loader keeps them on the host, in
float64 (`datasets.HOST_KEYS`). PandaSet has no official detection metric:
the evaluation returns an empty result, as the reference's does.

Infos and the gt database are made by
    python -m tsm_det_pointcloud_tpu_torch.datasets.pandaset.pandaset_dataset \\
        create_pandaset_infos CFG DATA_PATH
(CFG a dataset config or a model config with a DATA_CONFIG), which writes
pandaset_infos_{train,val,test}.pkl of the config's SEQUENCES found under
DATA_PATH/dataset, the train split's gt database and its db infos under
DATA_PATH.
"""
from __future__ import annotations

import json
import os
import pickle
from pathlib import Path

import numpy as np

from ...ops import boxes as box_ops
from ..dataset import DatasetTemplate
from ..nuscenes.nuscenes_tables import quat_rotation_matrix


def pose_dict_to_numpy(pose):
    """Pose dict -> (7,) [x, y, z, qw, qx, qy, qz] (network-passable)."""
    return [pose["position"]["x"], pose["position"]["y"],
            pose["position"]["z"], pose["heading"]["w"],
            pose["heading"]["x"], pose["heading"]["y"],
            pose["heading"]["z"]]


def pose_numpy_to_dict(pose):
    return {"position": {"x": pose[0], "y": pose[1], "z": pose[2]},
            "heading": {"w": pose[3], "x": pose[4], "y": pose[5],
                        "z": pose[6]}}


def _pose_quat(pose):
    h = pose["heading"]
    return [h["w"], h["x"], h["y"], h["z"]]


def _pose_pos(pose):
    p = pose["position"]
    return np.array([p["x"], p["y"], p["z"]])


def lidar_points_to_ego(points, pose):
    """World -> ego: R(q)^T (p - t). Parity: devkit
    ps.geometry.lidar_points_to_ego (inverse of the pose matrix)."""
    rot = quat_rotation_matrix(_pose_quat(pose))
    return (np.asarray(points, np.float64) - _pose_pos(pose)) @ rot


def ego_to_lidar_points(points, pose):
    """Ego -> world: R(q) p + t."""
    rot = quat_rotation_matrix(_pose_quat(pose))
    return np.asarray(points, np.float64) @ rot.T + _pose_pos(pose)


def _read_df(path):
    """Read a (possibly gzipped) pandas pickle."""
    import pandas as pd

    return pd.read_pickle(path)


class PandasetDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True,
                 root_path=None, logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, root_path=root_path, logger=logger,
        )
        if self.root_path is None:
            self.root_path = Path(self.dataset_cfg.DATA_PATH)
        self.split = self.dataset_cfg.get(
            "DATA_SPLIT", {}).get(self.mode, "train")
        self.sequences = self.dataset_cfg.get("SEQUENCES", {}).get(
            self.split, [])
        self._poses_cache = {}
        self.pandaset_infos = []
        self.include_pandaset_infos(self.mode)

    # the other loaders call this `infos`
    @property
    def infos(self):
        return self.pandaset_infos

    def include_pandaset_infos(self, mode):
        if self.logger is not None:
            self.logger.info("Loading PandaSet dataset")
        infos = []
        for info_path in self.dataset_cfg.get("INFO_PATH", {}).get(mode, []):
            p = Path(self.root_path) / info_path
            if not p.exists():
                continue
            with open(p, "rb") as f:
                infos.extend(pickle.load(f))
        self.pandaset_infos.extend(infos)
        if self.logger is not None:
            self.logger.info(
                "Total samples for PandaSet dataset (%s): %d"
                % (mode, len(infos)))

    def set_split(self, split):
        self.sequences = self.dataset_cfg.SEQUENCES[split]
        self.split = split

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.pandaset_infos) * self.total_epochs
        return len(self.pandaset_infos)

    # -- raw readers ---------------------------------------------------------

    def _get_pose(self, info):
        """Per-frame lidar pose from <seq>/lidar/poses.json (cached)."""
        seq = str(info["sequence"]).zfill(3)
        if seq not in self._poses_cache:
            poses_path = (Path(self.root_path) / "dataset" / seq / "lidar"
                          / "poses.json")
            with open(poses_path) as f:
                self._poses_cache[seq] = json.load(f)
        return self._poses_cache[seq][int(info["frame_idx"])]

    def _get_lidar_points(self, info, pose):
        """World-frame lidar frame -> normative ego frame, intensity
        normalized from [0, 255] to [0, 1]."""
        frame = _read_df(Path(self.root_path) / info["lidar_path"]
                         if not os.path.isabs(str(info["lidar_path"]))
                         else info["lidar_path"])
        device = self.dataset_cfg.get("LIDAR_DEVICE", 0)
        if device != -1:
            frame = frame[frame.d == device]
        world = frame.to_numpy()
        ego = lidar_points_to_ego(world[:, :3], pose)
        # pandaset ego (x right, y front, z up) -> normative
        # (x forward, y left, z up)
        ego = ego[:, [1, 0, 2]]
        ego[:, 1] = -ego[:, 1]
        intensity = world[:, 3:4] / 255.0
        return np.concatenate([ego, intensity], axis=1).astype(np.float32)

    def _get_annotations(self, info, pose):
        """World-frame cuboids -> normative ego boxes (N, 7) + labels +
        the world->ego z-rotation used for the yaw mapping."""
        cuboids = _read_df(Path(self.root_path) / info["cuboids_path"]
                           if not os.path.isabs(str(info["cuboids_path"]))
                           else info["cuboids_path"])
        device = self.dataset_cfg.get("LIDAR_DEVICE", 0)
        if device != -1:
            cuboids = cuboids[cuboids["cuboids.sensor_id"] != 1 - device]
        centers = np.stack([cuboids["position.%s" % a].to_numpy()
                            for a in "xyz"], axis=1)
        dims = np.stack([cuboids["dimensions.%s" % a].to_numpy()
                         for a in "xyz"], axis=1)
        yaws = cuboids["yaw"].to_numpy()
        labels = cuboids["label"].to_numpy()
        mapping = self.dataset_cfg.get("TRAINING_CATEGORIES", {})
        labels = np.array([mapping.get(lab, lab) for lab in labels])

        ego_centers = lidar_points_to_ego(centers, pose)
        # yaw world->ego under the negligible-pitch approximation: rotate
        # the world y axis into ego, measure its z-rotation
        yaxis = lidar_points_to_ego(
            np.array([[0.0, 0, 0], [0, 1.0, 0]]), pose)
        yaxis = yaxis[1] - yaxis[0]
        if abs(yaxis[-1]) >= 0.1 and self.logger is not None:
            self.logger.warning(
                "The car's pitch is supposed to be negligible; "
                "sin(pitch) >= 0.1 (%s)" % yaxis[-1])
        zrot_world_to_ego = np.arctan2(-yaxis[0], yaxis[1])
        # pandaset ego -> normative axes (x<->y swap + y flip); dims
        # swap accordingly, yaw is measured from the (swapped) x axis
        boxes = np.stack([
            ego_centers[:, 1], -ego_centers[:, 0], ego_centers[:, 2],
            dims[:, 1], dims[:, 0], dims[:, 2],
            yaws + zrot_world_to_ego,
        ], axis=1)
        return boxes.astype(np.float32), labels, zrot_world_to_ego

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.pandaset_infos)
        info = self.pandaset_infos[index]
        pose = self._get_pose(info)
        points = self._get_lidar_points(info, pose)
        boxes, labels, zrot = self._get_annotations(info, pose)
        input_dict = {
            "points": points,
            "gt_boxes": boxes,
            "gt_names": labels,
            "sequence": int(info["sequence"]),
            "frame_idx": info["frame_idx"],
            "zrot_world_to_ego": zrot,
            "pose": pose_dict_to_numpy(pose),
            "frame_id": "%s_%s" % (info["sequence"], info["frame_idx"]),
        }
        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:
            new_index = int(self.rng.integers(0, len(self)))
            return self.__getitem__(new_index)
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Normative-ego predictions -> world-frame cuboid DataFrames
        (parity: reference :256-355, incl. the devkit-compatible
        predictions/cuboids/NN.pkl.gz dump)."""
        import pandas as pd

        annos = []
        for index, box_dict in enumerate(pred_dicts):
            frame_idx = batch_dict["frame_idx"][index]
            seq_idx = batch_dict["sequence"][index]
            zrot = float(np.asarray(batch_dict["zrot_world_to_ego"][index]))
            pose = pose_numpy_to_dict(
                np.asarray(batch_dict["pose"][index]).tolist())
            boxes = np.asarray(box_dict["pred_boxes"]).reshape(-1, 7)
            scores = np.asarray(box_dict["pred_scores"]).reshape(-1)
            labels = np.asarray(box_dict["pred_labels"]).reshape(-1)
            if "count" in box_dict:
                k = int(np.asarray(box_dict["count"]))
                boxes, scores, labels = boxes[:k], scores[:k], labels[:k]
            names = np.array(class_names, object)[
                np.clip(labels - 1, 0, len(class_names) - 1)]
            # normative -> pandaset ego axes, then ego -> world
            ego_centers = np.stack(
                [-boxes[:, 1], boxes[:, 0], boxes[:, 2]], axis=1)
            world = ego_to_lidar_points(ego_centers, pose)
            df = pd.DataFrame({
                "position.x": world[:, 0], "position.y": world[:, 1],
                "position.z": world[:, 2],
                "dimensions.x": boxes[:, 4], "dimensions.y": boxes[:, 3],
                "dimensions.z": boxes[:, 5],
                "yaw": (boxes[:, 6] - zrot) % (2 * np.pi),
                "label": names, "score": scores,
            })
            single = {"preds": df, "name": df["label"].tolist(),
                      "frame_idx": frame_idx,
                      "sequence": str(int(seq_idx)).zfill(3)}
            if output_path is not None:
                cur = os.path.join(
                    str(output_path), single["sequence"], "predictions",
                    "cuboids", "%s.pkl.gz" % str(int(frame_idx)).zfill(2))
                os.makedirs(os.path.dirname(cur), exist_ok=True)
                df.to_pickle(cur)
            annos.append(single)
        return annos

    def get_infos(self):
        """Per-frame info dicts for the current split's sequences
        (parity: reference :358-384 incl. the 100-frame guard)."""
        infos = []
        for seq in self.sequences:
            seq = str(seq).zfill(3)
            lidar_dir = Path(self.root_path) / "dataset" / seq / "lidar"
            frames = sorted(
                p.name for p in lidar_dir.glob("*.pkl*")
                if not p.name.startswith("poses"))
            if len(frames) > 100:
                raise ValueError(
                    "The implementation for this dataset assumes that "
                    "each sequence is no longer than 100 frames. The "
                    "current sequence has %d" % len(frames))
            ext = frames[0].split(".", 1)[1] if frames else "pkl.gz"
            infos.extend({
                "sequence": seq, "frame_idx": ii,
                "lidar_path": os.path.join(
                    "dataset", seq, "lidar", "%02d.%s" % (ii, ext)),
                "cuboids_path": os.path.join(
                    "dataset", seq, "annotations", "cuboids",
                    "%02d.%s" % (ii, ext)),
            } for ii in range(len(frames)))
        return infos

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split="train"):
        database_save_path = Path(self.root_path) / (
            "gt_database" if split == "train" else "gt_database_%s" % split)
        db_info_save_path = Path(self.root_path) / (
            "pandaset_dbinfos_%s.pkl" % split)
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        for info in infos:
            pose = self._get_pose(info)
            points = self._get_lidar_points(info, pose)
            gt_boxes, names, _ = self._get_annotations(info, pose)
            if gt_boxes.shape[0] == 0:
                continue
            box_idx = box_ops.points_in_boxes_np(points[:, :3], gt_boxes)
            for i in range(gt_boxes.shape[0]):
                name = str(names[i])
                clean = name.replace("/", "").replace(" ", "")
                filename = "%s_%s_%d.bin" % (info["frame_idx"], clean, i)
                gt_points = points[box_idx == i].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                with open(database_save_path / filename, "wb") as f:
                    gt_points.tofile(f)
                if used_classes is None or name in used_classes:
                    all_db_infos.setdefault(name, []).append({
                        "name": name,
                        "path": str((database_save_path / filename
                                     ).relative_to(self.root_path)),
                        "gt_idx": i, "box3d_lidar": gt_boxes[i],
                        "num_points_in_gt": int(gt_points.shape[0]),
                        "difficulty": -1,
                    })
        for k, v in all_db_infos.items():
            if self.logger:
                self.logger.info("Database %s: %d" % (k, len(v)))
        with open(db_info_save_path, "wb") as f:
            pickle.dump(all_db_infos, f)

    def evaluation(self, det_annos, class_names, **kwargs):
        """PandaSet has no official detection metric (reference :437-444
        returns empty). eval_metric='waymo' offers the Waymo matching
        protocol, loudly labeled non-official."""
        if kwargs.get("eval_metric") == "waymo" and self.pandaset_infos:
            from ...eval.waymo_eval import waymo_evaluation

            gt_annos = []
            for info in self.pandaset_infos:
                pose = self._get_pose(info)
                boxes, names, _ = self._get_annotations(info, pose)
                gt_annos.append({"name": np.asarray(names, object),
                                 "gt_boxes_lidar": boxes})
            s, d = waymo_evaluation(gt_annos, det_annos, tuple(class_names))
            return ("[NON-OFFICIAL metric: Waymo matching protocol — "
                    "PandaSet has no official detection metric]\n" + s, d)
        if self.logger is not None:
            self.logger.warning(
                "Evaluation is not implemented for Pandaset as there is "
                "no official one. Returning an empty evaluation result.")
        return "", {}


def create_pandaset_infos(dataset_cfg, class_names, data_path, save_path):
    """Offline info + gt-db creation (parity: reference :446-471)."""
    dataset = PandasetDataset(
        dataset_cfg=dataset_cfg, class_names=class_names,
        root_path=data_path, training=False)
    for split in ("train", "val", "test"):
        if split not in dataset_cfg.get("SEQUENCES", {}):
            continue
        dataset.set_split(split)
        infos = dataset.get_infos()
        file_path = os.path.join(str(save_path),
                                 "pandaset_infos_%s.pkl" % split)
        with open(file_path, "wb") as f:
            pickle.dump(infos, f)
        print("Pandaset info %s file is saved to %s" % (split, file_path))
    if "train" in dataset_cfg.get("SEQUENCES", {}):
        dataset.set_split("train")
        dataset.create_groundtruth_database(
            os.path.join(str(save_path), "pandaset_infos_train.pkl"),
            split="train")


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 2 and sys.argv[1] == "create_pandaset_infos":
        from ...config import cfg_from_yaml_file
        from ...utils.edict import EDict

        cfg = cfg_from_yaml_file(sys.argv[2], EDict())
        dataset_cfg = cfg.DATA_CONFIG if "DATA_CONFIG" in cfg else cfg
        class_names = list(cfg.get("CLASS_NAMES", ["Car", "Pedestrian", "Cyclist"]))
        ROOT_DIR = Path(sys.argv[3]) if len(sys.argv) > 3 else Path(dataset_cfg.DATA_PATH)
        create_pandaset_infos(dataset_cfg, class_names, ROOT_DIR, ROOT_DIR)
