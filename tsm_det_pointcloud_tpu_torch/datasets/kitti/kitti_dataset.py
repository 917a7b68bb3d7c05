"""The KITTI dataset (counterpart of
tsm_det_pointcloud_tpu/datasets/kitti/kitti_dataset.py).

Info-pickle driven loading, the camera-FOV crop (`FOV_POINTS_ONLY`), info
and gt-database creation (`create_kitti_infos`, also a command:
    python -m tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset \
        create_kitti_infos tools/cfgs/dataset_configs/kitti_dataset.yaml DATA_ROOT
), camera-frame prediction dicts and the official KITTI eval.
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ...ops import boxes as box_ops
from ..dataset import DatasetTemplate
from . import calibration_kitti, object3d_kitti


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names, training=training,
            root_path=root_path, logger=logger,
        )
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        self.root_split_path = self.root_path / (
            "training" if self.split != "test" else "testing"
        )
        split_file = self.root_path / "ImageSets" / (self.split + ".txt")
        self.sample_id_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists() else None
        )
        self.kitti_infos = []
        self.include_kitti_data(self.mode)

    def include_kitti_data(self, mode):
        if self.logger is not None:
            self.logger.info("Loading KITTI dataset")
        kitti_infos = []
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            info_path = self.root_path / info_path
            if not info_path.exists():
                continue
            with open(info_path, "rb") as f:
                kitti_infos.extend(pickle.load(f))
        self.kitti_infos.extend(kitti_infos)
        if self.logger is not None:
            self.logger.info("Total samples for KITTI dataset: %d" % len(kitti_infos))

    def set_split(self, split):
        self.split = split
        self.root_split_path = self.root_path / (
            "training" if self.split != "test" else "testing"
        )
        split_file = self.root_path / "ImageSets" / (self.split + ".txt")
        self.sample_id_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists() else None
        )

    # -- raw readers ---------------------------------------------------------

    def get_lidar(self, idx):
        lidar_file = self.root_split_path / "velodyne" / ("%s.bin" % idx)
        return np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 4)

    def get_calib(self, idx):
        calib_file = self.root_split_path / "calib" / ("%s.txt" % idx)
        return calibration_kitti.Calibration(str(calib_file))

    def get_label(self, idx):
        label_file = self.root_split_path / "label_2" / ("%s.txt" % idx)
        return object3d_kitti.get_objects_from_label(str(label_file))

    def get_road_plane(self, idx):
        plane_file = self.root_split_path / "planes" / ("%s.txt" % idx)
        if not plane_file.exists():
            return None
        with open(plane_file, "r") as f:
            lines = f.readlines()
        plane = np.asarray([float(i) for i in lines[3].split()])
        if plane[1] > 0:  # normal should point up (camera -y)
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])

    def get_image_shape(self, idx):
        import struct
        img_file = self.root_split_path / "image_2" / ("%s.png" % idx)
        if not img_file.exists():
            return np.array([375, 1242], dtype=np.int32)
        with open(img_file, "rb") as f:
            head = f.read(26)
        w, h = struct.unpack(">II", head[16:24])
        return np.array([h, w], dtype=np.int32)

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        """Mask of points that project inside the camera-2 image with
        non-negative depth (img_shape is (height, width))."""
        pts_img, depth = calib.rect_to_img(pts_rect)
        hw = np.asarray(img_shape, dtype=np.float64)[::-1]  # -> (width, height)
        inside = ((pts_img >= 0) & (pts_img < hw)).all(axis=1)
        return inside & (depth >= 0)

    # -- info generation (offline) -------------------------------------------

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        sample_id_list = sample_id_list or self.sample_id_list
        if sample_id_list is None:  # split file absent (e.g. no test set)
            return []

        def process_single_scene(sample_idx):
            info = {}
            pc_info = {"num_features": 4, "lidar_idx": sample_idx}
            info["point_cloud"] = pc_info
            image_info = {
                "image_idx": sample_idx,
                "image_shape": self.get_image_shape(sample_idx),
            }
            info["image"] = image_info
            calib = self.get_calib(sample_idx)
            P2 = np.concatenate([calib.P2, np.array([[0., 0., 0., 1.]])], axis=0)
            R0_4x4 = np.zeros([4, 4], dtype=calib.R0.dtype)
            R0_4x4[3, 3] = 1.0
            R0_4x4[:3, :3] = calib.R0
            V2C_4x4 = np.concatenate(
                [calib.V2C, np.array([[0., 0., 0., 1.]])], axis=0
            )
            info["calib"] = {"P2": P2, "R0_rect": R0_4x4, "Tr_velo_to_cam": V2C_4x4}

            if has_label:
                obj_list = self.get_label(sample_idx)
                annotations = {
                    "name": np.array([obj.cls_type for obj in obj_list]),
                    "truncated": np.array([obj.truncation for obj in obj_list]),
                    "occluded": np.array([obj.occlusion for obj in obj_list]),
                    "alpha": np.array([obj.alpha for obj in obj_list]),
                    "bbox": np.concatenate(
                        [obj.box2d.reshape(1, 4) for obj in obj_list], axis=0
                    ) if obj_list else np.zeros((0, 4)),
                    "dimensions": np.array(
                        [[obj.l, obj.h, obj.w] for obj in obj_list]
                    ).reshape(-1, 3),
                    "location": np.concatenate(
                        [obj.loc.reshape(1, 3) for obj in obj_list], axis=0
                    ) if obj_list else np.zeros((0, 3)),
                    "rotation_y": np.array([obj.ry for obj in obj_list]),
                    "score": np.array([obj.score for obj in obj_list]),
                    "difficulty": np.array(
                        [obj.level for obj in obj_list], np.int32
                    ),
                }
                num_objects = len(
                    [obj.cls_type for obj in obj_list if obj.cls_type != "DontCare"]
                )
                num_gt = len(annotations["name"])
                index = list(range(num_objects)) + [-1] * (num_gt - num_objects)
                annotations["index"] = np.array(index, dtype=np.int32)

                loc = annotations["location"][:num_objects]
                dims = annotations["dimensions"][:num_objects]
                rots = annotations["rotation_y"][:num_objects]
                loc_lidar = calib.rect_to_lidar(loc)
                l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
                loc_lidar[:, 2] += h[:, 0] / 2
                gt_boxes_lidar = np.concatenate(
                    [loc_lidar, l, w, h, -(np.pi / 2 + rots[..., None])], axis=1
                )
                annotations["gt_boxes_lidar"] = gt_boxes_lidar

                if count_inside_pts:
                    points = self.get_lidar(sample_idx)
                    pts_rect = calib.lidar_to_rect(points[:, 0:3])
                    fov_flag = self.get_fov_flag(
                        pts_rect, info["image"]["image_shape"], calib
                    )
                    pts_fov = points[fov_flag]
                    num_points_in_gt = np.zeros(num_gt, dtype=np.int32)
                    if num_objects > 0:
                        box_idx = box_ops.points_in_boxes_np(
                            pts_fov[:, :3], gt_boxes_lidar
                        )
                        for k in range(num_objects):
                            num_points_in_gt[k] = (box_idx == k).sum()
                    num_points_in_gt[num_objects:] = -1
                    annotations["num_points_in_gt"] = num_points_in_gt
                info["annos"] = annotations
            return info

        if num_workers <= 1:
            return [process_single_scene(sid) for sid in sample_id_list]
        # parity: reference threadpools the per-scene label/calib parsing
        # (kitti_dataset.py:150,220) — IO-bound, threads suffice
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(num_workers) as pool:
            return list(pool.map(process_single_scene, sample_id_list))

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split="train"):
        database_save_path = self.root_path / (
            "gt_database" if split == "train" else ("gt_database_%s" % split)
        )
        db_info_save_path = self.root_path / ("kitti_dbinfos_%s.pkl" % split)
        database_save_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}

        with open(info_path, "rb") as f:
            infos = pickle.load(f)

        for k in range(len(infos)):
            info = infos[k]
            sample_idx = info["point_cloud"]["lidar_idx"]
            points = self.get_lidar(sample_idx)
            annos = info["annos"]
            names = annos["name"]
            difficulty = annos["difficulty"]
            bbox = annos["bbox"]
            gt_boxes = annos["gt_boxes_lidar"]

            num_obj = gt_boxes.shape[0]
            box_idxs = box_ops.points_in_boxes_np(points[:, :3], gt_boxes)
            for i in range(num_obj):
                filename = "%s_%s_%d.bin" % (sample_idx, names[i], i)
                filepath = database_save_path / filename
                gt_points = points[box_idxs == i]
                gt_points = gt_points.copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                with open(filepath, "w") as f:
                    gt_points.tofile(f)

                if used_classes is None or names[i] in used_classes:
                    db_path = str(filepath.relative_to(self.root_path))
                    db_info = {
                        "name": names[i], "path": db_path,
                        "image_idx": sample_idx, "gt_idx": i,
                        "box3d_lidar": gt_boxes[i],
                        "num_points_in_gt": gt_points.shape[0],
                        "difficulty": difficulty[i],
                        "bbox": bbox[i], "score": annos["score"][i],
                    }
                    all_db_infos.setdefault(names[i], []).append(db_info)
        with open(db_info_save_path, "wb") as f:
            pickle.dump(all_db_infos, f)
        return all_db_infos

    # -- predictions + eval ----------------------------------------------------

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Device predictions -> KITTI camera-frame annos
        (parity: kitti_dataset.py:276-351)."""

        def get_template_prediction(num_samples):
            return {
                "name": np.zeros(num_samples), "truncated": np.zeros(num_samples),
                "occluded": np.zeros(num_samples), "alpha": np.zeros(num_samples),
                "bbox": np.zeros([num_samples, 4]),
                "dimensions": np.zeros([num_samples, 3]),
                "location": np.zeros([num_samples, 3]),
                "rotation_y": np.zeros(num_samples),
                "score": np.zeros(num_samples),
                "boxes_lidar": np.zeros([num_samples, 7]),
            }

        def generate_single_sample_dict(batch_index, box_dict):
            pred_scores = np.asarray(box_dict["pred_scores"])
            pred_boxes = np.asarray(box_dict["pred_boxes"])
            pred_labels = np.asarray(box_dict["pred_labels"])
            ret_dict = get_template_prediction(pred_scores.shape[0])
            if pred_scores.shape[0] == 0:
                return ret_dict
            calib = batch_dict["calib"][batch_index]
            image_shape = np.asarray(batch_dict["image_shape"][batch_index])
            pred_boxes_camera = box_ops.boxes3d_lidar_to_kitti_camera(
                pred_boxes, calib
            )
            pred_boxes_img = box_ops.boxes3d_kitti_camera_to_imageboxes(
                pred_boxes_camera, calib, image_shape=image_shape
            )
            ret_dict["name"] = np.array(class_names)[pred_labels - 1]
            ret_dict["alpha"] = (
                -np.arctan2(-pred_boxes[:, 1], pred_boxes[:, 0])
                + pred_boxes_camera[:, 6]
            )
            ret_dict["bbox"] = pred_boxes_img
            ret_dict["dimensions"] = pred_boxes_camera[:, 3:6]
            ret_dict["location"] = pred_boxes_camera[:, 0:3]
            ret_dict["rotation_y"] = pred_boxes_camera[:, 6]
            ret_dict["score"] = pred_scores
            ret_dict["boxes_lidar"] = pred_boxes
            return ret_dict

        annos = []
        for index, box_dict in enumerate(pred_dicts):
            frame_id = batch_dict["frame_id"][index]
            single_pred_dict = generate_single_sample_dict(index, box_dict)
            single_pred_dict["frame_id"] = frame_id
            annos.append(single_pred_dict)
            if output_path is not None:
                cur_det_file = Path(output_path) / ("%s.txt" % frame_id)
                with open(cur_det_file, "w") as f:
                    bbox = single_pred_dict["bbox"]
                    loc = single_pred_dict["location"]
                    dims = single_pred_dict["dimensions"]  # lhw -> hwl output
                    for idx in range(len(bbox)):
                        print(
                            "%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                            "%.4f %.4f %.4f %.4f %.4f"
                            % (single_pred_dict["name"][idx],
                               single_pred_dict["alpha"][idx],
                               bbox[idx][0], bbox[idx][1], bbox[idx][2], bbox[idx][3],
                               dims[idx][1], dims[idx][2], dims[idx][0],
                               loc[idx][0], loc[idx][1], loc[idx][2],
                               single_pred_dict["rotation_y"][idx],
                               single_pred_dict["score"][idx]),
                            file=f,
                        )
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        if "annos" not in self.kitti_infos[0].keys():
            return None, {}
        from ...eval.kitti_eval import get_official_eval_result

        eval_det_annos = copy.deepcopy(det_annos)
        eval_gt_annos = [copy.deepcopy(info["annos"]) for info in self.kitti_infos]
        ap_result_str, ap_dict = get_official_eval_result(
            eval_gt_annos, eval_det_annos, class_names
        )
        return ap_result_str, ap_dict

    # -- torch-style dataset protocol ------------------------------------------

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.kitti_infos) * self.total_epochs
        return len(self.kitti_infos)

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.kitti_infos)
        info = copy.deepcopy(self.kitti_infos[index])
        sample_idx = info["point_cloud"]["lidar_idx"]
        img_shape = info["image"]["image_shape"]
        calib = self.get_calib(sample_idx)
        get_item_list = self.dataset_cfg.get("GET_ITEM_LIST", ["points"])

        input_dict = {"frame_id": sample_idx, "calib": calib}

        if "annos" in info:
            annos = info["annos"]
            mask = annos["name"] != "DontCare"
            loc = annos["location"][mask]
            dims = annos["dimensions"][mask]
            rots = annos["rotation_y"][mask]
            gt_names = annos["name"][mask]
            if "gt_boxes_lidar" in annos:
                gt_boxes_lidar = annos["gt_boxes_lidar"][: mask.sum()]
            else:
                gt_boxes_camera = np.concatenate(
                    [loc, dims, rots[..., None]], axis=1
                ).astype(np.float32)
                gt_boxes_lidar = box_ops.boxes3d_kitti_camera_to_lidar(
                    gt_boxes_camera, calib
                )
            input_dict.update({"gt_names": gt_names, "gt_boxes": gt_boxes_lidar})
            road_plane = self.get_road_plane(sample_idx)
            if road_plane is not None:
                input_dict["road_plane"] = road_plane

        if "points" in get_item_list:
            points = self.get_lidar(sample_idx)
            if self.dataset_cfg.get("FOV_POINTS_ONLY", False):
                pts_rect = calib.lidar_to_rect(points[:, 0:3])
                fov_flag = self.get_fov_flag(pts_rect, img_shape, calib)
                points = points[fov_flag]
            input_dict["points"] = points

        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:
            new_index = int(self.rng.integers(0, len(self)))
            return self.__getitem__(new_index)
        data_dict["image_shape"] = img_shape
        data_dict["calib"] = calib
        return data_dict


def create_kitti_infos(dataset_cfg, class_names, data_path, save_path, workers=4):
    dataset = KittiDataset(
        dataset_cfg=dataset_cfg, class_names=class_names, root_path=data_path,
        training=False,
    )
    train_split, val_split = "train", "val"

    train_filename = save_path / ("kitti_infos_%s.pkl" % train_split)
    val_filename = save_path / ("kitti_infos_%s.pkl" % val_split)
    trainval_filename = save_path / "kitti_infos_trainval.pkl"
    test_filename = save_path / "kitti_infos_test.pkl"

    dataset.set_split(train_split)
    kitti_infos_train = dataset.get_infos(
        num_workers=workers, has_label=True, count_inside_pts=True
    )
    with open(train_filename, "wb") as f:
        pickle.dump(kitti_infos_train, f)

    dataset.set_split(val_split)
    kitti_infos_val = dataset.get_infos(
        num_workers=workers, has_label=True, count_inside_pts=True
    )
    with open(val_filename, "wb") as f:
        pickle.dump(kitti_infos_val, f)
    with open(trainval_filename, "wb") as f:
        pickle.dump(kitti_infos_train + kitti_infos_val, f)

    dataset.set_split("test")
    kitti_infos_test = dataset.get_infos(
        num_workers=workers, has_label=False, count_inside_pts=False
    )
    with open(test_filename, "wb") as f:
        pickle.dump(kitti_infos_test, f)

    dataset.set_split(train_split)
    dataset.create_groundtruth_database(train_filename, split=train_split)


if __name__ == "__main__":
    import sys

    if sys.argv.__len__() > 1 and sys.argv[1] == "create_kitti_infos":
        import yaml as _yaml
        from ...utils.edict import EDict

        dataset_cfg = EDict(_yaml.safe_load(open(sys.argv[2])))
        ROOT_DIR = Path(sys.argv[3]) if len(sys.argv) > 3 else Path(dataset_cfg.DATA_PATH)
        create_kitti_infos(
            dataset_cfg=dataset_cfg,
            class_names=["Car", "Pedestrian", "Cyclist"],
            data_path=ROOT_DIR, save_path=ROOT_DIR,
        )
