"""The Waymo Open Dataset (counterpart of
tsm_det_pointcloud_tpu/datasets/waymo/waymo_dataset.py).

Per-sequence info pickles, `SAMPLED_INTERVAL` subsampling (train 5: a fifth
of the frames), npy lidar frames [x, y, z, tanh(intensity), elongation] with
the no-label-zone filter unless `DISABLE_NLZ_FLAG_ON_POINTS`, multi-frame
sweeps aligned by pose with a time-lag channel (`SEQUENCE_CONFIG`), the gt
database with the per-frame class thinning, and the Waymo metric.

The preprocessing (tfrecords -> npy / pkl, `create_waymo_infos`, also a
command:
    python -m tsm_det_pointcloud_tpu_torch.datasets.waymo.waymo_dataset \\
        create_waymo_infos tools/cfgs/dataset_configs/waymo_dataset.yaml DATA_ROOT
) runs in Python and numpy (`waymo_preprocess`), a process a sequence. The
loader reads the layout it writes:
  <root>/<PROCESSED_DATA_TAG>/<sequence>/NNNN.npy + <sequence>.pkl

`USE_SHARED_MEMORY` (training only): the first SHARED_MEMORY_FILE_LIMIT
frames are loaded once into shared memory (`datasets.shared_memory`, one
array a frame, keyed <sequence>___<index>) when the dataset is made, and
read from there; `clean_shared_memory()` removes them. In a multi-process
run each rank loads and removes every world-size-th frame from its rank
(the JAX `_dist_info` stride) and all wait at a barrier before any reads
(a frame another host's shared memory holds is read from its file); the
caller removes them after a barrier. Without shared memory the frames are
read from their files, as in the JAX package.
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ...ops import boxes as box_ops
from ...parallel import comm
from .. import shared_memory as shm
from ..dataset import DatasetTemplate


class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, root_path=root_path, logger=logger,
        )
        self.data_path = self.root_path / self.dataset_cfg.get(
            "PROCESSED_DATA_TAG", "waymo_processed_data"
        )
        self.split = self.dataset_cfg.DATA_SPLIT[self.mode]
        split_file = self.root_path / "ImageSets" / (self.split + ".txt")
        self.sample_sequence_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists() else []
        )
        self.infos = []
        self.include_waymo_data(self.mode)
        self.use_shared_memory = (
            self.dataset_cfg.get("USE_SHARED_MEMORY", False) and self.training
        )
        self.shared_memory_file_limit = int(self.dataset_cfg.get(
            "SHARED_MEMORY_FILE_LIMIT", 0x7FFFFFFF
        ))
        if self.use_shared_memory:
            self.load_data_to_shared_memory()

    def include_waymo_data(self, mode):
        if self.logger:
            self.logger.info("Loading Waymo dataset")
        infos = []
        for seq in self.sample_sequence_list:
            seq_name = Path(seq).stem
            info_path = self.data_path / seq_name / (f"{seq_name}.pkl")
            if not info_path.exists():
                continue
            with open(info_path, "rb") as f:
                infos.extend(pickle.load(f))
        self.infos.extend(infos[:: self.dataset_cfg.get("SAMPLED_INTERVAL", {}).get(self.mode, 1)])
        if self.logger:
            self.logger.info("Total samples for Waymo dataset: %d" % len(self.infos))

    def _shared_frames(self):
        """The (sequence, index) keys of the frames this process caches in
        shared memory: every world-size-th from its rank (the JAX
        `_dist_info` stride)."""
        rank, world = comm.get_rank(), comm.get_world_size()
        for info in self.infos[: self.shared_memory_file_limit][rank::world]:
            pc = info["point_cloud"]
            yield f"{pc['lidar_sequence']}___{pc['sample_idx']}", pc

    def load_data_to_shared_memory(self):
        if not shm.available():
            self.use_shared_memory = False
            return
        for key, pc in self._shared_frames():
            if not shm.sa_exists(key):
                shm.sa_create(key, self._load_lidar_file(pc["lidar_sequence"],
                                                         pc["sample_idx"]))
        comm.barrier()   # every rank's frames are there before any rank reads
        if self.logger:
            self.logger.info("Training data has been saved to shared memory")

    def clean_shared_memory(self):
        super().clean_shared_memory()
        for key, _ in self._shared_frames():
            shm.sa_delete(key)

    def get_lidar(self, sequence_name, sample_idx):
        """A frame's points (N, 5): x, y, z, tanh(intensity), elongation;
        the no-label-zone points dropped unless DISABLE_NLZ_FLAG_ON_POINTS.
        From shared memory where the frame is cached there."""
        if self.use_shared_memory:
            key = f"{sequence_name}___{sample_idx}"
            if shm.sa_exists(key):
                return shm.sa_attach(key, copy=True)
        return self._load_lidar_file(sequence_name, sample_idx)

    def _load_lidar_file(self, sequence_name, sample_idx):
        lidar_file = self.data_path / sequence_name / ("%04d.npy" % sample_idx)
        point_features = np.load(lidar_file)  # (N, 6): xyz, intensity, elong, NLZ
        points_all, nlz_flag = point_features[:, 0:5], point_features[:, 5]
        if not self.dataset_cfg.get("DISABLE_NLZ_FLAG_ON_POINTS", False):
            points_all = points_all[nlz_flag == -1]
        points_all[:, 3] = np.tanh(points_all[:, 3])
        return points_all

    def get_sequence_data(self, info, sequence_name, sample_idx,
                          sweep_range=(-4, 0)):
        """The sweeps of `sweep_range` around the frame: each past frame's
        points moved into this frame by the two poses, every point with a
        time-lag channel 0.1 * -offset."""
        points_list = []
        pose_cur = np.asarray(info.get("pose", np.eye(4)), np.float64).reshape(4, 4)
        seq_len = info.get("sequence_len", sample_idx + 1)
        for offset in range(sweep_range[0], sweep_range[1] + 1):
            idx = sample_idx + offset
            if idx < 0 or idx >= seq_len:
                continue
            try:
                pts = self.get_lidar(sequence_name, idx)
            except FileNotFoundError:
                continue
            if offset != 0:
                pose_prev = self._pose_of(sequence_name, idx)
                if pose_prev is not None:
                    rel = np.linalg.inv(pose_cur) @ pose_prev
                    xyz1 = np.concatenate([pts[:, :3], np.ones((len(pts), 1))], 1)
                    pts = pts.copy()
                    pts[:, :3] = (xyz1 @ rel.T)[:, :3]
            lag = np.full((len(pts), 1), 0.1 * -offset, np.float32)
            points_list.append(np.concatenate([pts, lag], 1))
        return np.concatenate(points_list, 0) if points_list else None

    def _pose_of(self, sequence_name, sample_idx):
        for info in self.infos:
            pc = info["point_cloud"]
            if (pc["lidar_sequence"] == sequence_name and pc["sample_idx"] == sample_idx
                    and "pose" in info):
                return np.asarray(info["pose"], np.float64).reshape(4, 4)
        return None

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * self.total_epochs
        return len(self.infos)

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        info = copy.deepcopy(self.infos[index])
        pc_info = info["point_cloud"]
        sequence_name = pc_info["lidar_sequence"]
        sample_idx = pc_info["sample_idx"]
        seq_cfg = self.dataset_cfg.get("SEQUENCE_CONFIG", {})
        if seq_cfg.get("ENABLED", False):
            points = self.get_sequence_data(
                info, sequence_name, sample_idx,
                sweep_range=tuple(seq_cfg.get("SAMPLE_OFFSET", [-4, 0])),
            )
        else:
            points = self.get_lidar(sequence_name, sample_idx)

        input_dict = {
            "points": points,
            "frame_id": info.get("frame_id", f"{sequence_name}_{sample_idx}"),
        }
        if "annos" in info:
            annos = info["annos"]
            mask = annos["name"] != "unknown"
            input_dict.update({
                "gt_names": annos["name"][mask],
                "gt_boxes": annos["gt_boxes_lidar"][mask].astype(np.float32),
                "num_points_in_gt": annos.get(
                    "num_points_in_gt", np.zeros(mask.sum()))[mask],
            })
        data_dict = self.prepare_data(data_dict=input_dict)
        if data_dict is None:
            new_index = int(self.rng.integers(0, len(self)))
            return self.__getitem__(new_index)
        data_dict.pop("num_points_in_gt", None)
        data_dict["metadata"] = info.get("metadata", None)
        return data_dict

    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names, output_path=None):
        annos = []
        for b, box_dict in enumerate(pred_dicts):
            boxes = np.asarray(box_dict["pred_boxes"]).reshape(-1, 7)
            scores = np.asarray(box_dict["pred_scores"]).reshape(-1)
            labels = np.asarray(box_dict["pred_labels"]).reshape(-1)
            keep = scores > 0
            annos.append({
                "name": np.array(class_names, dtype=object)[
                    np.clip(labels[keep] - 1, 0, len(class_names) - 1)
                ] if keep.any() else np.zeros(0, object),
                "score": scores[keep],
                "boxes_lidar": boxes[keep],
                "frame_id": (np.asarray(batch_dict["frame_id"])[b]
                             if "frame_id" in batch_dict else b),
            })
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """The Waymo metric (DATA_CONFIG.EVAL_METRIC, default waymo; any
        other raises) on the split's gt, Car read as Vehicle."""
        if "annos" not in self.infos[0]:
            return "No ground-truth boxes for evaluation", {}
        metric = self.dataset_cfg.get("EVAL_METRIC", "waymo")
        eval_det = copy.deepcopy(det_annos)
        eval_gt = [copy.deepcopy(info["annos"]) for info in self.infos]
        if metric == "waymo":
            from ...eval.waymo_eval import waymo_evaluation

            name_map = {"Car": "Vehicle"}
            for a in eval_det + eval_gt:
                a["name"] = np.asarray([name_map.get(n, n) for n in a["name"]], dtype=object)
            classes = tuple(name_map.get(c, c) for c in class_names)
            return waymo_evaluation(eval_gt, eval_det, classes)
        raise NotImplementedError(metric)

    def create_groundtruth_database(self, info_path=None, used_classes=None, split="train",
                                    sampled_interval=1, processed_data_tag=None):
        """The gt database of copy-paste augmentation: each gt object's points
        (box-centred) in a .bin, and pcdet_waymo_dbinfos_<split>_sampled_<k>.pkl;
        a Vehicle only every 4th frame and a Pedestrian every 2nd."""
        db_path = self.root_path / f"pcdet_gt_database_{split}_sampled_{sampled_interval}"
        db_info_path = (self.root_path
                        / f"pcdet_waymo_dbinfos_{split}_sampled_{sampled_interval}.pkl")
        db_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        for k in range(0, len(self.infos), sampled_interval):
            info = self.infos[k]
            pc_info = info["point_cloud"]
            seq, idx = pc_info["lidar_sequence"], pc_info["sample_idx"]
            points = self.get_lidar(seq, idx)
            annos = info["annos"]
            names = annos["name"]
            gt_boxes = annos["gt_boxes_lidar"]
            box_idx = box_ops.points_in_boxes_np(points[:, :3], gt_boxes[:, :7])
            for i in range(len(names)):
                if used_classes and names[i] not in used_classes:
                    continue
                if names[i] == "Vehicle" and k % 4 != 0:
                    continue
                if names[i] == "Pedestrian" and k % 2 != 0:
                    continue
                gt_points = points[box_idx == i]
                if len(gt_points) == 0:
                    continue
                gt_points = gt_points.copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                fname = f"{seq}_{idx}_{names[i]}_{i}.bin"
                with open(db_path / fname, "wb") as f:
                    gt_points.astype(np.float32).tofile(f)
                all_db_infos.setdefault(names[i], []).append({
                    "name": names[i],
                    "path": str(Path(db_path.name) / fname),
                    "sequence_name": seq,
                    "sample_idx": idx,
                    "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": len(gt_points),
                    "difficulty": annos.get("difficulty", [0] * len(names))[i],
                })
        with open(db_info_path, "wb") as f:
            pickle.dump(all_db_infos, f)
        return db_info_path

    def set_split(self, split):
        self.split = split
        split_file = self.root_path / "ImageSets" / (self.split + ".txt")
        self.sample_sequence_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists() else []
        )
        self.infos = []

    def get_infos(self, raw_data_path, save_path, num_workers=1, has_label=True,
                  sampled_interval=1):
        """tfrecords -> per-sequence npy / pkl (`waymo_preprocess`), a
        sequence a process of a pool of `num_workers` (forked from the
        loaders' fork server, `datasets.forkserver_context`)."""
        from functools import partial

        from .waymo_preprocess import process_single_sequence

        fn = partial(process_single_sequence, save_path=Path(save_path),
                     sampled_interval=sampled_interval, has_label=has_label)
        files = [Path(raw_data_path) / seq for seq in self.sample_sequence_list]
        if num_workers > 1:
            from .. import forkserver_context

            with forkserver_context().Pool(num_workers) as pool:
                per_seq = pool.map(fn, files)
        else:
            per_seq = [fn(f) for f in files]
        return [info for seq in per_seq for info in seq]


def create_waymo_infos(dataset_cfg, class_names, data_path, save_path, raw_data_tag="raw_data",
                       processed_data_tag="waymo_processed_data", workers=1):
    """tfrecords under <data_path>/<raw_data_tag>/ -> per-sequence npy / pkl
    under <save_path>/<processed_data_tag>/, the split info pickles and the
    train gt database (the reference's waymo_dataset.py:403-445)."""
    from ...utils.common_utils import create_logger

    data_path, save_path = Path(data_path), Path(save_path)
    dataset = WaymoDataset(dataset_cfg=dataset_cfg, class_names=class_names,
                           root_path=data_path, training=False, logger=create_logger())
    train_split, val_split = "train", "val"
    train_filename = save_path / f"{processed_data_tag}_infos_{train_split}.pkl"
    val_filename = save_path / f"{processed_data_tag}_infos_{val_split}.pkl"

    print("---------------Start to generate data infos---------------")
    dataset.set_split(train_split)
    waymo_infos_train = dataset.get_infos(
        raw_data_path=data_path / raw_data_tag, save_path=save_path / processed_data_tag,
        num_workers=workers, has_label=True, sampled_interval=1)
    with open(train_filename, "wb") as f:
        pickle.dump(waymo_infos_train, f)
    print(f"----------------Waymo info train file is saved to "
          f"{train_filename}----------------")

    dataset.set_split(val_split)
    waymo_infos_val = dataset.get_infos(
        raw_data_path=data_path / raw_data_tag, save_path=save_path / processed_data_tag,
        num_workers=workers, has_label=True, sampled_interval=1)
    with open(val_filename, "wb") as f:
        pickle.dump(waymo_infos_val, f)
    print(f"----------------Waymo info val file is saved to "
          f"{val_filename}----------------")

    print("---------------Start create groundtruth database for data "
          "augmentation---------------")
    dataset.set_split(train_split)
    dataset.infos = list(waymo_infos_train)
    dataset.create_groundtruth_database(
        info_path=train_filename, split="train", sampled_interval=1,
        used_classes=["Vehicle", "Pedestrian", "Cyclist"],
        processed_data_tag=processed_data_tag)
    print("---------------Data preparation Done---------------")


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "create_waymo_infos":
        import yaml as _yaml

        from ...utils.edict import EDict

        dataset_cfg = EDict(_yaml.safe_load(open(sys.argv[2])))
        ROOT_DIR = Path(sys.argv[3]) if len(sys.argv) > 3 else Path(dataset_cfg.DATA_PATH)
        create_waymo_infos(
            dataset_cfg=dataset_cfg, class_names=["Vehicle", "Pedestrian", "Cyclist"],
            data_path=ROOT_DIR, save_path=ROOT_DIR,
            processed_data_tag=dataset_cfg.get("PROCESSED_DATA_TAG", "waymo_processed_data"),
            workers=int(sys.argv[4]) if len(sys.argv) > 4 else 1)
