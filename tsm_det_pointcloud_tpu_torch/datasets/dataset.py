"""Dataset base class (counterpart of tsm_det_pointcloud_tpu/datasets/dataset.py:
`prepare_data` :85, `collate_batch` :124).

The batch layout is the fixed-shape one the port's models take:
  points (B, N_fixed, C) + points_mask (B, N_fixed) bool, N_fixed the data
  processor's NUM_POINTS (else MAX_POINTS);
  gt_boxes (B, MAX_GT_BOXES, 8) + gt_boxes_mask (B, MAX_GT_BOXES) bool.
The other `batch_dict` keys are the reference's.
"""
from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from ..utils.common_utils import keep_arrays_by_name
from .augmentor.data_augmentor import DataAugmentor
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder

DEFAULT_MAX_GT_BOXES = 100
DEFAULT_MAX_POINTS = 131072


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(
            root_path if root_path is not None else dataset_cfg.DATA_PATH
        )
        if self.dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.array(
            self.dataset_cfg.POINT_CLOUD_RANGE, dtype=np.float32
        )
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg.POINT_FEATURE_ENCODING,
            point_cloud_range=self.point_cloud_range,
        )
        self.data_augmentor = (
            DataAugmentor(
                self.root_path, self.dataset_cfg.DATA_AUGMENTOR,
                self.class_names, logger=self.logger,
            )
            if self.training and self.dataset_cfg.get("DATA_AUGMENTOR", None)
            else None
        )
        self.data_processor = DataProcessor(
            self.dataset_cfg.DATA_PROCESSOR,
            point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features,
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.max_gt_boxes = int(self.dataset_cfg.get("MAX_GT_BOXES", DEFAULT_MAX_GT_BOXES))
        self.max_points = int(
            self.data_processor.num_sampled_points
            or self.dataset_cfg.get("MAX_POINTS", DEFAULT_MAX_POINTS)
        )
        self.total_epochs = 0
        self._merge_all_iters_to_one_epoch = False
        # the pipeline's generator; the loader reseeds it before each sample
        self.rng = np.random.default_rng(0)

    @property
    def mode(self):
        return "train" if self.training else "test"

    def prepare_data(self, data_dict):
        """Augment -> class filter/encode -> feature encode -> process.
        Parity: dataset.py:102-158. Returns None when a training sample ends
        up with zero gt boxes (caller re-draws another index, reference
        :152-154)."""
        if self.training:
            assert "gt_boxes" in data_dict, "gt_boxes required for training"
            gt_boxes_mask = np.array(
                [n in self.class_names for n in data_dict["gt_names"]], dtype=bool
            )
            data_dict = self.data_augmentor.forward(
                {**data_dict, "gt_boxes_mask": gt_boxes_mask}, rng=self.rng
            ) if self.data_augmentor is not None else data_dict

        if data_dict.get("gt_boxes", None) is not None:
            selected = keep_arrays_by_name(data_dict["gt_names"], self.class_names)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                dtype=np.int32,
            )
            gt_boxes = np.concatenate(
                (data_dict["gt_boxes"], gt_classes.reshape(-1, 1).astype(np.float32)),
                axis=1,
            )
            data_dict["gt_boxes"] = gt_boxes

        if data_dict.get("points", None) is not None:
            data_dict = self.point_feature_encoder.forward(data_dict)

        data_dict = self.data_processor.forward(data_dict, rng=self.rng)

        if self.training and len(data_dict.get("gt_boxes", [])) == 0:
            return None

        data_dict.pop("gt_names", None)
        return data_dict

    def collate_batch(self, batch_list, _unused=False):
        """Fixed-shape batch assembly. Every output array has a static shape
        given (batch_size, max_points, max_gt_boxes)."""
        batch_list = [b for b in batch_list if b is not None]
        data_dict = defaultdict(list)
        for cur_sample in batch_list:
            for key, val in cur_sample.items():
                data_dict[key].append(val)
        batch_size = len(batch_list)
        ret = {}
        for key, val in data_dict.items():
            if key == "points":
                n = self.max_points
                pts = np.zeros((batch_size, n, val[0].shape[-1]), np.float32)
                mask = np.zeros((batch_size, n), bool)
                for i, p in enumerate(val):
                    k = min(len(p), n)
                    pts[i, :k] = p[:k]
                    mask[i, :k] = True
                ret["points"] = pts
                ret["points_mask"] = mask
            elif key == "gt_boxes":
                m = self.max_gt_boxes
                width = val[0].shape[-1] if len(val) and val[0].ndim == 2 else 8
                boxes = np.zeros((batch_size, m, width), np.float32)
                bmask = np.zeros((batch_size, m), bool)
                for i, b in enumerate(val):
                    k = min(len(b), m)
                    if k:
                        boxes[i, :k] = b[:k]
                        bmask[i, :k] = True
                ret["gt_boxes"] = boxes
                ret["gt_boxes_mask"] = bmask
            elif key in ("frame_id", "metadata", "calib", "use_lead_xyz", "image_shape"):
                ret[key] = np.array(val) if key == "image_shape" else val
            else:
                try:
                    ret[key] = np.stack(val, axis=0)
                except ValueError:
                    ret[key] = val
        ret["batch_size"] = batch_size
        return ret

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        raise NotImplementedError

    def evaluation(self, det_annos, class_names, **kwargs):
        raise NotImplementedError

    def merge_all_iters_to_one_epoch(self, merge=True, epochs=None):
        self._merge_all_iters_to_one_epoch = merge
        self.total_epochs = epochs

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError
