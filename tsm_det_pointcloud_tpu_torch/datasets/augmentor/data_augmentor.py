"""Config-driven augmentation queue (counterpart of
tsm_det_pointcloud_tpu/datasets/augmentor/data_augmentor.py).

Each AUG_CONFIG_LIST entry's NAME selects a method; DISABLE_AUG_LIST filters.
The last step wraps headings into [-pi, pi) and applies gt_boxes_mask. Every
call takes the dataset's np.random.Generator, reseeded per (seed, epoch,
index) by the loader.
"""
from __future__ import annotations

import numpy as np

from ...utils.common_utils import limit_period
from . import augmentor_utils
from .database_sampler import DataBaseSampler


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.augmentor_configs = augmentor_configs
        self._build_queue()

    def _build_queue(self):
        augmentor_configs = self.augmentor_configs
        self.data_augmentor_queue = []
        aug_config_list = (
            augmentor_configs
            if isinstance(augmentor_configs, list)
            else augmentor_configs.AUG_CONFIG_LIST
        )
        disable_list = (
            [] if isinstance(augmentor_configs, list)
            else augmentor_configs.get("DISABLE_AUG_LIST", [])
        )
        for cur_cfg in aug_config_list:
            if cur_cfg.NAME in disable_list:
                continue
            cur_augmentor = getattr(self, cur_cfg.NAME)(config=cur_cfg)
            self.data_augmentor_queue.append(cur_augmentor)

    def __getstate__(self):
        # the queue holds closures, which do not pickle: a loader worker
        # rebuilds it from the configs
        state = dict(self.__dict__)
        del state["data_augmentor_queue"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._build_queue()

    # -- factories (each returns fn(data_dict, rng) -> data_dict) -----------

    def gt_sampling(self, config=None):
        sampler = DataBaseSampler(
            root_path=self.root_path, sampler_cfg=config,
            class_names=self.class_names, logger=self.logger,
        )
        return sampler

    def random_world_flip(self, config=None):
        prob = config.get("ENABLE_PROB", 0.5)
        axes = config["ALONG_AXIS_LIST"]

        def fn(data_dict, rng):
            for ax in axes:
                f = (
                    augmentor_utils.random_flip_along_x
                    if ax == "x"
                    else augmentor_utils.random_flip_along_y
                )
                data_dict["gt_boxes"], data_dict["points"] = f(
                    data_dict["gt_boxes"], data_dict["points"], rng, prob=prob
                )
            return data_dict

        return fn

    def random_world_rotation(self, config=None):
        rot_range = config["WORLD_ROT_ANGLE"]
        prob = config.get("ENABLE_PROB", 1.0)

        def fn(data_dict, rng):
            data_dict["gt_boxes"], data_dict["points"] = augmentor_utils.global_rotation(
                data_dict["gt_boxes"], data_dict["points"], rng, rot_range, prob=prob
            )
            return data_dict

        return fn

    def random_world_scaling(self, config=None):
        scale_range = config["WORLD_SCALE_RANGE"]
        prob = config.get("ENABLE_PROB", 1.0)

        def fn(data_dict, rng):
            data_dict["gt_boxes"], data_dict["points"] = augmentor_utils.global_scaling(
                data_dict["gt_boxes"], data_dict["points"], rng, scale_range, prob=prob
            )
            return data_dict

        return fn

    def random_box_noise(self, config=None):
        prob = config.get("ENABLE_PROB", 0.5)

        def fn(data_dict, rng):
            data_dict["gt_boxes"], data_dict["points"] = augmentor_utils.random_box_noise(
                data_dict["gt_boxes"], data_dict["points"], rng,
                loc_noise=config["LOC_NOISE"],
                scale_range=config["SCALE_RANGE"],
                rot_range=config["ROTATION_RANGE"],
                prob=prob,
            )
            return data_dict

        return fn

    def random_local_rotation(self, config=None):
        def fn(data_dict, rng):
            data_dict["gt_boxes"], data_dict["points"] = augmentor_utils.random_local_rotation(
                data_dict["gt_boxes"], data_dict["points"], rng,
                config["LOCAL_ROT_ANGLE"],
            )
            return data_dict

        return fn

    def random_local_translation(self, config=None):
        def fn(data_dict, rng):
            data_dict["gt_boxes"], data_dict["points"] = augmentor_utils.random_local_translation(
                data_dict["gt_boxes"], data_dict["points"], rng,
                config["LOCAL_TRANSLATION_RANGE"],
                axes=config.get("ALONG_AXIS_LIST", ["x", "y", "z"]),
            )
            return data_dict

        return fn

    def random_local_scaling(self, config=None):
        def fn(data_dict, rng):
            data_dict["gt_boxes"], data_dict["points"] = augmentor_utils.random_local_scaling(
                data_dict["gt_boxes"], data_dict["points"], rng,
                config["LOCAL_SCALE_RANGE"],
            )
            return data_dict

        return fn

    def random_world_frustum_dropout(self, config=None):
        def fn(data_dict, rng):
            for direction in config.get("DIRECTION", ["top"]):
                rng_range = config.get("INTENSITY_RANGE", [0.0, 0.2])
                data_dict["gt_boxes"], data_dict["points"] = getattr(
                    augmentor_utils, f"global_frustum_dropout_{direction}")(
                    data_dict["gt_boxes"], data_dict["points"], rng, rng_range)
            return data_dict

        return fn

    def random_local_pyramid_aug(self, config=None):
        def fn(data_dict, rng):
            data_dict["gt_boxes"], data_dict["points"] = augmentor_utils.local_pyramid_aug(
                data_dict["gt_boxes"], data_dict["points"], rng,
                drop_prob=config.get("DROP_PROB", 0.25),
                sparsify_prob=config.get("SPARSIFY_PROB", 0.05),
                sparsify_max_num=config.get("SPARSIFY_MAX_NUM", 50),
                swap_prob=config.get("SWAP_PROB", 0.1),
                swap_max_num=config.get("SWAP_MAX_NUM", 50),
            )
            return data_dict

        return fn

    # -- driver --------------------------------------------------------------

    def forward(self, data_dict, rng=None):
        rng = rng if rng is not None else np.random.default_rng()
        for aug in self.data_augmentor_queue:
            data_dict = aug(data_dict, rng)

        data_dict["gt_boxes"][:, 6] = limit_period(
            data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi
        )
        if "calib" in data_dict:
            data_dict.pop("calib", None)
        if "road_plane" in data_dict:
            data_dict.pop("road_plane", None)
        if "gt_boxes_mask" in data_dict:
            gt_boxes_mask = data_dict["gt_boxes_mask"]
            data_dict["gt_boxes"] = data_dict["gt_boxes"][gt_boxes_mask]
            data_dict["gt_names"] = data_dict["gt_names"][gt_boxes_mask]
            data_dict.pop("gt_boxes_mask")
        return data_dict
