"""The tiny configurations used to hold the port against the JAX package.

A copy of the repository's flagship tiny config (`_tsm_model_cfg` and
`_synth_batch` of `__graft_entry__.py`): the distilled TSM detector at
narrow widths on a 16 x 16 x 4 m range. `data/tsm_tiny_state.npz` holds
that model's weights as the JAX package initialises them (PRNGKey(0)),
converted by `convert.from_flax_variables`; with them the eval forward on
`synth_batch(2)` must reproduce `tests/goldens/tsm_forward.npz`.

Also a copy of the tiny SECOND of the JAX package's tests
(`second_model_cfg`, `META` and `synthetic_batch` of
tests/test_second_e2e.py): the real 8x-stride topology on a 32 x 32 x 40
grid, one class. `data/second_tiny_state.npz` holds its converted
PRNGKey(0) eval init; with it the eval forward on `second_points(2)` must
reproduce `tests/goldens/second_forward.npz`.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .models.detectors import DatasetMeta
from .utils.edict import EDict

PCR = [0.0, -8.0, -2.0, 16.0, 8.0, 2.0]
VOXEL = [0.25, 0.25, 0.25]
STATE_PATH = Path(__file__).resolve().parent / "data" / "tsm_tiny_state.npz"
SECOND_STATE_PATH = STATE_PATH.parent / "second_tiny_state.npz"
META = DatasetMeta(
    class_names=("Car", "Pedestrian", "Cyclist"),
    point_cloud_range=tuple(PCR), voxel_size=tuple(VOXEL),
    grid_size=(64, 64, 16), max_voxels=256, max_points_per_voxel=5,
    num_point_features=4, max_points=256,
)


def _sa_cfg(agg1=48):
    return {
        "NPOINT_LIST": [[64], [16]],
        "SAMPLE_RANGE_LIST": [[[0, 256]], [[0, 64]]],
        "SAMPLE_METHOD_LIST": [["d-fps"], ["s-fps"]],
        "QUERY_RANGE": [[[0, 0, 0], [0, 0, 0]], [[2, 2, 2], [4, 4, 4]]],
        "STRIDE": [[[0, 0, 0], [0, 0, 0]], [[1, 1, 1], [1, 1, 1]]],
        "RADIUS": [[0.5, 1.0], [1.0, 3.0]],
        "NSAMPLE": [[8, 8], [8, 8]],
        "MLPS": [[[8, 16], [8, 16]], [[16, 24], [16, 24]]],
        "SPCONV_MLPS_PRE": [[0, 0, 32], [agg1]],
        "AGGREGATION_MLPS": [[32], [agg1]],
        "CONFIDENCE_MLPS": [[16], [16]],
        "WEIGHT_GAMMA": 1.0,
        "DILATED_RADIUS_GROUP": True,
    }


def tiny_model_cfg():
    vsa = {
        "DILATED_RADIUS_GROUP": False,
        "QUERY_RANGE": [[2, 2, 2], [4, 4, 4]],
        "SPARSE_TENSOR_STRIDE": 4,
        "STRIDE": [[1, 1, 1], [1, 1, 1]],
        "RADIUS": [1.0, 3.0], "NSAMPLE": [8, 8],
        "MLPS": [[16, 24], [16, 24]],
    }
    return EDict({
        "NAME": "3DSSD",
        "FACTOR": 4,
        "BACKBONE_3D": {
            "NAME": "VoxelPointNet2FSMSGDistillation",
            "FACTOR": 4,
            "VOXEL_CONFIG": {"POINT_CLOUD_RANGE": PCR, "VOXEL_SIZE": VOXEL},
            "SA_CONFIG": _sa_cfg(),
            "S_SA_CONFIG": _sa_cfg(agg1=24),
        },
        "POINT_HEAD": {
            "NAME": "PointHeadVoteSASAStatisticDistillation",
            "CLASS_AGNOSTIC": False, "USE_BN": True,
            "SAMPLE_RANGE": [0, 16],
            "VOTE_CONFIG": {"VOTE_FC": [16], "MAX_TRANSLATION_RANGE": [3.0, 3.0, 2.0]},
            "VOXEL_CONFIG": {"POINT_CLOUD_RANGE": PCR, "VOXEL_SIZE": VOXEL},
            "VSA_CONFIG": vsa,
            "S_VOTE_CONFIG": {"VOTE_FC": [16], "MAX_TRANSLATION_RANGE": [3.0, 3.0, 2.0]},
            "S_VSA_CONFIG": vsa,
            "SHARED_FC": [48, 48], "DP_RATIO": -0.3,
            "CLS_FC": [16], "REG_FC": [16],
            "TARGET_CONFIG": {
                "VOTE_EXTRA_WIDTH": [0.1, 0.1, 0.1],
                "ASSIGN_METHOD": "mask", "GT_CENTRAL_RADIUS": 10.0,
                "BOX_CODER": "PointBinResidualCoder",
                "BOX_CODER_CONFIG": {"use_mean_size": False, "angle_bin_num": 12},
            },
            "LOSS_CONFIG": {
                "LOSS_CLS": "WeightedBinaryCrossEntropyWithCenterness",
                "LOSS_REG": "WeightedSmoothL1Loss",
                "LOSS_SASA_CONFIG": {
                    "func": "Focal", "set_ignore_flag": True,
                    "extra_width": [1.0, 1.0, 1.0],
                    "layer_weights": [0.1, 0.1, 0.1], "num_class": 3,
                },
                "AXIS_ALIGNED_IOU_LOSS_REGULARIZATION": False,
                "CORNER_LOSS_REGULARIZATION": True,
                "RDIOU_REGRESS_REGULARIZATION": True,
                "LOSS_WEIGHTS": {
                    "vote_reg_weight": 1.0, "point_cls_weight": 1.0,
                    "point_offset_reg_weight": 0.1,
                    "point_angle_cls_weight": 0.1,
                    "point_angle_reg_weight": 0.1,
                    "point_similarity_weight": 0.1,
                    "point_iou_weight": 1.0, "point_corner_weight": 1.0,
                },
            },
        },
        "POST_PROCESSING": {
            "RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
            "SCORE_THRESH": [0.62, 0.3, 0.3],
            "EVAL_METRIC": "kitti",
            "NMS_CONFIG": {"MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu",
                           "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 16,
                           "NMS_POST_MAXSIZE": 8},
        },
    })


# A Waymo-flavoured tiny configuration: 5 point features, a range symmetric
# about 0, 384 points sampled 96 / 24, and the Waymo config's NMS settings
# (NMS_THRESH 0.5, SCORE_THRESH 0.01 for every class).
WAYMO_PCR = [-8.0, -8.0, -2.0, 8.0, 8.0, 2.0]
WAYMO_POINTS = 384
WAYMO_META = DatasetMeta(
    class_names=("Vehicle", "Pedestrian", "Cyclist"),
    point_cloud_range=tuple(WAYMO_PCR), voxel_size=tuple(VOXEL),
    grid_size=(64, 64, 16), max_voxels=256, max_points_per_voxel=5,
    num_point_features=5, max_points=WAYMO_POINTS,
)


def tiny_waymo_model_cfg():
    cfg = tiny_model_cfg()
    for sa in (cfg.BACKBONE_3D.SA_CONFIG, cfg.BACKBONE_3D.S_SA_CONFIG):
        sa["NPOINT_LIST"] = [[96], [24]]
        sa["SAMPLE_RANGE_LIST"] = [[[0, WAYMO_POINTS]], [[0, 96]]]
    cfg.BACKBONE_3D.VOXEL_CONFIG["POINT_CLOUD_RANGE"] = WAYMO_PCR
    cfg.POINT_HEAD.VOXEL_CONFIG["POINT_CLOUD_RANGE"] = WAYMO_PCR
    cfg.POINT_HEAD["SAMPLE_RANGE"] = [0, 24]
    cfg.POST_PROCESSING["SCORE_THRESH"] = [0.01, 0.01, 0.01]
    cfg.POST_PROCESSING.NMS_CONFIG.update(
        {"NMS_THRESH": 0.5, "NMS_PRE_MAXSIZE": 24, "NMS_POST_MAXSIZE": 8})
    return cfg


def synth_waymo_points(batch_size, n=WAYMO_POINTS, seed=0):
    """(B, n, 5) float32 points in the tiny Waymo-flavoured range."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n, 5), np.float32)
    pts[..., 0] = rng.uniform(-7.5, 7.5, (batch_size, n))
    pts[..., 1] = rng.uniform(-7.5, 7.5, (batch_size, n))
    pts[..., 2] = rng.uniform(-1.5, 1.5, (batch_size, n))
    pts[..., 3:] = rng.uniform(0, 1, (batch_size, n, 2))
    return pts


def synth_points(batch_size, n=256, seed=0):
    """(B, n, 4) float32 points in the tiny range."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0.5, 15.5, (batch_size, n))
    pts[..., 1] = rng.uniform(-7.5, 7.5, (batch_size, n))
    pts[..., 2] = rng.uniform(-1.5, 1.5, (batch_size, n))
    pts[..., 3] = rng.uniform(0, 1, (batch_size, n))
    return pts


# gt boxes (x, y, z, dx, dy, dz, heading, class) of the tiny training batch:
# "sparse" is the reference's own pair of small boxes, which no vote reaches
# (no positives); "wide" adds boxes over most of the range, so that the box,
# rdiou and corner losses have positives
GT_BOXES = {
    "sparse": [[8, 0, -0.5, 3.9, 1.6, 1.56, 0.3, 1],
               [4, 3, -0.5, 0.8, 0.6, 1.7, -0.5, 2]],
    "wide": [[4, -4, 0, 7, 7, 3.5, 0.2, 1], [11, -3, 0, 7, 8, 3.5, -0.4, 2],
             [5, 4, 0, 8, 7, 3.5, 1.1, 3], [12, 4, 0, 7, 7, 3.5, 2.5, 1]],
}


def synth_gt(batch_size, which="sparse"):
    """gt_boxes (B, 4, 8) float32 and gt_boxes_mask (B, 4) bool: the boxes
    of GT_BOXES[which] in every scan, padded to 4 slots."""
    boxes = np.asarray(GT_BOXES[which], np.float32)
    gt = np.zeros((batch_size, 4, 8), np.float32)
    gt[:, :len(boxes)] = boxes
    mask = np.zeros((batch_size, 4), bool)
    mask[:, :len(boxes)] = True
    return gt, mask


def train_statistics(seed=5):
    """Seeded (3, SHARED_FC[-1]) class-statistics buffers for the tiny
    training checks (a real distillation run transfers them from the teacher
    checkpoint; the init's zeros would switch the cls conditioning off)."""
    rng = np.random.RandomState(seed)
    return {name: rng.randn(3, 48).astype(np.float32)
            for name in ("object_mean", "object_momentum",
                         "object_statistic_features")}


SECOND_META = DatasetMeta(
    class_names=("Car",),
    point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
    voxel_size=(0.5, 0.5, 0.1), grid_size=(32, 32, 40), max_voxels=512,
    max_points_per_voxel=5, num_point_features=4, max_points=512,
)


def second_model_cfg():
    return EDict({
        "NAME": "SECONDNet",
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "VoxelBackBone8x"},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
        "BACKBONE_2D": {
            "NAME": "BaseBEVBackbone",
            "LAYER_NUMS": [1, 1], "LAYER_STRIDES": [1, 2],
            "NUM_FILTERS": [32, 64], "UPSAMPLE_STRIDES": [1, 2],
            "NUM_UPSAMPLE_FILTERS": [32, 32],
        },
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle", "CLASS_AGNOSTIC": False,
            "USE_DIRECTION_CLASSIFIER": True, "DIR_OFFSET": 0.78539,
            "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
            "ANCHOR_GENERATOR_CONFIG": [{
                "class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]],
                "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.78],
                "align_center": False, "feature_map_stride": 8,
                "matched_threshold": 0.6, "unmatched_threshold": 0.45,
            }],
            "TARGET_ASSIGNER_CONFIG": {"MATCH_HEIGHT": False},
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {
                "cls_weight": 1.0, "loc_weight": 2.0, "dir_weight": 0.2,
                "code_weights": [1.0] * 7}},
        },
        "POST_PROCESSING": {
            "RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
            "SCORE_THRESH": 0.1, "EVAL_METRIC": "kitti",
            "NMS_CONFIG": {"MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu",
                           "NMS_THRESH": 0.01, "NMS_PRE_MAXSIZE": 64,
                           "NMS_POST_MAXSIZE": 8},
        },
    })


def second_points(batch_size=2, n=512, seed=0):
    """(B, n, 4) float32 points of the tiny SECOND batch: uniform in its
    range, the first 50 of each scan in a car-sized box at (8, 0, -1)."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0.5, 15.5, (batch_size, n))
    pts[..., 1] = rng.uniform(-7.5, 7.5, (batch_size, n))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (batch_size, n))
    pts[..., 3] = rng.uniform(0, 1, (batch_size, n))
    for b in range(batch_size):
        pts[b, :50, 0] = rng.uniform(6.5, 9.5, 50)
        pts[b, :50, 1] = rng.uniform(-0.7, 0.7, 50)
        pts[b, :50, 2] = rng.uniform(-1.7, -0.3, 50)
    return pts


def load_state(path=STATE_PATH):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}
