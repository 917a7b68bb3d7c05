"""The tiny TSM configuration used to hold the port against the JAX package.

A copy of the repository's flagship tiny config (`_tsm_model_cfg` and
`_synth_batch` of `__graft_entry__.py`): the distilled TSM detector at
narrow widths on a 16 x 16 x 4 m range. `data/tsm_tiny_state.npz` holds
that model's weights as the JAX package initialises them (PRNGKey(0)),
converted by `convert.from_flax_variables`; with them the eval forward on
`synth_batch(2)` must reproduce `tests/goldens/tsm_forward.npz`.
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


def synth_points(batch_size, n=256, seed=0):
    """(B, n, 4) float32 points in the tiny range."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0.5, 15.5, (batch_size, n))
    pts[..., 1] = rng.uniform(-7.5, 7.5, (batch_size, n))
    pts[..., 2] = rng.uniform(-1.5, 1.5, (batch_size, n))
    pts[..., 3] = rng.uniform(0, 1, (batch_size, n))
    return pts


def load_state(path=STATE_PATH):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}
