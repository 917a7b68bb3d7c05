"""The tiny configurations used to hold the port against the JAX package.

A copy of the repository's flagship tiny config (`_tsm_model_cfg` and
`_synth_batch` of `__graft_entry__.py`): the distilled TSM detector at
narrow widths on a 16 x 16 x 4 m range. `data/tsm_tiny_state.npz` holds
that model's weights as the JAX package initialises them (PRNGKey(0)),
converted by `convert.from_flax_variables`; with them the eval forward on
`synth_batch(2)` must reproduce `tests/goldens/tsm_forward.npz`.

`tiny_teacher_model_cfg()` is the same model's teacher phase: the
VoxelPointNet2FSMSG backbone (SA_CONFIG, both layers) and the
PointHeadVoteSASAStatistic head (VOTE_CONFIG, VSA_CONFIG), without the
student's S_* sections. `data/tsm_teacher_tiny_state.npz` holds its
converted PRNGKey(0) training init; with it and `teacher_overrides()`
(seeded class statistics and a confidence bias of layer 1 under which the
statistic update counts points of two classes and none of the third) the
eval forward on `synth_points(2)` must reproduce
`data/tsm_teacher_tiny_forward.npz`, and one training step on it with the
"wide" boxes `data/tsm_teacher_tiny_train_golden.npz`.

Also a copy of the tiny SECOND of the JAX package's tests
(`second_model_cfg`, `META` and `synthetic_batch` of
tests/test_second_e2e.py): the real 8x-stride topology on a 32 x 32 x 40
grid, one class. `data/second_tiny_state.npz` holds its converted
PRNGKey(0) eval init; with it the eval forward on `second_points(2)` must
reproduce `tests/goldens/second_forward.npz`. `second_gt` gives its
training batches their gt boxes.

The tiny PointPillars is a copy of the JAX package's test model
(`tiny_model_cfg`, `META` and `synthetic_batch` of
tests/test_pointpillar_e2e.py): 0.5 m pillars of at most 8 points on the
SECOND tiny range, 256 pillars for 512 points (the scans overflow it), one
class. `data/pointpillar_tiny_state.npz` holds its converted PRNGKey(0) eval
init; with it the eval forward on `second_points(2)` (the same batch) must
reproduce `tests/goldens/pointpillar_forward.npz`.

The tiny CenterPoint (`centerpoint_model_cfg`, `CENTERPOINT_META`) runs
VoxelResBackBone8x on a 64 x 64 x 40 grid of the same range and a
CenterHead of two class groups (Car; Pedestrian and Cyclist), so that the
group-local labels go through the label table, with circle NMS.
`data/centerpoint_tiny_state.npz` holds its converted PRNGKey(0) eval init
and `data/centerpoint_tiny_forward.npz` the JAX package's eval outputs and
post-processed predictions on `second_points(2)` with
`centerpoint_eval_state()`: that init with every value redrawn from a numpy
seed, so that the heatmap scores spread (at the init they all lie within
1e-3 of sigmoid(-2.19), and their order would turn on rounding).
`centerpoint_gt` gives its training batches their gt boxes.

The tiny nuScenes CenterPoint (`centerpoint_nusc_model_cfg`,
`CENTERPOINT_NUSC_META`) is the tiny CenterPoint on a nuScenes-like 16 x 16
x 8 m range (a 64 x 64 x 40 grid) with 5 point features (x, y, z,
intensity, time lag: `nusc_points`) and a `vel` head in each of its two
class groups (car; pedestrian and barrier), so that its boxes are 9 columns
and its targets 10 wide (`centerpoint_nusc_gt`: gt boxes with velocities).
No init is committed: its checks run on `centerpoint_nusc_state()`, every
entry of the port model's state dict drawn from a numpy seed
(`redraw_state`), its hm_out kernels as `centerpoint_eval_state` sets them;
`data/centerpoint_nusc_tiny_forward.npz` holds the JAX package's eval
outputs and post-processed predictions with it. The tiny Lyft CenterPoint
(`centerpoint_lyft_model_cfg`, `CENTERPOINT_LYFT_META`) is the tiny
CenterPoint on the same range and point features with the Lyft config's
head layout: Lyft's nine classes in five groups, no `vel` head (7-column
boxes); its state is `centerpoint_lyft_state()`, drawn the same way, and
`data/centerpoint_lyft_tiny_forward.npz` holds the JAX package's eval
outputs and predictions with it on `nusc_points(2)`. The PandaSet config
runs the KITTI CenterPoint's model: its tiny model is the tiny CenterPoint.

The tiny two-stage detectors are copies of the JAX package's test models
(`model_cfg` and `META` of tests/test_parta2_e2e.py and
tests/test_pvrcnn_e2e.py): Part-A2 (UNetV2, a 4^3 RoI-aware pool) and
PV-RCNN (64 keypoints over bev, x_conv3, x_conv4 and the raw points, a 3^3
RoI grid) on the tiny SECOND's range and grid, one class, fed
`second_points(2, 256)`. Their checks run on `two_stage_state(which)`, a
state drawn from a numpy seed over the port model's own entries (no init
is committed: the converted inits would take 5.4 MB and 3.1 MB), with the
anchor head's cls bias lifted so that the proposals' scores spread;
`data/parta2_tiny_forward.npz` and `data/pvrcnn_tiny_forward.npz` hold the
JAX package's eval outputs and post-processed predictions with it.
`two_stage_gt` gives their training batches their gt boxes.

The tiny PointRCNN is the JAX package's test model (`pointrcnn_cfg` and
`META_POINT` of tests/test_two_stage_models.py) with the in-RoI SA stack of
its `test_pointrcnn_roi_sa_stack_e2e` (NPOINTS [16, -1]: a d-fps and ball
query layer, then the GroupAll terminal), so that it runs every layer
pointrcnn.yaml runs: PointNet2MSG at 64 / 16 centres and two FP levels,
PointHeadBox with one mean size, 32 pooled points a RoI. One class, fed
`second_points(2, 256)`. `data/pointrcnn_tiny_state.npz` holds its
converted PRNGKey(0) training init; its checks run on
`two_stage_state("pointrcnn")`, that init redrawn from a numpy seed (at the
init every point scores within rounding of sigmoid(-log 99), and the
proposals' order would turn on it);
`data/pointrcnn_tiny_forward.npz` holds the JAX package's eval outputs and
post-processed predictions with it, and `TWO_STAGE_GT["pointrcnn"]` the gt
boxes of its training batches.

The tiny Voxel R-CNN and SECONDNetIoU are the JAX package's test models
(`voxelrcnn_cfg` and `test_secondnet_iou_e2e` of
tests/test_two_stage_models.py, on META_VOXEL, which is PVRCNN_META): the
anchor RPN on VoxelBackBone8x, then a 3^3 RoI grid pooled over x_conv3 and
x_conv4 by window queries, or a 3^3 lattice of the BEV map and the IoU
branch. Their checks run on `two_stage_state("voxelrcnn" /
"secondnetiou")`; `data/{voxelrcnn,secondnetiou}_tiny_forward.npz` hold the
JAX package's eval outputs and predictions with it.

The tiny PV-RCNN++ (`pvrcnnplusplus_model_cfg`) is the tiny PV-RCNN with
sector keypoint sampling and VectorPool on the raw points and on x_conv3.
Its checks run on `two_stage_state("pvrcnnplusplus")`, whose entries of
PV-RCNN's names and shapes are PV-RCNN's draws (`SHARED_DRAWS`), so that
its proposals and training RoIs are PV-RCNN's and it trains on PV-RCNN's
gt boxes; `data/pvrcnnplusplus_tiny_forward.npz` holds the JAX package's
eval outputs and predictions with it.

The tiny PVSSDAs (`pvssda_model_cfg(which)`, `PVSSDA_META`, on
`pvssda_points(2)`: 512 points a scan, 150 of them in a car-sized box) are
the TSM project's point detector on both PointNet++ backbones: "fsmsg" on
PointNet2FSMSG with every branch of it (layer 0: d-fps and three dilated
scales, the widest of 40 samples; layer 1: f-fps, s-fps on layer 0's
confidence scores and d-fps over the range [64, 128), confidence scores at
both layers) under PVSSDAHead with mean sizes, "msg" on the JAX package's
test topology (`test_experimental_variants.py`'s PN2 and its
`use_mean_size: False` head). Their checks run on `pvssda_state(which)`,
every entry drawn from a numpy seed; `data/pvssda_tiny_forward.npz` holds
the JAX package's eval outputs and predictions of the "fsmsg" one.

The tiny CaDDN is the JAX package's test model (`model_cfg`, `META` and
`batch` of tests/test_caddn_e2e.py): ImageVFE at 16 features and 16 depth
bins over 1-20 m, Conv2DCollapse, a one-level BEV backbone and a one-class
anchor head, on a 32 x 32 x 16 grid of a 16 x 16 x 4 m range, fed 64 x 96
noise images under a pinhole looking down +x (`caddn_batch`). Its two depth
networks: `caddn_model_cfg("compact")` (CompactDDN) and
`caddn_model_cfg("deeplab")` (the DDNDeepLabV3 plan LAYERS [1, 1, 1, 1],
WIDTH 8, with the fg / bg balancer's weights). Their checks run on
`caddn_state(which)`, every entry drawn from a numpy seed (`redraw_state`);
`data/caddn_tiny_forward.npz` holds the JAX package's eval outputs,
post-processed predictions and training loss terms with it, the deeplab
model's training batch with `caddn_boxes2d`.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .models.detectors import DatasetMeta
from .utils.edict import EDict

PCR = [0.0, -8.0, -2.0, 16.0, 8.0, 2.0]
VOXEL = [0.25, 0.25, 0.25]
STATE_PATH = Path(__file__).resolve().parent / "data" / "tsm_tiny_state.npz"
SECOND_STATE_PATH = STATE_PATH.parent / "second_tiny_state.npz"
TEACHER_STATE_PATH = STATE_PATH.parent / "tsm_teacher_tiny_state.npz"
TEACHER_FORWARD_PATH = STATE_PATH.parent / "tsm_teacher_tiny_forward.npz"
TEACHER_TRAIN_GOLDEN_PATH = STATE_PATH.parent / "tsm_teacher_tiny_train_golden.npz"
POINTPILLAR_STATE_PATH = STATE_PATH.parent / "pointpillar_tiny_state.npz"
CENTERPOINT_STATE_PATH = STATE_PATH.parent / "centerpoint_tiny_state.npz"
CENTERPOINT_FORWARD_PATH = STATE_PATH.parent / "centerpoint_tiny_forward.npz"
PARTA2_FORWARD_PATH = STATE_PATH.parent / "parta2_tiny_forward.npz"
PVRCNN_FORWARD_PATH = STATE_PATH.parent / "pvrcnn_tiny_forward.npz"
POINTRCNN_STATE_PATH = STATE_PATH.parent / "pointrcnn_tiny_state.npz"
POINTRCNN_FORWARD_PATH = STATE_PATH.parent / "pointrcnn_tiny_forward.npz"
VOXELRCNN_FORWARD_PATH = STATE_PATH.parent / "voxelrcnn_tiny_forward.npz"
SECONDNETIOU_FORWARD_PATH = STATE_PATH.parent / "secondnetiou_tiny_forward.npz"
PVRCNNPLUSPLUS_FORWARD_PATH = STATE_PATH.parent / "pvrcnnplusplus_tiny_forward.npz"
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


def tiny_teacher_model_cfg():
    """The teacher phase of `tiny_model_cfg()`: its SA_CONFIG, VOTE_CONFIG
    and VSA_CONFIG under the teacher's backbone and head, no S_* keys."""
    cfg = tiny_model_cfg()
    cfg.BACKBONE_3D["NAME"] = "VoxelPointNet2FSMSG"
    del cfg.BACKBONE_3D["S_SA_CONFIG"]
    cfg.POINT_HEAD["NAME"] = "PointHeadVoteSASAStatistic"
    del cfg.POINT_HEAD["S_VOTE_CONFIG"], cfg.POINT_HEAD["S_VSA_CONFIG"]
    return cfg


# the tiny teacher's layer-1 confidence bias in the checks: with the init's
# weights the points of synth_points(2) then fall to classes 0 and 1 with
# scores over the update's 0.3, and none to class 2
TEACHER_CONF_BIAS = (0.0, 0.0, -6.0)


def teacher_overrides(seed=5):
    """Port state entries that the tiny teacher's checks set over the
    PRNGKey(0) init: seeded class statistics (zeros would make the cls
    conditioning a constant) and TEACHER_CONF_BIAS."""
    out = {f"module_list.1.head.{k}": v for k, v in train_statistics(seed).items()}
    out["module_list.0.sa1.confidence_out.bias"] = np.asarray(TEACHER_CONF_BIAS, np.float32)
    return out


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


# gt boxes of the tiny SECOND's training checks, (x, y, z, dx, dy, dz,
# heading, class), per scan: "ref" is the reference batch's own box, which its
# anchors barely overlap (one forced match a scan); "anchored" has boxes on the anchors of both rotations (positives, both
# direction bins, a heading past pi / 4 that swaps its BEV extent), a box
# that only a forced match takes (its best IoU under 0.45, equal at two
# anchors up to rounding), one on pi / 4 itself and a masked slot that would
# match.
SECOND_GT = {
    "ref": [[[8.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1]],
            [[8.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1]]],
    "anchored": [[[5.5, -2.5, -1.0, 4.0, 1.7, 1.6, 0.2, 1],
                  [10.5, 2.8, -0.9, 4.1, 1.7, 1.5, 1.6, 1],
                  [10.6, -2.6, -1.0, 3.8, 1.5, 1.5, -1.5, 1]],
                 [[8.0, -1.3, -1.0, 5.0, 2.0, 1.5, 0.1, 1],
                  [2.0, 5.0, -1.0, 4.0, 1.8, 1.5, 0.7853982, 1],
                  [5.5, 2.6, -1.0, 4.0, 1.7, 1.6, 0.0, 1]]],
}
SECOND_GT_MASKED = {"ref": (), "anchored": ((1, 2),)}   # (scan, slot) masked out


def second_gt(batch_size, which="anchored"):
    """gt_boxes (B, 4, 8) float32 and gt_boxes_mask (B, 4) bool of the tiny
    SECOND: SECOND_GT[which]'s scans in turn, padded to 4 slots."""
    gt = np.zeros((batch_size, 4, 8), np.float32)
    mask = np.zeros((batch_size, 4), bool)
    scans = SECOND_GT[which]
    for b in range(batch_size):
        boxes = np.asarray(scans[b % len(scans)], np.float32)
        gt[b, :len(boxes)] = boxes
        mask[b, :len(boxes)] = True
    for b, slot in SECOND_GT_MASKED[which]:
        if b < batch_size:
            mask[b, slot] = False
    return gt, mask


POINTPILLAR_META = DatasetMeta(
    class_names=("Car",),
    point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
    voxel_size=(0.5, 0.5, 4.0), grid_size=(32, 32, 1), max_voxels=256,
    max_points_per_voxel=8, num_point_features=4, max_points=512,
)


def pointpillar_model_cfg():
    return EDict({
        "NAME": "PointPillar",
        "VFE": {"NAME": "PillarVFE", "WITH_DISTANCE": False, "USE_ABSLOTE_XYZ": True,
                "USE_NORM": True, "NUM_FILTERS": [16]},
        "MAP_TO_BEV": {"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": 16},
        "BACKBONE_2D": {
            "NAME": "BaseBEVBackbone",
            "LAYER_NUMS": [1, 1], "LAYER_STRIDES": [2, 2],
            "NUM_FILTERS": [16, 32], "UPSAMPLE_STRIDES": [1, 2],
            "NUM_UPSAMPLE_FILTERS": [16, 16],
        },
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle", "CLASS_AGNOSTIC": False,
            "USE_DIRECTION_CLASSIFIER": True, "DIR_OFFSET": 0.78539,
            "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
            "ANCHOR_GENERATOR_CONFIG": [{
                "class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]],
                "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.78],
                "align_center": False, "feature_map_stride": 2,
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
                           "NMS_THRESH": 0.01, "NMS_PRE_MAXSIZE": 128,
                           "NMS_POST_MAXSIZE": 16},
        },
    })


def pointpillar_gt(batch_size):
    """gt_boxes (B, 5, 8) and gt_boxes_mask (B, 5) of the reference batch:
    two cars a scan."""
    gt = np.zeros((batch_size, 5, 8), np.float32)
    gt[:, 0] = [8, 0, -1, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [4, 3, -1, 3.9, 1.6, 1.56, -0.5, 1]
    mask = np.zeros((batch_size, 5), bool)
    mask[:, :2] = True
    return gt, mask


CENTERPOINT_META = DatasetMeta(
    class_names=("Car", "Pedestrian", "Cyclist"),
    point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
    voxel_size=(0.25, 0.25, 0.1), grid_size=(64, 64, 40), max_voxels=512,
    max_points_per_voxel=5, num_point_features=4, max_points=512,
)


def centerpoint_model_cfg():
    heads = {"center": {"out_channels": 2, "num_conv": 2},
             "center_z": {"out_channels": 1, "num_conv": 2},
             "dim": {"out_channels": 3, "num_conv": 2},
             "rot": {"out_channels": 2, "num_conv": 2}}
    return EDict({
        "NAME": "CenterPoint",
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "VoxelResBackBone8x"},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
        "BACKBONE_2D": {
            "NAME": "BaseBEVBackbone",
            "LAYER_NUMS": [1, 1], "LAYER_STRIDES": [1, 2],
            "NUM_FILTERS": [32, 64], "UPSAMPLE_STRIDES": [1, 2],
            "NUM_UPSAMPLE_FILTERS": [32, 32],
        },
        "DENSE_HEAD": {
            "NAME": "CenterHead",
            "CLASS_NAMES_EACH_HEAD": [["Car"], ["Pedestrian", "Cyclist"]],
            "SHARED_CONV_CHANNEL": 32, "NUM_HM_CONV": 2,
            "SEPARATE_HEAD_CFG": {"HEAD_ORDER": ["center", "center_z", "dim", "rot"],
                                  "HEAD_DICT": heads},
            "TARGET_ASSIGNER_CONFIG": {"FEATURE_MAP_STRIDE": 8, "NUM_MAX_OBJS": 100,
                                       "GAUSSIAN_OVERLAP": 0.1, "MIN_RADIUS": 2},
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {"cls_weight": 1.0, "loc_weight": 2.0,
                                             "code_weights": [1.0] * 8}},
            "POST_PROCESSING": {"MAX_OBJ_PER_SAMPLE": 32},
        },
        "POST_PROCESSING": {
            "RECALL_THRESH_LIST": [0.3, 0.5, 0.7],
            "SCORE_THRESH": 0.1, "EVAL_METRIC": "kitti",
            "NMS_CONFIG": {"NMS_TYPE": "circle_nms", "MIN_RADIUS": 2.5,
                           "NMS_POST_MAXSIZE": 16},
        },
    })


def centerpoint_gt(batch_size):
    """gt_boxes (B, 6, 8) and gt_boxes_mask (B, 6) of the tiny CenterPoint's
    training batches, per scan: two cars, a pedestrian and a cyclist on the
    map, a car whose centre lies off the map (x 17) and a masked slot."""
    gt = np.zeros((batch_size, 6, 8), np.float32)
    gt[:, 0] = [8, 0, -1, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [4, 3, -1, 0.8, 0.6, 1.7, -0.5, 2]
    gt[:, 2] = [12.3, -4.6, -1, 1.76, 0.6, 1.73, 2.0, 3]
    gt[:, 3] = [3.1, -5.2, -1.2, 4.2, 1.7, 1.5, -1.2, 1]
    gt[:, 4] = [17, 2, -1, 3.9, 1.6, 1.56, 0.0, 1]
    gt[:, 5] = [6, -5, -1, 3.9, 1.6, 1.56, 1.0, 1]
    mask = np.zeros((batch_size, 6), bool)
    mask[:, :5] = True
    return gt, mask


# the tiny CenterPoint's eval state: its hm_out bias and a gain on its hm_out
# kernels, so that the heatmap scores spread and some of the decoded ones
# fall below SCORE_THRESH 0.1
CENTERPOINT_EVAL_HM_BIAS, CENTERPOINT_EVAL_HM_GAIN = -2.0, 4.0


def redraw_state(state, seed):
    """Every entry of `state` redrawn from numpy's RandomState(seed), in key
    order: conv and Dense kernels N(0, 1 / fan-in), BN scales and running
    variances U(0.5, 1.5), the other vectors N(0, 0.2^2)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, t in sorted(state.items()):
        a = t.numpy()
        if a.ndim >= 2:
            fan_in = int(np.prod(a.shape[1:])) if a.ndim == 4 else int(np.prod(a.shape[:-1]))
            v = rng.randn(*a.shape) / np.sqrt(fan_in)
        elif key.endswith(("running_var", ".weight")):
            v = rng.uniform(0.5, 1.5, a.shape)
        else:
            v = rng.randn(*a.shape) * 0.2
        out[key] = v
    return out


def centerpoint_eval_state(seed=3):
    """The tiny CenterPoint's state for its eval checks: the committed init
    redrawn (`redraw_state`), the hm_out kernels times
    CENTERPOINT_EVAL_HM_GAIN and their biases at CENTERPOINT_EVAL_HM_BIAS."""
    out = {}
    for key, v in redraw_state(load_state(CENTERPOINT_STATE_PATH), seed).items():
        if key.endswith("hm_out.weight"):
            v = v * CENTERPOINT_EVAL_HM_GAIN
        elif key.endswith("hm_out.bias"):
            v = np.full(v.shape, CENTERPOINT_EVAL_HM_BIAS)
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


CENTERPOINT_NUSC_META = DatasetMeta(
    class_names=("car", "pedestrian", "barrier"),
    point_cloud_range=(-8.0, -8.0, -5.0, 8.0, 8.0, 3.0),
    voxel_size=(0.25, 0.25, 0.2), grid_size=(64, 64, 40), max_voxels=512,
    max_points_per_voxel=10, num_point_features=5, max_points=512,
)
CENTERPOINT_NUSC_FORWARD_PATH = STATE_PATH.parent / "centerpoint_nusc_tiny_forward.npz"


def centerpoint_nusc_model_cfg():
    """The tiny CenterPoint with nuScenes' head layout: HEAD_ORDER ends in
    vel, nms_gpu post-processing."""
    cfg = centerpoint_model_cfg()
    head = cfg.DENSE_HEAD
    head.CLASS_NAMES_EACH_HEAD = [["car"], ["pedestrian", "barrier"]]
    head.SEPARATE_HEAD_CFG.HEAD_ORDER = ["center", "center_z", "dim", "rot", "vel"]
    head.SEPARATE_HEAD_CFG.HEAD_DICT["vel"] = {"out_channels": 2, "num_conv": 2}
    head.LOSS_CONFIG.LOSS_WEIGHTS = {"cls_weight": 1.0, "loc_weight": 0.25,
                                     "code_weights": [1.0] * 8 + [0.2, 0.2]}
    cfg.POST_PROCESSING.NMS_CONFIG = {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.2,
                                      "NMS_PRE_MAXSIZE": 48, "NMS_POST_MAXSIZE": 16}
    return cfg


def nusc_points(batch_size=2, n=512, seed=0):
    """(B, n, 5) float32 points of the tiny nuScenes CenterPoint: uniform in
    its range, intensity in [0, 100), the time lag of one of ten sweeps
    (0, 0.05, ..., 0.45 s), the first 60 of each scan in a car-sized box at
    (2, 1, -1)."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch_size, n, 5), np.float32)
    pts[..., 0] = rng.uniform(-7.5, 7.5, (batch_size, n))
    pts[..., 1] = rng.uniform(-7.5, 7.5, (batch_size, n))
    pts[..., 2] = rng.uniform(-2.5, 1.5, (batch_size, n))
    pts[..., 3] = rng.uniform(0, 100, (batch_size, n))
    pts[..., 4] = rng.randint(0, 10, (batch_size, n)) * 0.05
    for b in range(batch_size):
        pts[b, :60, 0] = rng.uniform(0.0, 4.0, 60)
        pts[b, :60, 1] = rng.uniform(0.2, 1.8, 60)
        pts[b, :60, 2] = rng.uniform(-1.8, -0.2, 60)
    return pts


def centerpoint_nusc_gt(batch_size):
    """gt_boxes (B, 6, 10) (x, y, z, dx, dy, dz, heading, vx, vy, class) and
    gt_boxes_mask (B, 6) of the tiny nuScenes CenterPoint's training
    batches, per scan: two cars (one standing), a pedestrian and a barrier on
    the map, a car whose centre lies off the map and a masked slot."""
    gt = np.zeros((batch_size, 6, 10), np.float32)
    gt[:, 0] = [2, 1, -1, 4.6, 1.9, 1.7, 0.3, 4.5, 1.4, 1]
    gt[:, 1] = [-4, 3, -1, 0.7, 0.7, 1.8, -0.5, -0.8, 0.9, 2]
    gt[:, 2] = [4.3, -4.6, -1.3, 2.5, 0.5, 1.0, 2.0, 0.0, 0.0, 3]
    gt[:, 3] = [-3.1, -5.2, -1.2, 4.2, 1.7, 1.5, -1.2, 0.0, 0.0, 1]
    gt[:, 4] = [9, 2, -1, 4.6, 1.9, 1.7, 0.0, 6.0, 0.0, 1]
    gt[:, 5] = [6, -5, -1, 4.6, 1.9, 1.7, 1.0, 1.0, 1.0, 1]
    mask = np.zeros((batch_size, 6), bool)
    mask[:, :5] = True
    return gt, mask


# its hm_out bias: about 36 of a scan's 64 decoded boxes then pass
# SCORE_THRESH 0.1 (all 64 at CENTERPOINT_EVAL_HM_BIAS)
CENTERPOINT_NUSC_HM_BIAS = -3.0


def _drawn_centerpoint_state(model_cfg, meta, seed, hm_bias):
    """Every entry of the port model's state dict redrawn (`redraw_state`),
    the hm_out kernels times CENTERPOINT_EVAL_HM_GAIN and their biases at
    hm_bias."""
    from .models import build_network

    model = build_network(model_cfg, len(meta.class_names), meta, device="cpu", seed=0)
    out = {}
    for key, v in redraw_state(model.state_dict(), seed).items():
        if key.endswith("hm_out.weight"):
            v = v * CENTERPOINT_EVAL_HM_GAIN
        elif key.endswith("hm_out.bias"):
            v = np.full(v.shape, hm_bias)
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


def centerpoint_nusc_state(seed=3):
    """The tiny nuScenes CenterPoint's state for its checks
    (`_drawn_centerpoint_state`, hm_out biases at CENTERPOINT_NUSC_HM_BIAS)."""
    return _drawn_centerpoint_state(centerpoint_nusc_model_cfg(), CENTERPOINT_NUSC_META, seed,
                                    CENTERPOINT_NUSC_HM_BIAS)


PP_MULTIHEAD_META = DatasetMeta(
    class_names=("car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
                 "motorcycle", "bicycle", "pedestrian", "traffic_cone"),
    point_cloud_range=(-8.0, -8.0, -5.0, 8.0, 8.0, 3.0),
    voxel_size=(0.5, 0.5, 8.0), grid_size=(32, 32, 1), max_voxels=192,
    max_points_per_voxel=8, num_point_features=5, max_points=512,
)
PP_MULTIHEAD_FORWARD_PATH = STATE_PATH.parent / "pp_multihead_tiny_forward.npz"


def pp_multihead_model_cfg():
    """cbgs_pp_multihead.yaml's model at tiny widths: its ten anchor
    classes, thresholds, sin / cos coder, strided first deblock (0.5) and
    shared conv, on one BEV layer a level (16 / 16 / 32 filters, 8 upsample
    filters each), a 16-wide PFN, an 8 x 8 anchor map (1280 anchors) and an
    NMS of pre 64, post 16."""
    from .infer import ROOT, load_cfg

    cfg = load_cfg(ROOT / "tools/cfgs/nuscenes_models/cbgs_pp_multihead.yaml").MODEL
    cfg.VFE.NUM_FILTERS = [16]
    cfg.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    cfg.BACKBONE_2D.update(LAYER_NUMS=[1, 1, 1], NUM_FILTERS=[16, 16, 32],
                           NUM_UPSAMPLE_FILTERS=[8, 8, 8])
    cfg.DENSE_HEAD.SHARED_CONV_NUM_FILTER = 8
    cfg.POST_PROCESSING.NMS_CONFIG.update(NMS_PRE_MAXSIZE=64, NMS_POST_MAXSIZE=16)
    return cfg


# the tiny multi-head's conv_cls bias in its checks: with the redrawn
# weights ~300 of a scan's 1280 anchors then pass SCORE_THRESH 0.1
PP_MULTIHEAD_CLS_BIAS = -3.0


def pp_multihead_state(seed=3):
    """The tiny multi-head's state for its checks: every entry of the port
    model's state redrawn (`redraw_state`), the conv_cls bias at
    PP_MULTIHEAD_CLS_BIAS."""
    from .models import build_network

    model = build_network(pp_multihead_model_cfg(), 10, PP_MULTIHEAD_META, device="cpu")
    out = {}
    for key, v in redraw_state(model.state_dict(), seed).items():
        if key.endswith("conv_cls.bias"):
            v = np.full(v.shape, PP_MULTIHEAD_CLS_BIAS)
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


def pp_multihead_gt(batch_size):
    """gt_boxes (B, 5, 8) and gt_boxes_mask (B, 5) of the tiny multi-head's
    training batches, per scan: a car, a bus, a pedestrian and a traffic
    cone on the map, then a masked slot."""
    gt = np.zeros((batch_size, 5, 8), np.float32)
    gt[:, 0] = [2, 1, -0.1, 4.6, 1.9, 1.7, 0.3, 1]
    gt[:, 1] = [-4, -3, 0.7, 10.5, 2.9, 3.5, 1.4, 4]
    gt[:, 2] = [-4, 4, 0.0, 0.7, 0.7, 1.8, -0.5, 9]
    gt[:, 3] = [5, -5, -0.8, 0.4, 0.4, 1.1, 0.0, 10]
    mask = np.zeros((batch_size, 5), bool)
    mask[:, :4] = True
    return gt, mask


LYFT_CLASSES = ("car", "truck", "bus", "emergency_vehicle", "other_vehicle", "motorcycle",
                "bicycle", "pedestrian", "animal")
CENTERPOINT_LYFT_META = dataclasses.replace(CENTERPOINT_NUSC_META, class_names=LYFT_CLASSES)
CENTERPOINT_LYFT_FORWARD_PATH = STATE_PATH.parent / "centerpoint_lyft_tiny_forward.npz"


def centerpoint_lyft_model_cfg():
    """The tiny CenterPoint with the Lyft config's head layout: Lyft's nine
    classes in its five groups, no velocity, nms_gpu post-processing."""
    cfg = centerpoint_model_cfg()
    head = cfg.DENSE_HEAD
    head.CLASS_NAMES_EACH_HEAD = [["car"], ["truck", "other_vehicle"], ["bus", "emergency_vehicle"],
                                  ["motorcycle", "bicycle"], ["pedestrian", "animal"]]
    head.LOSS_CONFIG.LOSS_WEIGHTS = {"cls_weight": 1.0, "loc_weight": 0.25,
                                     "code_weights": [1.0] * 8}
    cfg.POST_PROCESSING.NMS_CONFIG = {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.2,
                                      "NMS_PRE_MAXSIZE": 48, "NMS_POST_MAXSIZE": 16}
    return cfg


def centerpoint_lyft_state(seed=6):
    """The tiny Lyft CenterPoint's state for its checks
    (`_drawn_centerpoint_state`, hm_out biases at CENTERPOINT_NUSC_HM_BIAS;
    the seed spreads the scores: a group's decoded ones lie at least 3e-5
    apart on `nusc_points(2)`, and 4 to all 64 of a group's pass
    SCORE_THRESH)."""
    return _drawn_centerpoint_state(centerpoint_lyft_model_cfg(), CENTERPOINT_LYFT_META, seed,
                                    CENTERPOINT_NUSC_HM_BIAS)


def _two_stage_dense_head():
    return {
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
    }


def _two_stage_post(nms_pre=16):
    return {
        "RECALL_THRESH_LIST": [0.3, 0.5, 0.7], "SCORE_THRESH": 0.1,
        "EVAL_METRIC": "kitti",
        "NMS_CONFIG": {"MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu",
                       "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": nms_pre,
                       "NMS_POST_MAXSIZE": 8},
    }


def _rcnn_loss_cfg():
    return {"CORNER_LOSS_REGULARIZATION": True,
            "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                             "rcnn_corner_weight": 1.0, "code_weights": [1.0] * 7}}


PARTA2_META = DatasetMeta(
    class_names=("Car",), point_cloud_range=(0.0, -8.0, -3.0, 16.0, 8.0, 1.0),
    voxel_size=(0.5, 0.5, 0.1), grid_size=(32, 32, 40), max_voxels=256,
    max_points_per_voxel=5, num_point_features=4, max_points=256,
)
PVRCNN_META = dataclasses.replace(PARTA2_META, max_voxels=512)


def parta2_model_cfg():
    return EDict({
        "NAME": "PartA2Net",
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "UNetV2"},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
        "BACKBONE_2D": {
            "NAME": "BaseBEVBackbone",
            "LAYER_NUMS": [1], "LAYER_STRIDES": [1], "NUM_FILTERS": [32],
            "UPSAMPLE_STRIDES": [1], "NUM_UPSAMPLE_FILTERS": [32],
        },
        "DENSE_HEAD": _two_stage_dense_head(),
        "POINT_HEAD": {
            "NAME": "PointIntraPartOffsetHead", "CLS_FC": [16], "PART_FC": [16],
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0,
                                             "point_part_weight": 1.0}},
        },
        "ROI_HEAD": {
            "NAME": "PartA2FCHead",
            "ROI_AWARE_POOL": {"POOL_SIZE": 4},
            "SHARED_FC": [32], "CLS_FC": [16], "REG_FC": [16],
            "NMS_CONFIG": {
                "TRAIN": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.8,
                          "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 16},
                "TEST": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
                         "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 8},
            },
            "TARGET_CONFIG": {
                "ROI_PER_IMAGE": 8, "FG_RATIO": 0.5, "REG_FG_THRESH": 0.55,
                "CLS_FG_THRESH": 0.75, "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1,
            },
            "LOSS_CONFIG": _rcnn_loss_cfg(),
        },
        "POST_PROCESSING": _two_stage_post(),
    })


def pvrcnn_model_cfg():
    return EDict({
        "NAME": "PVRCNN",
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "VoxelBackBone8x"},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
        "PFE": {
            "NAME": "VoxelSetAbstraction", "POINT_SOURCE": "raw_points",
            "NUM_KEYPOINTS": 64, "NUM_OUTPUT_FEATURES": 32,
            "FEATURES_SOURCE": ["bev", "x_conv3", "x_conv4", "raw_points"],
            "SA_LAYER": {
                "raw_points": {"MLPS": [[8, 8], [8, 8]], "POOL_RADIUS": [0.4, 0.8],
                               "NSAMPLE": [8, 8]},
                "x_conv3": {"MLPS": [[8, 8], [8, 8]], "POOL_RADIUS": [1.2, 2.4],
                            "NSAMPLE": [8, 8]},
                "x_conv4": {"MLPS": [[8, 8], [8, 8]], "POOL_RADIUS": [2.4, 4.8],
                            "NSAMPLE": [8, 8]},
            },
        },
        "BACKBONE_2D": {
            "NAME": "BaseBEVBackbone",
            "LAYER_NUMS": [1], "LAYER_STRIDES": [1], "NUM_FILTERS": [32],
            "UPSAMPLE_STRIDES": [1], "NUM_UPSAMPLE_FILTERS": [32],
        },
        "DENSE_HEAD": _two_stage_dense_head(),
        "POINT_HEAD": {
            "NAME": "PointHeadSimple", "CLS_FC": [16],
            "USE_POINT_FEATURES_BEFORE_FUSION": True,
            "TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2]},
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0}},
        },
        "ROI_HEAD": {
            "NAME": "PVRCNNHead",
            "SHARED_FC": [32, 32], "CLS_FC": [16], "REG_FC": [16],
            "NMS_CONFIG": {
                "TRAIN": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.8,
                          "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 32},
                "TEST": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
                         "NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 16},
            },
            "ROI_GRID_POOL": {"GRID_SIZE": 3, "MLPS": [[8, 8], [8, 8]],
                              "POOL_RADIUS": [0.8, 1.6], "NSAMPLE": [8, 8]},
            "TARGET_CONFIG": {
                "ROI_PER_IMAGE": 16, "FG_RATIO": 0.5, "REG_FG_THRESH": 0.55,
                "CLS_FG_THRESH": 0.75, "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1,
            },
            "LOSS_CONFIG": _rcnn_loss_cfg(),
        },
        "POST_PROCESSING": _two_stage_post(),
    })


def pvrcnnplusplus_model_cfg():
    """The tiny PV-RCNN++: the tiny PV-RCNN with its PFE as
    pv_rcnn_plusplus.yaml's, cut to size: the keypoints by sector d-fps over
    6 azimuth sectors (the tiny scans' x >= 0 leaves sectors 0 and 5
    empty), VectorPool on the raw points (2^3 and 3^3 cells) and on x_conv3
    (3^3 and 3^3), each with an aggregation MLP, and x_conv4 kept on
    PV-RCNN's SAGroup, so that both kinds of support set and both kinds of
    source run."""
    cfg = pvrcnn_model_cfg()
    cfg["NAME"] = "PVRCNNPlusPlus"
    pfe = cfg["PFE"]
    pfe["SAMPLE_METHOD"] = "SPC"
    pfe["SPC_SAMPLING"] = {"NUM_SECTORS": 6, "SAMPLE_RADIUS_WITH_ROI": 1.6}
    pfe["SA_LAYER"]["raw_points"] = {
        "NAME": "VectorPoolAggregationModuleMSG", "POOL_RADIUS": [0.4, 0.8],
        "NSAMPLE": [8, 8], "LOCAL_GRIDS": [[2, 2, 2], [3, 3, 3]], "MLPS": [[8, 8], [8, 8]],
        "AGGREGATION_MLPS": [16]}
    pfe["SA_LAYER"]["x_conv3"] = {
        "NAME": "VectorPoolAggregationModuleMSG", "POOL_RADIUS": [1.2, 2.4],
        "NSAMPLE": [8, 8], "LOCAL_GRIDS": [[3, 3, 3], [3, 3, 3]], "MLPS": [[8, 8], [8, 8]],
        "AGGREGATION_MLPS": [16]}
    return cfg


def _roi_common():
    """The NMS, target and loss sections of the JAX tiny RoI heads
    (ROI_COMMON of tests/test_two_stage_models.py)."""
    return {
        "NMS_CONFIG": {
            "TRAIN": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.8,
                      "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 16},
            "TEST": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
                     "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 8},
        },
        "TARGET_CONFIG": {
            "ROI_PER_IMAGE": 8, "FG_RATIO": 0.5, "REG_FG_THRESH": 0.55,
            "CLS_FG_THRESH": 0.75, "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1,
        },
        "LOSS_CONFIG": _rcnn_loss_cfg(),
    }


VOXELRCNN_META = PVRCNN_META   # META_VOXEL of the JAX package's test


def voxelrcnn_model_cfg():
    """The JAX package's tiny Voxel R-CNN (`voxelrcnn_cfg` of
    tests/test_two_stage_models.py): a 3^3 RoI grid over x_conv3 and x_conv4,
    one window query of 5^3 voxels, radius and 8 samples a source."""
    return EDict({
        "NAME": "VoxelRCNN",
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "VoxelBackBone8x"},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
        "BACKBONE_2D": {
            "NAME": "BaseBEVBackbone",
            "LAYER_NUMS": [1], "LAYER_STRIDES": [1], "NUM_FILTERS": [32],
            "UPSAMPLE_STRIDES": [1], "NUM_UPSAMPLE_FILTERS": [32],
        },
        "DENSE_HEAD": _two_stage_dense_head(),
        "ROI_HEAD": {
            "NAME": "VoxelRCNNHead",
            "ROI_GRID_POOL": {
                "GRID_SIZE": 3,
                "POOL_LAYERS": {
                    "x_conv3": {"MLPS": [[8, 8]], "POOL_RADIUS": [1.2],
                                "NSAMPLE": [8], "QUERY_RANGES": [[2, 2, 2]]},
                    "x_conv4": {"MLPS": [[8, 8]], "POOL_RADIUS": [2.4],
                                "NSAMPLE": [8], "QUERY_RANGES": [[2, 2, 2]]},
                },
            },
            "SHARED_FC": [32], "CLS_FC": [16], "REG_FC": [16],
            **_roi_common(),
        },
        "POST_PROCESSING": _two_stage_post(),
    })


def secondnetiou_model_cfg():
    """The JAX package's tiny SECONDNetIoU (`test_secondnet_iou_e2e` of
    tests/test_two_stage_models.py): the tiny Voxel R-CNN's first stage and
    a SECONDHead over a 3^3 lattice of the 32-channel BEV map."""
    cfg = voxelrcnn_model_cfg()
    cfg["NAME"] = "SECONDNetIoU"
    common = _roi_common()
    cfg["ROI_HEAD"] = EDict({
        "NAME": "SECONDHead",
        "ROI_GRID_POOL": {"GRID_SIZE": 3},
        "SHARED_FC": [32], "IOU_FC": [16],
        "IOU_WEIGHT": 0.5,
        "NMS_CONFIG": common["NMS_CONFIG"],
        "TARGET_CONFIG": common["TARGET_CONFIG"],
        "LOSS_CONFIG": {"LOSS_WEIGHTS": {"rcnn_iou_weight": 1.0}},
    })
    return cfg


# the anchor head's conv_cls bias in the tiny two-stage states: the
# proposals' scores then spread around SCORE_THRESH 0.1
TWO_STAGE_CLS_BIAS = -2.0


def two_stage_model(which):
    """(model config, DatasetMeta) of the tiny Part-A2 ("parta2"), PV-RCNN
    ("pvrcnn"), PV-RCNN++ ("pvrcnnplusplus"), PointRCNN ("pointrcnn"), Voxel
    R-CNN ("voxelrcnn"), SECONDNetIoU ("secondnetiou"), PVSSDA on
    PointNet2FSMSG ("pvssda", TwoStageBase's detector with no RoI head) or
    DSASNet on SparsePointBackbone ("dsasnet")."""
    cfg, meta = {"parta2": (parta2_model_cfg, PARTA2_META),
                 "pvssda": (pvssda_model_cfg, PVSSDA_META),
                 "dsasnet": (dsasnet_model_cfg, DSASNET_META),
                 "pvrcnn": (pvrcnn_model_cfg, PVRCNN_META),
                 "pvrcnnplusplus": (pvrcnnplusplus_model_cfg, PVRCNN_META),
                 "pointrcnn": (pointrcnn_model_cfg, POINTRCNN_META),
                 "voxelrcnn": (voxelrcnn_model_cfg, VOXELRCNN_META),
                 "secondnetiou": (secondnetiou_model_cfg, VOXELRCNN_META)}[which]
    return cfg(), meta


# added to the bias of every channels-last BN (the sparse convs', the MLPs'
# and the heads'; not the BEV backbone's, whose output the anchor head turns
# into boxes) in the tiny two-stage states' training checks: a ReLU after a
# train-mode BN then sees inputs near 0 only where a row lies ~3 standard
# deviations under its channel's mean. Otherwise, across the ~10^5 ReLU
# inputs of a step, some lie within the rounding distance between the two
# packages' forwards of 0 (2.6e-7 and 4.4e-7 were seen), and a ReLU that
# passes such an input on one side only moves the gradients of every layer
# before it by up to a few percent, which no per-element tolerance can tell
# from a fault.
TWO_STAGE_TRAIN_BN_LIFT = 3.0
# the tiny PointRCNN's output layers in its training state (the point
# head's and the RoI head's): their kernels and biases times this gain,
# since the lifted BNs' large ReLU outputs would otherwise give boxes of
# exp(4) times the mean size, saturated scores, and RCNN residuals whose
# exp amplifies the two packages' rounding apart past the checks' 1e-5
POINTRCNN_TRAIN_GAIN = 0.1
POINTRCNN_TRAIN_GAIN_LAYERS = ("module_list.1.cls_out.", "module_list.1.box_out.",
                               "module_list.2.cls_out.", "module_list.2.reg_out.")


# the tiny detector whose draws a tiny detector's state takes wherever an
# entry of the same name and shape is in both: PV-RCNN++'s first stage and
# RoI head are then PV-RCNN's, and so are its training RoIs (its gt boxes
# are PV-RCNN's)
SHARED_DRAWS = {"pvrcnnplusplus": "pvrcnn"}


def _drawn(which, seed):
    """`redraw_state` over the tiny `which`'s port state dict (PointRCNN's:
    the committed init), and the model."""
    from .models import build_network

    cfg, meta = two_stage_model(which)
    model = build_network(cfg, 1, meta, device="cpu", seed=0)
    base = load_state(POINTRCNN_STATE_PATH) if which == "pointrcnn" else model.state_dict()
    return redraw_state(base, seed), model


def two_stage_state(which, seed=4, train=False):
    """The tiny two-stage detector's state for its checks: every entry of
    the port model's state dict (PointRCNN's: the committed init) drawn as
    `redraw_state` draws it (PV-RCNN++'s entries of PV-RCNN's names and
    shapes as PV-RCNN's: SHARED_DRAWS), the anchor head's conv_cls bias at
    TWO_STAGE_CLS_BIAS; with `train` the channels-last BN biases raised by
    TWO_STAGE_TRAIN_BN_LIFT. PVSSDA's is `pvssda_state`, DSASNet's
    `dsasnet_state`."""
    from .models.backbones_3d.pointnet2_modules import BatchNorm

    if which == "pvssda":
        return pvssda_state(train=train)
    if which == "dsasnet":
        return dsasnet_state(train=train)
    drawn, model = _drawn(which, seed)
    if which in SHARED_DRAWS:
        shared = _drawn(SHARED_DRAWS[which], seed)[0]
        drawn = {k: shared[k] if k in shared and shared[k].shape == v.shape else v
                 for k, v in drawn.items()}
    lifted = {f"{name}.bias" for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    out = {}
    for key, v in drawn.items():
        if key.endswith("conv_cls.bias"):
            v = np.full(v.shape, TWO_STAGE_CLS_BIAS)
        elif train and which == "pointrcnn" and key.startswith(POINTRCNN_TRAIN_GAIN_LAYERS):
            v = v * POINTRCNN_TRAIN_GAIN
        elif train and key in lifted:
            v = v + TWO_STAGE_TRAIN_BN_LIFT
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


# gt boxes (x, y, z, dx, dy, dz, heading, class) of the tiny two-stage
# detectors' training checks, per scan, the last of each scan masked out
# (a copy of the first, 5 cm along x). Each is a training-mode RoI of
# `two_stage_state(which, train=True)` grown along its length, so that its
# IoU with that RoI is 1 / the factor: Part-A2's scan 0 has a foreground RoI at IoU 0.8, one at
# 0.6 (foreground, and in the cls loss's ignored interval) and one at 0.17
# (hard background), the rest easy background tied at priority 1.0 (8 of 16
# sampled); its scan 1 has nine RoIs at IoU 0.4, which is never sampled, so
# that only 7 of 16 have a positive priority and none is sampled.
# PV-RCNN's scans have RoIs at IoU 0.8, 0.6, 0.17 and at 0.91, 0.4 (16 of
# 32 sampled in each).
TWO_STAGE_GT = {
    "parta2": [
        [[11.657, -1.154, -1.122, 14.528, 0.695, 2.696, 3.579, 1],
         [2.69, -8.856, -3.227, 4.816, 3.424, 2.835, 1.879, 1],
         [-0.123, 10.648, -0.749, 25.91, 2.496, 1.355, 2.727, 1],
         [11.707, -1.154, -1.122, 14.528, 0.695, 2.696, 3.579, 1]],
        [[2.254, -1.027, -3.178, 8.065, 1.901, 1.344, 0.81, 1],
         [4.114, -1.031, -1.003, 19.316, 0.476, 3.049, 5.533, 1],
         [0.031, 10.968, -0.565, 11.081, 3.582, 1.77, 2.748, 1],
         [12.136, -7.285, -1.633, 5.969, 0.713, 1.417, 2.702, 1],
         [4.28, -10.059, -1.899, 8.96, 0.683, 1.407, 5.796, 1],
         [16.131, 8.197, -3.086, 18.929, 6.723, 1.427, 3.481, 1],
         [12.86, -4.172, -2.369, 54.901, 0.421, 2.654, 0.801, 1],
         [15.827, 1.24, -1.649, 9.397, 1.619, 3.07, 5.963, 1],
         [8.188, -6.667, -3.418, 12.42, 2.458, 4.514, 5.951, 1],
         [2.304, -1.027, -3.178, 8.065, 1.901, 1.344, 0.81, 1]],
    ],
    "pvrcnn": [
        [[2.449, -5.849, -1.297, 12.424, 1.352, 5.058, 3.234, 1],
         [3.513, -2.627, -1.652, 3.214, 2.804, 1.112, 2.875, 1],
         [3.752, 4.64, -1.01, 40.132, 3.63, 2.035, 2.627, 1],
         [2.499, -5.849, -1.297, 12.424, 1.352, 5.058, 3.234, 1]],
        [[5.745, 13.47, 0.004, 0.767, 1.983, 1.22, 3.717, 1],
         [17.281, -3.449, -0.849, 15.677, 0.922, 8.23, 6.623, 1],
         [5.795, 13.47, 0.004, 0.767, 1.983, 1.22, 3.717, 1]],
    ],
    # PointRCNN's: the reference batch's box over the 50-point cluster (point
    # head positives, and the GT_EXTRA_WIDTH band around it), then training
    # RoIs grown to IoU 0.8, 0.6 and 0.17 (scan 0) and 0.9, 0.6 and 0.4
    # (scan 1)
    "pointrcnn": [
        [[8.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1],
         [8.046, -2.977, -1.464, 5.935, 1.697, 2.471, 1.14, 1],
         [2.353, 2.497, 0.943, 8.758, 2.019, 2.574, 1.344, 1],
         [11.371, 7.553, -1.851, 30.418, 1.991, 2.583, 1.827, 1],
         [8.096, -2.977, -1.464, 5.935, 1.697, 2.471, 1.14, 1]],
        [[8.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1],
         [-1.619, 5.362, -1.979, 6.936, 2.159, 2.518, 1.322, 1],
         [8.236, 3.102, -1.969, 10.05, 1.355, 2.608, 0.977, 1],
         [5.215, -6.153, -1.68, 14.007, 1.866, 2.543, 1.82, 1],
         [-1.569, 5.362, -1.979, 6.936, 2.159, 2.518, 1.322, 1]],
    ],
    # Voxel R-CNN's, which SECONDNetIoU shares (their first stages draw the
    # same state, so their training RoIs are the same): RoIs widened by 12 %,
    # turned by 0.06 rad, moved 4 cm along their heading and grown along their
    # length to IoU 0.8, 0.6 and 0.17 (scan 0) and 0.865 and 0.4 (scan 1); 8
    # of 16 sampled in each. No edge of a gt box lies on its RoI's: the IoU's
    # gradient, which SECONDHead's loss follows, is then the same in both
    # packages (on shared edges the clipped polygon's vertices, and so the
    # gradient, turn on rounding)
    "voxelrcnn": [
        [[11.251, 5.471, -1.219, 3.502, 2.085, 5.695, 6.401, 1],
         [7.244, -8.855, -1.259, 11.044, 1.197, 1.287, 5.399, 1],
         [9.045, -0.588, -3.126, 5.446, 1.525, 3.755, 5.16, 1],
         [11.301, 5.471, -1.219, 3.502, 2.085, 5.695, 6.401, 1]],
        [[11.485, 5.176, -1.548, 2.441, 2.077, 5.034, 6.759, 1],
         [5.137, -5.958, 1.392, 2.436, 2.178, 2.875, 6.151, 1],
         [11.535, 5.176, -1.548, 2.441, 2.077, 5.034, 6.759, 1]],
    ],
}
TWO_STAGE_GT["secondnetiou"] = TWO_STAGE_GT["voxelrcnn"]
TWO_STAGE_GT["pvrcnnplusplus"] = TWO_STAGE_GT["pvrcnn"]


def two_stage_gt(which, batch_size=2):
    """gt_boxes (B, M, 8) float32 and gt_boxes_mask (B, M) bool of the tiny
    two-stage detector's training batches: TWO_STAGE_GT[which]'s scans in
    turn, the last box of each masked, padded to the longest."""
    scans = TWO_STAGE_GT[which]
    M = max(len(s) for s in scans)
    gt = np.zeros((batch_size, M, 8), np.float32)
    mask = np.zeros((batch_size, M), bool)
    for b in range(batch_size):
        boxes = np.asarray(scans[b % len(scans)], np.float32)
        gt[b, :len(boxes)] = boxes
        mask[b, :len(boxes) - 1] = True
    return gt, mask


POINTRCNN_META = PARTA2_META   # META_POINT of the JAX package's test


def pointrcnn_model_cfg():
    roi_common = parta2_model_cfg().ROI_HEAD
    return EDict({
        "NAME": "PointRCNN",
        "BACKBONE_3D": {
            "NAME": "PointNet2MSG",
            "SA_CONFIG": {
                "NPOINTS": [64, 16],
                "RADIUS": [[0.5, 1.0], [1.0, 2.0]],
                "NSAMPLE": [[8, 8], [8, 8]],
                "MLPS": [[[8, 8], [8, 8]], [[16, 16], [16, 16]]],
            },
            "FP_MLPS": [[16], [16]],
        },
        "POINT_HEAD": {
            "NAME": "PointHeadBox", "CLS_FC": [16], "REG_FC": [16],
            "CLASS_AGNOSTIC": False, "USE_POINT_FEATURES_BEFORE_FUSION": False,
            "TARGET_CONFIG": {
                "GT_EXTRA_WIDTH": [0.2, 0.2, 0.2], "BOX_CODER": "PointResidualCoder",
                "BOX_CODER_CONFIG": {"use_mean_size": True, "mean_size": [[3.9, 1.6, 1.56]]},
            },
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0,
                                             "point_box_weight": 1.0}},
        },
        "ROI_HEAD": {
            "NAME": "PointRCNNHead",
            "ROI_POINT_POOL": {"NUM_SAMPLED_POINTS": 32, "DEPTH_NORMALIZER": 70.0},
            "XYZ_UP_LAYER": [16, 16],
            "SHARED_FC": [32], "CLS_FC": [16], "REG_FC": [16],
            "SA_CONFIG": {"NPOINTS": [16, -1], "RADIUS": [0.4, 100], "NSAMPLE": [8, 8],
                          "MLPS": [[16, 16], [16, 32]]},
            "NMS_CONFIG": roi_common.NMS_CONFIG, "TARGET_CONFIG": roi_common.TARGET_CONFIG,
            "LOSS_CONFIG": roi_common.LOSS_CONFIG,
        },
        "POST_PROCESSING": _two_stage_post(),
    })


def gt_roi_proposals(gt, gmask, n_boxes, seed=0):
    """First-stage outputs whose proposals are the valid gt boxes: logits
    (B, n_boxes, 1) and boxes (B, n_boxes, 7), the gt boxes jittered (centre
    within 5 cm, sizes within 3 %, heading within 0.03 rad, so that each
    keeps an IoU above REG_FG_THRESH 0.55 with its box) at the top scores,
    far-off 0.5 m boxes at low ones. Fed to a RoI head in training, they
    make its foreground non-empty, so that its regression and corner losses
    have terms."""
    rng = np.random.RandomState(seed)
    B = gmask.shape[0]
    boxes = np.zeros((B, n_boxes, 7), np.float32)
    boxes[..., 0] = rng.uniform(100, 200, (B, n_boxes))
    boxes[..., 3:6] = 0.5
    logits = rng.uniform(-6, -4, (B, n_boxes, 1)).astype(np.float32)
    for b in range(B):
        for j in np.flatnonzero(gmask[b]):
            box = np.array(gt[b, j, :7], np.float32)
            box[:3] += rng.uniform(-0.05, 0.05, 3)
            box[3:6] *= rng.uniform(0.97, 1.03, 3)
            box[6] += rng.uniform(-0.03, 0.03)
            boxes[b, j] = box
            logits[b, j] = 4.0 - 0.1 * j
    return logits, boxes


PVSSDA_META = PARTA2_META
PVSSDA_FORWARD_PATH = STATE_PATH.parent / "pvssda_tiny_forward.npz"
# the tiny PVSSDAs' training gt box (the car-sized box of `pvssda_points`'
# cluster) and a masked copy of it, a scan
PVSSDA_GT = [[8.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1], [8.05, 0.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1]]


def pvssda_points(batch_size=2, n=512, seed=0):
    """(B, n, 4) float32 points of the tiny PVSSDAs: `second_points`'
    recipe with 150 points a scan in the car-sized box at (8, 0, -1), dense
    enough that layer 0's widest annulus (1-3 m) holds more than its 40
    samples."""
    rng = np.random.RandomState(seed)
    pts = second_points(batch_size, n, seed)
    for b in range(batch_size):
        pts[b, :150, 0] = rng.uniform(6.5, 9.5, 150)
        pts[b, :150, 1] = rng.uniform(-0.7, 0.7, 150)
        pts[b, :150, 2] = rng.uniform(-1.7, -0.3, 150)
    return pts


def pvssda_gt(batch_size=2):
    """gt_boxes (B, 2, 8) and gt_boxes_mask (B, 2) of the tiny PVSSDAs'
    training batches: PVSSDA_GT a scan, its second box masked."""
    gt = np.tile(np.asarray(PVSSDA_GT, np.float32)[None], (batch_size, 1, 1))
    mask = np.zeros((batch_size, 2), bool)
    mask[:, 0] = True
    return gt, mask


def _pvssda_head(use_mean_size):
    coder = ({"use_mean_size": True, "mean_size": [[3.9, 1.6, 1.56]]} if use_mean_size
             else {"use_mean_size": False})
    return {"CLS_FC": [16], "REG_FC": [16], "CLASS_AGNOSTIC": False,
            "TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2],
                              "BOX_CODER": "PointResidualCoder", "BOX_CODER_CONFIG": coder},
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0,
                                             "point_box_weight": 1.0}}}


def pvssda_model_cfg(which="fsmsg"):
    """The tiny PVSSDA on PointNet2FSMSG ("fsmsg") or PointNet2MSG ("msg")."""
    if which == "msg":
        backbone = {"NAME": "PointNet2MSG",
                    "SA_CONFIG": {"NPOINTS": [64], "RADIUS": [[0.5, 1.0]], "NSAMPLE": [[8, 8]],
                                  "MLPS": [[[8, 8], [8, 8]]]},
                    "FP_MLPS": [[16]]}
        head = dict(_pvssda_head(False), NAME="PVSSDAHead")
    else:
        backbone = {"NAME": "PointNet2FSMSG", "SA_CONFIG": {
            "NPOINT_LIST": [[128], [24, 24, 16]],
            "SAMPLE_RANGE_LIST": [[[0, 512]], [[0, 128], [0, 128], [64, 128]]],
            "SAMPLE_METHOD_LIST": [["d-fps"], ["f-fps", "s-fps", "d-fps"]],
            "RADIUS": [[0.5, 1.0, 3.0], [1.0, 2.0]],
            "NSAMPLE": [[8, 16, 40], [16, 32]],
            "MLPS": [[[8], [8, 8], [8, 16]], [[16], [16, 16]]],
            "AGGREGATION_MLPS": [[16], [32]],
            "CONFIDENCE_MLPS": [[8], [8]],
            "NUM_CLASS": 1, "WEIGHT_GAMMA": 1.0, "DILATED_RADIUS_GROUP": True}}
        head = dict(_pvssda_head(True), NAME="PVSSDAHead")
    return EDict({"NAME": "PVSSDA", "BACKBONE_3D": backbone, "POINT_HEAD": head,
                  "POST_PROCESSING": _two_stage_post(nms_pre=32)})


def pvssda_state(which="fsmsg", seed=12, train=False):
    """The tiny PVSSDA's state for its checks: every entry of the port
    model's state dict drawn from numpy's RandomState(seed)
    (`redraw_state`); with `train` the channels-last BN biases raised by
    TWO_STAGE_TRAIN_BN_LIFT and the point head's output layers times
    POINTRCNN_TRAIN_GAIN, as the tiny PointRCNN's training state."""
    from .models import build_network
    from .models.backbones_3d.pointnet2_modules import BatchNorm

    model = build_network(pvssda_model_cfg(which), 1, PVSSDA_META, device="cpu", seed=0)
    lifted = {f"{name}.bias" for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    out = {}
    for key, v in redraw_state(model.state_dict(), seed).items():
        if train and key in lifted:
            v = v + TWO_STAGE_TRAIN_BN_LIFT
        elif train and key.startswith(("module_list.1.cls_out.", "module_list.1.box_out.")):
            v = v * POINTRCNN_TRAIN_GAIN
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


# the tiny DSASNets (the TSM project's two-stage detector over a BEV / point
# hybrid 2D backbone) on the tiny PV-RCNN's geometry: VoxelBackBone8x's
# pyramid of a 32 x 32 x 41 grid (x_conv4 5 x 4 x 4, a 4 x 4 BEV map of 256
# channels), on `second_points(2, 256)` (the 50-point car cluster at (8, 0,
# -1); `pvssda_gt` its training boxes); a hybrid each, at narrow widths
DSASNET_META = PVRCNN_META
DSASNET_FORWARD_PATH = STATE_PATH.parent / "dsasnet_tiny_forward.npz"
DSASNET_POOL = {
    "FEATURES_SOURCE": ["x_conv3", "x_conv4"],
    "POOL_LAYERS": {
        "x_conv3": {"MLPS": [[8, 8]], "POOL_RADIUS": [1.2], "NSAMPLE": [8],
                    "QUERY_RANGES": [[2, 2, 2]]},
        "x_conv4": {"MLPS": [[8, 8]], "POOL_RADIUS": [2.4], "NSAMPLE": [8],
                    "QUERY_RANGES": [[2, 2, 2]]},
    },
}
# SparsePointBackbone ("spb"): 128 key-point candidates, 48 + 16 picked, the
# second stage's weights 0 within 8 m (so that some of its rows run out of
# weighted points and pick ties); PointFromVoxel ("pfv") and VoxelPointCross
# ("vpc") on 8 z-groups of the 256 channels; BEVPoint ("bevpoint") over
# x_conv2-4 at stride 2, 32 raw key points
DSASNET_HYBRIDS = {
    "spb": {"NAME": "SparsePointBackbone", "FG_CORNER_POINTS": [128, 64],
            "PTS_NUM_SAMPLE": [48, 16], "MAX_TRANSLATION_RANGE": [3.0, 3.0, 2.0], "N_CLS": 3,
            "NUM_POINT_FEATURES": 32, "SP_SOURCE": "x_conv4", "NEAR_RADIUS": 8.0,
            "STAT_START_ITER": 0, "POINT_GRID_POOL": DSASNET_POOL},
    "pfv": {"NAME": "PointFromVoxel", "Z_GROUPS": 8, "LOCAL_CH": 4, "GLOBAL_CH": 8,
            "FG_CORNER_POINTS": [[64, 32], [16, 8]], "SAMPLE_FPS": True, "STAT_START_ITER": 0},
    "vpc": {"NAME": "VoxelPointCross", "Z_GROUPS": 8, "TRUNK_CH": 32, "N_BLOCK": [1, 1],
            "FG_CORNER_POINTS": [[32, 32], [24, 8]], "SAMPLE_FPS": True,
            "SA_CONFIG": {"RADIUS": [1.6], "NSAMPLE": [8], "MLPS": [[16, 16]]}},
    "bevpoint": {"NAME": "BEVPoint", "NUM_FILTERS": 8, "N_BLOCK": [1, 1, 1],
                 "NUM_RAW_KEYPOINTS": 32},
}


def dsasnet_model_cfg(which="spb"):
    """The tiny DSASNet on the hybrid `which` (DSASNET_HYBRIDS): MeanVFE,
    DSASNetVoxelBackBone8x, HeightCompression, the hybrid, DSASNetHead (the
    tiny PVSSDA's point head) and, on SparsePointBackbone, DSASNetRoIHead
    (the tiny PV-RCNN's RoI head). The other hybrids' tiny DSASNets stop at
    the point head: the RoI head reads their point features as it reads
    SparsePointBackbone's, and the JAX compile of its training step is two
    thirds of a tiny model's. Their NMS takes scores from 0.01: the point
    head's seeded logits on VoxelPointCross lie around -3.4, where none
    passes 0.1."""
    cfg = EDict({
        "NAME": "DSASNet",
        "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "DSASNetVoxelBackBone8x"},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 256},
        "BACKBONE_2D": dict(DSASNET_HYBRIDS[which]),
        "POINT_HEAD": dict(_pvssda_head(True), NAME="DSASNetHead"),
        "POST_PROCESSING": _two_stage_post(nms_pre=32),
    })
    if which == "spb":
        cfg["ROI_HEAD"] = EDict(pvrcnn_model_cfg().ROI_HEAD, NAME="DSASNetRoIHead")
    else:
        cfg.POST_PROCESSING.SCORE_THRESH = 0.01
    return cfg


# the tiny PVSSDA on its BEV topology (the JAX package's
# test_voxel_point_cross_neck_in_detector): PillarVFE, PointNet2MSG, the
# pillar scatter, a one-level BEV backbone at stride 2, the VoxelPointCross
# neck, an anchor head, on the tiny PointPillars' pillars
PVSSDA_NECK_META = POINTPILLAR_META


def pvssda_neck_model_cfg():
    pp = pointpillar_model_cfg()
    return EDict({
        "NAME": "PVSSDA",
        "VFE": pp.VFE,
        "BACKBONE_3D": pvssda_model_cfg("msg").BACKBONE_3D,
        "MAP_TO_BEV": pp.MAP_TO_BEV,
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [2],
                        "NUM_FILTERS": [16], "UPSAMPLE_STRIDES": [1],
                        "NUM_UPSAMPLE_FILTERS": [16]},
        "NECK": {"NAME": "VoxelPointCross", "NUM_FILTERS": 16},
        "DENSE_HEAD": pp.DENSE_HEAD,
        "POST_PROCESSING": pp.POST_PROCESSING,
    })


def dsasnet_model(which):
    """(model config, DatasetMeta) of a tiny DSASNet (DSASNET_HYBRIDS) or of
    the tiny PVSSDA on its BEV topology ("neck")."""
    if which == "neck":
        return pvssda_neck_model_cfg(), PVSSDA_NECK_META
    return dsasnet_model_cfg(which), DSASNET_META


def dsasnet_state(which="spb", seed=13, train=False):
    """The tiny DSASNet's (or the neck PVSSDA's) state for its checks: every
    entry of the port model's state dict drawn from numpy's
    RandomState(seed) (`redraw_state`: the hybrids' statistics buffers
    non-zero, so that their class conditioning is not constant); with
    `train` the channels-last BN biases raised by TWO_STAGE_TRAIN_BN_LIFT
    and the point head's output layers times POINTRCNN_TRAIN_GAIN, as the
    tiny PVSSDA's training state."""
    from .models import build_network
    from .models.backbones_3d.pointnet2_modules import BatchNorm

    cfg, meta = dsasnet_model(which)
    model = build_network(cfg, 1, meta, device="cpu", seed=0)
    lifted = {f"{name}.bias" for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    heads = tuple(f"module_list.{i}.{n}." for i, m in enumerate(model.module_list)
                  if type(m).__name__ == "DSASNetHead" for n in ("cls_out", "box_out"))
    out = {}
    for key, v in redraw_state(model.state_dict(), seed).items():
        if train and key in lifted:
            v = v + TWO_STAGE_TRAIN_BN_LIFT
        elif train and heads and key.startswith(heads):
            v = v * POINTRCNN_TRAIN_GAIN
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


CADDN_PCR = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
CADDN_META = DatasetMeta(
    class_names=("Car",), point_cloud_range=CADDN_PCR, voxel_size=(0.5, 0.5, 0.25),
    grid_size=(32, 32, 16), max_voxels=256, max_points_per_voxel=5, num_point_features=4,
    max_points=128, depth_downsample_factor=8)
CADDN_FORWARD_PATH = STATE_PATH.parent / "caddn_tiny_forward.npz"
CADDN_DDNS = {"compact": None,
              "deeplab": {"NAME": "DDNDeepLabV3", "LAYERS": [1, 1, 1, 1], "WIDTH": 8}}


def caddn_model_cfg(which="compact"):
    """The JAX package's tiny CaDDN (tests/test_caddn_e2e.py `model_cfg`);
    "deeplab" selects the tiny DDNDeepLabV3 plan and the balancer's weights
    (its `test_caddn_deeplab_vfe_and_balancer`)."""
    cfg = EDict({
        "NAME": "CaDDN",
        "VFE": {"NAME": "ImageVFE", "NUM_OUTPUT_FEATURES": 16, "NUM_DEPTH_BINS": 16,
                "DEPTH_RANGE": [1.0, 20.0], "LOSS_CONFIG": {"WEIGHTS": {"ddn_loss": 3.0}}},
        "MAP_TO_BEV": {"NAME": "Conv2DCollapse", "NUM_BEV_FEATURES": 16},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [1],
                        "NUM_FILTERS": [16], "UPSAMPLE_STRIDES": [1],
                        "NUM_UPSAMPLE_FILTERS": [16]},
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle", "CLASS_AGNOSTIC": False,
            "USE_DIRECTION_CLASSIFIER": True, "DIR_OFFSET": 0.78539,
            "DIR_LIMIT_OFFSET": 0.0, "NUM_DIR_BINS": 2,
            "ANCHOR_GENERATOR_CONFIG": [{
                "class_name": "Car", "anchor_sizes": [[3.9, 1.6, 1.56]],
                "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.78],
                "align_center": False, "feature_map_stride": 1,
                "matched_threshold": 0.6, "unmatched_threshold": 0.45}],
            "TARGET_ASSIGNER_CONFIG": {"MATCH_HEIGHT": False},
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {"cls_weight": 1.0, "loc_weight": 2.0,
                                             "dir_weight": 0.2,
                                             "code_weights": [1.0] * 7}}},
        "POST_PROCESSING": {
            "RECALL_THRESH_LIST": [0.3, 0.5, 0.7], "SCORE_THRESH": 0.1, "EVAL_METRIC": "kitti",
            "NMS_CONFIG": {"MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu",
                           "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 64, "NMS_POST_MAXSIZE": 8}},
    })
    if CADDN_DDNS[which] is not None:
        cfg.VFE.DDN = dict(CADDN_DDNS[which])
        cfg.VFE.FG_WEIGHT = 13.0
        cfg.VFE.BG_WEIGHT = 1.0
    return cfg


def caddn_batch(b=2):
    """The JAX test's batch (numpy): 64 x 96 images in [0, 1), a pinhole
    (fx 50, principal point (48, 32)) whose depth axis is lidar +x, 128 points
    a scan in front of it and one car box a scan."""
    rng = np.random.RandomState(0)
    images = rng.rand(b, 64, 96, 3).astype(np.float32)
    P = np.repeat(np.asarray([[0, -50.0, 0, 48.0], [0, 0, -50.0, 32.0], [1, 0, 0, 0]],
                             np.float32)[None], b, 0)
    pts = np.zeros((b, 128, 4), np.float32)
    pts[..., 0] = rng.uniform(2, 15, (b, 128))
    pts[..., 1] = rng.uniform(-5, 5, (b, 128))
    pts[..., 2] = rng.uniform(-2, 0.5, (b, 128))
    gt = np.zeros((b, 2, 8), np.float32)
    gv = np.zeros((b, 2), bool)
    gt[:, 0] = [8, 0, -1, 3.9, 1.6, 1.56, 0.3, 1]
    gv[:, 0] = True
    return {"images": images, "trans_lidar_to_cam_img": P, "points": pts,
            "points_mask": np.ones((b, 128), bool), "gt_boxes": gt, "gt_boxes_mask": gv}


def caddn_boxes2d(b=2):
    """2D gt boxes for the balancer (u1 v1 u2 v2): a scan's first box takes
    the image's middle third, its second is an all-zero (invalid) row."""
    out = np.zeros((b, 2, 4), np.float32)
    out[:, 0] = [32.0, 0.0, 64.0, 64.0]
    return out


def caddn_train_batch(which="compact"):
    """The tiny CaDDN's training batch: `caddn_batch`, and for the deeplab
    model `caddn_boxes2d`."""
    b = caddn_batch()
    if which == "deeplab":
        b["gt_boxes2d"] = caddn_boxes2d()
    return b


def caddn_state(which="compact", seed=11):
    """The tiny CaDDN's state for its checks: every entry of the port model's
    state dict drawn from numpy's RandomState(seed) (`redraw_state`; the
    anchors' scores then all pass SCORE_THRESH, and NMS keeps its 8 a scan)."""
    from .models import build_network

    model = build_network(caddn_model_cfg(which), 1, CADDN_META, device="cpu", seed=0)
    return {k: torch.from_numpy(v.astype(np.float32))
            for k, v in redraw_state(model.state_dict(), seed).items()}


# the JAX registry's module variants on the tiny SECOND and PointPillars:
# name -> (topology, {section: overrides}); "pp2" is the tiny PointPillars with
# a second class (Pedestrian), so that the grouped cls head has two groups
VARIANTS = {
    "DynamicMeanVFE": ("second", {"VFE": {"NAME": "DynamicMeanVFE"}}),
    "MeanDensityVFE": ("second", {"VFE": {"NAME": "MeanDensityVFE"}}),
    "SPVFE": ("second", {"VFE": {"NAME": "SPVFE", "NUM_FILTERS": [16, 8]}}),
    "VPCVFE": ("pointpillar", {"VFE": {"NAME": "VPCVFE", "NUM_FILTERS": [16]}}),
    "DynamicPillarVFE": ("pointpillar", {"VFE": {"NAME": "DynamicPillarVFE"}}),
    "SpaceVoxelBackBone8x": ("second", {"BACKBONE_3D": {"NAME": "SpaceVoxelBackBone8x"}}),
    "AnchorHeadMulti": ("pointpillar", {"DENSE_HEAD": {"NAME": "AnchorHeadMulti",
                                                       "SHARED_CONV_NUM_FILTER": 16}}),
    "AnchorHeadSingleCls": ("second", {"DENSE_HEAD": {"NAME": "AnchorHeadSingleCls"}}),
    "AnchorHeadMultiCls": ("pp2", {"DENSE_HEAD": {
        "NAME": "AnchorHeadMultiCls", "SHARED_CONV_NUM_FILTER": 16,
        "RPN_HEAD_CFGS": [{"HEAD_CLS_NAME": ["Car"]}, {"HEAD_CLS_NAME": ["Pedestrian"]}]}}),
}
PEDESTRIAN_ANCHORS = {"class_name": "Pedestrian", "anchor_sizes": [[0.8, 0.6, 1.73]],
                      "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-0.6],
                      "align_center": False, "feature_map_stride": 2,
                      "matched_threshold": 0.5, "unmatched_threshold": 0.35}


def variant_model(name):
    """(model cfg, DatasetMeta) of a module variant on its tiny topology
    (`VARIANTS`)."""
    topology, overrides = VARIANTS[name]
    if topology == "second":
        cfg, meta = second_model_cfg(), SECOND_META
    else:
        cfg, meta = pointpillar_model_cfg(), POINTPILLAR_META
    if topology == "pp2":
        cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG = list(cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG) + [
            dict(PEDESTRIAN_ANCHORS)]
        meta = dataclasses.replace(meta, class_names=("Car", "Pedestrian"))
    for section, values in overrides.items():
        cfg[section] = EDict({**cfg[section], **values})
    return cfg, meta


def variant_gt(meta, batch_size=2):
    """Training boxes of the variants' batches: `second_gt`'s anchored cars,
    and for a two-class meta a pedestrian a scan."""
    gt, mask = second_gt(batch_size)
    if len(meta.class_names) > 1:
        ped = np.zeros((batch_size, 1, 8), np.float32)
        ped[:, 0] = [6.0, 2.0, -0.9, 0.8, 0.6, 1.73, 0.4, 2]
        gt = np.concatenate([gt, ped], 1)
        mask = np.concatenate([mask, np.ones((batch_size, 1), bool)], 1)
    return gt, mask


def load_state(path=STATE_PATH):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}
