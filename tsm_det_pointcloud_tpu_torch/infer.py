"""Eval entry point: build the detector on the card and detect on synthetic
scans.

    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/fast_cpc.yaml [--batch 16] \
        [--points 16384] [--iters 3] [--seed 0] [--device cuda] [--profile]
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/waymo_models/waymo_fast_cpc.yaml --batch 8 \
        --points 122880
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/second.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/fast_cpc_teacher.yaml
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/pointpillar.yaml --batch 16 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/centerpoint.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/PartA2.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/pvrcnn.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/pv_rcnn_plusplus.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/pointrcnn.yaml --batch 4 --points 16384
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/voxel_rcnn_car.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/second_iou.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml \
        --batch 4 --points 300000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/lyft_models/centerpoint_voxel01_res3d.yaml \
        --batch 4 --points 300000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/pandaset_models/centerpoint.yaml --batch 4 --points 115200
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/CaDDN.yaml --batch 2
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/dsasnet.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/nuscenes_models/cbgs_pp_multihead.yaml \
        --batch 4 --points 300000
    python -m tsm_det_pointcloud_tpu_torch.infer --variant pillar_options \
        --batch 4 --points 20000
--variant NAME takes a variant of a shipped config (`variant_cfg`:
pillar_options, teacher3, pointrcnn_pool_last, neck, or a DSASNet hybrid) in
place of --cfg_file.

The dataset's geometry is read from the config's DATA_CONFIG (voxel limits
of the test mode) and the synthetic scans follow it: KITTI (4 point
features), Waymo (5 point features, a +-75.2 m range), nuScenes (5 point
features: x, y, z, intensity, a sweep's time lag; a +-51.2 m range), Lyft
(the same 5 features, a +-80 m range) or PandaSet (4 point features,
KITTI's range and its mirror behind the ego). A camera config (CaDDN, its
VFE an ImageVFE) also gets synthetic camera inputs (`synth_camera`): noise
images of KITTI's 375 x 1242 and KITTI's lidar-to-image projection
P2 R0 Tr_velo_to_cam (`KITTI_LIDAR_TO_IMAGE`); it prints the voxels inside
the camera frustum a scan too. Prints
the detections per scan of the last batch (for a CenterHead with a
velocity branch also the speed of its decoded boxes over SCORE_THRESH,
which the detector's post-processing drops, as the JAX one does) and the
scans/s over the timed batches (host clock around work that ends in a
synchronize). Weights, BN running stats and the TSM heads' statistics
buffers are random, made from --seed, with the cls priors lifted so that
NMS has boxes to work on.
--profile then traces one more batch with
torch.profiler and prints the device's busy share of that batch's wall time
and the kernels with the most device time, and the same for the batch's
post-processing alone (`main` returns both traces' figures and kernel
names).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .config import cfg_from_list, cfg_from_yaml_file
from .models import build_network
from .models.dense_heads.point_head_vote import STATISTIC_BUFFERS
from .models.detectors import DatasetMeta
from .ops import iou3d
from .utils.common_utils import resolve_device
from .utils.edict import EDict

ROOT = Path(__file__).resolve().parent.parent


class ScanRecipe(NamedTuple):
    """The constants of one synthetic-scan recipe: background points uniform
    in the box `lo`..`hi`, `n_clusters` object-like clusters of 200 points
    each (x within 2 m, y within 1 m of a centre drawn in `centre_lo`..
    `centre_hi`, z in `cluster_z`), and the box that holds such a cluster
    (z centre, dx, dy, dz)."""
    lo: tuple
    hi: tuple
    n_clusters: int
    centre_lo: tuple
    centre_hi: tuple
    cluster_z: tuple
    box: tuple


# keyed by the dataset's POINT_CLOUD_RANGE: the recipes of the JAX package's
# bench.py (KITTI range, eight car-like clusters; pointpillar.yaml's range,
# 0.32 m narrower in y, takes the same scans) and tools/bench_waymo.py
# (Waymo range, sixteen vehicle-like clusters)
_KITTI_SCANS = ScanRecipe((0.0, -39.0, -2.0), (69.0, 39.0, 0.5), 8, (5, -30), (60, 30),
                          (-1.6, -0.2), (-0.9, 4.2, 2.2, 1.6))
SCAN_RECIPES = {
    (0, -40, -3, 70.4, 40, 1): _KITTI_SCANS,
    (-75.2, -75.2, -2, 75.2, 75.2, 4): ScanRecipe(
        (-74, -74, -1.9), (74, 74, 3.9), 16, (-60, -60), (60, 60), (0.0, 1.8),
        (0.9, 4.2, 2.2, 2.0)),
    (0, -39.68, -3, 69.12, 39.68, 1): _KITTI_SCANS,
    # nuScenes (the lidar 1.84 m up): sixteen car-like clusters
    (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0): ScanRecipe(
        (-51, -51, -1.9), (51, 51, 1.5), 16, (-45, -45), (45, 45), (-1.8, -0.2),
        (-1.0, 4.6, 1.95, 1.73)),
    # Lyft (the roof lidar 1.8 m up, +-80 m): sixteen car-like clusters
    (-80.0, -80.0, -5.0, 80.0, 80.0, 3.0): ScanRecipe(
        (-79, -79, -1.9), (79, 79, 1.5), 16, (-70, -70), (70, 70), (-1.8, -0.2),
        (-1.0, 4.76, 1.93, 1.72)),
    # PandaSet (the Pandar64 1.8 m up; KITTI's range and its mirror behind the
    # ego): sixteen car-like clusters
    (-70.4, -40, -3, 70.4, 40, 1): ScanRecipe(
        (-70, -39.5, -1.9), (70, 39.5, 0.9), 16, (-60, -32), (60, 32), (-1.7, -0.2),
        (-1.0, 4.6, 1.9, 1.6)),
    # CaDDN's range (KITTI's camera frustum out to 46.8 m): eight car-like
    # clusters in the camera's view
    (2, -30.08, -3.0, 46.8, 30.08, 1.0): ScanRecipe(
        (2.5, -29.5, -2.0), (46.0, 29.5, 0.5), 8, (8, -6), (44, 6), (-1.6, -0.2),
        (-0.9, 4.2, 2.2, 1.6)),
}
KITTI_RANGE, WAYMO_RANGE = list(SCAN_RECIPES)[:2]


def scan_recipe(point_cloud_range):
    """The synthetic-scan recipe for a dataset's range."""
    key = tuple(point_cloud_range)
    if key not in SCAN_RECIPES:
        raise ValueError(f"no synthetic-scan recipe for POINT_CLOUD_RANGE {key}: "
                         f"add one to infer.SCAN_RECIPES")
    return SCAN_RECIPES[key]


def synth_scene(batch, n, seed=0, point_cloud_range=KITTI_RANGE, n_features=4):
    """Synthetic scans (B, n, n_features: x, y, z, then features in [0, 1))
    in the given range by its `ScanRecipe`, and the clusters' (x, y) centres
    (B, n_clusters, 2)."""
    r = scan_recipe(point_cloud_range)
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch, n, n_features), np.float32)
    for a in range(3):
        pts[..., a] = rng.uniform(r.lo[a], r.hi[a], (batch, n))
    for a in range(3, n_features):
        pts[..., a] = rng.uniform(0, 1, (batch, n))
    centres = np.zeros((batch, r.n_clusters, 2), np.float32)
    for b in range(batch):
        for k in range(r.n_clusters):
            cx = rng.uniform(r.centre_lo[0], r.centre_hi[0])
            cy = rng.uniform(r.centre_lo[1], r.centre_hi[1])
            centres[b, k] = cx, cy
            s = slice(k * 200, (k + 1) * 200)
            pts[b, s, 0] = rng.uniform(cx - 2, cx + 2, 200)
            pts[b, s, 1] = rng.uniform(cy - 1, cy + 1, 200)
            pts[b, s, 2] = rng.uniform(*r.cluster_z, 200)
    return pts, centres


def synth_points(batch, n, seed=0):
    """Synthetic KITTI-range scans (B, n, 4) with eight car-like clusters
    each, so NMS has real work (the same recipe as the JAX bench)."""
    return synth_scene(batch, n, seed)[0]


def synth_waymo(batch, n, seed=0):
    """Synthetic Waymo-range scans (B, n, 5: x, y, z, intensity, elongation)
    with sixteen vehicle-like clusters each."""
    return synth_scene(batch, n, seed, WAYMO_RANGE, 5)[0]


def synth_scans(meta, batch, n, seed=0):
    """Synthetic scans of the dataset `meta` describes (`dataset_meta`)."""
    return synth_scene(batch, n, seed, meta.point_cloud_range, meta.num_point_features)[0]


# KITTI's calibration of training frame 000000: P2 (3 x 4), R0_rect and
# Tr_velo_to_cam (3 x 4 each, padded to 4 x 4); the lidar-to-image matrix is
# their product, as CaDDN's trans_lidar_to_cam_img
KITTI_IMAGE_SIZE = (375, 1242)
_KITTI_P2 = np.array([[7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01],
                      [0.0, 7.215377e+02, 1.728540e+02, 2.163791e-01],
                      [0.0, 0.0, 1.0, 2.745884e-03]])
_KITTI_R0 = np.array([[9.999239e-01, 9.837760e-03, -7.445048e-03],
                      [-9.869795e-03, 9.999421e-01, -4.278459e-03],
                      [7.402527e-03, 4.351614e-03, 9.999631e-01]])
_KITTI_TR = np.array([[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
                      [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
                      [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01]])
KITTI_LIDAR_TO_IMAGE = (_KITTI_P2 @ np.block([[_KITTI_R0, np.zeros((3, 1))],
                                              [np.zeros((1, 3)), np.ones((1, 1))]])
                        @ np.vstack([_KITTI_TR, [0.0, 0.0, 0.0, 1.0]])).astype(np.float32)


def uses_images(model_cfg):
    """Whether a model config reads camera images (its VFE an ImageVFE)."""
    return (model_cfg.get("VFE") or {}).get("NAME") == "ImageVFE"


def refuse_camera_data(cfg, entry):
    """Raise for a camera config in an entry point that reads a dataset: no
    ported dataset loads images or their projections (nor does the JAX
    package's), so CaDDN runs on synthetic camera batches alone."""
    if uses_images(cfg.MODEL):
        raise NotImplementedError(
            f"{entry}: {cfg.MODEL.NAME} reads camera images and their lidar-to-image "
            f"projections, which no ported dataset loads; run it on synthetic camera "
            f"batches through infer or train")


def synth_camera(batch, seed=0):
    """Synthetic camera inputs: images (B, H, W, 3) uniform in [0, 1) from
    the seed and KITTI's lidar-to-image matrix (B, 3, 4)."""
    images = np.random.RandomState(seed).uniform(0, 1, (batch, *KITTI_IMAGE_SIZE, 3)).astype(np.float32)
    return {"images": images,
            "trans_lidar_to_cam_img": np.repeat(KITTI_LIDAR_TO_IMAGE[None], batch, 0)}


def boxes_to_image(gt_boxes, lidar_to_img):
    """2D gt boxes (B, M, 4) u1 v1 u2 v2: the image extent of each 3D box's
    eight corners (in front of the camera), clipped to the image; all zero
    for a box behind it."""
    from .ops.boxes import boxes_to_corners_3d_np

    B, M = gt_boxes.shape[:2]
    corners = boxes_to_corners_3d_np(gt_boxes[..., :7].reshape(-1, 7)).reshape(B, M, 8, 3)
    hom = np.concatenate([corners, np.ones((B, M, 8, 1), corners.dtype)], -1)
    uvw = np.einsum("bmkj,bij->bmki", hom, lidar_to_img)
    depth = uvw[..., 2]
    front = (depth > 0.1).all(-1)
    uv = uvw[..., :2] / np.maximum(depth, 0.1)[..., None]
    h, w = KITTI_IMAGE_SIZE
    out = np.stack([uv[..., 0].min(-1), uv[..., 1].min(-1), uv[..., 0].max(-1),
                    uv[..., 1].max(-1)], -1)
    out = np.clip(out, 0, [w, h, w, h])
    return np.where(front[..., None], out, 0.0).astype(np.float32)


def load_cfg(cfg_file, set_cfgs=None):
    """The config of `cfg_file`, then the `--set KEY VALUE ...` overrides
    (`config.cfg_from_list`)."""
    cfg = cfg_from_yaml_file(str(cfg_file), EDict({"ROOT_DIR": ROOT, "LOCAL_RANK": 0}))
    if set_cfgs:
        cfg_from_list(list(set_cfgs), cfg)
    return cfg


# the anchor heads' conv_cls bias in place of the -log(99) prior, by
# detector: with the seeded weights and eval state a few thousand of a
# scan's anchors then score above the config's SCORE_THRESH 0.1 (calibrated
# on the synthetic KITTI scans at 20000 points: ~2,850 of SECOND's 211,200
# anchors, ~2,800 of PointPillars' 321,408, where SECOND's value lets ~78,000
# pass; infer prints the count). Part-A2's and PV-RCNN's seeded anchor logits
# lie within ~0.25 of each other, so a scan's count jumps from none to all
# across a quarter of bias: at these values ~23,800 and ~210 anchors a scan
# pass (on the same scans). Their proposal layer keeps the best 1024 a scan
# (NMS_PRE_MAXSIZE of the test mode) whatever their scores, and infer prints
# the proposals NMS kept a scan and the RoI head's boxes over SCORE_THRESH.
# SECONDNetIoU's first stage is SECOND's, with the same seeded weights and eval
# state, so it takes SECOND's value; Voxel R-CNN's (one class, a narrower BEV
# backbone) was set on the card. PV-RCNN++'s seeded first stage is another
# draw than PV-RCNN's (its PFE's weights come first in the generator): at
# -2.5 ~116,000 anchors a scan pass, at -2.855 ~230 (set on one scan).
# CaDDN's seeded anchor logits on noise images lie within 0.15 of each other
# (before the bias: the 100th best of a scan 0.2505, the 300th 0.2489, the
# 3000th 0.2298, on the card at b2): at -2.447 a few hundred pass. PVSSDA's
# anchor head on the VoxelPointCross neck (`variant_cfg("neck")`): before the
# bias the 1000th best of a scan's 321,408 anchors 0.369, the 2800th 0.360,
# the 10000th 0.356 (two synthetic scans of 20000 points, on the CPU)
CLS_BIAS = {"SECONDNet": -2.575, "PointPillar": -3.25, "PartA2Net": -2.575,
            "PVRCNN": -2.5, "PVRCNNPlusPlus": -2.855, "SECONDNetIoU": -2.575,
            "VoxelRCNN": -1.25, "CaDDN": -2.447, "PVSSDA": -2.56}
# the same by detector on another dataset, and by variant (`variant_cfg`),
# where the seeded logits lie elsewhere: each value puts a scan's 2800th
# best anchor at SCORE_THRESH 0.1 (set on the CPU on two synthetic scans,
# before the bias the 2800th best logit 1.757 and 1.770 of
# cbgs_pp_multihead.yaml's 327,680 anchors at 300,000 points, 0.377 and
# 0.379 of pillar_options' 321,408 at 20,000)
DATASET_CLS_BIAS = {("PointPillar", "NuScenesDataset"): -3.96}
VARIANT_CLS_BIAS = {"pillar_options": -2.575}
# the point head's cls_out bias of a one-stage point detector (PVSSDA, a box
# a point): pvssda_3dssd.yaml's seeded logits at bias 0 lie within 0.38-0.53
# over a scan's 512 points (the 100th best ~0.495, on the CPU at b1 x 16384
# on two synthetic scans), so at this bias ~100 of them pass SCORE_THRESH
POINT_CLS_BIAS = {"PVSSDA": -2.69}
# CenterPoint's hm_out by the config's dataset: a gain on its seeded kernel
# and a bias in place of the -2.19 init, one for every class group or one
# for all. The seeded heatmap logits lie within 0.5 of each other, so at the
# init's bias either all of a scan's decoded boxes pass SCORE_THRESH or
# none; with these ~100 of centerpoint.yaml's 500 do on the synthetic KITTI
# scans. The nuScenes config's six groups' seeded logits lie apart (at gain
# 20 and bias 0 a group's 50th best is 2.5 to 10.7, stable over scans and
# from 100k to 300k points on the CPU): each group's bias puts its 50th best
# at SCORE_THRESH, ~300 of a scan's 3000 decoded boxes (infer prints the count).
# The Lyft config's five groups and the PandaSet config's one were set the
# same way on the CPU, at gain 20 and bias 0 on two synthetic scans of
# 100,000 points: a group's 50th best local peak of the heatmap logits is
# 2.58, 5.93, -0.01, 7.17 and 1.34 (Lyft) and 4.48 (PandaSet, its 100th
# 4.45)
CENTERPOINT_HM = {"KittiDataset": (20.0, -6.5),
                  "NuScenesDataset": (20.0, (-4.75, -12.1, -4.65, -12.9, -7.1, -7.6)),
                  "LyftDataset": (20.0, (-4.78, -8.12, -2.18, -9.37, -3.54)),
                  "PandasetDataset": (20.0, -6.66)}


@torch.no_grad()
def randomize_eval_state(model, seed, dataset="KittiDataset", variant=None):
    """Seeded non-trivial BN running stats and, for TSM, statistics buffers
    (a real deployment loads them from a checkpoint), and cls output biases
    lifted from the -log(99) prior so that boxes reach NMS: TSM's cls heads
    at 1.0, an anchor head's conv_cls at VARIANT_CLS_BIAS of the variant,
    else DATASET_CLS_BIAS of its detector and dataset, else CLS_BIAS of its
    detector, a point
    detector's cls_out at POINT_CLS_BIAS,
    CenterPoint's hm_out kernel times the gain and its bias at the bias of
    CENTERPOINT_HM[dataset]."""
    from .models.backbones_3d.pointnet2_modules import BatchNorm

    g = torch.Generator().manual_seed(int(seed))
    dev = next(model.parameters()).device
    kind = type(model).__name__
    cls_bias = VARIANT_CLS_BIAS.get(variant, DATASET_CLS_BIAS.get((kind, dataset),
                                                                  CLS_BIAS.get(kind)))
    for name, m in model.named_modules():
        if isinstance(m, (BatchNorm, torch.nn.BatchNorm2d)):
            n = m.running_mean.shape[0]
            m.running_mean.copy_((torch.randn(n, generator=g) * 0.2).to(dev))
            m.running_var.copy_((0.5 + torch.rand(n, generator=g)).to(dev))
        tail = name.rsplit(".", 1)[-1]
        if tail in ("cls0_out", "cls1_out", "cls2_out"):
            m.bias.fill_(1.0)
        elif tail == "conv_cls":
            m.bias.fill_(cls_bias)
        elif tail == "cls_out" and type(model).__name__ in POINT_CLS_BIAS:
            m.bias.fill_(POINT_CLS_BIAS[type(model).__name__])
        elif tail == "hm_out":
            gain, bias = CENTERPOINT_HM[dataset]
            if isinstance(bias, tuple):   # by group: ...head_<g>.hm_out
                bias = bias[int(name.rsplit(".", 2)[-2].removeprefix("head_"))]
            m.weight.mul_(gain)
            m.bias.fill_(bias)
    seed_statistics(model, g)


@torch.no_grad()
def seed_statistics(model, g):
    """The class-statistics buffers N(0, 0.25) from generator g, wherever
    a module keeps them (the distillation head at its own scope, the
    teacher head in its branch, a hybrid 2D backbone's `object_statistics`,
    which holds the first of them alone); a real run transfers them from the
    teacher checkpoint or accumulates them in training."""
    for m in model.modules():
        own = dict(m.named_buffers(recurse=False))
        if "object_statistic_features" in own:
            for buf in STATISTIC_BUFFERS:
                if buf in own:
                    own[buf].copy_((torch.randn(own[buf].shape, generator=g) * 0.5)
                                   .to(own[buf].device))


def dataset_meta(cfg, n_points, mode="test"):
    """The static geometry of the config's dataset, read from its
    DATA_CONFIG: the range, the point features, the voxel size of the first
    DATA_PROCESSOR entry that states one (and its voxel limits, where it has
    them: MAX_NUMBER_OF_VOXELS of `mode`, "test" for eval and "train" for
    training, as the JAX data processor picks them), and the grid they
    give; no voxel size nor grid for a point-based config that voxelizes
    nothing (pointrcnn.yaml)."""
    data = cfg.DATA_CONFIG
    pcr = tuple(data.POINT_CLOUD_RANGE)
    voxel = next((p for p in data.DATA_PROCESSOR if "VOXEL_SIZE" in p), None)
    limits = {}
    if voxel is not None:
        size = tuple(voxel.VOXEL_SIZE)
        grid = np.round(np.subtract(pcr[3:], pcr[:3]) / np.asarray(size)).astype(int)
        limits["voxel_size"] = size
        limits["grid_size"] = tuple(int(g) for g in grid)
        if "MAX_NUMBER_OF_VOXELS" in voxel:
            limits["max_voxels"] = int(voxel.MAX_NUMBER_OF_VOXELS[mode])
        if "MAX_POINTS_PER_VOXEL" in voxel:
            limits["max_points_per_voxel"] = int(voxel.MAX_POINTS_PER_VOXEL)
    return DatasetMeta(
        class_names=tuple(cfg.CLASS_NAMES), point_cloud_range=pcr,
        num_point_features=len(data.POINT_FEATURE_ENCODING.used_feature_list),
        max_points=n_points, **limits)


# DSASNet's other hybrid 2D backbones, BACKBONE_2D swaps of dsasnet.yaml at
# their modules' defaults where the trunk allows: Z_GROUPS must divide
# HeightCompression's 256 channels (the defaults 10 and 5 do not), so 8
HYBRID_VARIANTS = {
    "PointFromVoxel": {"NAME": "PointFromVoxel", "Z_GROUPS": 8, "LOCAL_CH": 32, "GLOBAL_CH": 32,
                       "FG_CORNER_POINTS": [[2048, 1024], [512, 256]]},
    "VoxelPointCross": {"NAME": "VoxelPointCross", "Z_GROUPS": 8, "TRUNK_CH": 256,
                        "N_BLOCK": [2, 2], "FG_CORNER_POINTS": [[1024, 512], [512, 256]]},
    "BEVPoint": {"NAME": "BEVPoint", "NUM_FILTERS": 128, "N_BLOCK": [1, 1, 1],
                 "NUM_RAW_KEYPOINTS": 1000},
}


# the variants of shipped configs that are the first users of the JAX
# package's options no shipped config takes (`variant_cfg`)
OPTION_VARIANTS = ("pillar_options", "teacher3", "pointrcnn_pool_last")


def _third_teacher_layer(sa):
    """SA_CONFIG with a third layer: s-fps 512 of layer 1's 512 points over
    [0, 512] at layer 1's query ranges, radii, nsample and MLP widths. It
    keeps 512 points because the distillation loss pairs the teacher's last
    layer point for point with the student's (a JAX teacher of 256 fails its
    training init on the shapes)."""
    for key in ("POOL_METHOD", "QUERY_RANGE", "STRIDE", "RADIUS", "NSAMPLE", "MLPS",
                "SPCONV_MLPS_PRE", "AGGREGATION_MLPS", "CONFIDENCE_MLPS"):
        sa[key] = list(sa[key]) + [sa[key][1]]
    sa.NPOINT_LIST = list(sa.NPOINT_LIST) + [[512]]
    sa.SAMPLE_RANGE_LIST = list(sa.SAMPLE_RANGE_LIST) + [[[0, 512]]]
    sa.SAMPLE_METHOD_LIST = list(sa.SAMPLE_METHOD_LIST) + [["s-fps"]]


def variant_cfg(name):
    """The config of a variant of a shipped config:
      * a DSASNet variant: dsasnet.yaml with BACKBONE_2D one of
        HYBRID_VARIANTS; or ("neck") PVSSDA on its BEV topology,
        pointpillar.yaml's data, PillarVFE, scatter, BEV backbone, anchor
        head and post-processing with pointrcnn.yaml's PointNet2MSG and the
        VoxelPointCross neck at NUM_FILTERS 128, trained with
        pointpillar.yaml's optimisation;
      * "pillar_options": pointpillar.yaml with a two-layer PFN (64, 64) on
        the distance and without absolute xyz; UPSAMPLE_STRIDES
        [0.5, 1, 2, 2] (a strided-conv deblock0 and a deblock_final that
        brings the stride-4 concatenation back to stride 2 and its 384
        channels: the 321,408 anchors stay); per-class SCORE_THRESH
        [0.1, 0.1, 0.1] with nms_normal, so that post-processing takes the
        per-pass route over the 321,408 boxes with axis-aligned NMS;
        random_world_frustum_dropout (top, left; intensity [0, 0.2]) after
        its augmentors; and OPTIMIZER adam (its own LR, WEIGHT_DECAY,
        MOMENTUM, DECAY_STEP_LIST, LR_DECAY and LR_CLIP; sgd by setting
        OPTIMIZATION.OPTIMIZER);
      * "teacher3": fast_cpc.yaml with a third teacher SA layer
        (`_third_teacher_layer`);
      * "pointrcnn_pool_last": pointrcnn.yaml with the RoI head's SA_CONFIG
        NPOINTS [128, 32] and no group-all layer, so the head max-pools the
        last SA level."""
    kitti = ROOT / "tools/cfgs/kitti_models"
    if name == "pillar_options":
        cfg = load_cfg(kitti / "pointpillar.yaml")
        cfg.MODEL.VFE.update(NUM_FILTERS=[64, 64], WITH_DISTANCE=True, USE_ABSLOTE_XYZ=False)
        cfg.MODEL.BACKBONE_2D.update(UPSAMPLE_STRIDES=[0.5, 1, 2, 2],
                                     NUM_UPSAMPLE_FILTERS=[128, 128, 128])
        cfg.MODEL.POST_PROCESSING.SCORE_THRESH = [0.1, 0.1, 0.1]
        cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_TYPE = "nms_normal"
        augs = cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST
        augs.append(EDict({"NAME": "random_world_frustum_dropout",
                           "DIRECTION": ["top", "left"], "INTENSITY_RANGE": [0.0, 0.2]}))
        cfg.OPTIMIZATION.OPTIMIZER = "adam"
        return cfg
    if name == "teacher3":
        cfg = load_cfg(kitti / "fast_cpc.yaml")
        _third_teacher_layer(cfg.MODEL.BACKBONE_3D.SA_CONFIG)
        return cfg
    if name == "pointrcnn_pool_last":
        cfg = load_cfg(kitti / "pointrcnn.yaml")
        sa = cfg.MODEL.ROI_HEAD.SA_CONFIG
        for key in ("NPOINTS", "RADIUS", "NSAMPLE", "MLPS"):
            sa[key] = list(sa[key])[:2]
        return cfg
    if name != "neck":
        cfg = load_cfg(kitti / "dsasnet.yaml")
        cfg.MODEL.BACKBONE_2D = EDict(HYBRID_VARIANTS[name])
        return cfg
    cfg = load_cfg(kitti / "pointpillar.yaml")
    m = cfg.MODEL
    cfg.MODEL = EDict({"NAME": "PVSSDA", "VFE": m.VFE,
                       "BACKBONE_3D": load_cfg(kitti / "pointrcnn.yaml").MODEL.BACKBONE_3D,
                       "MAP_TO_BEV": m.MAP_TO_BEV, "BACKBONE_2D": m.BACKBONE_2D,
                       "NECK": EDict({"NAME": "VoxelPointCross", "NUM_FILTERS": 128}),
                       "DENSE_HEAD": m.DENSE_HEAD, "POST_PROCESSING": m.POST_PROCESSING})
    return cfg


def build_detector(cfg_file, device="cuda", seed=0, n_points=16384, variant=None):
    """The detector of `cfg_file` (or of a loaded config), or of the variant
    `variant` (`variant_cfg`), with seeded random weights and eval state;
    its dataset's geometry is `model.dataset_meta`."""
    if variant is not None:
        cfg_file = variant_cfg(variant)
    cfg = cfg_file if isinstance(cfg_file, dict) else load_cfg(cfg_file)
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                          dataset=dataset_meta(cfg, n_points), device=device,
                          seed=seed)
    randomize_eval_state(model, seed + 1, cfg.DATA_CONFIG.DATASET, variant)
    return cfg, model


@torch.no_grad()
def detect(model, points, mask, camera=None):
    """points (B, N, C), mask (B, N) on the model's device, and a camera
    model's images and projections (`camera`, tensors on that device) ->
    (batch_dict, pred) with fixed-size detections."""
    out = model({"points": points, "points_mask": mask,
                 "batch_size": points.shape[0], **(camera or {})})
    pred, _ = model.post_processing(out)
    return out, pred


def voxel_anchor_counts(model, out):
    """Per scan, the voxels (or pillars) a voxel-based detector kept, or the
    voxels inside a camera detector's frustum, and the predictions that
    reach NMS: the anchors whose best class score reaches a
    scalar SCORE_THRESH (or that class's of a per-class one), or
    CenterPoint's decoded boxes scoring above it;
    None where the model or the config has neither. A two-stage detector's
    first-stage boxes are counted by the dense head's scores (`cls_preds`),
    or PointRCNN's point head's (`point_cls_preds`, a box a point): the
    final NMS takes its RoI head's boxes, which `rois_over` counts."""
    post = model.model_cfg["POST_PROCESSING"]
    voxels = (out["voxel_mask"].sum(1).tolist() if "voxel_mask" in out
              else out["voxels_in_frustum"].tolist() if "voxels_in_frustum" in out else None)
    thresh = post.get("SCORE_THRESH", 0.1)
    over = None
    if "final_scores" in out:
        over = (out["final_scores"] > float(thresh)).sum(1).tolist()
    elif not isinstance(thresh, (list, tuple)):
        logits = (out["cls_preds"] if "cls_preds" in out else out["point_cls_preds"]) \
            if "roi_labels" in out else out["batch_cls_preds"]
        over = (torch.sigmoid(logits).amax(-1) >= float(thresh)).sum(1).tolist()
    elif "cls_preds" in out and "roi_labels" not in out:
        # an anchor head under per-class thresholds (multi_thresh_nms): each
        # anchor's best class score against that class's threshold
        scores, labels = torch.sigmoid(out["batch_cls_preds"]).max(-1)
        thr = torch.tensor(list(thresh), dtype=scores.dtype, device=scores.device)[labels]
        over = (scores >= thr).sum(1).tolist()
    return voxels, over


def velocities_over(model, out):
    """Per scan, (count, mean, max) of the speeds |(vx, vy)| of a CenterHead's
    decoded 9-column boxes scoring above SCORE_THRESH, and whether all their
    velocities are finite; None where the decoded boxes have no velocity."""
    if "final_boxes" not in out or out["final_boxes"].shape[-1] < 9:
        return None
    thresh = float(model.model_cfg["POST_PROCESSING"].get("SCORE_THRESH", 0.1))
    rows = []
    for boxes, scores in zip(out["final_boxes"], out["final_scores"]):
        vel = boxes[scores > thresh][:, 7:9]
        speed = torch.linalg.vector_norm(vel, dim=-1)
        rows.append((int(speed.numel()), float(speed.mean()) if speed.numel() else 0.0,
                     float(speed.max()) if speed.numel() else 0.0,
                     bool(torch.isfinite(vel).all())))
    return rows


def rois_over(model, out):
    """Per scan, a two-stage detector's proposals (the RoIs its proposal NMS
    kept) and the RoI head's boxes scoring at least SCORE_THRESH, which the
    final NMS takes; None for a one-stage detector."""
    if "roi_valid" not in out:
        return None
    thresh = float(model.model_cfg["POST_PROCESSING"].get("SCORE_THRESH", 0.1))
    scores = out["batch_cls_preds"][..., 0]
    if not out.get("cls_preds_normalized", False):
        scores = torch.sigmoid(scores)
    return list(zip(out["roi_valid"].sum(1).tolist(),
                    ((scores >= thresh) & out["roi_valid"]).sum(1).tolist()))


def self_device_us(evt):
    """A torch.profiler event's own device time, µs (the attribute's name
    differs between PyTorch versions; 0 when it has none)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_batch(model, points, mask, top=20, camera=None):
    """Trace one batch on the card; print the device busy share and the
    kernels with the most device time. Then trace the batch's
    post-processing (NMS) alone, to show its share of the batch. Returns
    both traces' `profile_call` results."""
    traced = {}
    whole = profile_call(
        lambda: traced.update(out=detect(model, points, mask, camera)[0]), top)
    out = traced["out"]   # the traced batch's forward, for its post-processing
    print("post-processing alone:")
    return whole, profile_call(lambda: model.post_processing(out), top=5)


def profile_call(fn, top=20):
    """Trace one call of `fn` on the card; print the device busy share of
    its wall time and the kernels with the most device time. Returns
    (wall ms, device busy ms, the names of the kernels that ran). The trace
    holds the device's events alone: the host's op events slowed the traced
    call's host path and doubled key_averages' seconds on a traced forward."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    iou3d.FIXPOINT_ITERS[0] = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_iters = iou3d.FIXPOINT_ITERS[0]
    # kernel events only: a user annotation's (Optimizer.step) span covers
    # its kernels', so counting it would count them twice. key_averages
    # takes seconds on a traced forward: it is built once
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and self_device_us(e) > 0]
    busy_us = sum(self_device_us(e) for e in events)
    print(f"profile: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%), idle {100 - 100 * busy_us / wall_us:.1f}%")
    if n_iters:
        print(f"profile: {n_iters} NMS keep-fixpoint iterations (`iou3d.FIXPOINT_ITERS`, one "
              f"host sync each)")
    events.sort(key=self_device_us, reverse=True)
    for e in events[:top]:
        print(f"  {self_device_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    return wall_us / 1e3, busy_us / 1e3, [e.key for e in events]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg_file", default=str(ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--variant", default=None,
                    choices=OPTION_VARIANTS + ("neck",) + tuple(HYBRID_VARIANTS),
                    help="a variant of a shipped config (`variant_cfg`) in place of "
                         "--cfg_file")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, model = build_detector(args.cfg_file, dev, args.seed, args.points, args.variant)
    pts = torch.from_numpy(synth_scans(model.dataset_meta, args.batch, args.points, args.seed)).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    camera = ({k: torch.from_numpy(v).to(dev) for k, v in synth_camera(args.batch, args.seed).items()}
              if uses_images(cfg.MODEL) else None)
    t0 = time.perf_counter()
    out, pred = detect(model, pts, mask, camera)  # warm-up: builds the kernels
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out, pred = detect(model, pts, mask, camera)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    voxels, over = voxel_anchor_counts(model, out)
    rois = rois_over(model, out)
    vels = velocities_over(model, out)
    for b, c in enumerate(pred["count"].tolist()):
        extra = "" if voxels is None else (
            f", {voxels[b]} voxels" + (" in the camera frustum" if camera else ""))
        extra += "" if over is None else f", {over[b]} predictions over SCORE_THRESH"
        if rois is not None:
            extra += (f" (first stage); {rois[b][0]} proposals kept, {rois[b][1]} RoI boxes "
                      f"over SCORE_THRESH")
        if vels is not None:
            n, mean, top, finite = vels[b]
            extra += (f"; their velocities {'finite' if finite else 'NOT finite'}, speed mean "
                      f"{mean:.3f} max {top:.3f} m/s")
        print(f"scan {b}: {c} detections{extra}")
    print(f"warm-up batch {warm:.3f} s (the kernels' and cuDNN's first calls)")
    if args.iters:   # --iters 0: the warm-up batch's detections alone (a --profile run)
        what = (f"{'x'.join(map(str, camera['images'].shape[1:3]))} images"
                if camera else f"{args.points} points")
        print(f"{args.batch * args.iters / dt:.3f} scans/s on {dev} "
              f"(batch {args.batch} x {what}, {args.iters} batches)")
    if args.profile:
        if dev.type != "cuda":
            raise RuntimeError("--profile measures the card: run with --device cuda")
        return profile_batch(model, pts, mask, camera=camera)


if __name__ == "__main__":
    main()
