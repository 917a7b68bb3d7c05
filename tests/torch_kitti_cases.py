"""The synthetic KITTI root and dataset configs shared by the port's KITTI
tests (test_torch_kitti_data.py, test_torch_kitti_eval.py,
test_torch_eval_loop.py, torch_eval_loop_cases.py).

`make_root` writes tests/test_kitti_pipeline.py's `make_kitti_root` layout
(velodyne, label_2, calib, planes, ImageSets; one Car and one DontCare a
frame) and adds a Pedestrian and a Cyclist a frame, each with a point
cluster, so that every class has gt-database entries; `copy_root` gives the
JAX package and the port copies of one root.
"""
import shutil

import numpy as np
import yaml

from tests.test_kitti_pipeline import make_kitti_root
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.config import cfg_from_yaml_file
from tsm_det_pointcloud_tpu_torch.infer import ROOT
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict

CLASSES = ["Car", "Pedestrian", "Cyclist"]
# (class, lidar centre x, y, z, dx, dy, dz, heading, image box) of the extra
# objects; frame k shifts them by 0.3 k m in x
EXTRA = (("Pedestrian", 6.0, 3.0, -0.9, 0.8, 0.6, 1.7, 0.4, (700, 140, 760, 260)),
         ("Cyclist", 12.0, -4.0, -0.8, 1.8, 0.6, 1.7, -1.1, (420, 150, 520, 250)))


def make_root(path, n_frames=6):
    """make_kitti_root's root with a Pedestrian and a Cyclist added to every
    frame (labels in the camera frame of its calib: cam x = -lidar y,
    cam y = -lidar z, cam z = lidar x), 60 points inside each."""
    path.mkdir(parents=True, exist_ok=True)
    root, ids = make_kitti_root(path, n_frames)
    rng = np.random.RandomState(1)
    for k, sid in enumerate(ids):
        velo = root / "training" / "velodyne" / f"{sid}.bin"
        pts = [np.fromfile(velo, np.float32).reshape(-1, 4)]
        lines = []
        for name, x, y, z, dx, dy, dz, head, box in EXTRA:
            x = x + 0.3 * k
            local = rng.uniform(-0.4, 0.4, (60, 3)) * np.array([dx, dy, dz])
            c, s = np.cos(head), np.sin(head)
            cl = np.zeros((60, 4), np.float32)
            cl[:, 0] = x + local[:, 0] * c - local[:, 1] * s
            cl[:, 1] = y + local[:, 0] * s + local[:, 1] * c
            cl[:, 2] = z + local[:, 2]
            cl[:, 3] = rng.uniform(0, 1, 60)
            pts.append(cl)
            ry = -head - np.pi / 2
            alpha = -np.arctan2(-y, x) + ry
            lines.append(f"{name} 0.00 0 {alpha:.4f} {box[0]} {box[1]} {box[2]} {box[3]} "
                         f"{dz:.2f} {dy:.2f} {dx:.2f} {-y:.2f} {-(z - dz / 2):.2f} {x:.2f} "
                         f"{ry:.4f}\n")
        np.concatenate(pts).astype(np.float32).tofile(velo)
        label = root / "training" / "label_2" / f"{sid}.txt"
        car, dontcare = label.read_text().splitlines(keepends=True)
        label.write_text(car + "".join(lines) + dontcare)
    return root, ids


def copy_root(base, dst):
    shutil.copytree(base, dst)
    return dst


def dataset_cfg(cfg_file, root):
    """The DATA_CONFIG of a repository config (e.g. kitti_dataset.yaml's own,
    or fast_cpc.yaml's, which replaces the augmentors and the processors)
    with DATA_PATH at `root`."""
    cfg = cfg_from_yaml_file(str(ROOT / cfg_file), EDict({"ROOT_DIR": ROOT}))
    data = cfg.DATA_CONFIG if "DATA_CONFIG" in cfg else cfg
    data.DATA_PATH = str(root)
    return data


def tiny_dataset_cfg(root, num_points=256, cfg_file="tools/cfgs/kitti_models/fast_cpc.yaml"):
    """fast_cpc.yaml's DATA_CONFIG (or fast_cpc_teacher.yaml's, the same
    processors) on the tiny model's range (tiny.PCR, VOXEL_SIZE tiny.VOXEL
    at FACTOR 4), NUM_POINTS `num_points` in both modes and MAX_GT_BOXES
    16."""
    data = dataset_cfg(cfg_file, root)
    data.POINT_CLOUD_RANGE = list(tiny.PCR)
    data.MAX_GT_BOXES = 16
    for p in data.DATA_PROCESSOR:
        if p.NAME == "sample_points":
            p.NUM_POINTS = {"train": num_points, "test": num_points}
        if p.NAME == "repository_info":
            p.VOXEL_SIZE = list(tiny.VOXEL)
    return data


def tiny_second_dataset_cfg(root):
    """second.yaml's DATA_CONFIG on the tiny SECOND's geometry
    (tiny.SECOND_META: its range, voxels of 0.5 x 0.5 x 0.1 m, 512 voxels in
    both modes, MAX_POINTS 512), gt sampling of its one class, MAX_GT_BOXES
    16."""
    meta = tiny.SECOND_META
    data = dataset_cfg("tools/cfgs/kitti_models/second.yaml", root)
    data.POINT_CLOUD_RANGE = list(meta.point_cloud_range)
    data.MAX_POINTS = meta.max_points
    data.MAX_GT_BOXES = 16
    data.DATA_AUGMENTOR.AUG_CONFIG_LIST[0].SAMPLE_GROUPS = ["Car:15"]
    for p in data.DATA_PROCESSOR:
        if p.NAME == "transform_points_to_voxels":
            p.VOXEL_SIZE = list(meta.voxel_size)
            p.MAX_NUMBER_OF_VOXELS = {"train": meta.max_voxels, "test": meta.max_voxels}
    return data


def _tiny_voxel_dataset_cfg(cfg_file, root, meta, groups):
    """`cfg_file`'s DATA_CONFIG on the geometry of `meta` (its range, voxel
    size, MAX_POINTS_PER_VOXEL and its voxels in both modes, MAX_POINTS),
    gt sampling of `groups`, MAX_GT_BOXES 16."""
    data = dataset_cfg(cfg_file, root)
    data.POINT_CLOUD_RANGE = list(meta.point_cloud_range)
    data.MAX_POINTS = meta.max_points
    data.MAX_GT_BOXES = 16
    data.DATA_AUGMENTOR.AUG_CONFIG_LIST[0].SAMPLE_GROUPS = list(groups)
    for p in data.DATA_PROCESSOR:
        if p.NAME == "transform_points_to_voxels":
            p.VOXEL_SIZE = list(meta.voxel_size)
            p.MAX_POINTS_PER_VOXEL = meta.max_points_per_voxel
            p.MAX_NUMBER_OF_VOXELS = {"train": meta.max_voxels, "test": meta.max_voxels}
    return data


def tiny_pointpillar_dataset_cfg(root):
    """pointpillar.yaml's DATA_CONFIG (gt sampling on road planes) on the tiny
    PointPillars' geometry (tiny.POINTPILLAR_META), gt sampling of its one
    class."""
    return _tiny_voxel_dataset_cfg("tools/cfgs/kitti_models/pointpillar.yaml", root,
                                   tiny.POINTPILLAR_META, ["Car:15"])


def tiny_centerpoint_dataset_cfg(root):
    """centerpoint.yaml's DATA_CONFIG on the tiny CenterPoint's geometry
    (tiny.CENTERPOINT_META), gt sampling of its three classes."""
    return _tiny_voxel_dataset_cfg("tools/cfgs/kitti_models/centerpoint.yaml", root,
                                   tiny.CENTERPOINT_META,
                                   ["Car:15", "Pedestrian:15", "Cyclist:15"])


def tiny_two_stage_dataset_cfg(which, root):
    """PartA2.yaml's ("parta2"), pvrcnn.yaml's ("pvrcnn"),
    pv_rcnn_plusplus.yaml's ("pvrcnnplusplus"), pointrcnn.yaml's
    ("pointrcnn"), voxel_rcnn_car.yaml's ("voxelrcnn") or second_iou.yaml's
    ("secondnetiou"), pvssda_3dssd.yaml's ("pvssda") or dsasnet.yaml's
    ("dsasnet", pvrcnn.yaml's) DATA_CONFIG (gt
    sampling on road planes) on the tiny detector's geometry
    (tiny.two_stage_model(which); pointrcnn.yaml's and pvssda_3dssd.yaml's
    sample_points takes its MAX_POINTS in both modes), gt sampling of its one
    class."""
    cfg_file = {"parta2": "PartA2.yaml", "pvrcnn": "pvrcnn.yaml",
                "pvrcnnplusplus": "pv_rcnn_plusplus.yaml",
                "pointrcnn": "pointrcnn.yaml", "voxelrcnn": "voxel_rcnn_car.yaml",
                "secondnetiou": "second_iou.yaml", "pvssda": "pvssda_3dssd.yaml",
                "dsasnet": "dsasnet.yaml"}[which]
    meta = tiny.two_stage_model(which)[1]
    data = _tiny_voxel_dataset_cfg(f"tools/cfgs/kitti_models/{cfg_file}", root, meta,
                                   ["Car:15"])
    for p in data.DATA_PROCESSOR:
        if which in ("pointrcnn", "pvssda") and p.NAME == "sample_points":
            p.NUM_POINTS = {"train": meta.max_points, "test": meta.max_points}
    return data


def write_tiny_yaml(path, root, batch=2, epochs=1, model=None, data=None, classes=CLASSES):
    """A config file of a tiny model (default the tiny TSM) on a dataset
    config (default `tiny_dataset_cfg(root)`), for the entry points."""
    model = tiny.tiny_model_cfg() if model is None else model
    doc = {"CLASS_NAMES": list(classes),
           "DATA_CONFIG": _plain(tiny_dataset_cfg(root) if data is None else data),
           "MODEL": _plain(model),
           "OPTIMIZATION": {"BATCH_SIZE_PER_GPU": batch, "NUM_EPOCHS": epochs,
                            "OPTIMIZER": "adam_onecycle", "LR": 0.01, "WEIGHT_DECAY": 0.01,
                            "MOMENTUM": 0.9, "MOMS": [0.95, 0.85], "PCT_START": 0.3,
                            "DIV_FACTOR": 10, "DECAY_STEP_LIST": [35, 45], "LR_DECAY": 0.1,
                            "LR_CLIP": 1e-7, "LR_WARMUP": False, "WARMUP_EPOCH": 1,
                            "GRAD_NORM_CLIP": 10}}
    path.write_text(yaml.safe_dump(doc))
    return path


def _plain(d):
    if isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_plain(v) for v in d]
    return d
