"""The synthetic nuScenes root and dataset configs shared by the port's
nuScenes tests (test_torch_nuscenes_data.py, the nuScenes cases of
test_torch_eval_loop_centerpoint.py, test_torch_demo.py,
test_torch_dist_entry.py).

`make_root` writes the port's synthetic root (datasets/nuscenes/synthetic.py)
at POINTS points a sweep: 2 train scenes and 1 val scene of 3 keyframes,
each keyframe after nine sweeps. `jax_infos` and `port_infos` make each
side's 10-sweep infos and train gt database on its own copy of it
(`copy_root`).

`dataset_cfg` is cbgs_voxel01_res3d_centerpoint.yaml's DATA_CONFIG at a
root; `tiny_dataset_cfg` puts the tiny nuScenes CenterPoint on it: the full
range in 0.8 x 0.8 x 0.2 m voxels of up to 32 points (a 128 x 128 x 40
grid), VOXELS voxels and MAX_POINTS points a scan, 16 gt slots. No voxel of
the synthetic scans reaches 32 points, nor a scan MAX_POINTS points or
VOXELS voxels, so the voxels' means do not depend on the order of the
points, which the two packages' sweep draws change (see
datasets/nuscenes/nuscenes_dataset.py of the port).
"""
import shutil

import yaml

from tests.torch_kitti_cases import _plain
from tsm_det_pointcloud_tpu.datasets.nuscenes.nuscenes_dataset import (
    NuScenesDataset as JNuScenesDataset,
    create_nuscenes_info as jcreate_nuscenes_info,
)
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.datasets.nuscenes.nuscenes_dataset import (
    create_nuscenes_infos,
)
from tsm_det_pointcloud_tpu_torch.datasets.nuscenes.synthetic import write_synthetic_nuscenes
from tsm_det_pointcloud_tpu_torch.infer import ROOT, load_cfg

NUSC_CFG = ROOT / "tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml"
VERSION = "v1.0-trainval"
CLASSES = list(tiny.CENTERPOINT_NUSC_META.class_names)
ALL_CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
               "motorcycle", "bicycle", "pedestrian", "traffic_cone"]
POINTS, VOXELS, MAX_POINTS = 150, 2048, 3072


def make_root(path):
    write_synthetic_nuscenes(path, n_train=2, n_val=1, n_samples=3, n_points=POINTS, seed=0)
    return path


def copy_root(base, dst):
    shutil.copytree(base, dst)
    return dst


def dataset_cfg(root):
    """cbgs_voxel01_res3d_centerpoint.yaml's DATA_CONFIG with DATA_PATH at
    `root`."""
    data = load_cfg(NUSC_CFG).DATA_CONFIG
    data.DATA_PATH = str(root)
    return data


def tiny_dataset_cfg(root):
    """`dataset_cfg` on the tiny nuScenes CenterPoint's geometry (see the
    module docstring)."""
    data = dataset_cfg(root)
    data.MAX_POINTS = MAX_POINTS
    data.MAX_GT_BOXES = 16
    for p in data.DATA_PROCESSOR:
        if p.NAME == "transform_points_to_voxels":
            p.VOXEL_SIZE = [0.8, 0.8, 0.2]
            p.MAX_POINTS_PER_VOXEL = 32
            p.MAX_NUMBER_OF_VOXELS = {"train": VOXELS, "test": VOXELS}
    return data


def jax_infos(root):
    """The JAX package's 10-sweep infos and train-split gt database."""
    jcreate_nuscenes_info(VERSION, root, root, max_sweeps=10)
    data = dataset_cfg(root)
    data.BALANCED_RESAMPLING = False
    JNuScenesDataset(data, ALL_CLASSES, training=True).create_groundtruth_database(
        max_sweeps=10)
    return root


def port_infos(root):
    """The port's (`create_nuscenes_infos`, the `__main__` of its dataset)."""
    create_nuscenes_infos(dataset_cfg(root), ALL_CLASSES, root)
    return root


def write_tiny_yaml(path, root, batch=2, epochs=1):
    """A config file of the tiny nuScenes CenterPoint on `tiny_dataset_cfg`,
    with the nuScenes config's optimizer, for the entry points."""
    cfg = load_cfg(NUSC_CFG)
    opt = _plain(cfg.OPTIMIZATION)
    opt.update(BATCH_SIZE_PER_GPU=batch, NUM_EPOCHS=epochs)
    doc = {"CLASS_NAMES": CLASSES, "DATA_CONFIG": _plain(tiny_dataset_cfg(root)),
           "MODEL": _plain(tiny.centerpoint_nusc_model_cfg()), "OPTIMIZATION": opt}
    path.write_text(yaml.safe_dump(doc))
    return path


def make_roots(tmp_path_factory):
    """(the JAX side's root, the port's): copies of one synthetic root, each
    with its side's infos and gt database."""
    base = tmp_path_factory.mktemp("nusc")
    make_root(base / "base")
    return (jax_infos(copy_root(base / "base", base / "jax")),
            port_infos(copy_root(base / "base", base / "port")))
