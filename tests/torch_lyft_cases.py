"""The synthetic Lyft root and dataset configs shared by the port's Lyft
tests (test_torch_lyft_data.py, test_torch_lyft_eval.py, test_torch_demo.py,
test_torch_dist_entry.py, test_torch_convert_ckpt.py).

`make_base` writes the port's synthetic root (datasets/lyft/synthetic.py) at
POINTS points a sweep under BASE/trainval, its scene splits under
BASE/ImageSets: 2 train scenes and 1 val scene of 3 key frames, each key
frame after nine sweeps. `jax_infos` and `port_infos` make each side's infos
(10 sweeps an info) and train gt database (10 sweeps) on its own copy of it
(`make_roots`), with numpy's global state seeded alike first: both packages
draw a cloud's sweeps from it.

`dataset_cfg` is the Lyft CenterPoint config's DATA_CONFIG (5 sweeps) at a
root; `tiny_dataset_cfg` puts the tiny Lyft CenterPoint on it: the full
+-80 m range in 1 x 1 x 0.2 m voxels of up to 32 points (a 160 x 160 x 40
grid), VOXELS voxels and MAX_POINTS points a scan, 96 gt slots.
"""
import shutil

import numpy as np
import yaml

from tests.torch_kitti_cases import _plain
from tsm_det_pointcloud_tpu.datasets.lyft.lyft_dataset import (
    LyftDataset as JLyftDataset,
    create_lyft_info as jcreate_lyft_info,
)
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.datasets.lyft.lyft_dataset import create_lyft_infos
from tsm_det_pointcloud_tpu_torch.datasets.lyft.synthetic import write_synthetic_lyft
from tsm_det_pointcloud_tpu_torch.infer import ROOT, load_cfg

LYFT_CFG = ROOT / "tools/cfgs/lyft_models/centerpoint_voxel01_res3d.yaml"
CLASSES = list(tiny.LYFT_CLASSES)
POINTS, VOXELS, MAX_POINTS = 150, 2048, 3072


def make_base(path):
    """The synthetic root under path/trainval; returns path."""
    write_synthetic_lyft(path / "trainval", n_train=2, n_val=1, n_samples=3, n_points=POINTS,
                         seed=0)
    return path


def dataset_cfg(root):
    """The Lyft CenterPoint config's DATA_CONFIG with DATA_PATH at `root`."""
    data = load_cfg(LYFT_CFG).DATA_CONFIG
    data.DATA_PATH = str(root)
    return data


def tiny_dataset_cfg(root):
    """`dataset_cfg` on the tiny Lyft CenterPoint's geometry (see the module
    docstring)."""
    data = dataset_cfg(root)
    data.MAX_POINTS = MAX_POINTS
    data.MAX_GT_BOXES = 96
    for p in data.DATA_PROCESSOR:
        if p.NAME == "transform_points_to_voxels":
            p.VOXEL_SIZE = [1.0, 1.0, 0.2]
            p.MAX_POINTS_PER_VOXEL = 32
            p.MAX_NUMBER_OF_VOXELS = {"train": VOXELS, "test": VOXELS}
    return data


def jax_infos(root):
    """The JAX package's infos and train-split gt database."""
    np.random.seed(0)
    jcreate_lyft_info("trainval", root, root)
    data = dataset_cfg(root)
    data.INFO_PATH = {"train": ["lyft_infos_train.pkl"]}
    JLyftDataset(data, CLASSES, training=True).create_groundtruth_database()
    return root


def port_infos(root):
    """The port's (`create_lyft_infos`, the `__main__` of its dataset)."""
    np.random.seed(0)
    create_lyft_infos(dataset_cfg(root), CLASSES, root)
    return root


def write_tiny_yaml(path, root, batch=2, epochs=1):
    """A config file of the tiny Lyft CenterPoint on `tiny_dataset_cfg`, with
    the Lyft config's optimizer, for the entry points."""
    cfg = load_cfg(LYFT_CFG)
    opt = _plain(cfg.OPTIMIZATION)
    opt.update(BATCH_SIZE_PER_GPU=batch, NUM_EPOCHS=epochs)
    doc = {"CLASS_NAMES": CLASSES, "DATA_CONFIG": _plain(tiny_dataset_cfg(root)),
           "MODEL": _plain(tiny.centerpoint_lyft_model_cfg()), "OPTIMIZATION": opt}
    path.write_text(yaml.safe_dump(doc))
    return path


def make_roots(tmp_path_factory):
    """(the JAX side's root, the port's): copies of one synthetic root, each
    with its side's infos and gt database."""
    base = tmp_path_factory.mktemp("lyft")
    make_base(base / "base")
    shutil.copytree(base / "base", base / "jax")
    shutil.copytree(base / "base", base / "port")
    return jax_infos(base / "jax" / "trainval"), port_infos(base / "port" / "trainval")
