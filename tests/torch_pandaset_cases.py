"""The synthetic PandaSet root and dataset configs shared by the port's
PandaSet tests (test_torch_pandaset_data.py, test_torch_dist_entry.py).

`make_base` writes the port's synthetic root (datasets/pandaset/synthetic.py)
at POINTS Pandar64 points a frame: sequences 001 (train) and 002 (val) of
FRAMES frames; `make_roots` copies it once a side and makes each side's
infos and train gt database (`create_pandaset_infos`) on its copy.

`dataset_cfg` is the PandaSet CenterPoint config's DATA_CONFIG with those
two sequences; `tiny_dataset_cfg` puts the tiny CenterPoint on it: the
config's range in 0.88 x 1 x 0.1 m voxels of up to 32 points (a 160 x 80 x
40 grid), VOXELS voxels and MAX_POINTS points a scan.
"""
import shutil

import yaml

from tests.torch_kitti_cases import _plain
from tsm_det_pointcloud_tpu.datasets.pandaset.pandaset_dataset import (
    create_pandaset_infos as jcreate_pandaset_infos,
)
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.datasets.pandaset.pandaset_dataset import (
    create_pandaset_infos,
)
from tsm_det_pointcloud_tpu_torch.datasets.pandaset.synthetic import write_synthetic_pandaset
from tsm_det_pointcloud_tpu_torch.infer import ROOT, load_cfg

PANDASET_CFG = ROOT / "tools/cfgs/pandaset_models/centerpoint.yaml"
CLASSES = ["Car", "Pedestrian", "Cyclist"]
POINTS, FRAMES, VOXELS, MAX_POINTS = 1200, 3, 2048, 3072


def make_base(path):
    write_synthetic_pandaset(path, ("001", "002"), FRAMES, POINTS, seed=0)
    return path


def dataset_cfg(root):
    """The PandaSet CenterPoint config's DATA_CONFIG at `root`, sequence 001
    for training and 002 for eval."""
    data = load_cfg(PANDASET_CFG).DATA_CONFIG
    data.DATA_PATH = str(root)
    data.SEQUENCES = {"train": ["001"], "val": ["002"]}
    return data


def tiny_dataset_cfg(root):
    """`dataset_cfg` on the tiny CenterPoint's geometry (see the module
    docstring)."""
    data = dataset_cfg(root)
    data.MAX_POINTS = MAX_POINTS
    for p in data.DATA_PROCESSOR:
        if p.NAME == "transform_points_to_voxels":
            p.VOXEL_SIZE = [0.88, 1.0, 0.1]
            p.MAX_POINTS_PER_VOXEL = 32
            p.MAX_NUMBER_OF_VOXELS = {"train": VOXELS, "test": VOXELS}
    return data


def write_tiny_yaml(path, root, batch=2, epochs=1):
    """A config file of the tiny CenterPoint on `tiny_dataset_cfg`, with the
    PandaSet config's optimizer, for the entry points."""
    cfg = load_cfg(PANDASET_CFG)
    opt = _plain(cfg.OPTIMIZATION)
    opt.update(BATCH_SIZE_PER_GPU=batch, NUM_EPOCHS=epochs)
    doc = {"CLASS_NAMES": CLASSES, "DATA_CONFIG": _plain(tiny_dataset_cfg(root)),
           "MODEL": _plain(tiny.centerpoint_model_cfg()), "OPTIMIZATION": opt}
    path.write_text(yaml.safe_dump(doc))
    return path


def make_roots(tmp_path_factory):
    """(the JAX side's root, the port's): copies of one synthetic root, each
    with its side's infos and gt database."""
    base = tmp_path_factory.mktemp("pandaset")
    make_base(base / "base")
    jroot = shutil.copytree(base / "base", base / "jax")
    proot = shutil.copytree(base / "base", base / "port")
    jcreate_pandaset_infos(dataset_cfg(jroot), CLASSES, jroot, jroot)
    create_pandaset_infos(dataset_cfg(proot), CLASSES, proot, proot)
    return jroot, proot
