"""The synthetic Waymo root and dataset configs shared by the port's Waymo
tests (test_torch_waymo_preprocess.py, test_torch_waymo_data.py,
test_torch_waymo_eval_loop.py).

`make_root` writes raw tfrecords with the port's
`datasets.waymo.synthetic` (two train sequences and one val sequence of two
frames, ~195k points a frame, the labelled objects 3-7.5 m from the ego so
that the tiny configs' +-8 m range holds some); `preprocessed_roots` runs
the JAX package's and the port's `create_waymo_infos` on copies of it.
"""
import shutil

from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.config import cfg_from_yaml_file
from tsm_det_pointcloud_tpu_torch.datasets.waymo.synthetic import write_synthetic_waymo
from tsm_det_pointcloud_tpu_torch.infer import ROOT
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict

CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]
WAYMO_CPC = "tools/cfgs/waymo_models/waymo_fast_cpc.yaml"
WAYMO_BASE = "tools/cfgs/dataset_configs/waymo_dataset.yaml"
N_TRAIN, N_VAL, N_FRAMES = 2, 1, 2


def make_root(path):
    write_synthetic_waymo(path, N_TRAIN, N_VAL, N_FRAMES, seed=3, radius=(3.0, 7.5))
    return path


def dataset_cfg(cfg_file, root, interval=1):
    """The DATA_CONFIG of a repository config with DATA_PATH at `root` and
    SAMPLED_INTERVAL `interval` in both modes (the test root has four train
    frames; the config's own train interval of 5 keeps one)."""
    cfg = cfg_from_yaml_file(str(ROOT / cfg_file), EDict({"ROOT_DIR": ROOT}))
    data = cfg.DATA_CONFIG if "DATA_CONFIG" in cfg else cfg
    data.DATA_PATH = str(root)
    if interval is not None:
        data.SAMPLED_INTERVAL = {"train": interval, "test": interval}
    return data


def jax_dataset_cfg(cfg_file, root, interval=1):
    """dataset_cfg as the JAX package's config loader reads it."""
    from tsm_det_pointcloud_tpu.config import cfg_from_yaml_file as jcfg_from_yaml_file
    from tsm_det_pointcloud_tpu.utils.edict import EDict as JEDict

    cfg = jcfg_from_yaml_file(str(ROOT / cfg_file), JEDict({"ROOT_DIR": ROOT}))
    data = cfg.DATA_CONFIG if "DATA_CONFIG" in cfg else cfg
    data.DATA_PATH = str(root)
    if interval is not None:
        data.SAMPLED_INTERVAL = {"train": interval, "test": interval}
    return data


def create_infos(create, cfg, root, workers=1):
    create(cfg, CLASSES, root, root, processed_data_tag=cfg.PROCESSED_DATA_TAG,
           workers=workers)


def preprocessed_roots(base):
    """(JAX root, port root): copies of one raw root, each preprocessed by
    its own package's `create_waymo_infos` (the port's with 2 workers)."""
    from tsm_det_pointcloud_tpu.datasets.waymo.waymo_dataset import (
        create_waymo_infos as jcreate_waymo_infos,
    )
    from tsm_det_pointcloud_tpu_torch.datasets import stop_workers
    from tsm_det_pointcloud_tpu_torch.datasets.waymo.waymo_dataset import create_waymo_infos

    make_root(base / "raw")
    jroot = shutil.copytree(base / "raw", base / "jax")
    proot = shutil.copytree(base / "raw", base / "port")
    create_infos(jcreate_waymo_infos, jax_dataset_cfg(WAYMO_BASE, jroot), jroot)
    create_infos(create_waymo_infos, dataset_cfg(WAYMO_BASE, proot), proot, workers=2)
    stop_workers()
    return jroot, proot


def tiny_dataset_cfg(root, num_points=tiny.WAYMO_POINTS, jax=False):
    """waymo_fast_cpc.yaml's DATA_CONFIG on the tiny Waymo-flavoured model's
    range (tiny.WAYMO_PCR, VOXEL_SIZE tiny.VOXEL at FACTOR 4), NUM_POINTS
    `num_points` in both modes and MAX_GT_BOXES 16."""
    data = (jax_dataset_cfg if jax else dataset_cfg)(WAYMO_CPC, root)
    data.POINT_CLOUD_RANGE = list(tiny.WAYMO_PCR)
    data.MAX_GT_BOXES = 16
    for p in data.DATA_PROCESSOR:
        if p.NAME == "sample_points":
            p.NUM_POINTS = {"train": num_points, "test": num_points}
        if p.NAME == "repository_info":
            p.VOXEL_SIZE = list(tiny.VOXEL)
    return data
