"""The port's shared-memory cache (datasets/shared_memory.py) against the
JAX package's, each pointed at its own directory under the test's tmp_path
(the port's through TSM_SHM_DIR): the same files for the same keys, the
first publish kept, private copies and read-only maps, deletes, and the
quiet return to plain loading when the directory is missing (the gt
sampler's route; tests/test_torch_kitti_data.py and
tests/test_torch_waymo_data.py hold the loaders' batches)."""
import pickle

import numpy as np
import pytest

from tsm_det_pointcloud_tpu.datasets import shared_memory as jshm
from tsm_det_pointcloud_tpu.datasets.augmentor.database_sampler import (
    DataBaseSampler as JDataBaseSampler,
)
from tsm_det_pointcloud_tpu_torch.datasets import shared_memory as shm
from tsm_det_pointcloud_tpu_torch.datasets.augmentor.database_sampler import DataBaseSampler
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.setenv("TSM_SHM_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jshm, "SHM_ROOT", tmp_path / "jax")
    return tmp_path / "port", tmp_path / "jax"


@pytest.mark.parametrize("key", ["k1", "segment-0/with:odd chars", "a.b_c-d"])
def test_create_attach_delete_equal_jax(dirs, key):
    arr = np.arange(24, dtype=np.float32).reshape(6, 4)
    for mod, d in zip((shm, jshm), dirs):
        assert mod.available() and not mod.sa_exists(key)
        mod.sa_create(key, arr)
        mod.sa_create(key, arr * 2)          # the first publish stays
        got = mod.sa_attach(key)
        got[0, 0] = 99                       # a private copy
        np.testing.assert_array_equal(mod.sa_attach(key), arr)
        assert not mod.sa_attach(key, copy=False).flags.writeable
    assert [p.name for p in dirs[0].iterdir()] == [p.name for p in dirs[1].iterdir()]
    assert (dirs[0] / next(dirs[0].iterdir()).name).read_bytes() == \
        (dirs[1] / next(dirs[1].iterdir()).name).read_bytes()
    for mod, d in zip((shm, jshm), dirs):
        mod.sa_delete(key)
        mod.sa_delete(key)                   # a missing key is fine
        assert not list(d.iterdir())


def test_sampler_without_shared_memory_reads_files_like_jax(tmp_path, monkeypatch):
    """Where the shared-memory directory is missing both samplers turn the
    route off and paste from the per-object files."""
    monkeypatch.setenv("TSM_SHM_DIR", str(tmp_path / "missing"))
    monkeypatch.setattr(jshm, "SHM_ROOT", tmp_path / "missing")
    rng = np.random.RandomState(0)
    db = rng.randn(80, 4).astype(np.float32) * 0.2
    np.save(tmp_path / "global.npy", db)
    (tmp_path / "gt").mkdir()
    infos = {"Car": []}
    for i, (start, end, x) in enumerate(((0, 30, 5.0), (30, 80, 12.0))):
        db[start:end].tofile(tmp_path / "gt" / f"{i}.bin")
        infos["Car"].append({
            "name": "Car", "path": f"gt/{i}.bin", "global_data_offset": (start, end),
            "box3d_lidar": np.array([x, 0, -1, 3.9, 1.6, 1.56, 0.0], np.float32),
            "num_points_in_gt": end - start, "difficulty": 0})
    with open(tmp_path / "dbinfos.pkl", "wb") as f:
        pickle.dump(infos, f)
    cfg = EDict({"DB_INFO_PATH": ["dbinfos.pkl"], "DB_DATA_PATH": ["global.npy"],
                 "USE_SHARED_MEMORY": True, "SAMPLE_GROUPS": ["Car:2"],
                 "NUM_POINT_FEATURES": 4, "LIMIT_WHOLE_SCENE": False})
    data = {"gt_boxes": np.zeros((0, 7), np.float32), "gt_names": np.zeros(0, object),
            "points": rng.randn(100, 4).astype(np.float32) + np.array([30, 0, 0, 0], np.float32)}
    outs = []
    for cls in (JDataBaseSampler, DataBaseSampler):
        sampler = cls(root_path=tmp_path, sampler_cfg=cfg, class_names=["Car"])
        assert not sampler.use_shared_memory
        outs.append(sampler(dict(data), np.random.default_rng(0)))
    for k in ("points", "gt_boxes", "gt_names"):
        np.testing.assert_array_equal(outs[1][k], outs[0][k])
    assert len(outs[1]["gt_boxes"]) == 2 and len(outs[1]["points"]) == 180
