"""The port's KITTI data path against the JAX package on copies of one
synthetic KITTI root (torch_kitti_cases.make_root: tests/test_kitti_pipeline.py's
`make_kitti_root` with a Pedestrian and a Cyclist added to each frame).
Every comparison is exact: both sides run the same numpy on the same files
from the same (seed, epoch, index) generators.

  * `create_kitti_infos`: the info pickles, `kitti_dbinfos_train.pkl` and
    every gt-database .bin file;
  * `__getitem__` in training (every augmentor of kitti_dataset.yaml,
    random_local_pyramid_aug included, and of fast_cpc.yaml,
    fast_cpc_teacher.yaml and second.yaml) and test mode, and
    `collate_batch`;
  * second.yaml's collate, which keeps a scan's first MAX_POINTS (20000)
    points: on scans of datasets/kitti/synthetic.py (~25k points in the
    field of view) both packages drop the same tail (ROADMAP §C);
  * gt sampling's USE_SHARED_MEMORY route (one global npy of the gt
    database's points in a directory under the test's tmp_path,
    TSM_SHM_DIR): the loader's batches equal with it on and off, for 0 and
    2 workers, and to the JAX package's with it on; nothing is left after
    `clean_shared_memory`;
  * the loader: its batches equal the JAX loader's for workers 0 and 2,
    its rank shards are disjoint and cover the split, and a program that
    ran it with workers leaves no process behind;
  * the DatasetMeta a dataset gives the model builder, for fast_cpc.yaml,
    fast_cpc_teacher.yaml and second.yaml.
"""
import json
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_kitti_cases import CLASSES, copy_root, dataset_cfg, make_root
from tsm_det_pointcloud_tpu.datasets import DataLoader as JDataLoader, _seed_for_sample
from tsm_det_pointcloud_tpu.datasets.kitti.kitti_dataset import (
    KittiDataset as JKittiDataset,
    create_kitti_infos as jcreate_kitti_infos,
)
from tsm_det_pointcloud_tpu.models import _meta_from_dataset as jmeta_from_dataset
from tsm_det_pointcloud_tpu_torch.datasets import (DataLoader, build_dataloader,
                                                   seed_for_sample, stop_workers)
from tsm_det_pointcloud_tpu_torch.datasets.kitti.calibration_kitti import Calibration
from tsm_det_pointcloud_tpu_torch.datasets.kitti.synthetic import write_synthetic_kitti
from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import (
    KittiDataset,
    create_kitti_infos,
)
from tsm_det_pointcloud_tpu_torch.infer import ROOT
from tsm_det_pointcloud_tpu_torch.models import meta_from_dataset

BASE_CFG = "tools/cfgs/dataset_configs/kitti_dataset.yaml"
FAST_CPC = "tools/cfgs/kitti_models/fast_cpc.yaml"
TEACHER = "tools/cfgs/kitti_models/fast_cpc_teacher.yaml"
SECOND = "tools/cfgs/kitti_models/second.yaml"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("kitti")
    make_root(base / "base")
    jroot = copy_root(base / "base", base / "jax")
    proot = copy_root(base / "base", base / "port")
    jcreate_kitti_infos(dataset_cfg(BASE_CFG, jroot), CLASSES, jroot, jroot, workers=1)
    create_kitti_infos(dataset_cfg(BASE_CFG, proot), CLASSES, proot, proot, workers=1)
    return jroot, proot


def assert_same(got, want, where=""):
    """Recursive equality of pickled infos / samples / batches: arrays equal
    in dtype and value, calibrations equal matrix for matrix."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif type(want).__name__ == "Calibration":
        assert isinstance(got, Calibration), where
        for attr in ("P2", "R0", "V2C"):
            np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    else:
        assert got == want, where


@pytest.mark.parametrize("name", ["kitti_infos_train.pkl", "kitti_infos_val.pkl",
                                  "kitti_infos_trainval.pkl", "kitti_infos_test.pkl",
                                  "kitti_dbinfos_train.pkl"])
def test_infos_equal_jax(roots, name):
    jroot, proot = roots
    with open(jroot / name, "rb") as f:
        want = pickle.load(f)
    with open(proot / name, "rb") as f:
        got = pickle.load(f)
    assert_same(got, want, name)


def test_gt_database_files_equal_jax(roots):
    jroot, proot = roots
    want = sorted(p.name for p in (jroot / "gt_database").iterdir())
    got = sorted(p.name for p in (proot / "gt_database").iterdir())
    assert got == want and len(want) == 18   # 6 frames x (Car, Pedestrian, Cyclist)
    for name in want:
        assert (proot / "gt_database" / name).read_bytes() == \
            (jroot / "gt_database" / name).read_bytes(), name


def _datasets(roots, cfg_file, training, edit=None):
    jroot, proot = roots
    jcfg, pcfg = dataset_cfg(cfg_file, jroot), dataset_cfg(cfg_file, proot)
    if edit is not None:
        edit(jcfg)
        edit(pcfg)
    jds = JKittiDataset(jcfg, CLASSES, training=training, root_path=jroot)
    pds = KittiDataset(pcfg, CLASSES, training=training, root_path=proot)
    return jds, pds


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("cfg_file", [BASE_CFG, FAST_CPC, TEACHER, SECOND],
                         ids=["kitti_dataset", "fast_cpc", "teacher", "second"])
def test_getitem_and_collate_equal_jax(roots, cfg_file, training):
    jds, pds = _datasets(roots, cfg_file, training)
    if training:
        names = [c.NAME for c in pds.dataset_cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST]
        assert len(pds.data_augmentor.data_augmentor_queue) == len(names)
    jsamples, psamples = [], []
    for epoch in (0, 3):
        for i in range(len(jds)):
            _seed_for_sample(jds, 7, epoch, i)
            seed_for_sample(pds, 7, epoch, i)
            jsamples.append(jds[i])
            psamples.append(pds[i])
            assert_same(psamples[-1], jsamples[-1], f"sample {i} epoch {epoch}")
    assert_same(pds.collate_batch(psamples[:4]), jds.collate_batch(jsamples[:4]), "batch")


def test_second_collate_drops_the_scan_tail_like_jax(tmp_path):
    """second.yaml collates a scan's first MAX_POINTS points and the model
    voxelizes those alone, where the reference's data processor voxelizes
    every point of the scan: in test mode (no shuffle) the scan's tail is
    dropped, in both packages alike."""
    write_synthetic_kitti(tmp_path, 1, 2, 120000)
    create_kitti_infos(dataset_cfg(SECOND, tmp_path), CLASSES, tmp_path, tmp_path, workers=1)
    jds = JKittiDataset(dataset_cfg(SECOND, tmp_path), CLASSES, training=False,
                        root_path=tmp_path)
    pds = KittiDataset(dataset_cfg(SECOND, tmp_path), CLASSES, training=False,
                       root_path=tmp_path)
    samples = [pds[i] for i in range(2)]
    assert_same(samples, [jds[i] for i in range(2)])
    batch = pds.collate_batch(samples)
    assert_same(batch, jds.collate_batch([jds[i] for i in range(2)]))
    assert pds.max_points == 20000 and batch["points_mask"].sum() == 2 * 20000
    for b, sample in enumerate(samples):
        assert len(sample["points"]) > 24000          # ~5k points dropped a scan
        np.testing.assert_array_equal(batch["points"][b], sample["points"][:20000])


def _global_gt_database(root):
    """The gt database as the JAX sampler's USE_SHARED_MEMORY route reads it:
    every object's points in one array (kitti_gt_database_global.npy) and
    the db infos with each object's rows, global_data_offset [start, end)
    (kitti_dbinfos_train_global.pkl)."""
    with open(root / "kitti_dbinfos_train.pkl", "rb") as f:
        infos = pickle.load(f)
    chunks, start = [], 0
    for cls_infos in infos.values():
        for info in cls_infos:
            pts = np.fromfile(root / info["path"], np.float32).reshape(-1, 4)
            info["global_data_offset"] = (start, start + len(pts))
            start += len(pts)
            chunks.append(pts)
    np.save(root / "kitti_gt_database_global.npy", np.concatenate(chunks))
    with open(root / "kitti_dbinfos_train_global.pkl", "wb") as f:
        pickle.dump(infos, f)


def _global_sampler(cfg, use_shared_memory):
    """fast_cpc.yaml's gt sampling on the global gt database."""
    sampler = cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[0]
    sampler.DB_INFO_PATH = ["kitti_dbinfos_train_global.pkl"]
    sampler.DB_DATA_PATH = ["kitti_gt_database_global.npy"]
    sampler.USE_SHARED_MEMORY = use_shared_memory


@pytest.mark.parametrize("workers", [0, 2])
def test_gt_sampling_shared_memory_batches_equal_jax(roots, workers, tmp_path, monkeypatch):
    from tsm_det_pointcloud_tpu.datasets import shared_memory as jshm

    for root in roots:
        if not (root / "kitti_gt_database_global.npy").exists():
            _global_gt_database(root)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    monkeypatch.setenv("TSM_SHM_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jshm, "SHM_ROOT", tmp_path / "jax")
    stop_workers()   # the loader's workers fork from a server that reads TSM_SHM_DIR
    passes = {}
    try:
        for side, on in (("jax", True), ("port", True), ("port", False)):
            jds, pds = _datasets(roots, FAST_CPC, True, edit=lambda cfg: _global_sampler(cfg, on))
            ds = jds if side == "jax" else pds
            assert ds.data_augmentor.data_augmentor_queue[0].use_shared_memory == on
            loader = (JDataLoader(jds, 2, shuffle=True, drop_last=True, seed=5, prefetch=0)
                      if side == "jax" else
                      DataLoader(pds, 2, shuffle=True, drop_last=True, seed=5, workers=workers))
            passes[side, on] = _batches(loader, 1)
            if side == "port":
                loader.close()
            if side == "port" and on:
                assert [p.name for p in (tmp_path / "port").iterdir()] == [
                    "kitti_gt_database_global.npy.npy"]
                pds.clean_shared_memory()
        assert not list((tmp_path / "port").iterdir())
    finally:
        stop_workers()
    assert len(passes["port", True]) == 3
    assert sum(int(b["gt_boxes_mask"].sum()) for b in passes["jax", True]) > 12  # pasted
    for got, off, want in zip(passes["port", True], passes["port", False], passes["jax", True]):
        assert_same(got, want)
        assert_same(off, want)


def test_gt_sampling_draw_is_per_sample(roots):
    """A sample's gt sampling depends on its generator alone. With a pool
    over twice a group's draw (six cars, one drawn) the JAX sampler walks
    one permutation across the samples a process loads, so a sample loaded
    after another differs from the same sample loaded first; the port's
    does not (the loader's workers each load a different history)."""
    def sample(ds, seed_fn, history):
        for i in history + [1]:
            seed_fn(ds, 0, 0, i)
            out = ds[i]
        return out

    results = {}
    for side, (ds_cls, seed_fn, root) in {
            "jax": (JKittiDataset, _seed_for_sample, roots[0]),
            "port": (KittiDataset, seed_for_sample, roots[1])}.items():
        outs = []
        for history in ([], [0, 2]):
            cfg = dataset_cfg(FAST_CPC, root)
            cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[0].SAMPLE_GROUPS = ["Car:1"]
            outs.append(sample(ds_cls(cfg, CLASSES, training=True, root_path=root),
                               seed_fn, history))
        results[side] = outs
    assert_same(results["port"][1], results["port"][0], "port")
    assert_same(results["port"][0], results["jax"][0], "first load")
    assert not np.array_equal(results["jax"][1]["points"], results["jax"][0]["points"])


def _batches(loader, epoch):
    loader.set_epoch(epoch)
    return list(loader)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_jax(roots, workers):
    jds, pds = _datasets(roots, FAST_CPC, True)
    want = _batches(JDataLoader(jds, 2, shuffle=True, drop_last=True, seed=5, prefetch=0), 1)
    loader = DataLoader(pds, 2, shuffle=True, drop_last=True, seed=5, workers=workers)
    got = _batches(loader, 1)
    assert len(got) == len(want) == len(loader) == 3
    for g, w in zip(got, want):
        assert_same(g, w)
    assert isinstance(got[0]["points"], torch.Tensor)
    assert isinstance(got[0]["frame_id"], list)


# loads one pass with 2 workers, prints its descendants' pids, and exits
_ONE_PASS = """
import json, os, sys
from tsm_det_pointcloud_tpu_torch.config import cfg_from_yaml_file
from tsm_det_pointcloud_tpu_torch.datasets import build_dataloader
from tsm_det_pointcloud_tpu_torch.infer import ROOT
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict

cfg = cfg_from_yaml_file(str(ROOT / sys.argv[1]), EDict({"ROOT_DIR": ROOT}))
cfg.DATA_CONFIG.DATA_PATH = sys.argv[2]
_, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, workers=2,
                                training=False)
assert len(list(loader)) == 3
parents = {}
for p in filter(str.isdigit, os.listdir("/proc")):
    try:
        with open(f"/proc/{p}/stat") as f:
            parents.setdefault(int(f.read().rsplit(")", 1)[1].split()[1]), []).append(int(p))
    except OSError:
        pass
found, todo = [], [os.getpid()]
while todo:
    kids = parents.get(todo.pop(), [])
    found += kids
    todo += kids
print(json.dumps(found))
"""


def test_loader_leaves_no_process_at_exit(roots):
    """A program that ran a loader with workers stops its workers, the fork
    server and the resource tracker before it exits."""
    proc = subprocess.run([sys.executable, "-c", _ONE_PASS, FAST_CPC, str(roots[1])],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    started = json.loads(proc.stdout.splitlines()[-1])
    assert len(started) >= 3, started   # the fork server and its 2 workers at least
    running = []
    for pid in started:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    running.append(pid)
        except OSError:
            pass
    assert not running, f"still running after the program exited: {running}"


def test_loader_shards_are_disjoint(roots):
    _, proot = roots
    frames = []
    for shard in range(2):
        _, loader, sampler = build_dataloader(dataset_cfg(FAST_CPC, proot), CLASSES, 2,
                                              workers=0, seed=3, training=False,
                                              num_shards=2, shard_id=shard)
        assert len(loader) == 2     # 3 frames a shard: batches of 2 and 1
        frames.append([f for b in _batches(loader, 0) for f in b["frame_id"]])
    assert not set(frames[0]) & set(frames[1])
    assert sorted(frames[0] + frames[1]) == [f"{i:06d}" for i in range(6)]


def test_other_datasets_raise(roots):
    cfg = dataset_cfg(FAST_CPC, roots[1])
    cfg.DATASET = "NuScenesDataset"
    with pytest.raises(NotImplementedError, match="NuScenesDataset"):
        build_dataloader(cfg, CLASSES, 2, workers=0)


@pytest.mark.parametrize("cfg_file", [FAST_CPC, TEACHER, SECOND])
@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_meta_from_dataset_equals_jax(roots, cfg_file, training):
    jds, pds = _datasets(roots, cfg_file, training)
    assert meta_from_dataset(pds).__dict__ == jmeta_from_dataset(jds).__dict__
