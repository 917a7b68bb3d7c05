"""The port's Waymo dataset (datasets/waymo/waymo_dataset.py) against the JAX
package's, on copies of one synthetic Waymo root preprocessed by each
package (torch_waymo_cases). Every comparison is exact: both sides run the
same numpy on the same files from the same (seed, epoch, index) generators.

  * `__getitem__` for waymo_fast_cpc.yaml in training (its augmentors) and
    test mode, array for array, and `collate_batch`;
  * the no-label-zone flag both ways, `SAMPLED_INTERVAL` (the config's
    train 5 / test 1), the sweeps of `SEQUENCE_CONFIG`;
  * `meta_from_dataset`; the loader's batches with 0 and 2 workers;
  * `USE_SHARED_MEMORY` raising; prediction dicts and `evaluation` (Car
    read as Vehicle; any EVAL_METRIC but waymo raises);
  * gt sampling as waymo_fast_cpc.yaml configures it (kitti_dbinfos_train.pkl,
    4 point features): a no-op on a Waymo root, which has no such file; and
    with a 4-feature KITTI database present, both packages raise when they
    paste 4-column objects into 5-column Waymo points.
"""
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_waymo_preprocess import assert_same
from tests.torch_waymo_cases import (CLASSES, WAYMO_CPC, dataset_cfg, jax_dataset_cfg,
                                     preprocessed_roots)
from tsm_det_pointcloud_tpu.datasets import DataLoader as JDataLoader, _seed_for_sample
from tsm_det_pointcloud_tpu.datasets.waymo.waymo_dataset import WaymoDataset as JWaymoDataset
from tsm_det_pointcloud_tpu.models import _meta_from_dataset as jmeta_from_dataset
from tsm_det_pointcloud_tpu_torch.datasets import DataLoader, build_dataloader, seed_for_sample
from tsm_det_pointcloud_tpu_torch.datasets.waymo.waymo_dataset import WaymoDataset
from tsm_det_pointcloud_tpu_torch.models import meta_from_dataset


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return preprocessed_roots(tmp_path_factory.mktemp("waymo"))


def _datasets(roots, training, cfg_file=WAYMO_CPC, interval=1, edit=None):
    jroot, proot = roots
    jcfg, pcfg = jax_dataset_cfg(cfg_file, jroot, interval), dataset_cfg(cfg_file, proot, interval)
    if edit is not None:
        edit(jcfg)
        edit(pcfg)
    return (JWaymoDataset(jcfg, CLASSES, training=training, root_path=jroot),
            WaymoDataset(pcfg, CLASSES, training=training, root_path=proot))


def _samples(jds, pds, epochs=(0, 3), indices=None):
    jsamples, psamples = [], []
    for epoch in epochs:
        for i in (range(len(jds)) if indices is None else indices):
            _seed_for_sample(jds, 7, epoch, i)
            seed_for_sample(pds, 7, epoch, i)
            jsamples.append(jds[i])
            psamples.append(pds[i])
            assert_same(psamples[-1], jsamples[-1], f"sample {i} epoch {epoch}")
    return jsamples, psamples


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_getitem_and_collate_equal_jax(roots, training):
    jds, pds = _datasets(roots, training)
    assert len(pds) == len(jds) == (4 if training else 2)
    if training:
        names = [c.NAME for c in pds.dataset_cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST]
        assert len(pds.data_augmentor.data_augmentor_queue) == len(names)
    jsamples, psamples = _samples(jds, pds)
    n = 120000 if training else 163840
    assert psamples[0]["points"].shape == (n, 5)    # test: 163840 of ~195k kept, not padded
    assert_same(pds.collate_batch(psamples[:2]), jds.collate_batch(jsamples[:2]), "batch")


@pytest.mark.parametrize("disable", [True, False])
def test_nlz_flag_both_ways(roots, disable):
    def edit(cfg):
        cfg.DISABLE_NLZ_FLAG_ON_POINTS = disable

    jds, pds = _datasets(roots, False, edit=edit)
    pc = pds.infos[0]["point_cloud"]
    got = pds.get_lidar(pc["lidar_sequence"], pc["sample_idx"])
    want = jds.get_lidar(pc["lidar_sequence"], pc["sample_idx"])
    np.testing.assert_array_equal(got, want)
    raw = np.load(pds.data_path / pc["lidar_sequence"] / ("%04d.npy" % pc["sample_idx"]))
    assert (raw[:, 5] != -1).any()
    kept = raw if disable else raw[raw[:, 5] == -1]
    np.testing.assert_array_equal(got[:, :3], kept[:, :3])
    np.testing.assert_array_equal(got[:, 3], np.tanh(kept[:, 3]))


def test_sampled_interval_equals_jax(roots):
    """The config's SAMPLED_INTERVAL (train 5, test 1): a fifth of the train
    frames, every val frame."""
    for training, n in ((True, 1), (False, 2)):
        jds, pds = _datasets(roots, training, interval=None)
        assert len(pds) == len(jds) == n
        assert_same(pds.infos, jds.infos)


def test_sequence_sweeps_equal_jax(roots):
    def edit(cfg):
        cfg.SEQUENCE_CONFIG = {"ENABLED": True, "SAMPLE_OFFSET": [-1, 0]}
        features = ["x", "y", "z", "intensity", "elongation", "timestamp"]
        cfg.POINT_FEATURE_ENCODING.used_feature_list = features
        cfg.POINT_FEATURE_ENCODING.src_feature_list = features

    jds, pds = _datasets(roots, False, edit=edit)
    jsamples, psamples = _samples(jds, pds, epochs=(0,))
    lags = np.unique(psamples[1]["points"][:, 5])
    np.testing.assert_allclose(lags, [0.0, 0.1], atol=1e-7)   # frame 1 holds frame 0's sweep
    assert np.unique(psamples[0]["points"][:, 5]).tolist() == [0.0]


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_meta_from_dataset_equals_jax(roots, training):
    jds, pds = _datasets(roots, training)
    assert meta_from_dataset(pds).__dict__ == jmeta_from_dataset(jds).__dict__
    assert meta_from_dataset(pds).num_point_features == 5


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_jax(roots, workers):
    jds, pds = _datasets(roots, True)
    want = JDataLoader(jds, 2, shuffle=True, drop_last=True, seed=5, prefetch=0)
    want.set_epoch(1)
    loader = DataLoader(pds, 2, shuffle=True, drop_last=True, seed=5, workers=workers)
    loader.set_epoch(1)
    try:
        got = list(loader)
    finally:
        loader.close()
    want = list(want)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                     for k, v in g.items()}, w)


def test_build_dataloader_serves_waymo(roots):
    ds, loader, _ = build_dataloader(dataset_cfg(WAYMO_CPC, roots[1]), CLASSES, 2, workers=0,
                                     training=False)
    assert isinstance(ds, WaymoDataset) and len(loader) == 1
    batch = next(iter(loader))
    assert batch["points"].shape == (2, 163840, 5) and bool(batch["points_mask"].all())


def test_use_shared_memory_raises(roots):
    cfg = dataset_cfg(WAYMO_CPC, roots[1])
    cfg.USE_SHARED_MEMORY = True
    with pytest.raises(NotImplementedError, match="USE_SHARED_MEMORY"):
        WaymoDataset(cfg, CLASSES, training=True, root_path=roots[1])
    WaymoDataset(cfg, CLASSES, training=False, root_path=roots[1])   # as the JAX: train only


def test_prediction_dicts_and_evaluation_equal_jax(roots):
    """Echoed val gt, the class names as the model's labels give them (Car
    read as Vehicle): equal dicts, every AP and APH 100."""
    jds, pds = _datasets(roots, False)
    preds, frames = [], []
    for info in pds.infos:
        a = info["annos"]
        keep = np.isin(a["name"], CLASSES)
        preds.append({"pred_boxes": a["gt_boxes_lidar"][keep],
                      "pred_scores": np.linspace(0.9, 0.5, int(keep.sum())),
                      "pred_labels": np.asarray([CLASSES.index(n) + 1 for n in a["name"][keep]])})
        frames.append(info["frame_id"])
    batch = {"frame_id": frames}
    classes = ["Car", "Pedestrian", "Cyclist"]
    got = pds.generate_prediction_dicts(batch, preds, classes)
    want = jds.generate_prediction_dicts(batch, preds, classes)
    assert_same(got, want)
    assert got[0]["name"].dtype == object
    _, pres = pds.evaluation(got, classes)
    _, jres = jds.evaluation(want, classes)
    assert pres == jres and len(pres) == 12
    assert all(abs(v - 100.0) < 1e-6 for v in pres.values()), pres


def test_other_eval_metric_raises(roots):
    def edit(cfg):
        cfg.EVAL_METRIC = "kitti"

    _, pds = _datasets(roots, False, edit=edit)
    with pytest.raises(NotImplementedError, match="kitti"):
        pds.evaluation([{"name": np.zeros(0, object), "score": np.zeros(0),
                         "boxes_lidar": np.zeros((0, 7))}] * len(pds), CLASSES)


def test_gt_sampling_without_kitti_db_is_a_noop(roots):
    """waymo_fast_cpc.yaml's gt sampling reads kitti_dbinfos_train.pkl,
    which a Waymo root lacks: both packages warn and paste nothing, so the
    sample equals the one without the gt_sampling augmentor."""
    def drop(cfg):
        cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST = cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[1:]

    jds, pds = _datasets(roots, True)
    assert not (roots[1] / "kitti_dbinfos_train.pkl").exists()
    assert all(not v for v in pds.data_augmentor.data_augmentor_queue[0].db_infos.values())
    _, psamples = _samples(jds, pds, epochs=(0,), indices=[0])
    jds2, pds2 = _datasets(roots, True, edit=drop)
    _, pwithout = _samples(jds2, pds2, epochs=(0,), indices=[0])
    np.testing.assert_array_equal(psamples[0]["gt_boxes"], pwithout[0]["gt_boxes"])


def test_gt_sampling_with_a_kitti_db_raises_on_waymo_points(roots, tmp_path):
    """With a KITTI database (4 features a point, Car / Pedestrian / Cyclist)
    at the path waymo_fast_cpc.yaml names, both packages drop Car (not a
    class name) and paste Pedestrians and Cyclists, whose 4-column points do
    not concatenate with the 5-column Waymo scan: both raise ValueError (a
    fault of the reference the port keeps)."""
    errors = {}
    for side, root in zip(("jax", "port"), roots):
        db = {"Pedestrian": [], "Cyclist": [], "Car": []}
        (root / "kitti_gt").mkdir(exist_ok=True)
        for cls, (l, w, h) in (("Pedestrian", (0.8, 0.8, 1.7)), ("Cyclist", (1.8, 0.6, 1.7)),
                               ("Car", (4.0, 1.8, 1.5))):
            for k in range(3):
                pts = np.random.RandomState(k).uniform(-0.3, 0.3, (20, 4)).astype(np.float32)
                pts.tofile(root / "kitti_gt" / f"{cls}_{k}.bin")
                db[cls].append({"name": cls, "path": f"kitti_gt/{cls}_{k}.bin",
                                "box3d_lidar": np.array([30.0 + 6 * k, 20.0 * (1 + len(cls) % 3),
                                                         0.8, l, w, h, 0.0], np.float32),
                                "num_points_in_gt": 20, "difficulty": 0})
        with open(root / "kitti_dbinfos_train.pkl", "wb") as f:
            pickle.dump(db, f)
    try:
        jds, pds = _datasets(roots, True)
        sampler = pds.data_augmentor.data_augmentor_queue[0]
        assert "Car" not in sampler.sample_class_num
        assert len(sampler.db_infos["Pedestrian"]) == 3
        for side, ds, seed_fn in (("jax", jds, _seed_for_sample), ("port", pds, seed_for_sample)):
            seed_fn(ds, 7, 0, 0)
            with pytest.raises(ValueError) as e:
                ds[0]
            errors[side] = str(e.value)
        assert "concatenat" in errors["port"] and errors["port"] == errors["jax"]
    finally:
        for root in roots:
            (root / "kitti_dbinfos_train.pkl").unlink()
