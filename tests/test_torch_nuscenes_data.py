"""The port's nuScenes data path against the JAX package on the CPU, on a
small synthetic root (tests/torch_nuscenes_cases.py: the port's writer at 150
points a sweep, 2 train scenes and 1 val scene of 3 keyframes, 10-sweep
infos):

  * the infos: every key of every info (transforms, sweeps, velocities,
    num_lidar_pts, names, tokens), the splits, and what the writer puts in
    them (a NaN velocity, an annotation of radar points only);
  * dataset items, test mode: the points as sorted rows (the sweeps' order
    differs: the port draws them from a generator spawned from the sample's,
    the JAX package from numpy's global state), the 10-column gt boxes with
    NaN velocities zeroed, and PRED_VELOCITY False's 8 columns;
  * the CBGS-resampled train infos (their tokens, in order);
  * the gt database: the db infos and every object's points (sorted rows);
  * a training item through gt sampling (LIMIT_WHOLE_SCENE) and the three
    world augmentors, each side's generator seeded alike: 10-column boxes
    and the points as sorted rows;
  * the NDS dict of the dataset's evaluation on echoed gt (NDS 0.8, mAP 1)
    and on perturbed predictions, against the JAX evaluation.

Exact throughout (both sides run the same numpy), but the gt boxes after
the rotation and scaling augmentors and the transformed points, 1e-6.
"""
import copy
import pickle

import numpy as np
import pytest

from tests import torch_nuscenes_cases as cases
from tsm_det_pointcloud_tpu.datasets import _seed_for_sample as jseed_for_sample
from tsm_det_pointcloud_tpu.datasets.nuscenes.nuscenes_dataset import (
    NuScenesDataset as JNuScenesDataset,
)
from tsm_det_pointcloud_tpu.eval import nuscenes_eval as jnds
from tsm_det_pointcloud_tpu_torch.datasets import seed_for_sample
from tsm_det_pointcloud_tpu_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset
from tsm_det_pointcloud_tpu_torch.eval import nuscenes_eval as nds

V = cases.VERSION


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return cases.make_roots(tmp_path_factory)


def _load(root, name):
    with open(root / V / name, "rb") as f:
        return pickle.load(f)


def _equal(a, b, what):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("split", ["train", "val"])
def test_infos_equal_jax(roots, split):
    jroot, proot = roots
    want = _load(jroot, f"nuscenes_infos_10sweeps_{split}.pkl")
    got = _load(proot, f"nuscenes_infos_10sweeps_{split}.pkl")
    assert len(got) == len(want) == {"train": 6, "val": 3}[split]
    _equal(got, want, split)


def test_infos_hold_the_writers_cases(roots):
    """Ten classes and the ignored animal; the car annotated at one keyframe
    has a NaN velocity; the occluded car, no lidar point but 3 radar ones,
    stays in the infos; every info has nine real sweeps."""
    infos = _load(roots[1], "nuscenes_infos_10sweeps_train.pkl")
    names = {str(n) for i in infos for n in i["gt_names"]}
    assert names == set(cases.ALL_CLASSES) | {"ignore"}
    vel = np.concatenate([i["gt_boxes"][:, 7:9] for i in infos])
    assert np.isnan(vel).any() and (np.abs(vel[~np.isnan(vel)]) > 0.1).any()
    nlp = np.concatenate([i["num_lidar_pts"] for i in infos])
    nrp = np.concatenate([i["num_radar_pts"] for i in infos])
    assert ((nlp == 0) & (nrp == 3)).any()
    assert all(len(i["sweeps"]) == 9 and all(s["transform_matrix"] is not None
                                             for s in i["sweeps"]) for i in infos)


def _datasets(roots, training, **over):
    jroot, proot = roots
    sides = []
    for cls, root in ((JNuScenesDataset, jroot), (NuScenesDataset, proot)):
        data = cases.dataset_cfg(root)
        data.update(over)
        sides.append(cls(data, cases.ALL_CLASSES, training=training))
    return sides


def _sorted_rows(a):
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("pred_velocity", [True, False], ids=["vel", "novel"])
def test_items_equal_jax(roots, pred_velocity):
    jds, pds = _datasets(roots, False, PRED_VELOCITY=pred_velocity)
    assert len(jds) == len(pds) == 3
    for i in range(3):
        jseed_for_sample(jds, 0, 0, i)
        seed_for_sample(pds, 0, 0, i)
        want, got = jds[i], pds[i]
        assert set(got) == set(want) and got["frame_id"] == want["frame_id"]
        assert got["metadata"] == want["metadata"]
        assert got["points"].shape == want["points"].shape and got["points"].shape[1] == 5
        np.testing.assert_allclose(_sorted_rows(got["points"]), _sorted_rows(want["points"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])
        assert got["gt_boxes"].shape[1] == (10 if pred_velocity else 8)
        assert np.isfinite(got["gt_boxes"]).all()
        lags = np.unique(np.round(got["points"][:, 4], 3))
        assert len(lags) == 10 and lags[0] == 0


def test_cbgs_indices_equal_jax(roots):
    jds, pds = _datasets(roots, True)
    raw = _load(roots[1], "nuscenes_infos_10sweeps_train.pkl")
    assert [i["token"] for i in pds.infos] == [i["token"] for i in jds.infos]
    assert len(pds.infos) > len(raw)


def test_gt_database_equal_jax(roots):
    jroot, proot = roots
    want = _load(jroot, "nuscenes_dbinfos_10sweeps_withvelo.pkl")
    got = _load(proot, "nuscenes_dbinfos_10sweeps_withvelo.pkl")
    assert list(got) == list(want) and set(got) == set(cases.ALL_CLASSES) | {"ignore"}
    for name in want:
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            _equal({k: v for k, v in g.items()}, w, name)
            gp = np.fromfile(proot / V / g["path"], np.float32).reshape(-1, 5)
            wp = np.fromfile(jroot / V / w["path"], np.float32).reshape(-1, 5)
            np.testing.assert_array_equal(_sorted_rows(gp), _sorted_rows(wp))


def test_training_item_equal_jax(roots):
    """Each train index through gt sampling and flip / rotation / scaling, on
    fresh datasets (the JAX sampler then draws its permutation at each
    call, as the port's does), seeded alike: some items take pasted
    objects."""
    pasted = 0
    for i in range(4):
        jds, pds = _datasets(roots, True)
        jseed_for_sample(jds, 0, 0, i)
        seed_for_sample(pds, 0, 0, i)
        want, got = jds[i], pds[i]
        assert got["gt_boxes"].shape[1] == 10
        np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], rtol=1e-6, atol=1e-6)
        assert got["points"].shape == want["points"].shape
        np.testing.assert_allclose(_sorted_rows(got["points"]), _sorted_rows(want["points"]),
                                   rtol=1e-6, atol=1e-5)
        raw = pds.infos[i]
        pasted += len(got["gt_boxes"]) - int((raw["num_lidar_pts"] > 0).sum())
    assert pasted > 0


def _echo(ds, perturb=None):
    """Prediction dicts of the split's own gt of lidar points (score 1, 7
    columns), or
    perturbed: boxes moved and resized, every third dropped, scores drawn."""
    rng = np.random.RandomState(0)
    dets = []
    for info in ds.infos:
        boxes = np.asarray(info["gt_boxes"])[:, :7].copy()
        labels = np.array([cases.ALL_CLASSES.index(n) + 1 if n in cases.ALL_CLASSES else 0
                           for n in info["gt_names"]])
        keep = (labels > 0) & (np.asarray(info["num_lidar_pts"]) > 0)
        scores = np.ones(len(boxes), np.float32)
        if perturb:
            keep &= np.arange(len(boxes)) % 3 != 2
            boxes[:, :2] += rng.normal(0, 0.6, (len(boxes), 2))
            boxes[:, 3:6] *= rng.uniform(0.8, 1.2, (len(boxes), 3))
            boxes[:, 6] += rng.normal(0, 0.3, len(boxes))
            scores = rng.uniform(0.1, 1, len(boxes)).astype(np.float32)
        dets += ds.generate_prediction_dicts(
            {"metadata": [{"token": info["token"]}]},
            [{"pred_boxes": boxes[keep], "pred_scores": scores[keep],
              "pred_labels": labels[keep]}], cases.ALL_CLASSES)
    return dets


@pytest.mark.parametrize("perturb", [False, True], ids=["echo", "perturbed"])
def test_nds_equal_jax(roots, perturb):
    jds, pds = _datasets(roots, False)
    dets = _echo(pds, perturb)
    s, got = pds.evaluation(copy.deepcopy(dets), cases.ALL_CLASSES)
    s_want, want = jds.evaluation(copy.deepcopy(dets), cases.ALL_CLASSES)
    assert s == s_want and got == want
    for m in ("mATE", "mASE", "mAOE", "mAVE", "mAAE"):
        assert m in got
    if perturb:
        assert 0.1 < got["NDS"] < 0.8 and got["mATE"] > 0.1
    else:
        assert got["mAP"] > 0.999 and abs(got["NDS"] - 0.8) < 1e-9, s
        assert got["mATE"] < 1e-9 and got["mAVE"] == 1.0
    # the evaluation is the module's on the same annos
    gt = [{"name": np.asarray(i["gt_names"], object), "gt_boxes_lidar": i["gt_boxes"],
           "num_lidar_pts": i["num_lidar_pts"]} for i in pds.infos]
    assert nds.nuscenes_evaluation(gt, dets, cases.ALL_CLASSES)[1] == \
        jnds.nuscenes_evaluation(gt, dets, cases.ALL_CLASSES)[1] == got
