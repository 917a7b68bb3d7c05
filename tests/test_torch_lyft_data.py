"""The port's Lyft data path against the JAX package on the CPU, on a small
synthetic root (tests/torch_lyft_cases.py: the port's writer at 150 points a
sweep, 2 train scenes and 1 val scene of 3 key frames, infos of nine sweeps,
a 5-sweep config):

  * the infos: every key of every info (transforms, sweeps, 7-column boxes,
    NaN velocities, names, tokens) and the scene splits, and what the writer
    puts in them (nine classes, nine real sweeps);
  * dataset items in test mode, each side's global numpy state seeded alike
    (both draw 4 of an info's 9 sweeps from it): the points element for
    element, the gt boxes, and that the draw takes four sweeps and another
    seed other ones;
  * the gt database: the db infos and every object's points, byte for byte;
  * a training item through gt sampling (LIMIT_WHOLE_SCENE) and the three
    world augmentors, each side seeded alike;
  * a key frame whose gt all fall outside the range: both redraw the same
    other sample.

Exact throughout (both sides run the same numpy), but the gt boxes and
points after the rotation and scaling augmentors, 1e-6.
"""
import copy
import pickle

import numpy as np
import pytest

from tests import torch_lyft_cases as cases
from tsm_det_pointcloud_tpu.datasets import _seed_for_sample as jseed_for_sample
from tsm_det_pointcloud_tpu.datasets.lyft.lyft_dataset import LyftDataset as JLyftDataset
from tsm_det_pointcloud_tpu_torch.datasets import seed_for_sample
from tsm_det_pointcloud_tpu_torch.datasets.lyft.lyft_dataset import LyftDataset


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return cases.make_roots(tmp_path_factory)


def _load(root, name):
    with open(root / name, "rb") as f:
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
    want = _load(jroot, f"lyft_infos_{split}.pkl")
    got = _load(proot, f"lyft_infos_{split}.pkl")
    assert len(got) == len(want) == {"train": 6, "val": 3}[split]
    _equal(got, want, split)


def test_infos_hold_the_writers_cases(roots):
    """Lyft's nine classes in every key frame, 7-column boxes with NaN
    velocities beside them, nine real sweeps an info (each a transform and a
    time lag of 0.1 s steps)."""
    infos = _load(roots[1], "lyft_infos_train.pkl") + _load(roots[1], "lyft_infos_val.pkl")
    for info in infos:
        assert set(info["gt_names"]) == set(cases.CLASSES)
        assert info["gt_boxes"].shape[1] == 7 and np.isnan(info["gt_boxes_velocity"]).all()
        assert len(info["sweeps"]) == 9
        assert all(s["transform_matrix"] is not None for s in info["sweeps"])
        np.testing.assert_allclose([s["time_lag"] for s in info["sweeps"]],
                                   0.1 * np.arange(1, 10), atol=1e-5)


def _datasets(roots, training):
    jroot, proot = roots
    return (JLyftDataset(cases.dataset_cfg(jroot), cases.CLASSES, training=training),
            LyftDataset(cases.dataset_cfg(proot), cases.CLASSES, training=training))


def _items(jds, pds, i, seed=0):
    """Item i of each side, each reseeded just before it (the global state
    too: a side's draw consumes it)."""
    jseed_for_sample(jds, seed, 0, i)
    want = jds[i]
    seed_for_sample(pds, seed, 0, i)
    return want, pds[i]


def test_items_equal_jax(roots):
    """Element for element: both draw the same 4 of an info's 9 sweeps, in
    the same order, from the reseeded global state."""
    jds, pds = _datasets(roots, False)
    assert len(jds) == len(pds) == 3
    for i in range(3):
        want, got = _items(jds, pds, i)
        assert set(got) == set(want) and got["frame_id"] == want["frame_id"]
        assert got["points"].shape == want["points"].shape and got["points"].shape[1] == 5
        np.testing.assert_array_equal(got["points"], want["points"])
        np.testing.assert_array_equal(got["gt_boxes"], want["gt_boxes"])
        assert got["gt_boxes"].shape[1] == 8 and np.isfinite(got["gt_boxes"]).all()


def test_sweep_draw_takes_four_of_nine(roots):
    """MAX_SWEEPS 5 of infos of nine sweeps: the key frame and four sweeps a
    cloud, and another seed draws other ones, on both sides alike."""
    jds, pds = _datasets(roots, False)
    lags = []
    for seed in (0, 1):
        np.random.seed(seed)
        got = pds.get_lidar_with_sweeps(0, max_sweeps=5)
        np.random.seed(seed)
        np.testing.assert_array_equal(got, jds.get_lidar_with_sweeps(0, max_sweeps=5))
        lags.append(np.unique(np.round(got[:, 4], 3)))
    assert all(len(x) == 5 and x[0] == 0 for x in lags)
    assert not np.array_equal(lags[0], lags[1])


def test_gt_database_equal_jax(roots):
    jroot, proot = roots
    want = _load(jroot, "lyft_dbinfos_10sweeps.pkl")
    got = _load(proot, "lyft_dbinfos_10sweeps.pkl")
    assert list(got) == list(want) and set(got) == set(cases.CLASSES)
    for name in want:
        assert len(got[name]) == len(want[name]) > 0
        for g, w in zip(got[name], want[name]):
            _equal(g, w, name)
            assert (proot / g["path"]).read_bytes() == (jroot / w["path"]).read_bytes()


def test_training_item_equal_jax(roots):
    """Each train index through gt sampling and flip / rotation / scaling, on
    fresh datasets (the JAX sampler then draws its permutation at each
    call, as the port's does), seeded alike: some items take pasted
    objects."""
    pasted = 0
    for i in range(3):
        want, got = _items(*_datasets(roots, True), i)
        assert got["gt_boxes"].shape[1] == 8
        np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], rtol=1e-6, atol=1e-6)
        assert got["points"].shape == want["points"].shape
        np.testing.assert_allclose(got["points"], want["points"], rtol=1e-6, atol=1e-5)
        pasted += len(got["gt_boxes"]) > 33
    assert pasted > 0


def test_empty_sample_redraws_like_jax(roots):
    """A key frame whose gt all lie outside the range (the infos' boxes moved
    200 m out): prepare_data gives None and both redraw the same index from
    the sample's generator."""
    jds, pds = _datasets(roots, True)
    for ds in (jds, pds):
        ds.infos = copy.deepcopy(ds.infos)
        ds.infos[1]["gt_boxes"][:, 0] += 200.0
        ds.data_augmentor.data_augmentor_queue = ds.data_augmentor.data_augmentor_queue[1:]
    want, got = _items(jds, pds, 1, seed=3)
    assert got["frame_id"] == want["frame_id"] != jds.infos[1]["lidar_path"].split("/")[-1][:-4]
    np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["points"], want["points"], rtol=1e-6, atol=1e-5)
