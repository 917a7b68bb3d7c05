"""The port's PandaSet data path against the JAX package on the CPU, on a
small synthetic root (tests/torch_pandaset_cases.py: the port's writer at
1200 Pandar64 points a frame, sequence 001 for training and 002 for eval,
3 frames each, world poses hundreds of metres out with a non-trivial yaw):

  * the infos and the gt database (db infos and every object's points,
    byte for byte), and on both packages the database's file names of two
    sequences colliding (a reference fault, ROADMAP §C);
  * dataset items in both modes (points, gt boxes, the frame keys; the
    training items through gt sampling and the world augmentors, each side
    seeded alike), and the ego transform by hand: a cuboid's centre through
    world -> PandaSet ego -> normative, its dims swapped, the forward
    lidar's points and its cuboids dropped at LIDAR_DEVICE 0;
  * the frame keys through the collate and `to_torch_batch`: the pose and
    zrot_world_to_ego stay float64 numpy arrays on the host;
  * `generate_prediction_dicts`: the gt boxes fed back as predictions come
    out as the world cuboids (within 1e-4 m, yaw 1e-5), the DataFrames equal
    to the JAX package's, and the predictions/cuboids/NN.pkl.gz dump;
  * the evaluation: the default route returns ("", {}) on both, and the
    labelled waymo route raises the same KeyError on both (a reference
    fault, ROADMAP §C: the prediction dicts hold no `boxes_lidar`);
  * the tiny CenterPoint (tiny.centerpoint_eval_state()) through the
    dataset-driven loop (torch_eval_loop_cases.run_dataset_eval) on the
    tiny root: the JAX loop's world-frame DataFrames (rtol 1e-4 on the
    positions, which lie hundreds of metres out: atol 1e-3 m), the empty
    result, `evaluate` on a checkpoint of that state, and `train
    --data_root` for an epoch.

Exact but where the augmentors rotate and scale (1e-6).
"""
import copy
import pickle

import numpy as np
import pytest
import torch

from tests import torch_eval_loop_cases as loop
from tests import torch_pandaset_cases as cases
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.datasets import _seed_for_sample as jseed_for_sample
from tsm_det_pointcloud_tpu.datasets.pandaset.pandaset_dataset import (
    PandasetDataset as JPandasetDataset,
)
from tsm_det_pointcloud_tpu_torch import evaluate, tiny, train
from tsm_det_pointcloud_tpu_torch.datasets import seed_for_sample, to_torch_batch
from tsm_det_pointcloud_tpu_torch.datasets.pandaset.pandaset_dataset import (
    PandasetDataset,
    lidar_points_to_ego,
)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return cases.make_roots(tmp_path_factory)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("split", ["train", "val"])
def test_infos_equal_jax(roots, split):
    jroot, proot = roots
    want = _load(jroot / f"pandaset_infos_{split}.pkl")
    got = _load(proot / f"pandaset_infos_{split}.pkl")
    assert got == want and len(got) == cases.FRAMES
    assert got[0]["sequence"] == {"train": "001", "val": "002"}[split]


def test_gt_database_equal_jax(roots):
    jroot, proot = roots
    want = _load(jroot / "pandaset_dbinfos_train.pkl")
    got = _load(proot / "pandaset_dbinfos_train.pkl")
    assert list(got) == list(want) and {"Car", "Pedestrian", "Cyclist"} <= set(got)
    for name in want:
        assert len(got[name]) == len(want[name]) > 0
        for g, w in zip(got[name], want[name]):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert (proot / g["path"]).read_bytes() == (jroot / w["path"]).read_bytes()


def _datasets(roots, training):
    jroot, proot = roots
    return (JPandasetDataset(cases.dataset_cfg(jroot), cases.CLASSES, training=training,
                             root_path=jroot),
            PandasetDataset(cases.dataset_cfg(proot), cases.CLASSES, training=training,
                            root_path=proot))


def _items(jds, pds, i, seed=0):
    jseed_for_sample(jds, seed, 0, i)
    want = jds[i]
    seed_for_sample(pds, seed, 0, i)
    return want, pds[i]


@pytest.mark.parametrize("training", [False, True], ids=["test", "train"])
def test_items_equal_jax(roots, training):
    for i in range(cases.FRAMES):
        want, got = _items(*_datasets(roots, training), i)
        assert set(got) == set(want)
        for k in ("sequence", "frame_idx", "frame_id", "pose"):
            assert got[k] == want[k], k
        assert got["zrot_world_to_ego"] == want["zrot_world_to_ego"]
        assert type(got["zrot_world_to_ego"]) is np.float64
        tol = dict(rtol=1e-6, atol=1e-5) if training else dict(rtol=0, atol=0)
        assert got["points"].shape == want["points"].shape
        np.testing.assert_allclose(got["points"], want["points"], **tol)
        np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], **tol)


def test_ego_transform_by_hand(roots):
    """A cuboid's world centre through the pose's inverse, the PandaSet ego
    axes (x right, y forward) to the normative ones (x forward, y left), the
    dims swapped; the forward lidar's points (d = 1) and its cuboids
    (sensor_id 1) dropped; intensity in [0, 1]."""
    import pandas as pd

    _, pds = _datasets(roots, False)
    info = pds.infos[0]
    pose = pds._get_pose(info)
    cub = pd.read_pickle(pds.root_path / info["cuboids_path"])
    frame = pd.read_pickle(pds.root_path / info["lidar_path"])
    boxes, labels, zrot = pds._get_annotations(info, pose)
    kept = cub[cub["cuboids.sensor_id"] != 1]
    assert len(boxes) == len(kept) < len(cub)
    ego = lidar_points_to_ego(kept[["position.x", "position.y", "position.z"]].to_numpy(), pose)
    np.testing.assert_allclose(boxes[:, :3], np.stack([ego[:, 1], -ego[:, 0], ego[:, 2]], 1),
                               atol=1e-5)
    np.testing.assert_allclose(boxes[:, 3:6], kept[["dimensions.y", "dimensions.x",
                                                    "dimensions.z"]].to_numpy(), atol=1e-6)
    assert "Car" in set(labels) and "Cones" in set(labels)
    points = pds._get_lidar_points(info, pose)
    assert len(points) == int((frame.d == 0).sum()) < len(frame)
    assert 0 <= points[:, 3].min() and points[:, 3].max() <= 1
    assert abs(zrot) > 0.1 and np.abs(ego[:, :2]).max() < 100 < np.abs(
        kept[["position.x", "position.y"]].to_numpy()).min()


def test_frame_keys_stay_float64_on_the_host(roots):
    _, pds = _datasets(roots, False)
    samples = [pds[i] for i in range(2)]
    batch = to_torch_batch(pds.collate_batch(samples))
    assert isinstance(batch["points"], torch.Tensor)
    for k, dtype in (("pose", np.float64), ("zrot_world_to_ego", np.float64),
                     ("sequence", np.int64), ("frame_idx", np.int64)):
        assert isinstance(batch[k], np.ndarray) and batch[k].dtype == dtype, k
    np.testing.assert_array_equal(batch["pose"], np.array([s["pose"] for s in samples]))


def _gt_as_predictions(ds, i):
    """(batch, pred dicts) of info i's gt boxes of the three classes as
    predictions, the batch as the collate makes it."""
    sample = ds[i]
    boxes = sample["gt_boxes"]
    batch = ds.collate_batch([sample])
    return batch, [{"pred_boxes": boxes[:, :7], "pred_scores": np.linspace(1, 0.5, len(boxes)),
                    "pred_labels": boxes[:, 7].astype(np.int64)}]


def test_predictions_back_to_the_world_equal_jax(roots, tmp_path):
    import pandas as pd

    jds, pds = _datasets(roots, False)
    for i in range(cases.FRAMES):
        batch, preds = _gt_as_predictions(pds, i)
        got = pds.generate_prediction_dicts(copy.deepcopy(batch), preds, cases.CLASSES,
                                            output_path=tmp_path / "port")
        want = jds.generate_prediction_dicts(copy.deepcopy(batch), preds, cases.CLASSES,
                                             output_path=tmp_path / "jax")
        assert got[0]["name"] == want[0]["name"] and got[0]["sequence"] == "002"
        assert got[0]["frame_idx"] == want[0]["frame_idx"] == i
        pd.testing.assert_frame_equal(got[0]["preds"], want[0]["preds"])
        df = got[0]["preds"]
        info = pds.infos[i]
        cub = pd.read_pickle(pds.root_path / info["cuboids_path"])
        cub = cub[(cub["cuboids.sensor_id"] != 1) & cub.label.isin(
            [k for k, v in pds.dataset_cfg.TRAINING_CATEGORIES.items()])].reset_index()
        assert len(df) == len(cub) > 0
        for a in "xyz":
            np.testing.assert_allclose(df[f"position.{a}"], cub[f"position.{a}"], atol=1e-4)
            np.testing.assert_allclose(df[f"dimensions.{a}"], cub[f"dimensions.{a}"], atol=1e-6)
        np.testing.assert_allclose(df["yaw"], cub["yaw"] % (2 * np.pi), atol=1e-5)
        dump = pd.read_pickle(tmp_path / "port" / "002" / "predictions" / "cuboids"
                              / f"{i:02d}.pkl.gz")
        pd.testing.assert_frame_equal(dump, df)


def test_evaluation_routes_like_jax(roots):
    """The default route: ("", {}) on both; the waymo route: the same
    KeyError on both, as soon as a detection carries a class name."""
    jds, pds = _datasets(roots, False)
    batch, preds = _gt_as_predictions(pds, 0)
    annos = pds.generate_prediction_dicts(batch, preds, cases.CLASSES)
    assert pds.evaluation(annos, cases.CLASSES) == jds.evaluation(annos, cases.CLASSES) == ("", {})
    raised = []
    for ds in (jds, pds):
        with pytest.raises(KeyError) as e:
            ds.evaluation(annos, cases.CLASSES, eval_metric="waymo")
        raised.append(e.value.args)
    assert raised[0] == raised[1] == ("boxes_lidar",)


@pytest.fixture(scope="module")
def loop_case(roots, tmp_path_factory):
    jroot, proot = roots
    state = tiny.centerpoint_eval_state()
    jds = JPandasetDataset(cases.tiny_dataset_cfg(jroot), cases.CLASSES, training=False,
                           root_path=jroot)
    pds = PandasetDataset(cases.tiny_dataset_cfg(proot), cases.CLASSES, training=False,
                          root_path=proot)
    pres, jannos, pannos = loop.run_dataset_eval(
        jds, pds, tiny.centerpoint_model_cfg(), state, cases.CLASSES,
        tmp_path_factory.mktemp("eval_pandaset"))
    return dict(state=state, pres=pres, jannos=jannos, pannos=pannos)


def test_eval_loop_matches_jax(loop_case):
    jannos, pannos = loop_case["jannos"], loop_case["pannos"]
    assert len(pannos) == len(jannos) == cases.FRAMES
    assert sum(len(a["name"]) for a in pannos) > 0, "no detections to compare"
    for ja, pa in zip(jannos, pannos):
        assert (pa["sequence"], pa["frame_idx"]) == (ja["sequence"], ja["frame_idx"])
        assert pa["name"] == ja["name"]
        for col in ja["preds"].columns:
            if col == "label":
                assert list(pa["preds"][col]) == list(ja["preds"][col])
            else:
                np.testing.assert_allclose(pa["preds"][col], ja["preds"][col], rtol=1e-4,
                                           atol=1e-3 if col.startswith("position") else 1e-4,
                                           err_msg=col)
    assert {k: v for k, v in loop_case["pres"].items() if not k.endswith("_s")
            and k != "sec_per_example"} == {}


def test_entry_points_on_the_tiny_root(loop_case, roots, tmp_path):
    """`evaluate` on a checkpoint of the state (PandaSet's empty result), then
    `train --data_root` for an epoch writes a checkpoint."""
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"model_state": loop_case["state"], "optimizer_state": {}, "epoch": 0, "it": 0},
               ckpt)
    cfg_file = cases.write_tiny_yaml(tmp_path / "tiny_pandaset.yaml", roots[1])
    common = ["--cfg_file", str(cfg_file), "--data_root", str(roots[1]), "--device", "cpu",
              "--workers", "0", "--output_dir", str(tmp_path / "out")]
    res = evaluate.main(common + ["--ckpt", str(ckpt), "--batch_size", "2"])
    assert set(res) == {"sec_per_example", "loader_first_wait_s", "loader_wait_s", "scans_per_s"}
    ckpt_dir, epochs = train.main(common + ["--epochs", "1"])
    assert (ckpt_dir / "checkpoint_epoch_1.pth").exists()
    assert epochs[0]["steps"] == 1 and np.isfinite(epochs[0]["mean_loss"])


def test_gt_database_names_collide_across_sequences_like_jax(roots, tmp_path):
    """A reference fault the port keeps (ROADMAP §C): a db file is named by
    frame index, label and box index, not by sequence, so with two train
    sequences the objects of the second overwrite the first's files of the
    same frame and box index; both packages then list one path twice."""
    jroot, proot = roots
    infos = _load(proot / "pandaset_infos_train.pkl") + _load(proot / "pandaset_infos_val.pkl")
    paths = []
    for cls, root in ((JPandasetDataset, jroot), (PandasetDataset, proot)):
        with open(tmp_path / "both.pkl", "wb") as f:
            pickle.dump(infos, f)
        ds = cls(cases.dataset_cfg(root), cases.CLASSES, training=False, root_path=root)
        ds.create_groundtruth_database(str(tmp_path / "both.pkl"), split="both")
        db = _load(root / "pandaset_dbinfos_both.pkl")
        paths.append([d["path"] for v in db.values() for d in v])
    assert paths[0] == paths[1]
    assert len(set(paths[1])) < len(paths[1])
