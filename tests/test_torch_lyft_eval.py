"""The port's Lyft evaluation and the tiny Lyft CenterPoint against the JAX
package on the CPU:

  * `eval.lyft_eval`: the hand goldens of tests/test_nds_lyft_eval.py (a
    shifted box's IoU 0.6, the rotated square's 1/sqrt(2), the mixed mAP 0.5,
    a second prediction on a taken gt an FP, a class without gt scoring 0),
    each on both packages; `to_kitti_format` equal to the JAX function, its
    input untouched;
  * the dataset's evaluation on the synthetic root of
    tests/torch_lyft_cases.py: the Lyft mAP (1.0 on echoed gt, and on
    perturbed detections), the pseudo-KITTI AP of the five mapped classes
    (the unmapped emergency_vehicle, other_vehicle and animal pass through
    and are ignored) and the labelled Waymo route, each equal to the JAX
    evaluation's dict;
  * the tiny Lyft CenterPoint (tiny.centerpoint_lyft_state(): Lyft's nine
    classes in five groups, no vel head): the committed golden
    data/centerpoint_lyft_tiny_forward.npz is the JAX package's output now,
    and the port's eval forward and predictions match it;
  * the dataset-driven loop (torch_eval_loop_cases.run_dataset_eval) on the
    tiny root (3 val frames in batches of 2): the JAX loop's detections
    (names equal, scores and boxes rtol 1e-4), a Lyft mAP dict equal to the
    JAX evaluation of the port's own detections, `evaluate` on a
    checkpoint of that state, the first train-loader batch's loss within
    rtol 1e-4 of the JAX forward's, and `train --data_root` for an epoch.

Tolerances: the evaluations' dicts equal (both sides run the same numpy; the
port's BEV intersection runs in the host library, the JAX package's in
numpy: the goldens hold both at 1e-6); the golden as
tests/test_torch_centerpoint_nusc.py holds it (1e-5 against the JAX package
now, the forward rtol 1e-5 with atol 1e-5 times the largest magnitude).

The golden is regenerated with
    python -c "from tests.test_torch_lyft_eval import write_centerpoint_lyft_golden; write_centerpoint_lyft_golden()"
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests import torch_eval_loop_cases as loop
from tests import torch_lyft_cases as cases
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.datasets.kitti.kitti_format import to_kitti_format as jto_kitti
from tsm_det_pointcloud_tpu.datasets.lyft.lyft_dataset import LyftDataset as JLyftDataset
from tsm_det_pointcloud_tpu.eval import lyft_eval as jlyft
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu_torch import evaluate, infer, tiny, train
from tsm_det_pointcloud_tpu_torch.convert import to_flax_variables
from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_format import to_kitti_format
from tsm_det_pointcloud_tpu_torch.datasets.lyft.lyft_dataset import (
    MAP_NAME_TO_KITTI,
    LyftDataset,
)
from tsm_det_pointcloud_tpu_torch.eval import lyft_eval
from tsm_det_pointcloud_tpu_torch.models import build_network

CAR = [4.0, 2.0, 1.5]
TIMING = ("sec_per_example", "loader_first_wait_s", "loader_wait_s", "scans_per_s")
META = tiny.CENTERPOINT_LYFT_META
_JMODEL = jbuild(tiny.centerpoint_lyft_model_cfg(), num_class=9,
                 dataset=JDatasetMeta(**dataclasses.asdict(META)))
FINAL = ("final_boxes", "final_scores", "final_labels")


def _anno(names, boxes, scores=None):
    a = {"name": np.asarray(names, object),
         "boxes_lidar": np.asarray(boxes, np.float64).reshape(-1, 7)}
    if scores is not None:
        a["score"] = np.asarray(scores, np.float64)
    else:
        a["gt_boxes_lidar"] = a.pop("boxes_lidar")
    return a


def test_iou3d_goldens():
    """A 2 x 4 box shifted 1 m: IoU 12 / 20; 2 x 2 squares at 0 and 45
    degrees: the octagon over its complement, 1 / sqrt(2)."""
    for fn in (lyft_eval._iou3d, jlyft._iou3d):
        assert fn([1, 0, 0, 4, 2, 2, 0], np.array([[0, 0, 0, 4, 2, 2, 0]]))[0] == \
            pytest.approx(0.6, abs=1e-6)
        assert fn([0, 0, 0, 2, 2, 1, np.pi / 4], np.array([[0, 0, 0, 2, 2, 1, 0.0]]))[0] == \
            pytest.approx(1 / np.sqrt(2), abs=1e-6)


GOLDENS = {
    # pred 2 on gt A (IoU 0.6) after pred 1 took it: an FP at every threshold
    # (car 0.5); the rotated cyclist square TP up to 0.7 (0.5)
    "mixed": ([_anno(["car", "car", "cyclist"], [[0, 0, 0, 4, 2, 2, 0], [10, 0, 0, 4, 2, 2, 0],
                                                 [20, 0, 0, 2, 2, 1, 0.0]])],
              [_anno(["car", "car", "cyclist"], [[0, 0, 0, 4, 2, 2, 0], [1, 0, 0, 4, 2, 2, 0],
                                                 [20, 0, 0, 2, 2, 1, np.pi / 4]],
                     scores=[0.9, 0.8, 0.9])],
              ["car", "cyclist"], None, {"car": 0.5, "cyclist": 0.5, "mAP": 0.5}),
    # the second prediction on the same gt: an FP though it matches it
    "taken_gt": ([_anno(["car"], [[0, 0, 0, 4, 2, 2, 0]])],
                 [_anno(["car", "car"], [[0, 0, 0, 4, 2, 2, 0], [0.1, 0, 0, 4, 2, 2, 0]],
                        scores=[0.9, 0.8])],
                 ["car"], [0.5], {"car": 1.0, "mAP": 1.0}),
    "empty_class": ([_anno(["car"], [[0, 0, 0, 4, 2, 2, 0]])],
                    [_anno(["car"], [[0, 0, 0, 4, 2, 2, 0]], scores=[0.9])],
                    ["car", "truck"], None, {"car": 1.0, "truck": 0.0, "mAP": 0.5}),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_lyft_evaluation_goldens(name):
    gt, dt, classes, ths, want = GOLDENS[name]
    kw = {} if ths is None else {"iou_thresholds": ths}
    s, got = lyft_eval.lyft_evaluation(gt, dt, classes, **kw)
    s_j, got_j = jlyft.lyft_evaluation(gt, dt, classes, **kw)
    assert s == s_j and got == got_j
    assert got == pytest.approx(want, abs=1e-6)


def test_to_kitti_format_equals_jax():
    """Detections and gt annos (an empty one too) through the name map: the
    unmapped names pass as they are; the input is not changed."""
    rng = np.random.RandomState(0)
    annos = [{"name": np.array(["car", "animal", "bicycle"], object),
              "boxes_lidar": rng.uniform(-5, 5, (3, 7)), "score": rng.uniform(0, 1, 3)},
             {"name": np.array([], object), "boxes_lidar": np.zeros((0, 7)),
              "score": np.zeros(0)},
             {"gt_names": np.array(["truck", "emergency_vehicle"], object),
              "gt_boxes_lidar": rng.uniform(-5, 5, (2, 7))}]
    before = copy.deepcopy(annos)
    got, want = to_kitti_format(annos, MAP_NAME_TO_KITTI), jto_kitti(annos, MAP_NAME_TO_KITTI)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert list(got[0]["name"]) == ["Car", "animal", "Cyclist"]
    for a, b in zip(annos, before):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return cases.make_roots(tmp_path_factory)


def _echo(ds, perturb=False):
    """Prediction dicts of the split's own gt (score distinct, 7 columns),
    or perturbed: boxes moved, every third dropped, scores drawn."""
    rng = np.random.RandomState(0)
    dets = []
    for info in ds.infos:
        boxes = np.asarray(info["gt_boxes"])[:, :7].copy()
        labels = np.array([cases.CLASSES.index(n) + 1 for n in info["gt_names"]])
        keep = np.ones(len(boxes), bool)
        scores = rng.uniform(0.5, 1.0, len(boxes)).astype(np.float32)
        if perturb:
            keep &= np.arange(len(boxes)) % 3 != 2
            boxes[:, :2] += rng.normal(0, 0.3, (len(boxes), 2))
            boxes[:, 6] += rng.normal(0, 0.2, len(boxes))
        dets += ds.generate_prediction_dicts(
            {"metadata": [None]},
            [{"pred_boxes": boxes[keep], "pred_scores": scores[keep],
              "pred_labels": labels[keep]}], cases.CLASSES)
    return dets


@pytest.mark.parametrize("metric", ["lyft", "kitti", "waymo"])
@pytest.mark.parametrize("perturb", [False, True], ids=["echo", "perturbed"])
def test_dataset_evaluation_equals_jax(roots, metric, perturb):
    jroot, proot = roots
    jds = JLyftDataset(cases.dataset_cfg(jroot), cases.CLASSES, training=False)
    pds = LyftDataset(cases.dataset_cfg(proot), cases.CLASSES, training=False)
    dets = _echo(pds, perturb)
    s, got = pds.evaluation(copy.deepcopy(dets), cases.CLASSES, eval_metric=metric)
    s_want, want = jds.evaluation(copy.deepcopy(dets), cases.CLASSES, eval_metric=metric)
    assert s == s_want and got == want
    if metric == "lyft":
        assert set(got) == set(cases.CLASSES) | {"mAP"}
        if perturb:
            assert 0.05 < got["mAP"] < 0.95
        else:
            assert got["mAP"] == pytest.approx(1.0, abs=1e-12), s
    elif metric == "kitti":
        mapped = sorted(set(MAP_NAME_TO_KITTI.values()))
        assert {k.split("_")[0] for k in got if "/" in k} == set(mapped)
    else:
        assert s.startswith("[NON-OFFICIAL metric")


@jax.jit
def _jax_eval(variables, b):
    out = _JMODEL.apply(variables, dict(b, batch_size=2), training=False)
    pred, _ = _JMODEL.apply(variables, out, method=lambda m, bd: m.post_processing(bd))
    return {k: out[k] for k in FINAL}, pred


def _points():
    return {"points": tiny.nusc_points(2), "points_mask": np.ones((2, 512), bool)}


def write_centerpoint_lyft_golden():
    """Write the JAX eval outputs and predictions with
    tiny.centerpoint_lyft_state()."""
    out, pred = jax.tree_util.tree_map(
        np.asarray, _jax_eval(to_flax_variables(tiny.centerpoint_lyft_state()), _points()))
    np.savez_compressed(tiny.CENTERPOINT_LYFT_FORWARD_PATH, **out, **pred)


@pytest.fixture(scope="module")
def state():
    return tiny.centerpoint_lyft_state()


def test_committed_golden_is_current_and_port_matches(state):
    """The committed golden is the JAX package's output now (1e-5): 7-column
    decoded boxes of five groups, scores at least 1e-6 apart in each group,
    some under SCORE_THRESH; the port's forward and predictions match it."""
    with np.load(tiny.CENTERPOINT_LYFT_FORWARD_PATH) as z:
        golden = {k: z[k] for k in z.files}
    out, pred = jax.tree_util.tree_map(np.asarray, _jax_eval(to_flax_variables(state), _points()))
    want = {**out, **pred}
    assert set(golden) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert golden["final_boxes"].shape == (2, 160, 7)
    scores = golden["final_scores"]
    for g in range(5):
        assert (-np.diff(scores[:, 32 * g:32 * (g + 1)], axis=1)).min() > 1e-6
    assert (scores <= 0.1).any() and (scores > 0.1).any()
    model = build_network(tiny.centerpoint_lyft_model_cfg(), 9, META, device="cpu")
    model.load_state_dict(state, strict=True)
    pout, ppred = infer.detect(model, torch.from_numpy(tiny.nusc_points(2)),
                               torch.ones(2, 512, dtype=torch.bool))
    np.testing.assert_array_equal(pout["final_labels"].numpy(), golden["final_labels"])
    np.testing.assert_array_equal(ppred["count"].numpy(), golden["count"])
    np.testing.assert_array_equal(ppred["pred_labels"].numpy(), golden["pred_labels"])
    for k, got in (("final_boxes", pout), ("final_scores", pout), ("pred_boxes", ppred),
                   ("pred_scores", ppred)):
        w = golden[k]
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=k)


@pytest.fixture(scope="module")
def loop_case(roots, state, tmp_path_factory):
    jroot, proot = roots
    jds = JLyftDataset(cases.tiny_dataset_cfg(jroot), cases.CLASSES, training=False)
    pds = LyftDataset(cases.tiny_dataset_cfg(proot), cases.CLASSES, training=False)
    pres, jannos, pannos = loop.run_dataset_eval(
        jds, pds, tiny.centerpoint_lyft_model_cfg(), state, cases.CLASSES,
        tmp_path_factory.mktemp("eval_lyft"))
    return dict(pds=pds, pres=pres, jannos=jannos, pannos=pannos)


def test_eval_loop_detections_match_jax(loop_case):
    jannos, pannos = loop_case["jannos"], loop_case["pannos"]
    assert len(pannos) == len(jannos) == 3
    assert sum(len(a["name"]) for a in pannos) > 0, "no detections to compare"
    for ja, pa in zip(jannos, pannos):
        np.testing.assert_array_equal(pa["name"], ja["name"])
        np.testing.assert_allclose(pa["score"], ja["score"], rtol=1e-4)
        np.testing.assert_allclose(pa["boxes_lidar"], ja["boxes_lidar"], rtol=1e-4, atol=1e-4)


def test_eval_loop_map_dict_and_entry_point(loop_case, roots, state, tmp_path):
    """The loop's dict is the JAX Lyft mAP of the port's detections; the
    `evaluate` entry point on a checkpoint of the state returns it too."""
    pds = loop_case["pds"]
    gt = [{"name": np.asarray(i["gt_names"], object), "gt_boxes_lidar": i["gt_boxes"]}
          for i in pds.infos]
    _, want = jlyft.lyft_evaluation(gt, loop_case["pannos"], cases.CLASSES)
    assert {k: v for k, v in loop_case["pres"].items() if k not in TIMING} == want
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"model_state": state, "optimizer_state": {}, "epoch": 0, "it": 0}, ckpt)
    cfg_file = cases.write_tiny_yaml(tmp_path / "tiny_lyft.yaml", roots[1])
    res = evaluate.main(["--cfg_file", str(cfg_file), "--data_root", str(roots[1]),
                         "--ckpt", str(ckpt), "--device", "cpu", "--batch_size", "2",
                         "--workers", "0", "--output_dir", str(tmp_path / "out")])
    assert {k: v for k, v in res.items() if k not in TIMING} == want


def test_first_loader_batch_loss_matches_jax_and_train_runs(roots, state, tmp_path):
    """The first train-loader batch (gt sampling, the world augmentors, 5
    sweeps of 9): the port's loss within rtol 1e-4 of the JAX forward's;
    then `train --data_root` for an epoch of 3 steps writes a checkpoint."""
    got, want = loop.first_batch_loss(tiny.centerpoint_lyft_model_cfg(), state,
                                      cases.tiny_dataset_cfg(roots[1]), cases.CLASSES)
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, abs(want)))
    cfg_file = cases.write_tiny_yaml(tmp_path / "tiny_lyft.yaml", roots[1])
    ckpt_dir, epochs = train.main(["--cfg_file", str(cfg_file), "--data_root", str(roots[1]),
                                   "--device", "cpu", "--workers", "0", "--epochs", "1",
                                   "--output_dir", str(tmp_path / "out")])
    assert (ckpt_dir / "checkpoint_epoch_1.pth").exists()
    assert epochs[0]["steps"] == 3 and np.isfinite(epochs[0]["mean_loss"])
