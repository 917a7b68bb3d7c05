"""The Waymo slice as a whole against the JAX package: the tiny
Waymo-flavoured TSM (tiny.tiny_waymo_model_cfg: 5 point features, a +-8 m
range) on waymo_fast_cpc.yaml's data pipeline cut to that range
(torch_waymo_cases.tiny_dataset_cfg: 384 points a scan) over copies of one
synthetic Waymo root, preprocessed by each package.

Both sides take the JAX model's PRNGKey(0) training init (converted by
convert.from_flax_variables) with seeded class statistics and the student's
cls output biases lifted to 1.0, so that NMS keeps boxes. Tolerances, those
of tests/test_torch_eval_loop.py:
  * `eval_one_ckpt` (2 val frames in one batch): the same detections a
    frame, names equal, scores and lidar boxes rtol 1e-4 (atol 1e-4 on
    boxes: f32 sums in another order on the two sides);
  * the port's Waymo AP dict equal to the JAX `waymo_evaluation` on the
    port's detections and the val infos;
  * the training loss on the first train-loader batch (seed 0, epoch 0)
    within 1e-4 of the JAX loss.
The entry points `train --data_root` and `evaluate` are rehearsed once each
on the CPU on a YAML config of the same setup.
"""
import logging
import pickle

import jax
import numpy as np
import pytest
import torch
import yaml

from tests.torch_waymo_cases import CLASSES, preprocessed_roots, tiny_dataset_cfg
from tsm_det_pointcloud_tpu.datasets import DataLoader as JDataLoader
from tsm_det_pointcloud_tpu.datasets.waymo.waymo_dataset import WaymoDataset as JWaymoDataset
from tsm_det_pointcloud_tpu.eval.waymo_eval import waymo_evaluation as jwaymo_evaluation
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.parallel.train_state import device_batch
from tsm_det_pointcloud_tpu.runtime.eval_utils import eval_one_ckpt as jeval_one_ckpt
from tsm_det_pointcloud_tpu.utils.edict import EDict as JEDict
from tsm_det_pointcloud_tpu_torch import evaluate, tiny, train
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.datasets import DataLoader, build_dataloader
from tsm_det_pointcloud_tpu_torch.datasets.waymo.waymo_dataset import WaymoDataset
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.runtime.eval_utils import eval_one_ckpt
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict

CFG = EDict({"CLASS_NAMES": CLASSES})
B = 2


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return preprocessed_roots(tmp_path_factory.mktemp("waymo"))


@pytest.fixture(scope="module")
def jmodel(roots):
    jds = JWaymoDataset(tiny_dataset_cfg(roots[0], jax=True), CLASSES, training=False,
                        root_path=roots[0])
    return jbuild(JEDict(_plain(tiny.tiny_waymo_model_cfg())), num_class=3, dataset=jds)


@pytest.fixture(scope="module")
def variables(jmodel):
    gt, gt_mask = tiny.synth_gt(B)
    batch = {"points": tiny.synth_waymo_points(B), "batch_size": B,
             "points_mask": np.ones((B, tiny.WAYMO_POINTS), bool),
             "gt_boxes": gt, "gt_boxes_mask": gt_mask}
    v = jax.jit(lambda r, b: jmodel.init(r, b, training=True))(
        jax.random.PRNGKey(0), dict(batch))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["statistics"] = {"module_list_1": tiny.train_statistics()}
    s_head = v["params"]["module_list_1"]["s_head"]
    for k in ("cls0_out", "cls1_out", "cls2_out"):
        s_head[k] = dict(s_head[k], bias=np.ones_like(s_head[k]["bias"]))
    return v


def _port_model(variables, dataset):
    model = build_network(tiny.tiny_waymo_model_cfg(), 3, dataset, device="cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def evals(roots, jmodel, variables, tmp_path_factory):
    jroot, proot = roots
    out = tmp_path_factory.mktemp("eval")
    logger = logging.getLogger("test_torch_waymo_eval_loop")
    jds = JWaymoDataset(tiny_dataset_cfg(jroot, jax=True), CLASSES, training=False,
                        root_path=jroot)
    jres = jeval_one_ckpt(jmodel, variables, JDataLoader(jds, B, prefetch=0), jds, CFG,
                          logger, out / "jax")
    pds = WaymoDataset(tiny_dataset_cfg(proot), CLASSES, training=False, root_path=proot)
    pres = eval_one_ckpt(_port_model(variables, pds), DataLoader(pds, B), pds, CFG, logger,
                         out / "port")
    with open(out / "jax" / "result.pkl", "rb") as f:
        jannos = pickle.load(f)
    with open(out / "port" / "result.pkl", "rb") as f:
        pannos = pickle.load(f)
    return jres, pres, jannos, pannos, pds


def test_eval_loop_detections_match_jax(evals):
    _, _, jannos, pannos, _ = evals
    assert [a["frame_id"] for a in pannos] == [a["frame_id"] for a in jannos]
    assert sum(len(a["name"]) for a in pannos) > 0, "no detections to compare"
    for ja, pa in zip(jannos, pannos):
        assert len(pa["name"]) == len(ja["name"]), pa["frame_id"]
        np.testing.assert_array_equal(pa["name"], ja["name"])
        np.testing.assert_allclose(pa["score"], ja["score"], rtol=1e-4)
        np.testing.assert_allclose(pa["boxes_lidar"], ja["boxes_lidar"], rtol=1e-4, atol=1e-4)


def test_eval_loop_ap_dict_is_the_jax_metric(evals):
    """The port's result dict: the JAX Waymo metric on the port's own
    detections and the val infos, plus the loop's clocks."""
    jres, pres, _, pannos, pds = evals
    gt = [info["annos"] for info in pds.infos]
    _, want = jwaymo_evaluation(gt, pannos, tuple(CLASSES))
    got = {k: v for k, v in pres.items()
           if k not in ("sec_per_example", "loader_first_wait_s", "loader_wait_s",
                        "scans_per_s")}
    assert got.keys() == want.keys() and len(want) == 12
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
        assert np.isfinite(got[k])
    assert pres["sec_per_example"] > 0 and pres["scans_per_s"] > 0


def test_first_loader_batch_loss_matches_jax(roots, jmodel, variables):
    _, proot = roots
    ds, loader, _ = build_dataloader(tiny_dataset_cfg(proot), CLASSES, B, workers=0,
                                     seed=0, training=True)
    loader.set_epoch(0)
    batch = next(iter(loader))
    assert int(batch["gt_boxes_mask"].sum()) > 0
    jbatch = device_batch({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                           for k, v in batch.items()})

    @jax.jit
    def loss_of(v, b):
        out, _ = jmodel.apply(v, b, training=True, mutable=["batch_stats", "statistics"])
        return out["loss"]

    want = float(loss_of(variables, jbatch))
    model = _port_model(variables, ds).train()
    got = float(model(dict(batch))["loss"].detach())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, abs(want)))


def test_evaluate_and_train_entry_points_on_cpu(roots, tmp_path):
    """`train --data_root` on the Waymo root writes a checkpoint and
    evaluates it with the Waymo metric (--num_epochs_to_eval); `evaluate
    --ckpt` evaluates it and writes result.pkl."""
    _, proot = roots
    model = tiny.tiny_waymo_model_cfg()
    doc = {"CLASS_NAMES": CLASSES, "DATA_CONFIG": _plain(tiny_dataset_cfg(proot)),
           "MODEL": _plain(model),
           "OPTIMIZATION": {"BATCH_SIZE_PER_GPU": B, "NUM_EPOCHS": 1,
                            "OPTIMIZER": "adam_onecycle", "LR": 0.01, "WEIGHT_DECAY": 0.01,
                            "MOMENTUM": 0.9, "MOMS": [0.95, 0.85], "PCT_START": 0.3,
                            "DIV_FACTOR": 10, "DECAY_STEP_LIST": [35, 45], "LR_DECAY": 0.1,
                            "LR_CLIP": 1e-7, "LR_WARMUP": False, "WARMUP_EPOCH": 1,
                            "GRAD_NORM_CLIP": 10}}
    cfg = tmp_path / "tiny_waymo.yaml"
    cfg.write_text(yaml.safe_dump(doc))
    out = tmp_path / "out"
    train.main(["--cfg_file", str(cfg), "--data_root", str(proot), "--device", "cpu",
                "--workers", "0", "--output_dir", str(out), "--num_epochs_to_eval", "1",
                "--set", "DATA_CONFIG.SAMPLED_INTERVAL.train", "2"])
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    metrics = (out / "metrics.jsonl").read_text()
    # --set kept every second train frame: 2 samples, one step of 2
    assert ckpt.exists() and metrics.count("train/loss") == 1
    assert "eval/Vehicle/AP_L1" in metrics
    res = evaluate.main(["--cfg_file", str(cfg), "--data_root", str(proot), "--device", "cpu",
                         "--workers", "0", "--ckpt", str(ckpt), "--output_dir", str(out)])
    assert (out / "eval" / "default" / "result.pkl").exists()
    assert {"Vehicle/AP_L1", "Cyclist/APH_L2"} <= set(res)
