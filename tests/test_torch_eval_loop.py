"""The port's dataset-driven eval loop and training step against the JAX
package, on the tiny TSM with a dataset config on its range
(torch_kitti_cases.tiny_dataset_cfg: fast_cpc.yaml's augmentors and
processors, 256 points a scan) over copies of one synthetic KITTI root.

Both sides take the JAX tiny model's PRNGKey(0) training init (converted for
the port by convert.from_flax_variables) with seeded class statistics
(tiny.train_statistics) and the student's cls output biases lifted to 1.0,
so that NMS keeps boxes. Tolerances:
  * `eval_one_ckpt` (6 val frames in batches of 4, the last one ragged): the
    same detections a frame, names equal, scores and lidar boxes rtol 1e-4
    (atol 1e-4 on boxes: f32 sums in another order on the two sides);
  * the port's AP dict equal to the JAX package's `get_official_eval_result`
    on the port's own detections (both are numpy on the same annos);
  * the training loss on the first train-loader batch (seed 0, epoch 0)
    within 1e-4 of the JAX loss (`jax.value_and_grad`, the tiny train test's
    loss tolerance).
The entry points `evaluate` and `train --data_root` are rehearsed once each
on the CPU on a YAML config of the same setup.
"""
import logging
import pickle

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tests.torch_kitti_cases import (CLASSES, copy_root, make_root, tiny_dataset_cfg,
                                     write_tiny_yaml)
from tsm_det_pointcloud_tpu.datasets import DataLoader as JDataLoader
from tsm_det_pointcloud_tpu.datasets.kitti.kitti_dataset import (
    KittiDataset as JKittiDataset,
    create_kitti_infos as jcreate_kitti_infos,
)
from tsm_det_pointcloud_tpu.eval.kitti_eval import get_official_eval_result as jofficial
from tsm_det_pointcloud_tpu.parallel.train_state import device_batch
from tsm_det_pointcloud_tpu.runtime.eval_utils import eval_one_ckpt as jeval_one_ckpt
from tsm_det_pointcloud_tpu_torch import evaluate, tiny, train
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.datasets import DataLoader, build_dataloader
from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import (
    KittiDataset,
    create_kitti_infos,
)
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.runtime.eval_utils import eval_one_ckpt
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict

_JMODEL = ge._tsm_model()
CFG = EDict({"CLASS_NAMES": CLASSES})


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("kitti")
    make_root(base / "base")
    jroot = copy_root(base / "base", base / "jax")
    proot = copy_root(base / "base", base / "port")
    jcreate_kitti_infos(tiny_dataset_cfg(jroot), CLASSES, jroot, jroot, workers=1)
    create_kitti_infos(tiny_dataset_cfg(proot), CLASSES, proot, proot, workers=1)
    return jroot, proot


@pytest.fixture(scope="module")
def variables():
    """The JAX tiny model's PRNGKey(0) training init (numpy leaves), seeded
    statistics, the student's cls output biases at 1.0."""
    batch = ge._synth_batch(2, with_gt=True, seed=0)
    v = jax.jit(lambda r, b: _JMODEL.init(r, b, training=True))(
        jax.random.PRNGKey(0), dict(batch))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["statistics"] = {"module_list_1": tiny.train_statistics()}
    s_head = v["params"]["module_list_1"]["s_head"]
    for k in ("cls0_out", "cls1_out", "cls2_out"):
        s_head[k] = dict(s_head[k], bias=np.ones_like(s_head[k]["bias"]))
    return v


def _port_model(variables, dataset):
    model = build_network(tiny.tiny_model_cfg(), 3, dataset, device="cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def evals(roots, variables, tmp_path_factory):
    jroot, proot = roots
    out = tmp_path_factory.mktemp("eval")
    logger = logging.getLogger("test_torch_eval_loop")
    jds = JKittiDataset(tiny_dataset_cfg(jroot), CLASSES, training=False, root_path=jroot)
    jres = jeval_one_ckpt(_JMODEL, variables, JDataLoader(jds, 4, prefetch=0), jds, CFG,
                          logger, out / "jax")
    pds = KittiDataset(tiny_dataset_cfg(proot), CLASSES, training=False, root_path=proot)
    pres = eval_one_ckpt(_port_model(variables, pds), DataLoader(pds, 4), pds, CFG, logger,
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


def test_eval_loop_ap_dict_is_the_jax_eval(evals):
    """The port's AP dict equals the JAX official eval on the port's own
    detections and the val infos; the loop adds its clocks."""
    _, pres, _, pannos, pds = evals
    gt = [info["annos"] for info in pds.kitti_infos]
    _, want = jofficial(gt, pannos, CLASSES)
    got = {k: v for k, v in pres.items()
           if k not in ("sec_per_example", "loader_first_wait_s", "loader_wait_s",
                        "scans_per_s")}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert pres["sec_per_example"] > 0 and pres["scans_per_s"] > 0


def test_first_loader_batch_loss_matches_jax(roots, variables):
    _, proot = roots
    ds, loader, _ = build_dataloader(tiny_dataset_cfg(proot), CLASSES, 2, workers=0,
                                     seed=0, training=True)
    loader.set_epoch(0)
    batch = next(iter(loader))
    jbatch = device_batch({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                           for k, v in batch.items()})

    @jax.jit
    def loss_and_grad(v, b):
        def loss_fn(params):
            out, _ = _JMODEL.apply(dict(v, params=params), b, training=True,
                                   mutable=["batch_stats", "statistics"])
            return out["loss"]

        return jax.value_and_grad(loss_fn)(v["params"])

    want = float(loss_and_grad(variables, jbatch)[0])
    model = _port_model(variables, ds).train()
    got = float(model(dict(batch))["loss"].detach())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, abs(want)))


def test_evaluate_and_train_entry_points_on_cpu(roots, tmp_path):
    """`train --data_root` writes a checkpoint an epoch and its metrics
    stream, and with --num_epochs_to_eval evaluates its last checkpoint;
    `evaluate --ckpt` evaluates it and writes result.pkl."""
    _, proot = roots
    cfg = write_tiny_yaml(tmp_path / "tiny_kitti.yaml", proot, batch=2, epochs=1)
    out = tmp_path / "out"
    train.main(["--cfg_file", str(cfg), "--data_root", str(proot), "--device", "cpu",
                "--workers", "0", "--output_dir", str(out), "--num_epochs_to_eval", "1"])
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    # 3 steps: the first and the last logged, then the epoch's mean loss
    metrics = (out / "metrics.jsonl").read_text()
    assert ckpt.exists() and metrics.count("train/loss") == 2 and "train/mean_loss" in metrics
    assert "eval/Car_3d/moderate_R40" in metrics
    assert (out / "eval" / "eval_with_train" / "epoch_1" / "val" / "eval_summary.json").exists()
    res = evaluate.main(["--cfg_file", str(cfg), "--data_root", str(proot), "--device",
                         "cpu", "--workers", "0", "--ckpt", str(ckpt), "--output_dir",
                         str(out), "--batch_size", "4"])
    assert (out / "eval" / "default" / "result.pkl").exists()
    assert "Car_3d/moderate_R40" in res
