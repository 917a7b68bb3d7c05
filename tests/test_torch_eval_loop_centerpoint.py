"""The dataset-driven eval loop and first-batch training loss of the tiny CenterPoint
against the JAX package (tests/torch_eval_loop_cases.py: the states, data
sections and tolerances), and of the tiny nuScenes CenterPoint on a synthetic
nuScenes root (tests/torch_nuscenes_cases.py: cbgs_voxel01_res3d_centerpoint.yaml's
data section on the tiny model's geometry, `tiny.centerpoint_nusc_state()`):
`eval_one_ckpt` over the val split (3 frames in batches of 2) gives the JAX
loop's detections (names equal, scores and boxes rtol 1e-4) and an NDS dict
equal to the JAX evaluation of the port's own detections, the `evaluate`
entry point with a checkpoint of that state returns the same dict, and the
first train-loader batch (CBGS, gt sampling, the world augmentors; the
points' order differs from the JAX loader's, the voxels' means not) gives the
JAX forward's loss within rtol 1e-4."""
import logging
import pickle

import jax
import numpy as np
import pytest
import torch

from tests import torch_eval_loop_cases as cases
from tests import torch_nuscenes_cases as nusc
from tests.torch_eval_loop_cases import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.datasets import DataLoader as JDataLoader
from tsm_det_pointcloud_tpu.datasets.nuscenes.nuscenes_dataset import (
    NuScenesDataset as JNuScenesDataset,
)
from tsm_det_pointcloud_tpu.eval.nuscenes_eval import nuscenes_evaluation as jnds
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.parallel.train_state import device_batch
from tsm_det_pointcloud_tpu.runtime.eval_utils import eval_one_ckpt as jeval_one_ckpt
from tsm_det_pointcloud_tpu_torch import evaluate, tiny
from tsm_det_pointcloud_tpu_torch.convert import to_flax_variables
from tsm_det_pointcloud_tpu_torch.datasets import DataLoader, build_dataloader
from tsm_det_pointcloud_tpu_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.runtime.eval_utils import eval_one_ckpt
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict

TIMING = ("sec_per_example", "loader_first_wait_s", "loader_wait_s", "scans_per_s")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return cases.make_roots(tmp_path_factory)


@pytest.fixture(scope="module", params=['centerpoint'])
def case(request, roots, tmp_path_factory):
    return cases.run_case(request.param, roots, tmp_path_factory)


def test_eval_loop_detections_match_jax(case):
    cases.check_detections_match_jax(case)


def test_eval_loop_ap_dict_is_the_jax_eval(case):
    cases.check_ap_dict_is_the_jax_eval(case)


def test_first_loader_batch_loss_matches_jax(case, roots):
    cases.check_first_loader_batch_loss_matches_jax(case, roots)


@pytest.fixture(scope="module")
def nusc_case(tmp_path_factory):
    jroot, proot = nusc.make_roots(tmp_path_factory)
    out = tmp_path_factory.mktemp("eval_nusc")
    logger = logging.getLogger("test_torch_eval_loop_centerpoint")
    state = tiny.centerpoint_nusc_state()
    cfg = EDict({"CLASS_NAMES": nusc.CLASSES})
    jds = JNuScenesDataset(nusc.tiny_dataset_cfg(jroot), nusc.CLASSES, training=False)
    jmodel = jbuild(tiny.centerpoint_nusc_model_cfg(), num_class=3, dataset=jds)
    jeval_one_ckpt(jmodel, to_flax_variables(state), JDataLoader(jds, 2, prefetch=0), jds, cfg,
                   logger, out / "jax")
    pds = NuScenesDataset(nusc.tiny_dataset_cfg(proot), nusc.CLASSES, training=False)
    model = build_network(tiny.centerpoint_nusc_model_cfg(), 3, pds, device="cpu")
    model.load_state_dict(state, strict=True)
    pres = eval_one_ckpt(model, DataLoader(pds, 2), pds, cfg, logger, out / "port")
    annos = []
    for side in ("jax", "port"):
        with open(out / side / "result.pkl", "rb") as f:
            annos.append(pickle.load(f))
    return dict(roots=(jroot, proot), out=out, state=state, pds=pds, pres=pres,
                jannos=annos[0], pannos=annos[1])


def test_nusc_eval_loop_detections_match_jax(nusc_case):
    jannos, pannos = nusc_case["jannos"], nusc_case["pannos"]
    assert len(pannos) == len(jannos) == 3
    assert sum(len(a["name"]) for a in pannos) > 0, "no detections to compare"
    for ja, pa in zip(jannos, pannos):
        assert pa["metadata"] == ja["metadata"]
        np.testing.assert_array_equal(pa["name"], ja["name"])
        np.testing.assert_allclose(pa["score"], ja["score"], rtol=1e-4)
        np.testing.assert_allclose(pa["boxes_lidar"], ja["boxes_lidar"], rtol=1e-4, atol=1e-4)


def test_nusc_eval_loop_nds_dict_is_the_jax_eval(nusc_case, tmp_path):
    pds, pres = nusc_case["pds"], nusc_case["pres"]
    gt = [{"name": np.asarray(i["gt_names"], object), "gt_boxes_lidar": i["gt_boxes"],
           "num_lidar_pts": i["num_lidar_pts"]} for i in pds.infos]
    _, want = jnds(gt, nusc_case["pannos"], nusc.CLASSES)
    got = {k: v for k, v in pres.items() if k not in TIMING}
    assert got == want and "NDS" in got and got["mAVE"] == 1.0
    # the entry point, on a checkpoint of the same state
    ckpt = tmp_path / "ckpt.pth"
    torch.save({"model_state": nusc_case["state"], "optimizer_state": {}, "epoch": 0, "it": 0},
               ckpt)
    cfg_file = nusc.write_tiny_yaml(tmp_path / "tiny_nusc.yaml", nusc_case["roots"][1])
    res = evaluate.main(["--cfg_file", str(cfg_file), "--data_root", str(nusc_case["roots"][1]),
                         "--ckpt", str(ckpt), "--device", "cpu", "--batch_size", "2",
                         "--workers", "0", "--output_dir", str(tmp_path / "out")])
    assert {k: v for k, v in res.items() if k not in TIMING} == want


def test_nusc_first_loader_batch_loss_matches_jax(nusc_case):
    _, proot = nusc_case["roots"]
    ds, loader, _ = build_dataloader(nusc.tiny_dataset_cfg(proot), nusc.CLASSES, 2, workers=0,
                                     seed=0, training=True)
    loader.set_epoch(0)
    batch = next(iter(loader))
    assert batch["gt_boxes"].shape[-1] == 10 and batch["points"].shape[-1] == 5
    jbatch = device_batch({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                           for k, v in batch.items()})
    variables = to_flax_variables(nusc_case["state"])
    jmodel = jbuild(tiny.centerpoint_nusc_model_cfg(), num_class=3, dataset=ds)
    want = float(jax.jit(lambda v, b: jmodel.apply(v, b, training=True,
                                                   mutable=["batch_stats"])[0]["loss"])(
        variables, jbatch))
    model = build_network(tiny.centerpoint_nusc_model_cfg(), 3, ds, device="cpu")
    model.load_state_dict(nusc_case["state"], strict=True)
    got = float(model.train()(dict(batch))["loss"].detach())
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, abs(want)))
