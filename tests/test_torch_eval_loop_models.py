"""The dataset-driven eval loop and first-batch training loss of the tiny TSM
teacher (fast_cpc_teacher.yaml's data section on its range) and the tiny
SECOND (second.yaml's: the voxel route, no sample_points, on the tiny
SECOND's geometry) against the JAX package, over copies of one synthetic
KITTI root, as tests/test_torch_eval_loop.py holds the tiny student.

Both sides take the committed converted JAX PRNGKey(0) inits
(data/tsm_teacher_tiny_state.npz with tiny.teacher_overrides();
data/second_tiny_state.npz), the flax side through `convert.to_flax_variables`.
So that NMS keeps boxes: the teacher's cls output biases are 1.0 and its
SCORE_THRESH 0.05 for every class (tests/test_torch_teacher.py's), SECOND's
conv_cls bias 0. Tolerances, those
of tests/test_torch_eval_loop.py:
  * `eval_one_ckpt` (6 val frames in batches of 4): the same detections a
    frame, names equal, scores and lidar boxes rtol 1e-4 (atol 1e-4 on boxes);
  * the port's AP dict equal to the JAX `get_official_eval_result` on the
    port's own detections;
  * the loss on the first train-loader batch (seed 0, epoch 0) within
    rtol / atol 1e-4 of the JAX forward's.
"""
import logging
import pickle

import jax
import numpy as np
import pytest
import torch

from tests.test_second_e2e import second_model_cfg as jax_second_cfg
from tests.test_torch_teacher import _jax_teacher_cfg
from tests.torch_kitti_cases import (CLASSES, copy_root, make_root, tiny_dataset_cfg,
                                     tiny_second_dataset_cfg)
from tsm_det_pointcloud_tpu.datasets import DataLoader as JDataLoader
from tsm_det_pointcloud_tpu.datasets.kitti.kitti_dataset import (
    KittiDataset as JKittiDataset,
    create_kitti_infos as jcreate_kitti_infos,
)
from tsm_det_pointcloud_tpu.eval.kitti_eval import get_official_eval_result as jofficial
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.parallel.train_state import device_batch
from tsm_det_pointcloud_tpu.runtime.eval_utils import eval_one_ckpt as jeval_one_ckpt
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.convert import to_flax_variables
from tsm_det_pointcloud_tpu_torch.datasets import DataLoader, build_dataloader
from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import (
    KittiDataset,
    create_kitti_infos,
)
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.runtime.eval_utils import eval_one_ckpt
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict

TEACHER_THRESH = [0.05, 0.05, 0.05]


def _teacher():
    cfg = tiny.tiny_teacher_model_cfg()
    cfg.POST_PROCESSING.SCORE_THRESH = TEACHER_THRESH
    state = tiny.load_state(tiny.TEACHER_STATE_PATH)
    state.update({k: torch.from_numpy(v) for k, v in tiny.teacher_overrides().items()})
    for k in ("cls0_out", "cls1_out", "cls2_out"):
        state[f"module_list.1.head.{k}.bias"] = torch.ones(1)
    return cfg, _jax_teacher_cfg(TEACHER_THRESH), state, _teacher_data, CLASSES


def _teacher_data(root):
    return tiny_dataset_cfg(root, cfg_file="tools/cfgs/kitti_models/fast_cpc_teacher.yaml")


def _second():
    state = tiny.load_state(tiny.SECOND_STATE_PATH)
    state["module_list.4.conv_cls.bias"] = torch.zeros_like(state["module_list.4.conv_cls.bias"])
    return tiny.second_model_cfg(), jax_second_cfg(), state, tiny_second_dataset_cfg, ["Car"]


MODELS = {"teacher": _teacher, "second": _second}



@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("kitti")
    make_root(base / "base")
    jroot = copy_root(base / "base", base / "jax")
    proot = copy_root(base / "base", base / "port")
    jcreate_kitti_infos(tiny_dataset_cfg(jroot), CLASSES, jroot, jroot, workers=1)
    create_kitti_infos(tiny_dataset_cfg(proot), CLASSES, proot, proot, workers=1)
    return jroot, proot


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request, roots, tmp_path_factory):
    """(name, eval results of both sides, the port's val dataset, the model
    configs, the state, the dataset config maker, the classes)."""
    cfg, jcfg, state, data, classes = MODELS[request.param]()
    jroot, proot = roots
    out = tmp_path_factory.mktemp(f"eval_{request.param}")
    logger = logging.getLogger("test_torch_eval_loop_models")
    jds = JKittiDataset(data(jroot), classes, training=False, root_path=jroot)
    jmodel = jbuild(jcfg, num_class=len(classes), dataset=jds)
    jeval_one_ckpt(jmodel, to_flax_variables(state), JDataLoader(jds, 4, prefetch=0), jds,
                   EDict({"CLASS_NAMES": classes}), logger, out / "jax")
    pds = KittiDataset(data(proot), classes, training=False, root_path=proot)
    model = build_network(cfg, len(classes), pds, device="cpu")
    model.load_state_dict(state, strict=True)
    pres = eval_one_ckpt(model, DataLoader(pds, 4), pds, EDict({"CLASS_NAMES": classes}),
                         logger, out / "port")
    annos = []
    for side in ("jax", "port"):
        with open(out / side / "result.pkl", "rb") as f:
            annos.append(pickle.load(f))
    return dict(name=request.param, pres=pres, jannos=annos[0], pannos=annos[1], pds=pds,
                cfg=cfg, jcfg=jcfg, state=state, data=data, classes=classes)


def test_eval_loop_detections_match_jax(case):
    jannos, pannos = case["jannos"], case["pannos"]
    assert [a["frame_id"] for a in pannos] == [a["frame_id"] for a in jannos]
    assert sum(len(a["name"]) for a in pannos) > 0, "no detections to compare"
    for ja, pa in zip(jannos, pannos):
        assert len(pa["name"]) == len(ja["name"]), pa["frame_id"]
        np.testing.assert_array_equal(pa["name"], ja["name"])
        np.testing.assert_allclose(pa["score"], ja["score"], rtol=1e-4)
        np.testing.assert_allclose(pa["boxes_lidar"], ja["boxes_lidar"], rtol=1e-4, atol=1e-4)


def test_eval_loop_ap_dict_is_the_jax_eval(case):
    pds, pres = case["pds"], case["pres"]
    gt = [info["annos"] for info in pds.kitti_infos]
    _, want = jofficial(gt, case["pannos"], case["classes"])
    got = {k: v for k, v in pres.items()
           if k not in ("sec_per_example", "loader_first_wait_s", "loader_wait_s",
                        "scans_per_s")}
    assert got.keys() == want.keys() and len(want) == 24 * len(case["classes"])
    for k in want:
        assert got[k] == want[k], k


def test_first_loader_batch_loss_matches_jax(case, roots):
    _, proot = roots
    classes = case["classes"]
    ds, loader, _ = build_dataloader(case["data"](proot), classes, 2, workers=0, seed=0,
                                     training=True)
    loader.set_epoch(0)
    batch = next(iter(loader))
    jbatch = device_batch({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                           for k, v in batch.items()})
    variables = to_flax_variables(case["state"])
    jmodel = jbuild(case["jcfg"], num_class=len(classes), dataset=ds)
    mutable = [k for k in variables if k != "params"]
    want = float(jax.jit(lambda v, b: jmodel.apply(v, b, training=True, mutable=mutable)[0][
        "loss"])(variables, jbatch))
    model = build_network(case["cfg"], len(classes), ds, device="cpu")
    model.load_state_dict(case["state"], strict=True)
    got = float(model.train()(dict(batch))["loss"].detach())
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, abs(want)))
