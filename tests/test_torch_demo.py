"""The port's `demo` against the JAX package's tools/demo.py on the CPU, on
the tiny TSM with fast_cpc.yaml's data section on its range
(torch_kitti_cases.tiny_dataset_cfg: 256 points a scan) and a few raw
scans written from a seed, `.bin` and `.npy`, of 400 points each (some
out of range, so that the range mask and sample_points' draw both work):

  * `DemoDataset`'s samples and single-scan batches equal the JAX
    DemoDataset's (the same numpy from the same generator stream);
  * the detections a scan: both sides take the committed converted JAX tiny
    init (data/tsm_tiny_state.npz; the flax side gets it back through
    `convert.to_flax_variables`) with seeded class statistics and the
    student's cls output biases at 1.0, so that NMS keeps boxes; labels
    equal, scores and boxes rtol 1e-4 and atol 1e-4
    (tests/test_torch_eval_loop.py's);
  * the entry point once on the CPU with --device cpu and --ckpt.
"""
import importlib.util

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_kitti_data import assert_same
from tests.torch_kitti_cases import CLASSES, tiny_dataset_cfg, write_tiny_yaml
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu_torch import demo, tiny
from tsm_det_pointcloud_tpu_torch.convert import to_flax_variables
from tsm_det_pointcloud_tpu_torch.infer import ROOT
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.utils.common_utils import create_logger

_spec = importlib.util.spec_from_file_location("jax_tools_demo", ROOT / "tools" / "demo.py")
jdemo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jdemo)

N_SCANS, N_POINTS = 3, 400


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """A directory of .bin scans and one of .npy scans (the same points):
    uniform in the tiny range and 2 m around it, with a car-like cluster."""
    base = tmp_path_factory.mktemp("demo")
    rng = np.random.RandomState(0)
    for ext in (".bin", ".npy"):
        (base / ext[1:]).mkdir()
    for i in range(N_SCANS):
        pts = np.zeros((N_POINTS, 4), np.float32)
        pts[:, 0] = rng.uniform(-2, 18, N_POINTS)
        pts[:, 1] = rng.uniform(-10, 10, N_POINTS)
        pts[:, 2] = rng.uniform(-1.8, 1.0, N_POINTS)
        pts[:, 3] = rng.uniform(0, 1, N_POINTS)
        pts[:120, 0] = rng.uniform(6 + i, 10 + i, 120)
        pts[:120, 1] = rng.uniform(-1, 1, 120)
        pts[:120, 2] = rng.uniform(-1.6, -0.2, 120)
        pts.tofile(base / "bin" / f"{i:06d}.bin")
        np.save(base / "npy" / f"{i:06d}.npy", pts)
    return base


def _datasets(scans, ext):
    cfg = tiny_dataset_cfg(scans)
    path = scans / ext[1:]
    return (jdemo.DemoDataset(cfg, CLASSES, path, ext=ext),
            demo.DemoDataset(cfg, CLASSES, path, ext=ext))


@pytest.mark.parametrize("ext", [".bin", ".npy"])
def test_samples_equal_jax(scans, ext):
    jds, pds = _datasets(scans, ext)
    assert pds.sample_file_list == jds.sample_file_list and len(pds) == N_SCANS
    for i in range(N_SCANS):
        jsample, psample = jds[i], pds[i]
        assert_same(psample, jsample, f"scan {i}")
        assert_same(pds.collate(psample), jds.collate(jsample), f"batch {i}")
    one = demo.DemoDataset(tiny_dataset_cfg(scans), CLASSES, pds.sample_file_list[1], ext=ext)
    assert one.sample_file_list == [pds.sample_file_list[1]]


@pytest.fixture(scope="module")
def state():
    """The committed converted JAX tiny init with seeded statistics and the
    student's cls output biases at 1.0."""
    sd = tiny.load_state()
    for k, v in tiny.train_statistics().items():
        sd[f"module_list.1.{k}"] = torch.from_numpy(v)
    for k in ("cls0_out", "cls1_out", "cls2_out"):
        sd[f"module_list.1.s_head.{k}.bias"] = torch.ones_like(sd[f"module_list.1.s_head.{k}.bias"])
    return sd



def _jax_detections(jds, variables):
    """The JAX demo's loop (tools/demo.py:111-128) on `jds`."""
    model = jbuild(tiny.tiny_model_cfg(), num_class=3, dataset=jds.template)

    @jax.jit
    def infer(v, b):
        out = model.apply(v, b, training=False)
        pred, _ = model.apply(v, out, method=lambda m, bd: m.post_processing(bd))
        return pred

    preds = []
    for idx in range(len(jds)):
        batch = jds.collate(jds[idx])
        batch = {k: v for k, v in batch.items() if k != "frame_id"}
        pred = jax.device_get(infer(variables, batch))
        cnt = int(pred["count"][0])
        preds.append({k: np.asarray(pred[k][0][:cnt])
                      for k in ("pred_boxes", "pred_scores", "pred_labels")})
    return preds


def test_detections_equal_jax(scans, state):
    jds, pds = _datasets(scans, ".bin")
    want = _jax_detections(jds, to_flax_variables(state))
    model = build_network(tiny.tiny_model_cfg(), 3, pds, device="cpu")
    model.load_state_dict(state, strict=True)
    got = demo.run_demo(model, pds, create_logger())
    assert sum(len(p["pred_labels"]) for p in want) > 0, "no detections to compare"
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["pred_labels"], w["pred_labels"], err_msg=f"scan {i}")
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["pred_boxes"], w["pred_boxes"], rtol=1e-4, atol=1e-4)


def test_entry_point_on_cpu(scans, state, tmp_path, capsys):
    cfg = write_tiny_yaml(tmp_path / "tiny_kitti.yaml", scans)
    ckpt = tmp_path / "tiny.pth"
    torch.save({"model_state": state, "optimizer_state": {}, "epoch": 1, "it": 3}, ckpt)
    preds, rate = demo.main(["--cfg_file", str(cfg), "--data_path", str(scans / "bin"),
                       "--ckpt", str(ckpt), "--device", "cpu"])
    err = capsys.readouterr().err
    assert "Total number of samples: \t3" in err and f"Loaded checkpoint {ckpt}" in err
    assert err.count(" detections") == N_SCANS and "Demo done" in err
    assert sum(len(p["pred_labels"]) for p in preds) == err.count("  label=") > 0
    assert rate > 0
