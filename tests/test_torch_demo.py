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
  * the entry point once on the CPU with --device cpu and --ckpt;
  * the same two on the tiny PointPillars with pointpillar.yaml's data
    section on its geometry (torch_kitti_cases.tiny_pointpillar_dataset_cfg:
    0.5 m pillars of 8 points, 512 points a scan), from the committed
    converted JAX init (data/pointpillar_tiny_state.npz) with its conv_cls
    bias at 0;
  * the same two on the tiny Part-A2 with PartA2.yaml's data section on its
    geometry (torch_kitti_cases.tiny_two_stage_dataset_cfg: 256 points a
    scan), from tiny.two_stage_state("parta2"): its labels are the RoIs';
    on the tiny PointRCNN with pointrcnn.yaml's (sample_points at 256,
    no voxels), from tiny.two_stage_state("pointrcnn"); on the tiny PV-RCNN++
    with pv_rcnn_plusplus.yaml's, from tiny.two_stage_state("pvrcnnplusplus");
    on the tiny PVSSDA (PointNet2FSMSG) with pvssda_3dssd.yaml's (sample_points
    at 256), from tiny.two_stage_state("pvssda"); on the tiny DSASNet
    (SparsePointBackbone) with dsasnet.yaml's, from
    tiny.two_stage_state("dsasnet");
    and the entry point alone on the tiny Voxel R-CNN and SECONDNetIoU with
    voxel_rcnn_car.yaml's and second_iou.yaml's data sections (their
    detections are held against the JAX package through the eval loop,
    tests/test_torch_eval_loop_voxel_roi.py);
  * the tiny nuScenes CenterPoint (tiny.centerpoint_nusc_state()) on
    cbgs_voxel01_res3d_centerpoint.yaml's data section on its geometry
    (torch_nuscenes_cases.tiny_dataset_cfg) over `.npy` scans of 5 columns:
    its detections and the entry point; `.bin` scans of the same points are
    read as 4 columns on both sides (the JAX tool's reading, which this
    config cannot take: ROADMAP §C), and the port logs a warning;
  * the tiny Lyft CenterPoint (tiny.centerpoint_lyft_state(): five head
    groups) on the Lyft config's data section on its geometry
    (torch_lyft_cases.tiny_dataset_cfg) over `.npy` scans of 5 columns over
    the +-80 m range: its detections and the entry point.
"""
import importlib.util

import jax
import numpy as np
import pytest
import torch

from tests import torch_lyft_cases as lyft
from tests import torch_nuscenes_cases as nusc
from tests.test_torch_kitti_data import assert_same
from tests.torch_kitti_cases import (CLASSES, tiny_dataset_cfg, tiny_pointpillar_dataset_cfg,
                                     tiny_two_stage_dataset_cfg, write_tiny_yaml)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
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



def _jax_detections(jds, variables, model_cfg=None, num_class=3):
    """The JAX demo's loop (tools/demo.py:111-128) on `jds`."""
    model_cfg = tiny.tiny_model_cfg() if model_cfg is None else model_cfg
    model = jbuild(model_cfg, num_class=num_class, dataset=jds.template)

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


@pytest.fixture(scope="module")
def pp_state():
    """The committed converted JAX tiny PointPillars init, conv_cls bias 0."""
    sd = tiny.load_state(tiny.POINTPILLAR_STATE_PATH)
    sd["module_list.3.conv_cls.bias"] = torch.zeros_like(sd["module_list.3.conv_cls.bias"])
    return sd


def test_pointpillar_detections_equal_jax(scans, pp_state):
    cfg = tiny_pointpillar_dataset_cfg(scans)
    jds = jdemo.DemoDataset(cfg, ["Car"], scans / "bin", ext=".bin")
    pds = demo.DemoDataset(cfg, ["Car"], scans / "bin", ext=".bin")
    for i in range(N_SCANS):
        assert_same(pds.collate(pds[i]), jds.collate(jds[i]), f"batch {i}")
    want = _jax_detections(jds, to_flax_variables(pp_state), tiny.pointpillar_model_cfg(), 1)
    model = build_network(tiny.pointpillar_model_cfg(), 1, pds, device="cpu")
    model.load_state_dict(pp_state, strict=True)
    got = demo.run_demo(model, pds, create_logger())
    assert sum(len(p["pred_labels"]) for p in want) > 0, "no detections to compare"
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["pred_labels"], w["pred_labels"], err_msg=f"scan {i}")
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["pred_boxes"], w["pred_boxes"], rtol=1e-4, atol=1e-4)


def test_pointpillar_entry_point_on_cpu(scans, pp_state, tmp_path, capsys):
    cfg = write_tiny_yaml(tmp_path / "tiny_pointpillar.yaml", scans,
                          model=tiny.pointpillar_model_cfg(),
                          data=tiny_pointpillar_dataset_cfg(scans), classes=["Car"])
    ckpt = tmp_path / "tiny_pointpillar.pth"
    torch.save({"model_state": pp_state, "optimizer_state": {}, "epoch": 1, "it": 3}, ckpt)
    preds, rate = demo.main(["--cfg_file", str(cfg), "--data_path", str(scans / "bin"),
                             "--ckpt", str(ckpt), "--device", "cpu"])
    err = capsys.readouterr().err
    assert "Total number of samples: \t3" in err and f"Loaded checkpoint {ckpt}" in err
    assert err.count(" detections") == N_SCANS and "Demo done" in err
    assert sum(len(p["pred_labels"]) for p in preds) == err.count("  label=") > 0
    assert rate > 0


@pytest.mark.parametrize("which", ["parta2", "pointrcnn", "pvrcnnplusplus", "pvssda",
                                   "dsasnet"])
def test_parta2_detections_equal_jax(scans, which):
    cfg = tiny_two_stage_dataset_cfg(which, scans)
    state = tiny.two_stage_state(which)
    model_cfg = tiny.two_stage_model(which)[0]
    jds = jdemo.DemoDataset(cfg, ["Car"], scans / "bin", ext=".bin")
    pds = demo.DemoDataset(cfg, ["Car"], scans / "bin", ext=".bin")
    for i in range(N_SCANS):
        assert_same(pds.collate(pds[i]), jds.collate(jds[i]), f"batch {i}")
    want = _jax_detections(jds, to_flax_variables(state), model_cfg, 1)
    model = build_network(model_cfg, 1, pds, device="cpu")
    model.load_state_dict(state, strict=True)
    got = demo.run_demo(model, pds, create_logger())
    assert sum(len(p["pred_labels"]) for p in want) > 0, "no detections to compare"
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["pred_labels"], w["pred_labels"], err_msg=f"scan {i}")
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["pred_boxes"], w["pred_boxes"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("which", ["parta2", "pointrcnn", "voxelrcnn", "secondnetiou",
                                   "pvrcnnplusplus", "pvssda", "dsasnet"])
def test_parta2_entry_point_on_cpu(scans, tmp_path, capsys, which):
    cfg = write_tiny_yaml(tmp_path / f"tiny_{which}.yaml", scans,
                          model=tiny.two_stage_model(which)[0],
                          data=tiny_two_stage_dataset_cfg(which, scans), classes=["Car"])
    ckpt = tmp_path / f"tiny_{which}.pth"
    torch.save({"model_state": tiny.two_stage_state(which), "optimizer_state": {},
                "epoch": 1, "it": 3}, ckpt)
    preds, rate = demo.main(["--cfg_file", str(cfg), "--data_path", str(scans / "bin"),
                             "--ckpt", str(ckpt), "--device", "cpu"])
    err = capsys.readouterr().err
    assert "Total number of samples: \t3" in err and f"Loaded checkpoint {ckpt}" in err
    assert err.count(" detections") == N_SCANS and "Demo done" in err
    assert sum(len(p["pred_labels"]) for p in preds) == err.count("  label=") > 0
    assert rate > 0


@pytest.fixture(scope="module")
def nusc_scans(tmp_path_factory):
    """Two nuScenes-like scans of 600 points (x, y, z, intensity, time lag)
    over the +-51.2 m range and past it, each with a car-like cluster, as
    .npy (5 columns) and as .bin of their first 4 columns."""
    base = tmp_path_factory.mktemp("demo_nusc")
    rng = np.random.RandomState(1)
    for ext in ("npy", "bin"):
        (base / ext).mkdir()
    for i in range(2):
        pts = np.zeros((600, 5), np.float32)
        pts[:, 0:2] = rng.uniform(-54, 54, (600, 2))
        pts[:, 2] = rng.uniform(-1.8, 1.0, 600)
        pts[:, 3] = rng.uniform(0, 100, 600)
        pts[:, 4] = rng.randint(0, 10, 600) * 0.05
        pts[:150, 0] = rng.uniform(4 + i, 8.6 + i, 150)
        pts[:150, 1] = rng.uniform(2, 4, 150)
        pts[:150, 2] = rng.uniform(-1.8, -0.2, 150)
        np.save(base / "npy" / f"{i:06d}.npy", pts)
        pts[:, :4].copy().tofile(base / "bin" / f"{i:06d}.bin")
    return base


def test_nuscenes_npy_detections_equal_jax(nusc_scans):
    cfg = nusc.tiny_dataset_cfg(nusc_scans)
    jds = jdemo.DemoDataset(cfg, nusc.CLASSES, nusc_scans / "npy", ext=".npy")
    pds = demo.DemoDataset(cfg, nusc.CLASSES, nusc_scans / "npy", ext=".npy")
    state = tiny.centerpoint_nusc_state()
    want = _jax_detections(jds, to_flax_variables(state), tiny.centerpoint_nusc_model_cfg())
    model = build_network(tiny.centerpoint_nusc_model_cfg(), 3, pds, device="cpu")
    model.load_state_dict(state, strict=True)
    got = demo.run_demo(model, pds, create_logger())
    assert sum(len(p["pred_labels"]) for p in want) > 0, "no detections to compare"
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["pred_labels"], w["pred_labels"], err_msg=f"scan {i}")
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["pred_boxes"], w["pred_boxes"], rtol=1e-4, atol=1e-4)


def test_nuscenes_bin_reads_four_columns(nusc_scans, capsys):
    cfg = nusc.tiny_dataset_cfg(nusc_scans)
    jds = jdemo.DemoDataset(cfg, nusc.CLASSES, nusc_scans / "bin", ext=".bin")
    pds = demo.DemoDataset(cfg, nusc.CLASSES, nusc_scans / "bin", ext=".bin",
                           logger=create_logger())
    assert "reading .bin scans as 4 columns" in capsys.readouterr().err
    for i in range(2):
        jsample, psample = jds[i], pds[i]
        assert_same(psample, jsample, f"scan {i}")
        assert psample["points"].shape[1] == 4


def test_nuscenes_entry_point_on_cpu(nusc_scans, tmp_path, capsys):
    cfg = nusc.write_tiny_yaml(tmp_path / "tiny_nusc.yaml", nusc_scans)
    ckpt = tmp_path / "tiny_nusc.pth"
    torch.save({"model_state": tiny.centerpoint_nusc_state(), "optimizer_state": {},
                "epoch": 1, "it": 3}, ckpt)
    preds, rate = demo.main(["--cfg_file", str(cfg), "--data_path", str(nusc_scans / "npy"),
                             "--ext", ".npy", "--ckpt", str(ckpt), "--device", "cpu"])
    err = capsys.readouterr().err
    assert "Total number of samples: \t2" in err and f"Loaded checkpoint {ckpt}" in err
    assert sum(len(p["pred_labels"]) for p in preds) == err.count("  label=") > 0
    assert all(p["pred_boxes"].shape[-1] == 7 for p in preds) and rate > 0


def test_lyft_npy_detections_equal_jax_and_entry_point(tmp_path, capsys):
    """Two Lyft-like 5-column scans of 800 points over the +-80 m range and
    past it, each with a car-like cluster: the tiny Lyft CenterPoint's
    detections equal the JAX tool's, and the entry point runs on them."""
    rng = np.random.RandomState(2)
    (tmp_path / "npy").mkdir()
    for i in range(2):
        pts = np.zeros((800, 5), np.float32)
        pts[:, 0:2] = rng.uniform(-84, 84, (800, 2))
        pts[:, 2] = rng.uniform(-1.8, 1.0, 800)
        pts[:, 3] = rng.uniform(0, 100, 800)
        pts[:, 4] = rng.randint(0, 5, 800) * 0.1
        pts[:200, 0] = rng.uniform(10 + i, 14.7 + i, 200)
        pts[:200, 1] = rng.uniform(-3, -1, 200)
        pts[:200, 2] = rng.uniform(-1.8, -0.2, 200)
        np.save(tmp_path / "npy" / f"{i:06d}.npy", pts)
    cfg = lyft.tiny_dataset_cfg(tmp_path)
    jds = jdemo.DemoDataset(cfg, lyft.CLASSES, tmp_path / "npy", ext=".npy")
    pds = demo.DemoDataset(cfg, lyft.CLASSES, tmp_path / "npy", ext=".npy")
    state = tiny.centerpoint_lyft_state()
    want = _jax_detections(jds, to_flax_variables(state), tiny.centerpoint_lyft_model_cfg(), 9)
    model = build_network(tiny.centerpoint_lyft_model_cfg(), 9, pds, device="cpu")
    model.load_state_dict(state, strict=True)
    got = demo.run_demo(model, pds, create_logger())
    assert sum(len(p["pred_labels"]) for p in want) > 0, "no detections to compare"
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["pred_labels"], w["pred_labels"], err_msg=f"scan {i}")
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["pred_boxes"], w["pred_boxes"], rtol=1e-4, atol=1e-4)
    cfg_file = lyft.write_tiny_yaml(tmp_path / "tiny_lyft.yaml", tmp_path)
    ckpt = tmp_path / "tiny_lyft.pth"
    torch.save({"model_state": state, "optimizer_state": {}, "epoch": 1, "it": 3}, ckpt)
    capsys.readouterr()
    preds, rate = demo.main(["--cfg_file", str(cfg_file), "--data_path", str(tmp_path / "npy"),
                             "--ext", ".npy", "--ckpt", str(ckpt), "--device", "cpu"])
    err = capsys.readouterr().err
    assert "Total number of samples: \t2" in err and f"Loaded checkpoint {ckpt}" in err
    assert sum(len(p["pred_labels"]) for p in preds) == err.count("  label=") > 0
    assert all(p["pred_boxes"].shape[-1] == 7 for p in preds) and rate > 0
