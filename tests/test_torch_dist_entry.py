"""The port's `train` and `evaluate` entry points as two processes
(`--launcher pytorch --device cpu`, torchrun's environment set by hand,
gloo) on the tiny TSM over tests/torch_kitti_cases.py's root of 6 frames.

* `train` for one epoch at b1 a process (3 steps of 2 scans): both ranks
  end, rank 0 alone writes the log, the metrics and the checkpoint, and
  prints the epoch line;
* `evaluate --launcher pytorch` on that checkpoint at b1 a process: rank 0's
  result.pkl holds every frame once, in the dataset's order, with the boxes,
  scores and labels of the one-process `evaluate` at b1 (each rank runs the
  same per-scan forward on its frames); rank 1 writes none;
* Waymo's shared-memory preload over 2 ranks (`USE_SHARED_MEMORY`): each
  rank caches every second train frame from its rank, as the JAX
  `_dist_info` stride, every rank sees all of them once its dataset is
  made, and the ranks' cleaning leaves none;
* `train --launcher pytorch` for one epoch on the tiny two-stage detectors
  (Part-A2, PV-RCNN, PointRCNN, Voxel R-CNN, SECONDNetIoU and PV-RCNN++, on
  their configs' data sections on their geometry, road planes and gt
  sampling): rank 0 writes the checkpoint, which loads;
* `train --launcher pytorch` for one epoch on the tiny nuScenes CenterPoint
  over a synthetic nuScenes root (cbgs_voxel01_res3d_centerpoint.yaml's data
  section: CBGS, gt sampling, 10 sweeps): rank 0 writes the checkpoint,
  which loads; `--point_axis 2` refuses it;
* `train --launcher pytorch` for one epoch on the tiny Lyft CenterPoint over
  a synthetic Lyft root (the Lyft config's data section: 5 of 9 sweeps, gt
  sampling): rank 0 writes the checkpoint, which loads;
* `--launcher pytorch` without torchrun's environment raises, and so does
  `--point_axis 2` in one process (the world is not a multiple of 2; for a
  two-stage config, which has no point-sharded layer, whatever the world),
  and `--launcher` in the synthetic-scan mode.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from tests import torch_lyft_cases as lyft
from tests import torch_nuscenes_cases as nusc
from tests.torch_dist_cases import (JOIN_TIMEOUT, free_port, rank_env, run_ranks,
                                    shared_memory_case)
from tests.torch_kitti_cases import (CLASSES, make_root, tiny_dataset_cfg,
                                     tiny_two_stage_dataset_cfg, write_tiny_yaml)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu_torch import evaluate, tiny, train
from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from tsm_det_pointcloud_tpu_torch.infer import ROOT


def _launch(module, flags, world=2):
    """`python -m module flags` as `world` ranks; returns their outputs."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", **rank_env(rank, world, port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"tsm_det_pointcloud_tpu_torch.{module}", *flags],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist")
    root, _ = make_root(base / "root")
    create_kitti_infos(tiny_dataset_cfg(root), CLASSES, root, root, workers=1)
    cfg = write_tiny_yaml(base / "tiny_kitti.yaml", root, batch=1, epochs=1)
    common = ["--cfg_file", str(cfg), "--data_root", str(root), "--device", "cpu",
              "--workers", "0"]
    out_dir = base / "run"
    train_outs = _launch("train", common + ["--launcher", "pytorch", "--output_dir",
                                            str(out_dir)])
    eval_outs = _launch("evaluate", common + ["--launcher", "pytorch", "--output_dir",
                                              str(out_dir), "--eval_tag", "two",
                                              "--batch_size", "1"])
    one = evaluate.main(common + ["--output_dir", str(out_dir), "--eval_tag", "one",
                                  "--batch_size", "1"])
    return dict(base=base, root=root, cfg=cfg, common=common, out_dir=out_dir,
                train_outs=train_outs, eval_outs=eval_outs, one=one)


def test_train_rank0_alone_writes(setup):
    out_dir = setup["out_dir"]
    assert sorted(p.name for p in (out_dir / "ckpt").iterdir()) == ["checkpoint_epoch_1.pth"]
    assert len(list(out_dir.glob("log_train_*.txt"))) == 1
    rows = (out_dir / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 3    # steps 0 and 2 (the first and the last), the epoch's mean
    rank0, rank1 = setup["train_outs"]
    assert "epoch 1/1: mean loss" in rank0 and "train scans/s" in rank0
    assert "epoch 1/1" not in rank1
    assert "2 process(es), 2 data shard(s)" in next(out_dir.glob("log_train_*.txt")).read_text()


def test_sharded_eval_equals_one_process(setup):
    out_dir = setup["out_dir"]
    with open(out_dir / "eval" / "two" / "result.pkl", "rb") as f:
        two = pickle.load(f)
    with open(out_dir / "eval" / "one" / "result.pkl", "rb") as f:
        one = pickle.load(f)
    assert [a["frame_id"] for a in two] == [a["frame_id"] for a in one]
    assert len(one) == 6
    for a, b in zip(two, one):
        assert set(a) == set(b)
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(a[k], v, err_msg=k)
            else:
                assert a[k] == v, k
    assert "Car_3d/moderate_R40" in setup["one"]
    rank0, rank1 = setup["eval_outs"]
    assert "AP (3d, R40)" in rank0 and "AP (3d, R40)" not in rank1


def test_waymo_shared_memory_strided_over_ranks(tmp_path):
    from tests.torch_waymo_cases import WAYMO_BASE, create_infos, dataset_cfg, make_root
    from tsm_det_pointcloud_tpu_torch.datasets.waymo.waymo_dataset import create_waymo_infos

    root = make_root(tmp_path / "waymo")
    create_infos(create_waymo_infos, dataset_cfg(WAYMO_BASE, root), root)
    shm, out = tmp_path / "shm", tmp_path / "ranks"
    shm.mkdir()
    out.mkdir()
    ranks = run_ranks(shared_memory_case, (root, str(shm)), out)
    keys = ranks[0]["keys"]
    assert len(keys) == 4
    files = sorted(k + ".npy" for k in keys)
    for r, res in enumerate(ranks):
        assert res["seen"] == files and res["left"] == []
        assert res["mine"] == keys[r::2]


def test_missing_environment_raises(setup, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        train.main(setup["common"] + ["--launcher", "pytorch"])
    with pytest.raises(RuntimeError, match="RANK is not set"):
        evaluate.main(setup["common"] + ["--launcher", "jax"])


def test_point_axis_needs_a_multiple_of_ranks(setup):
    with pytest.raises(ValueError, match="not divisible by points=2"):
        evaluate.main(setup["common"] + ["--point_axis", "2", "--output_dir",
                                         str(setup["base"] / "pax")])


def _two_stage_yaml(setup, which):
    model = tiny.two_stage_model(which)[0]
    return write_tiny_yaml(setup["base"] / f"tiny_{which}.yaml", setup["root"], batch=1,
                           epochs=1, model=model, classes=["Car"],
                           data=tiny_two_stage_dataset_cfg(which, setup["root"]))


@pytest.mark.parametrize("which", ["parta2", "pvrcnn", "pointrcnn", "voxelrcnn", "secondnetiou",
                                   "pvrcnnplusplus", "pvssda", "dsasnet"])
def test_two_stage_trains_over_two_ranks(setup, which):
    import torch

    from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import load_model_state

    cfg = _two_stage_yaml(setup, which)
    out_dir = setup["base"] / f"run_{which}"
    rank0, rank1 = _launch("train", ["--cfg_file", str(cfg), "--data_root", str(setup["root"]),
                                     "--device", "cpu", "--workers", "0", "--launcher",
                                     "pytorch", "--output_dir", str(out_dir)])
    assert "epoch 1/1: mean loss" in rank0 and "epoch 1/1" not in rank1
    ckpt = out_dir / "ckpt" / "checkpoint_epoch_1.pth"
    model_cfg, meta = tiny.two_stage_model(which)
    from tsm_det_pointcloud_tpu_torch.models import build_network

    model = build_network(model_cfg, 1, meta, device="cpu")
    model.load_state_dict(load_model_state(ckpt), strict=True)
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())


def test_two_stage_refuses_point_axis(setup):
    with pytest.raises(ValueError, match="PartA2Net has no such layer"):
        train.main(["--cfg_file", str(_two_stage_yaml(setup, "parta2")), "--data_root",
                    str(setup["root"]), "--device", "cpu", "--workers", "0",
                    "--point_axis", "2", "--output_dir", str(setup["base"] / "pax2")])


def test_pointrcnn_refuses_point_axis(setup):
    with pytest.raises(ValueError, match="PointRCNN has no such layer"):
        train.main(["--cfg_file", str(_two_stage_yaml(setup, "pointrcnn")), "--data_root",
                    str(setup["root"]), "--device", "cpu", "--workers", "0",
                    "--point_axis", "2", "--output_dir", str(setup["base"] / "pax2_pointrcnn")])


@pytest.mark.parametrize("which,name", [("voxelrcnn", "VoxelRCNN"),
                                        ("secondnetiou", "SECONDNetIoU"),
                                        ("pvrcnnplusplus", "PVRCNNPlusPlus")])
def test_voxel_roi_refuses_point_axis(setup, which, name):
    with pytest.raises(ValueError, match=f"{name} has no such layer"):
        train.main(["--cfg_file", str(_two_stage_yaml(setup, which)), "--data_root",
                    str(setup["root"]), "--device", "cpu", "--workers", "0",
                    "--point_axis", "2", "--output_dir", str(setup["base"] / f"pax2_{which}")])


@pytest.fixture(scope="module")
def nusc_setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_nusc")
    root = nusc.port_infos(nusc.make_root(base / "root"))
    return base, root, nusc.write_tiny_yaml(base / "tiny_nusc.yaml", root, batch=1, epochs=1)


def test_nuscenes_centerpoint_trains_over_two_ranks(nusc_setup):
    import torch

    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import load_model_state

    base, root, cfg = nusc_setup
    rank0, rank1 = _launch("train", ["--cfg_file", str(cfg), "--data_root", str(root),
                                     "--device", "cpu", "--workers", "0", "--launcher",
                                     "pytorch", "--output_dir", str(base / "run")])
    assert "epoch 1/1: mean loss" in rank0 and "epoch 1/1" not in rank1
    model = build_network(tiny.centerpoint_nusc_model_cfg(), 3, tiny.CENTERPOINT_NUSC_META,
                          device="cpu")
    model.load_state_dict(load_model_state(base / "run" / "ckpt" / "checkpoint_epoch_1.pth"),
                          strict=True)
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())


def test_nuscenes_centerpoint_refuses_point_axis(nusc_setup):
    base, root, cfg = nusc_setup
    with pytest.raises(ValueError, match="CenterPoint has no such layer"):
        train.main(["--cfg_file", str(cfg), "--data_root", str(root), "--device", "cpu",
                    "--workers", "0", "--point_axis", "2", "--output_dir", str(base / "pax2")])


def test_lyft_centerpoint_trains_over_two_ranks(tmp_path):
    import torch

    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import load_model_state

    root = lyft.port_infos(lyft.make_base(tmp_path / "base") / "trainval")
    cfg = lyft.write_tiny_yaml(tmp_path / "tiny_lyft.yaml", root, batch=1, epochs=1)
    rank0, rank1 = _launch("train", ["--cfg_file", str(cfg), "--data_root", str(root),
                                     "--device", "cpu", "--workers", "0", "--launcher",
                                     "pytorch", "--output_dir", str(tmp_path / "run")])
    assert "epoch 1/1: mean loss" in rank0 and "epoch 1/1" not in rank1
    model = build_network(tiny.centerpoint_lyft_model_cfg(), 9, tiny.CENTERPOINT_LYFT_META,
                          device="cpu")
    model.load_state_dict(load_model_state(tmp_path / "run" / "ckpt" / "checkpoint_epoch_1.pth"),
                          strict=True)
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())


def test_synthetic_mode_stays_single_process():
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--launcher", "pytorch"])
