"""The port stands alone: it imports neither JAX, flax nor the JAX package;
its entry points refuse CUDA on a host without a card unless device="cpu"
is given; the weight converter consumes every leaf of a training init."""
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tsm_det_pointcloud_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|tsm_det_pointcloud_tpu)\b",
                       re.MULTILINE)


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        mods.append(".".join(rel.parts).removesuffix(".__init__"))
    return mods


def test_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'flax', 'tsm_det_pointcloud_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + list(PORT.rglob("*.cu")) + list(PORT.rglob("*.cpp")) + [ROOT / "chip_smoke.py"]))
def test_no_jax_import_in_source(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), path


def test_entry_points_refuse_cuda_without_card(monkeypatch):
    from tsm_det_pointcloud_tpu_torch import infer, tiny, train
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.utils.common_utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_network(tiny.tiny_model_cfg(), 3, tiny.META)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--batch", "1", "--points", "64", "--iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--batch", "1", "--points", "64", "--steps", "1"])
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_dataset_entry_points_refuse_cuda_without_card(monkeypatch, tmp_path):
    """`evaluate` and `train --data_root` default to the card too, and
    refuse a host without one before they read any data."""
    from tsm_det_pointcloud_tpu_torch import evaluate, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--data_root", str(tmp_path), "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--data_root", str(tmp_path), "--output_dir", str(tmp_path)])


def test_waymo_entry_points_refuse_cuda_without_card(monkeypatch, tmp_path):
    """The same on waymo_fast_cpc.yaml, with `--set`: the Waymo data path
    defaults to the card and refuses a host without one."""
    from tsm_det_pointcloud_tpu_torch import evaluate, train

    cfg = str(ROOT / "tools/cfgs/waymo_models/waymo_fast_cpc.yaml")
    flags = ["--cfg_file", cfg, "--data_root", str(tmp_path), "--output_dir", str(tmp_path),
             "--set", "DATA_CONFIG.SAMPLED_INTERVAL.train", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(flags)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(flags)


def test_demo_refuses_cuda_without_card(monkeypatch, tmp_path):
    """`demo` defaults to the card too, and refuses a host without one
    before it reads a scan."""
    from tsm_det_pointcloud_tpu_torch import demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main(["--data_path", str(tmp_path)])


def test_teacher_entry_points_refuse_cuda_without_card(monkeypatch):
    """`infer` and `train` on fast_cpc_teacher.yaml default to the card
    too, and refuse a host without one."""
    from tsm_det_pointcloud_tpu_torch import infer, train

    cfg = str(ROOT / "tools/cfgs/kitti_models/fast_cpc_teacher.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--cfg_file", cfg, "--batch", "1", "--points", "64", "--iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--cfg_file", cfg, "--batch", "1", "--points", "64", "--steps", "1"])


def test_other_models_raise():
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.models import build_network

    cfg = tiny.tiny_model_cfg()
    cfg["NAME"] = "PointPillar"
    with pytest.raises(NotImplementedError):
        build_network(cfg, 3, tiny.META, device="cpu")
    # train mode is ported, and asks for the gt boxes it trains on
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    model.train()
    with pytest.raises(ValueError, match="gt_boxes"):
        model({"points": torch.from_numpy(tiny.synth_points(1)),
               "points_mask": torch.ones(1, 256, dtype=torch.bool)})


def test_converter_consumes_every_eval_leaf():
    import __graft_entry__ as ge
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
    from tsm_det_pointcloud_tpu_torch.models import build_network

    model = ge._tsm_model()
    batch = ge._synth_batch(2, with_gt=True, seed=0)
    shapes = jax.eval_shape(
        lambda b: model.init(jax.random.PRNGKey(0), b, training=True), dict(batch))
    variables = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    state = from_flax_variables(variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(state) == n_leaves
    port = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    # strict: every port tensor is given and every converted leaf is used,
    # the teacher's SA layer 1 and head included
    port.load_state_dict(state, strict=True)
    assert any(k.startswith("module_list.0.sa1.") for k in state)
    assert "module_list.1.head.reg_weight" in state
    with pytest.raises(ValueError):
        from_flax_variables({"params": {"module_list_0": {"sa0": {"odd": {
            "leaf": np.zeros((2, 2, 2, 2), np.float32)}}}}})


def test_second_trains_and_only_pointpillars_raises():
    """SECOND builds on the CPU and its training forward returns a finite
    loss with its tb terms; the PointPillars topology is not ported and
    raises."""
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.models import build_network

    model = build_network(tiny.second_model_cfg(), 1, tiny.SECOND_META, device="cpu")
    assert [type(m).__name__ for m in model.module_list] == [
        "MeanVFE", "VoxelBackBone8x", "HeightCompression", "BaseBEVBackbone",
        "AnchorHeadSingle"]
    gt, gt_mask = tiny.second_gt(1)
    batch = {"points": torch.from_numpy(tiny.second_points(1)),
             "points_mask": torch.ones(1, 512, dtype=torch.bool), "batch_size": 1,
             "gt_boxes": torch.from_numpy(gt), "gt_boxes_mask": torch.from_numpy(gt_mask)}
    out = model.train()(batch)
    assert torch.isfinite(out["loss"])
    assert set(out["tb_dict"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss"}
    cfg = tiny.second_model_cfg()
    cfg["NAME"] = "PointPillar"
    cfg["VFE"] = {"NAME": "PillarVFE"}
    cfg["MAP_TO_BEV"] = {"NAME": "PointPillarScatter", "NUM_BEV_FEATURES": 64}
    with pytest.raises(NotImplementedError):
        build_network(cfg, 1, tiny.SECOND_META, device="cpu")
    cfg = tiny.second_model_cfg()
    cfg["VFE"] = {"NAME": "PillarVFE"}
    with pytest.raises(NotImplementedError, match="PillarVFE"):
        build_network(cfg, 1, tiny.SECOND_META, device="cpu")
