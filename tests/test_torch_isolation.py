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
    cfg["NAME"] = "NoSuchDetector"           # a NAME missing from the JAX registry
    with pytest.raises(NotImplementedError):
        build_network(cfg, 3, tiny.META, device="cpu")
    assert type(build_network(tiny.dsasnet_model_cfg(), 1, tiny.DSASNET_META,
                              device="cpu")).__name__ == "DSASNet"
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


def test_second_trains_and_unported_topologies_raise():
    """SECOND builds on the CPU and its training forward returns a finite
    loss with its tb terms; an unported detector (DSASNet) raises, and so does
    a module that the SECOND topology does not take."""
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
    cfg["NAME"] = "NoSuchDetector"
    with pytest.raises(NotImplementedError, match="NoSuchDetector"):
        build_network(cfg, 1, tiny.SECOND_META, device="cpu")
    cfg["NAME"] = "DSASNet"          # DSASNet's generic topology takes SECOND's modules
    assert type(build_network(cfg, 1, tiny.SECOND_META, device="cpu")).__name__ == "DSASNet"
    cfg = tiny.second_model_cfg()
    cfg["VFE"] = {"NAME": "PillarVFE"}
    with pytest.raises(NotImplementedError, match="PillarVFE"):
        build_network(cfg, 1, tiny.SECOND_META, device="cpu")


def test_parallel_modules_are_covered():
    """The multi-process modules are among those imported without JAX above
    and scanned for JAX imports."""
    mods = _port_modules()
    for name in ("comm", "train_state", "point_sharding"):
        assert f"tsm_det_pointcloud_tpu_torch.parallel.{name}" in mods
        assert (PORT / "parallel" / f"{name}.py").exists()


def test_zoo_modules_are_covered():
    """PointPillars' and CenterPoint's modules are among those imported
    without JAX above and scanned for JAX imports."""
    mods = _port_modules()
    for name in ("models.backbones_3d.vfe", "models.backbones_2d.map_to_bev",
                 "models.backbones_3d.spconv_backbone", "models.model_utils.centernet_utils",
                 "models.dense_heads.center_head", "models.detectors.pointpillar",
                 "models.detectors.centerpoint", "ops.loss_utils"):
        assert f"tsm_det_pointcloud_tpu_torch.{name}" in mods
        assert (PORT / (name.replace(".", "/") + ".py")).exists()


def test_two_stage_modules_are_covered():
    """Part-A2's and PV-RCNN's modules are among those imported without JAX
    above and scanned for JAX imports."""
    mods = _port_modules()
    for name in ("models.roi_heads.roi_head_template", "models.roi_heads.partA2_head",
                 "models.roi_heads.pvrcnn_head", "models.backbones_3d.spconv_unet",
                 "models.backbones_3d.pfe.voxel_set_abstraction",
                 "models.dense_heads.point_intra_part_head",
                 "models.dense_heads.point_head_simple", "models.detectors.two_stage",
                 "models.detectors.pv_rcnn"):
        assert f"tsm_det_pointcloud_tpu_torch.{name}" in mods
        assert (PORT / (name.replace(".", "/") + ".py")).exists()


def test_pointrcnn_modules_are_covered():
    """PointRCNN's modules are among those imported without JAX above and
    scanned for JAX imports."""
    mods = _port_modules()
    for name in ("models.backbones_3d.pointnet2_backbone", "models.backbones_3d.pointnet2_modules",
                 "models.dense_heads.point_head_box", "models.roi_heads.pointrcnn_head",
                 "ops.grouping", "ops.box_coder_utils"):
        assert f"tsm_det_pointcloud_tpu_torch.{name}" in mods
        assert (PORT / (name.replace(".", "/") + ".py")).exists()


def test_pointrcnn_data_entry_points_refuse_cuda_without_card(monkeypatch, tmp_path):
    """`evaluate`, `train --data_root` (also under --launcher) and `demo` on
    pointrcnn.yaml default to the card too, and refuse a host without one."""
    from tsm_det_pointcloud_tpu_torch import demo, evaluate, train

    cfg = str(ROOT / "tools/cfgs/kitti_models/pointrcnn.yaml")
    flags = ["--cfg_file", cfg, "--data_root", str(tmp_path), "--output_dir", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(flags)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(flags)
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(flags + ["--launcher", "pytorch"])
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main(["--cfg_file", cfg, "--data_path", str(tmp_path)])


def test_voxel_roi_modules_are_covered():
    """Voxel R-CNN's and SECONDNetIoU's RoI heads are among the modules
    imported without JAX above and scanned for JAX imports."""
    mods = _port_modules()
    for name in ("models.roi_heads.voxelrcnn_head", "models.roi_heads.second_head"):
        assert f"tsm_det_pointcloud_tpu_torch.{name}" in mods
        assert (PORT / (name.replace(".", "/") + ".py")).exists()


def test_pvrcnnplusplus_modules_are_covered():
    """PV-RCNN++'s module (sector d-fps and VectorPool) and its detector's
    are among those imported without JAX above and scanned for JAX
    imports."""
    mods = _port_modules()
    for name in ("models.backbones_3d.pfe.vector_pool", "models.detectors.pv_rcnn"):
        assert f"tsm_det_pointcloud_tpu_torch.{name}" in mods
        assert (PORT / (name.replace(".", "/") + ".py")).exists()


def test_two_stage_entry_points_refuse_cuda_without_card(monkeypatch):
    """`infer` and `train` on PartA2.yaml, pvrcnn.yaml, pointrcnn.yaml,
    voxel_rcnn_car.yaml, second_iou.yaml, pv_rcnn_plusplus.yaml,
    pvssda_3dssd.yaml and dsasnet.yaml default to the card too, and refuse a
    host without one; a detector NAME missing from the JAX registry (on the
    PV-RCNN modules and on SECONDHead's) raises in build_network, and
    DSASNet builds."""
    from tsm_det_pointcloud_tpu_torch import infer, tiny, train
    from tsm_det_pointcloud_tpu_torch.models import build_network

    for cfg in (tiny.pvrcnn_model_cfg(), tiny.secondnetiou_model_cfg()):
        cfg["NAME"] = "NoSuchDetector"
        with pytest.raises(NotImplementedError, match="NoSuchDetector"):
            build_network(cfg, 1, tiny.PVRCNN_META, device="cpu")
    assert type(build_network(tiny.dsasnet_model_cfg(), 1, tiny.DSASNET_META,
                              device="cpu")).__name__ == "DSASNet"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("PartA2", "pvrcnn", "pointrcnn", "voxel_rcnn_car", "second_iou",
                 "pv_rcnn_plusplus", "pvssda_3dssd", "dsasnet"):
        cfg = str(ROOT / f"tools/cfgs/kitti_models/{name}.yaml")
        with pytest.raises(RuntimeError, match="CUDA"):
            infer.main(["--cfg_file", cfg, "--batch", "1", "--points", "64", "--iters", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--cfg_file", cfg, "--batch", "1", "--points", "64", "--steps", "1"])


def test_zoo_entry_points_refuse_cuda_without_card(monkeypatch):
    """`infer` and `train` on pointpillar.yaml and centerpoint.yaml default
    to the card too, and refuse a host without one."""
    from tsm_det_pointcloud_tpu_torch import infer, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("pointpillar", "centerpoint"):
        cfg = str(ROOT / f"tools/cfgs/kitti_models/{name}.yaml")
        with pytest.raises(RuntimeError, match="CUDA"):
            infer.main(["--cfg_file", cfg, "--batch", "1", "--points", "64", "--iters", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--cfg_file", cfg, "--batch", "1", "--points", "64", "--steps", "1"])


def test_launcher_refuses_cuda_without_card(monkeypatch, tmp_path):
    """`--launcher` on the card's default device resolves it first: a host
    without a card raises before any process group is joined."""
    from tsm_det_pointcloud_tpu_torch import evaluate, train
    from tsm_det_pointcloud_tpu_torch.parallel import comm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        comm.init_distributed("pytorch", "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--data_root", str(tmp_path), "--output_dir", str(tmp_path),
                       "--launcher", "pytorch"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--data_root", str(tmp_path), "--output_dir", str(tmp_path),
                    "--launcher", "slurm"])
    assert comm.get_world_size() == 1


def test_lyft_pandaset_modules_are_covered():
    """The Lyft and PandaSet modules (datasets, writers, the Lyft mAP and the
    pseudo-KITTI annos) are among those imported without JAX above and
    scanned for JAX imports."""
    mods = _port_modules()
    for name in ("datasets.lyft.lyft_dataset", "datasets.lyft.lyft_tables",
                 "datasets.lyft.synthetic", "datasets.pandaset.pandaset_dataset",
                 "datasets.pandaset.synthetic", "datasets.kitti.kitti_format",
                 "eval.lyft_eval"):
        assert f"tsm_det_pointcloud_tpu_torch.{name}" in mods
        assert (PORT / (name.replace(".", "/") + ".py")).exists()


def test_dataset_registry_imports_without_pandas():
    """PandaSet's frames are pandas pickles, but the registry, the loader and
    both new datasets import on a host without pandas."""
    code = ("import sys\n"
            "sys.modules['pandas'] = None\n"
            "import tsm_det_pointcloud_tpu_torch.datasets as d\n"
            "from tsm_det_pointcloud_tpu_torch.datasets.pandaset import synthetic\n"
            "assert {'LyftDataset', 'PandasetDataset'} <= set(d.__all__)\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("cfg_name", ["lyft_models/centerpoint_voxel01_res3d.yaml",
                                      "pandaset_models/centerpoint.yaml"])
def test_lyft_pandaset_entry_points_refuse_cuda_without_card(monkeypatch, tmp_path, cfg_name):
    """`evaluate`, `train --data_root`, `infer` and `train` on the Lyft and
    PandaSet configs default to the card too, and refuse a host without one
    before they read any data."""
    from tsm_det_pointcloud_tpu_torch import evaluate, infer, train

    cfg = str(ROOT / "tools/cfgs" / cfg_name)
    flags = ["--cfg_file", cfg, "--data_root", str(tmp_path), "--output_dir", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: evaluate.main(flags), lambda: train.main(flags),
                lambda: infer.main(["--cfg_file", cfg, "--batch", "1", "--points", "64",
                                    "--iters", "1"]),
                lambda: train.main(["--cfg_file", cfg, "--batch", "1", "--points", "64",
                                    "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


def test_caddn_modules_are_covered():
    """CaDDN's modules (the depth networks, ImageVFE, its detector) and the
    variants' modules are among those imported without JAX above and
    scanned for JAX imports."""
    mods = _port_modules()
    for name in ("models.backbones_3d.ddn", "models.backbones_3d.image_vfe",
                 "models.detectors.caddn", "models.backbones_2d.map_to_bev",
                 "models.backbones_3d.vfe", "models.dense_heads.anchor_head",
                 "datasets.processor.data_processor", "ops.box_coder_utils", "ops.loss_utils"):
        assert f"tsm_det_pointcloud_tpu_torch.{name}" in mods
        assert (PORT / (name.replace(".", "/") + ".py")).exists()


def _reduced_caddn_yaml(path):
    """CaDDN.yaml with a CompactDDN of 16 features and 16 bins, a one-level
    BEV backbone and a 70 x 94 x 5 grid of its range, for the CPU."""
    import yaml

    from tsm_det_pointcloud_tpu_torch import infer

    cfg = infer.load_cfg(ROOT / "tools/cfgs/kitti_models/CaDDN.yaml")
    model = cfg.MODEL
    model.VFE.DDN = {"NAME": "CompactDDN"}
    model.VFE.NUM_OUTPUT_FEATURES = model.VFE.NUM_DEPTH_BINS = 16
    model.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    model.BACKBONE_2D.update(LAYER_NUMS=[1], LAYER_STRIDES=[2], NUM_FILTERS=[16],
                             UPSAMPLE_STRIDES=[1], NUM_UPSAMPLE_FILTERS=[16])
    model.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    for step in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if step.NAME == "calculate_grid_size":
            step.VOXEL_SIZE = [0.64, 0.64, 0.8]

    def plain(d):
        if isinstance(d, dict):
            return {k: plain(v) for k, v in d.items()}
        return [plain(v) for v in d] if isinstance(d, (list, tuple)) else d

    doc = {k: plain(cfg[k]) for k in ("CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION")}
    path.write_text(yaml.safe_dump(doc))
    return path


def test_caddn_entry_points(monkeypatch, tmp_path, capsys):
    """`infer` and `train` run a reduced CaDDN.yaml on the CPU on synthetic
    camera batches (KITTI's 375 x 1242 images and projection); `evaluate`,
    `train --data_root` and `demo` refuse a camera config, naming it; on a
    host without a card `infer` and `train` refuse cuda."""
    from tsm_det_pointcloud_tpu_torch import demo, evaluate, infer, train

    cfg = str(_reduced_caddn_yaml(tmp_path / "caddn_cpu.yaml"))
    monkeypatch.chdir(tmp_path)
    infer.main(["--cfg_file", cfg, "--device", "cpu", "--batch", "1", "--points", "2048",
                "--iters", "1"])
    out = capsys.readouterr().out
    assert "voxels in the camera frustum" in out and "375x1242 images" in out
    train.main(["--cfg_file", cfg, "--device", "cpu", "--batch", "1", "--points", "2048",
                "--steps", "1"])
    assert "train scans/s on cpu" in capsys.readouterr().out
    flags = ["--cfg_file", cfg, "--data_root", str(tmp_path), "--output_dir", str(tmp_path),
             "--device", "cpu"]
    for entry in (evaluate.main, train.main):
        with pytest.raises(NotImplementedError, match="CaDDN"):
            entry(flags)
    with pytest.raises(NotImplementedError, match="CaDDN"):
        demo.main(["--cfg_file", cfg, "--data_path", str(tmp_path), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    full = str(ROOT / "tools/cfgs/kitti_models/CaDDN.yaml")
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--cfg_file", full, "--batch", "1", "--iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--cfg_file", full, "--batch", "1", "--steps", "1"])


def test_dsasnet_modules_are_covered():
    """The hybrids, the neck and DSASNet's detector are among the modules
    imported without JAX above and scanned for JAX imports."""
    mods = _port_modules()
    for name in ("models.backbones_2d.point_bev_hybrids", "models.neck.voxel_point_cross",
                 "models.detectors.two_stage", "models.roi_heads.pvrcnn_head"):
        assert f"tsm_det_pointcloud_tpu_torch.{name}" in mods
        assert (PORT / (name.replace(".", "/") + ".py")).exists()


def _reduced_dsasnet_yaml(path):
    """dsasnet.yaml with 4000 voxels a level, 512 key-point candidates of
    which 128 + 64 are picked, narrow heads and a 64-box proposal NMS, for
    the CPU."""
    import yaml

    from tsm_det_pointcloud_tpu_torch import infer

    cfg = infer.load_cfg(ROOT / "tools/cfgs/kitti_models/dsasnet.yaml")
    for step in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if step.NAME == "transform_points_to_voxels":
            step.MAX_NUMBER_OF_VOXELS = {"train": 4000, "test": 4000}
    model = cfg.MODEL
    model.BACKBONE_2D.update(FG_CORNER_POINTS=[512, 192], PTS_NUM_SAMPLE=[128, 64],
                             NUM_POINT_FEATURES=32)
    model.POINT_HEAD.CLS_FC = model.POINT_HEAD.REG_FC = [16]
    model.ROI_HEAD.update(SHARED_FC=[32], CLS_FC=[16], REG_FC=[16])
    model.ROI_HEAD.ROI_GRID_POOL.update(GRID_SIZE=3, MLPS=[[8], [8]])
    for mode, post in (("TRAIN", 32), ("TEST", 16)):
        model.ROI_HEAD.NMS_CONFIG[mode].update(NMS_PRE_MAXSIZE=64, NMS_POST_MAXSIZE=post)
    model.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16

    def plain(d):
        if isinstance(d, dict):
            return {k: plain(v) for k, v in d.items()}
        return [plain(v) for v in d] if isinstance(d, (list, tuple)) else d

    doc = {k: plain(cfg[k]) for k in ("CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION")}
    path.write_text(yaml.safe_dump(doc))
    return path


def test_dsasnet_entry_points(monkeypatch, tmp_path, capsys):
    """`infer` and `train` run a reduced dsasnet.yaml on the CPU on synthetic
    scans (the training step passes `accumulated_iter`, from which the
    hybrid's statistics move); on a host without a card they refuse cuda,
    and so do `evaluate` and `train --data_root`."""
    from tsm_det_pointcloud_tpu_torch import evaluate, infer, train

    cfg = str(_reduced_dsasnet_yaml(tmp_path / "dsasnet_cpu.yaml"))
    monkeypatch.chdir(tmp_path)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)     # beside the other workers' pools (tests/torch_threads.py)
    try:
        infer.main(["--cfg_file", cfg, "--device", "cpu", "--batch", "1", "--points", "4000",
                    "--iters", "1"])
        out = capsys.readouterr().out
        assert "proposals kept" in out and "scans/s on cpu" in out
        train.main(["--cfg_file", cfg, "--device", "cpu", "--batch", "1", "--points", "4000",
                    "--steps", "1"])
        assert "train scans/s on cpu" in capsys.readouterr().out
    finally:
        torch.set_num_threads(n_threads)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = ["--cfg_file", cfg, "--data_root", str(tmp_path), "--output_dir", str(tmp_path)]
    for run in (lambda: evaluate.main(flags), lambda: train.main(flags),
                lambda: infer.main(["--cfg_file", cfg, "--batch", "1", "--iters", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


@pytest.mark.parametrize("variant", ["PointFromVoxel", "VoxelPointCross", "BEVPoint", "neck"])
def test_dsasnet_variants_build_at_full_width(variant):
    """The variants of `infer.variant_cfg` build at full width on the CPU:
    each hybrid in dsasnet.yaml's place (Z_GROUPS 8 divides the trunk's 256
    channels), PVSSDA on its BEV topology with the neck, each module's
    input width the one it is given."""
    from tsm_det_pointcloud_tpu_torch import infer
    from tsm_det_pointcloud_tpu_torch.models import build_network

    cfg = infer.variant_cfg(variant)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), infer.dataset_meta(cfg, 20000),
                          device="cpu")
    names = [type(m).__name__ for m in model.module_list]
    if variant == "neck":
        assert names == ["PillarVFE", "PointNet2MSG", "PointPillarScatter", "BaseBEVBackbone",
                         "VoxelPointCross", "AnchorHeadSingle"]
        assert model.module_list[4].pooled_channels == 128 and model.unused_parameters
    else:
        assert names[3] == variant and names[4:] == ["DSASNetHead", "DSASNetRoIHead"]
        width = model.module_list[3].point_channels
        assert width == {"PointFromVoxel": 128, "VoxelPointCross": 256, "BEVPoint": 384}[variant]
        assert model.module_list[4].cls_fc.fc0.in_features == width
