"""The flags and output layout of the port's `train` and `evaluate` against
the JAX package's tools/train.py and tools/test.py:

  * the output directory, output/<EXP_GROUP_PATH>/<TAG>/<extra_tag> under
    the repository, equals the one the JAX tools compute (their own
    `parse_config`) for the same --cfg_file string, for three spellings of
    it; `train` writes its checkpoints and its log there (the config in the
    log, `config.log_config_to_file`), and `evaluate --extra_tag --eval_tag`
    reads them there and writes under eval/<eval_tag>;
  * `train --ckpt` resumes from the named checkpoint, not the newest;
    `--max_ckpt_save_num 1` keeps one checkpoint;
  * `--fix_random_seed` seeds the loader and numpy's global state with the
    JAX tool's seed.
All on the tiny TSM over tests/torch_kitti_cases.py's root, on the CPU.
"""
import importlib.util
import re
import sys

import numpy as np
import pytest

from tests.torch_kitti_cases import CLASSES, make_root, tiny_dataset_cfg, write_tiny_yaml
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu_torch import datasets, evaluate, train
from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from tsm_det_pointcloud_tpu_torch.infer import ROOT
from tsm_det_pointcloud_tpu_torch.train import FIX_RANDOM_SEED, default_output_dir


def _load_tool(name):
    path = ROOT / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cwd, cfg_file", [
    ("", "tools/cfgs/kitti_models/fast_cpc.yaml"),
    ("tools", "cfgs/kitti_models/fast_cpc.yaml"),
    ("", str(ROOT / "tools/cfgs/kitti_models/second.yaml")),
], ids=["tools_cfgs", "cfgs", "absolute"])
@pytest.mark.parametrize("tool", ["train", "test"])
def test_output_dir_equals_jax_tools(monkeypatch, tool, cwd, cfg_file):
    monkeypatch.chdir(ROOT / cwd)
    monkeypatch.setattr(sys, "argv", [f"{tool}.py", "--cfg_file", cfg_file,
                                      "--extra_tag", "run7"])
    args, cfg = _load_tool(tool).parse_config()
    want = ROOT / "output" / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    assert default_output_dir(cfg_file, "run7") == want


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("kitti")
    root, _ = make_root(base / "root")
    create_kitti_infos(tiny_dataset_cfg(root), CLASSES, root, root, workers=1)
    return root


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """The tiny config trained twice under one output layout (the
    repository's root moved to a temporary directory): 2 epochs, then
    --ckpt on epoch 1's checkpoint with --epochs 3 and --max_ckpt_save_num
    1, then `evaluate --extra_tag --eval_tag` on the newest checkpoint."""
    base = tmp_path_factory.mktemp("runs")
    cfg = write_tiny_yaml(base / "tiny_kitti.yaml", root, batch=2, epochs=2)
    mp = pytest.MonkeyPatch()
    mp.setattr(train, "ROOT", base)
    flags = ["--cfg_file", str(cfg), "--data_root", str(root), "--device", "cpu",
             "--workers", "0", "--extra_tag", "flags"]
    try:
        ckpt_dir, first = train.main(flags)
        before = sorted(p.name for p in ckpt_dir.glob("*.pth"))
        _, resumed = train.main(flags + ["--ckpt", str(ckpt_dir / "checkpoint_epoch_1.pth"),
                                         "--epochs", "3", "--max_ckpt_save_num", "1"])
        res = evaluate.main(["--cfg_file", str(cfg), "--data_root", str(root), "--device",
                             "cpu", "--workers", "0", "--extra_tag", "flags",
                             "--eval_tag", "tagged", "--batch_size", "4"])
    finally:
        mp.undo()
    out = default_output_dir(cfg, "flags").relative_to(ROOT)
    return dict(out=base / out, ckpt_dir=ckpt_dir, first=first, before=before,
                resumed=resumed, res=res)


def test_train_writes_the_jax_layout_and_logs_the_config(runs):
    out = runs["out"]
    assert runs["ckpt_dir"] == out / "ckpt"
    assert runs["before"] == ["checkpoint_epoch_1.pth", "checkpoint_epoch_2.pth"]
    logs = sorted(out.glob("log_train_*.txt"))
    assert logs
    text = logs[0].read_text()
    assert "cfg.CLASS_NAMES: ['Car', 'Pedestrian', 'Cyclist']" in text
    assert "----------- DATA_CONFIG -----------" in text
    assert "cfg.OPTIMIZATION.NUM_EPOCHS: 2" in text


def test_ckpt_resumes_from_the_named_checkpoint(runs):
    """From epoch 1's checkpoint, not epoch 2's (the newest): epochs 2 and 3
    train again."""
    assert len(runs["first"]) == 2
    assert len(runs["resumed"]) == 2


def test_max_ckpt_save_num_keeps_one(runs):
    assert sorted(p.name for p in runs["ckpt_dir"].glob("*.pth")) == ["checkpoint_epoch_3.pth"]


def test_evaluate_extra_tag_and_eval_tag(runs):
    eval_dir = runs["out"] / "eval" / "tagged"
    assert (eval_dir / "result.pkl").exists()
    assert "cfg.CLASS_NAMES" in next(eval_dir.glob("log_eval_*.txt")).read_text()
    assert "Car_3d/moderate_R40" in runs["res"]


class _Stop(Exception):
    pass


def test_fix_random_seed_is_the_jax_seed(root, tmp_path, monkeypatch):
    """The loader's seed and numpy's global state under --fix_random_seed
    are the JAX tools/train.py's (read from its source)."""
    text = (ROOT / "tools" / "train.py").read_text()
    jax_seeds = {int(s) for s in re.findall(r"np\.random\.seed\((\d+)\)", text)}
    jax_seeds |= {int(s) for s in re.findall(r"seed=(\d+) if args\.fix_random_seed", text)}
    assert jax_seeds == {FIX_RANDOM_SEED}
    seen = {}

    def capture(*args, seed=None, **kwargs):
        seen["seed"] = seed
        seen["numpy"] = np.random.get_state()[1].copy()
        raise _Stop

    monkeypatch.setattr(datasets, "build_dataloader", capture)
    cfg = write_tiny_yaml(tmp_path / "tiny_kitti.yaml", root)
    for flags, want in (([], 0), (["--fix_random_seed"], FIX_RANDOM_SEED)):
        with pytest.raises(_Stop):
            train.main(["--cfg_file", str(cfg), "--data_root", str(root), "--device", "cpu",
                        "--output_dir", str(tmp_path / "out")] + flags)
        assert seen["seed"] == want
    np.random.seed(FIX_RANDOM_SEED)
    assert np.array_equal(seen["numpy"], np.random.get_state()[1])


def test_logger_writes_each_run_to_its_own_file(tmp_path):
    """The entry points' logger, made again in the same process (an entry
    point run twice), writes to the new run's log file alone: the earlier
    run's file gets none of the later lines, and a run without a file
    writes to none."""
    from tsm_det_pointcloud_tpu_torch.utils.common_utils import create_logger

    first, second = tmp_path / "log_first.txt", tmp_path / "log_second.txt"
    create_logger(first).info("the first run")
    create_logger(second).info("the second run")
    create_logger().info("a run without a log file")
    assert first.read_text().count("run") == 1 and "the first run" in first.read_text()
    assert second.read_text().count("run") == 1 and "the second run" in second.read_text()
