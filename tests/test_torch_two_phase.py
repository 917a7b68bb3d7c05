"""The TSM recipe's two phases on the port: a teacher checkpoint handed to a
distillation run (`runtime.checkpoint.partial_load` and
`transfer_statistics`, `train --pretrained_model`), against the JAX
package's pair (runtime/checkpoint.py:95-148) on the tiny teacher and
distillation models. Every comparison is exact: both sides copy values.

The JAX `tools/train.py` passes `partial_load` its `params`; the port's
state dict holds the BN running stats beside the parameters, and its
`partial_load` copies them too, as the reference's strict=False state-dict
load does, so the JAX side here runs `partial_load` on `batch_stats` as well.
"""
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import __graft_entry__ as ge
from tests.test_torch_teacher import _JMODEL as _JTEACHER, _jax_batch
from tsm_det_pointcloud_tpu.runtime.checkpoint import (
    partial_load as jpartial_load,
    transfer_statistics as jtransfer_statistics,
)
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import partial_load, transfer_statistics
from tsm_det_pointcloud_tpu_torch.runtime.train_state import is_student

_JDISTILL = ge._tsm_model()
STATS = ("object_statistic_features", "object_momentum", "object_mean")


def _random_tree(model, seed):
    """A training init's tree of `model` (shapes by jax.eval_shape), filled
    from numpy with values that differ from leaf to leaf and tree to tree
    (BN variances in [0.5, 1.5))."""
    shapes = jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b, training=True),
                            _jax_batch("sparse"))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.randn(*s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def trees():
    return _random_tree(_JTEACHER, 1), _random_tree(_JDISTILL, 2)


def _distill_model(tree=None):
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    if tree is not None:
        model.load_state_dict(from_flax_variables(tree), strict=True)
    return model


def test_partial_load_and_transfer_match_jax(trees):
    teacher, distill = trees
    want = from_flax_variables({
        "params": jpartial_load(distill["params"], teacher["params"]),
        "batch_stats": jpartial_load(distill["batch_stats"], teacher["batch_stats"]),
        "statistics": jtransfer_statistics(distill["statistics"], teacher["statistics"]),
    })
    model = _distill_model(distill)
    t_state = from_flax_variables(teacher)
    missed = partial_load(model, t_state)
    moved = transfer_statistics(model, t_state)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # what moved: the teacher's whole namespace and the statistics; what
    # partial_load missed: the student's entries and the head-scope statistics
    assert sorted(moved) == sorted(f"module_list.1.{s}" for s in STATS)
    assert set(missed) == {k for k in got if is_student(k)} | set(moved)
    for k in got:
        if not is_student(k) and k not in moved:
            assert torch.equal(got[k], t_state[k]), k
    for s in STATS:
        assert torch.equal(got[f"module_list.1.{s}"], t_state[f"module_list.1.head.{s}"])


def _cls_spread(model):
    pts = torch.from_numpy(tiny.synth_points(2))
    out, _ = infer.detect(model, pts, torch.ones(pts.shape[:2], dtype=torch.bool))
    cls = out["batch_cls_preds"]
    return float((cls.amax(1) - cls.amin(1)).max())


def test_structural_copy_leaves_statistics_at_zeros(trees):
    """A state-dict copy by full key (load_state_dict, strict=False) finds
    no module_list.1.object_* in the teacher's state: the student's
    statistics stay at their zeros and every cls logit is the same constant
    for all points (the conditioning `shared * 0`). transfer_statistics
    fills them, and the cls logits vary again."""
    teacher, _ = trees
    t_state = from_flax_variables(teacher)
    model = _distill_model()
    model.load_state_dict(t_state, strict=False)
    for s in STATS:
        assert not float(getattr(model.module_list[1], s).abs().max()), s
    assert _cls_spread(model) == 0.0
    assert transfer_statistics(model, t_state)
    for s in STATS:
        assert torch.equal(getattr(model.module_list[1], s), t_state[f"module_list.1.head.{s}"])
    assert _cls_spread(model) > 1e-3


def _write_cfg(path, base_yaml, model_cfg):
    """A config file: base_yaml's DATA_CONFIG and OPTIMIZATION, and the tiny
    model_cfg on the KITTI range (the synthetic scans' recipe)."""
    cfg = infer.load_cfg(infer.ROOT / base_yaml)
    model = json.loads(json.dumps(model_cfg))
    for section in ("BACKBONE_3D", "POINT_HEAD"):
        model[section]["VOXEL_CONFIG"]["POINT_CLOUD_RANGE"] = list(infer.KITTI_RANGE)
    out = {k: json.loads(json.dumps(cfg[k])) for k in ("CLASS_NAMES", "DATA_CONFIG",
                                                        "OPTIMIZATION")}
    out["MODEL"] = model
    path.write_text(yaml.safe_dump(out))
    return path


def _train(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "tsm_det_pointcloud_tpu_torch.train", "--device", "cpu",
         "--batch", "1", "--points", "2048", "--steps", "1", *args],
        cwd=infer.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_two_phase_cli(tmp_path):
    """`train` on the tiny teacher writes a checkpoint; a distillation run
    from it (--pretrained_model) keeps every teacher parameter bit-equal
    after its step, starts from and keeps the teacher's statistics, and
    moves the student's parameters (the JAX package's
    tests/test_two_phase_distill_cli.py, without its KITTI root).

    The teacher starts from zero statistics, and its steps from the init
    count no point (the confidence prior -log 99 scores every point near
    0.01, under the update's 0.3), so the test writes seeded statistics
    into the teacher's checkpoint before the second phase reads it."""
    t_cfg = _write_cfg(tmp_path / "teacher.yaml", "tools/cfgs/kitti_models/fast_cpc_teacher.yaml",
                       tiny.tiny_teacher_model_cfg())
    d_cfg = _write_cfg(tmp_path / "distill.yaml", "tools/cfgs/kitti_models/fast_cpc.yaml",
                       tiny.tiny_model_cfg())
    _train("--cfg_file", str(t_cfg), "--ckpt_dir", str(tmp_path / "teacher"))
    t_ckpt = tmp_path / "teacher" / "checkpoint_epoch_1.pth"
    ckpt = torch.load(t_ckpt, weights_only=True)
    for s, v in tiny.train_statistics().items():
        key = f"module_list.1.head.{s}"
        assert not float(ckpt["model_state"][key].abs().max()), key
        ckpt["model_state"][key] = torch.from_numpy(v)
    torch.save(ckpt, t_ckpt)
    log = _train("--cfg_file", str(d_cfg), "--ckpt_dir", str(tmp_path / "distill"),
                 "--pretrained_model", str(t_ckpt))
    assert "pretrained model" in log
    teacher = torch.load(t_ckpt, weights_only=True)["model_state"]
    distill = torch.load(tmp_path / "distill" / "checkpoint_epoch_1.pth",
                         weights_only=True)["model_state"]
    stats = {f"module_list.1.{s}": teacher[f"module_list.1.head.{s}"] for s in STATS}
    for k, v in stats.items():
        assert torch.equal(distill[k], v), k

    fresh = infer.load_cfg(d_cfg)
    model = build_network(fresh.MODEL, 3, infer.dataset_meta(fresh, 2048, "train"), device="cpu")
    seeded = model.state_dict()
    n_teacher = n_student = 0
    for k, _ in model.named_parameters():
        if is_student(k):
            n_student += not torch.equal(distill[k], seeded[k])
        else:
            assert torch.equal(distill[k], teacher[k]), f"teacher {k} changed"
            n_teacher += 1
    assert n_teacher > 50
    assert n_student == sum(is_student(k) for k, _ in model.named_parameters())
