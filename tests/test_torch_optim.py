"""The port's adam_onecycle (runtime/optimization.py), its student mask
(runtime/train_state.py) and its checkpoints (runtime/checkpoint.py) against
the JAX package's optax chain on a small parameter tree.

Same f32 arithmetic in nearly the same order: parameters after each step
rtol 1e-6, atol 1e-7; the schedules rtol 1e-6 plus atol 1e-9 for lr and
1e-7 for b1 (the JAX package evaluates them in f32, the port in f64: near
the end of the cosine 1 + cos(pi * frac) loses digits in f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tsm_det_pointcloud_tpu.parallel.train_state import wrap_student_only
from tsm_det_pointcloud_tpu.runtime.optimization import build_optimizer as jbuild
from tsm_det_pointcloud_tpu.runtime.optimization import onecycle_lr_fn as jonecycle
from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from tsm_det_pointcloud_tpu_torch.runtime.optimization import build_optimizer, onecycle_lr_fn
from tsm_det_pointcloud_tpu_torch.runtime.train_state import freeze_teacher, student_mask

OPTIM = {"OPTIMIZER": "adam_onecycle", "LR": 0.01, "WEIGHT_DECAY": 0.01,
         "MOMS": [0.95, 0.85], "PCT_START": 0.3, "DIV_FACTOR": 10,
         "GRAD_NORM_CLIP": 10}
TOTAL = 10


class _Tree(nn.Module):
    """Two student leaves (s_net.*) and one teacher leaf (net.w)."""

    def __init__(self, params):
        super().__init__()
        self.s_net = nn.ParameterDict(
            {k: nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in params["s_net"].items()})
        self.net = nn.ParameterDict(
            {"w": nn.Parameter(torch.from_numpy(params["net"]["w"].copy()))})


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"s_net": {"w": rng.randn(4, 3).astype(np.float32),
                      "b": rng.randn(3).astype(np.float32)},
            "net": {"w": rng.randn(3, 2).astype(np.float32)}}


def _grads(step):
    """Per-step gradients; steps 0 and 2 have a global norm above the clip
    (10), step 1 below it."""
    rng = np.random.RandomState(100 + step)
    scale = {0: 8.0, 1: 0.5, 2: 20.0}[step]
    g = {"s_net": {"w": rng.randn(4, 3).astype(np.float32) * scale,
                   "b": rng.randn(3).astype(np.float32) * scale},
         "net": {"w": np.zeros((3, 2), np.float32)}}   # stop_gradient'ed
    g["s_net"]["w"][0, 0] = 0.0                         # an exact zero
    return g


def test_schedules_match():
    jlr, jmom = jonecycle(0.01, 37, (0.95, 0.85), 10.0, 0.3)
    lr, mom = onecycle_lr_fn(0.01, 37, (0.95, 0.85), 10.0, 0.3)
    for step in (0, 1, 5, 10, 11, 12, 20, 36, 40):
        np.testing.assert_allclose(lr(step), float(jlr(step)), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(mom(step), float(jmom(step)), rtol=1e-6, atol=1e-7)


def _jax_steps(n):
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    tx, _ = jbuild(OPTIM, total_steps=TOTAL)
    tx = wrap_student_only(tx, params)
    state = tx.init(params)
    out = []
    for i in range(n):
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, _grads(i)), state,
                               params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
        out.append(jax.tree_util.tree_map(np.asarray, params))
    return out


def _port(params=None):
    model = _Tree(params or _params())
    mask = student_mask(model)
    opt = build_optimizer(OPTIM, freeze_teacher(model), TOTAL)
    return model, mask, opt


def _port_step(model, opt, i):
    g = _grads(i)
    for name, p in model.named_parameters():
        if p.requires_grad:
            top, leaf = name.split(".")
            p.grad = torch.from_numpy(g[top][leaf].copy())
    opt.step()


def _check(model, want):
    for name, p in model.named_parameters():
        top, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), want[top][leaf], rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_three_steps_match_optax():
    want = _jax_steps(3)
    model, mask, opt = _port()
    assert mask == {"s_net.w": True, "s_net.b": True, "net.w": False}
    teacher = model.net["w"].detach().clone()
    for i in range(3):
        _port_step(model, opt, i)
        _check(model, want[i])
    assert torch.equal(model.net["w"], teacher)
    assert not model.net["w"].requires_grad


def test_clip_is_optax_not_torch():
    """Below the threshold optax leaves the gradient as it is;
    clip_grad_norm_ would rescale it by max_norm / (norm + 1e-6)."""
    model, _, opt = _port()
    grads = [torch.full((3,), 0.1), torch.full((2,), 0.2)]
    assert float(opt._clip_factor(grads)) == 1.0
    big = [torch.full((4,), 10.0)]
    np.testing.assert_allclose(float(opt._clip_factor(big)), 10.0 / 20.0, rtol=1e-7)


@pytest.mark.parametrize("resume_at", [1, 2])
def test_checkpoint_resume_continues_the_run(tmp_path, resume_at):
    want = _jax_steps(3)
    model, _, opt = _port()
    for i in range(resume_at):
        _port_step(model, opt, i)
    for epoch in range(1, 4):
        save_checkpoint(model, opt, tmp_path, epoch, opt.state["count"],
                        max_ckpt_save_num=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint_epoch_2.pth", "checkpoint_epoch_3.pth"]
    model2, _, opt2 = _port(_params(seed=1))           # other weights
    epoch, it = restore_checkpoint(latest_checkpoint(tmp_path), model2, opt2)
    assert (epoch, it) == (3, resume_at) and opt2.state["count"] == resume_at
    for i in range(resume_at, 3):
        _port_step(model2, opt2, i)
    _check(model2, want[2])
