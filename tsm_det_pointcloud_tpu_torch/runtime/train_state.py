"""The training step (counterpart of
tsm_det_pointcloud_tpu/parallel/train_state.py:73-151).

A distillation config (`is_distillation`) trains only the student
namespace in the JAX package: `student_mask` marks the parameters with a
path segment starting with `s_`, and `wrap_student_only` zeroes every other
update. Here the teacher's parameters are frozen (`requires_grad_(False)`)
and left out of the optimizer, which is given the student's alone. The BN
running stats of teacher and student still update in the train-mode
forward, as the JAX step mutates every `batch_stats` leaf. Any other config
(the TSM teacher, SECOND) trains every parameter; the teacher's head also
updates its class statistics in the train-mode forward.
"""
from __future__ import annotations

import torch


def is_distillation(model_cfg):
    """True for a 3DSSD config with a distillation backbone or point head:
    the configs whose teacher the JAX tools/train.py:153-159 freezes."""
    return str(model_cfg.get("NAME", "")) == "3DSSD" and any(
        "Distillation" in str(model_cfg.get(section, {}).get("NAME", ""))
        for section in ("BACKBONE_3D", "POINT_HEAD"))


def is_student(name):
    """True for a parameter of the student namespace (a dotted-path segment
    starting with s_), the counterpart of the JAX `student_mask` label."""
    return any(part.startswith("s_") for part in name.split("."))


def student_mask(model):
    """{parameter name: trains} over the model's parameters."""
    return {name: is_student(name) for name, _ in model.named_parameters()}


def freeze_teacher(model):
    """Freeze every parameter outside the student namespace; return the
    student's parameters, the optimizer's whole charge."""
    student = []
    for name, p in model.named_parameters():
        p.requires_grad_(is_student(name))
        if is_student(name):
            student.append(p)
    return student


def train_step(model, optimizer, batch):
    """One step on `batch` (a dict of device tensors with gt_boxes and
    gt_boxes_mask): train-mode forward, backward, optimizer update. The
    forward gets `accumulated_iter`, the optimizer's steps so far (the
    hybrids' class statistics start at their STAT_START_ITER). Returns the
    loss and the tb_dict as device tensors; nothing is synchronised."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    out = model(dict(batch, accumulated_iter=optimizer.state["count"]))
    loss = out["loss"]
    loss.backward()
    optimizer.step()
    tb = {k: torch.as_tensor(v, device=loss.device).detach()
          for k, v in out["tb_dict"].items()}
    return loss.detach(), tb
