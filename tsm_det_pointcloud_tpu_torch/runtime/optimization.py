"""The optimizers of the JAX package (counterpart of
tsm_det_pointcloud_tpu/runtime/optimization.py): adam_onecycle, the
optimizer of every config under tools/cfgs/, and adam / sgd on a step-decay
learning rate (`decay_step_lr_fn`: LR times LR_DECAY at each
DECAY_STEP_LIST epoch, counted in steps of `steps_per_epoch`, floored at
LR_CLIP * LR).

The JAX package builds it with optax as
    chain(clip_by_global_norm(GRAD_NORM_CLIP),
          inject_hyperparams(adamw)(learning_rate=lr_fn, b1=mom_fn,
                                    b2=0.99, weight_decay=WEIGHT_DECAY))
and `AdamOneCycle` repeats that arithmetic step for step:
  * the global-norm clip is optax's: g * max_norm / norm only when
    norm >= max_norm (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the
    norm and clips always, so it is not used);
  * the learning rate and b1 are the schedules evaluated at the step count
    before the update, as `inject_hyperparams` does; the bias corrections use
    the scheduled b1 of the same step and the count after it;
  * AdamW: eps 1e-8 outside the square root, the weight decay added to the
    Adam direction before the learning rate scales it (decoupled).
The norm and the clip stay on the device: a step does not synchronise.
`adam` is the same class with b1 0.9 for every step and b2 0.999 (optax's
adamw defaults); `sgd` is `SGDMomentum`, optax's
    chain(clip_by_global_norm(GRAD_NORM_CLIP),
          inject_hyperparams(chain(add_decayed_weights(WEIGHT_DECAY),
                                   sgd(lr_fn, momentum=MOMENTUM))))
step for step: the decayed weights are added to the clipped gradient, the
trace is g + MOMENTUM * trace (zeros at first), the update -lr * trace.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def onecycle_lr_fn(lr_max, total_steps, moms, div_factor, pct_start):
    """(lr_fn, mom_fn) of the fastai one-cycle schedule: lr warms up
    linearly from lr_max / div_factor over pct_start of the steps, then
    anneals on a cosine to lr_max * 1e-4; momentum mirrors it between
    moms[0] and moms[1]."""
    warmup = max(int(total_steps * pct_start), 1)
    rest = max(total_steps - warmup, 1)
    lr_start = lr_max / div_factor
    lr_end = lr_max * 1e-4

    def _fracs(step):
        step = float(step)
        frac_w = min(max(step / warmup, 0.0), 1.0)
        frac_c = min(max((step - warmup) / rest, 0.0), 1.0)
        return step < warmup, frac_w, 0.5 * (1 + math.cos(math.pi * frac_c))

    def lr_fn(step):
        warm, frac_w, cos = _fracs(step)
        if warm:
            return lr_start + (lr_max - lr_start) * frac_w
        return lr_end + (lr_max - lr_end) * cos

    def mom_fn(step):
        warm, frac_w, cos = _fracs(step)
        if warm:
            return moms[0] + (moms[1] - moms[0]) * frac_w
        return moms[0] + (moms[1] - moms[0]) * cos

    return lr_fn, mom_fn


def decay_step_lr_fn(lr, decay_step_list, lr_decay, lr_clip, steps_per_epoch):
    """lr_fn of adam / sgd: LR multiplied by LR_DECAY at each boundary
    DECAY_STEP_LIST[i] * steps_per_epoch reached, floored at LR_CLIP * LR;
    float32 arithmetic, as the JAX package's jnp schedule."""
    boundaries = [int(e * steps_per_epoch) for e in decay_step_list]

    def lr_fn(step):
        cur = np.float32(lr)
        for b in boundaries:
            if step >= b:
                cur = np.float32(cur * np.float32(lr_decay))
        return float(max(cur, np.float32(lr_clip * lr)))

    return lr_fn


class _Scheduled(torch.optim.Optimizer):
    """The plumbing adam_onecycle, adam and sgd share: the step count in the
    state, every parameter without a gradient stepped as gradient zero
    (optax updates every leaf it was given; weight decay moves it still),
    and optax's global-norm clip of the gradients first."""

    def __init__(self, params, defaults, lr_fn, max_grad_norm):
        super().__init__(params, defaults)
        self.lr_fn = lr_fn
        self.max_grad_norm = float(max_grad_norm)
        # the step count rides in the state (a non-parameter key, which
        # torch's state_dict / load_state_dict carry as it is)
        self.state["count"] = 0

    def _clip_factor(self, grads):
        """optax.clip_by_global_norm's factor as a device scalar."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        mx = self.max_grad_norm
        return torch.where(norm < mx, torch.ones_like(norm), mx / norm)

    def _clipped_grads(self):
        params = [p for grp in self.param_groups for p in grp["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_grad_norm <= 0:
            return {p: p.grad for p in params}
        factor = self._clip_factor([p.grad for p in params])
        return {p: p.grad * factor for p in params}


class SGDMomentum(_Scheduled):
    """Clipped SGD with decoupled-by-addition weight decay and momentum on a
    scheduled learning rate (see the module docstring)."""

    def __init__(self, params, lr_fn, momentum=0.9, weight_decay=0.0, max_grad_norm=0.0):
        super().__init__(params, dict(momentum=float(momentum),
                                      weight_decay=float(weight_decay)),
                         lr_fn, max_grad_norm)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGDMomentum takes no closure")
        grads = self._clipped_grads()
        count = self.state["count"]
        lr = float(self.lr_fn(count))
        self.state["count"] = count + 1
        for grp in self.param_groups:
            m, wd = grp["momentum"], grp["weight_decay"]
            for p in grp["params"]:
                g = grads[p] + wd * p if wd else grads[p]
                st = self.state[p]
                if not st:
                    st["trace"] = torch.zeros_like(p)
                st["trace"].mul_(m).add_(g)
                p.add_(st["trace"], alpha=-lr)
        return None


class AdamOneCycle(_Scheduled):
    """Clipped AdamW with a scheduled learning rate and b1 (see the module
    docstring). `lr_fn` / `mom_fn` map the step count to lr / b1."""

    def __init__(self, params, lr_fn, mom_fn, b2=0.99, eps=1e-8,
                 weight_decay=0.0, max_grad_norm=0.0):
        super().__init__(params, dict(b2=float(b2), eps=float(eps),
                                      weight_decay=float(weight_decay)),
                         lr_fn, max_grad_norm)
        self.mom_fn = mom_fn

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamOneCycle takes no closure")
        grads = self._clipped_grads()
        count = self.state["count"]
        lr, b1 = float(self.lr_fn(count)), float(self.mom_fn(count))
        count += 1
        self.state["count"] = count
        for grp in self.param_groups:
            b2, eps, wd = grp["b2"], grp["eps"], grp["weight_decay"]
            for p in grp["params"]:
                g = grads[p]
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                mu, nu = st["mu"], st["nu"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                mu_hat = mu / (1 - b1 ** count)
                nu_hat = nu / (1 - b2 ** count)
                upd = mu_hat / (torch.sqrt(nu_hat) + eps)
                if wd:
                    upd = upd + wd * p
                p.add_(upd, alpha=-lr)
        return None


def build_optimizer(optim_cfg, params, total_steps, steps_per_epoch=1000):
    """The OPTIMIZATION section -> its optimizer over `params`:
    adam_onecycle (`AdamOneCycle` on the one-cycle schedules of
    `total_steps`), adam (`AdamOneCycle` with b1 0.9, b2 0.999) or sgd
    (`SGDMomentum`), those two on `decay_step_lr_fn` with `steps_per_epoch`
    (the loader's length; the JAX build_optimizer's default otherwise)."""
    name = optim_cfg["OPTIMIZER"]
    wd = float(optim_cfg.get("WEIGHT_DECAY", 0.0))
    clip = float(optim_cfg.get("GRAD_NORM_CLIP", 0.0))
    if name == "adam_onecycle":
        lr_fn, mom_fn = onecycle_lr_fn(
            float(optim_cfg["LR"]), int(total_steps),
            tuple(optim_cfg.get("MOMS", [0.95, 0.85])),
            float(optim_cfg.get("DIV_FACTOR", 10.0)),
            float(optim_cfg.get("PCT_START", 0.3)))
        return AdamOneCycle(params, lr_fn, mom_fn, b2=0.99, weight_decay=wd,
                            max_grad_norm=clip)
    if name not in ("adam", "sgd"):
        raise NotImplementedError(name)   # as the JAX build_optimizer
    lr_fn = decay_step_lr_fn(
        float(optim_cfg["LR"]), optim_cfg.get("DECAY_STEP_LIST", []),
        float(optim_cfg.get("LR_DECAY", 0.1)), float(optim_cfg.get("LR_CLIP", 1e-7)),
        steps_per_epoch)
    if name == "adam":
        return AdamOneCycle(params, lr_fn, lambda step: 0.9, b2=0.999, weight_decay=wd,
                            max_grad_norm=clip)
    return SGDMomentum(params, lr_fn, momentum=float(optim_cfg.get("MOMENTUM", 0.9)),
                       weight_decay=wd, max_grad_norm=clip)
