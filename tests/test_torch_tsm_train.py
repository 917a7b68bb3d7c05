"""The port's tiny-TSM distillation training step against the JAX package.

Both sides start from the JAX model's PRNGKey(0) training init (converted
for the port by convert.from_flax_variables) with seeded class-statistics
buffers (tiny.train_statistics), on `__graft_entry__._synth_batch(2,
with_gt=True)`'s points with two sets of gt boxes: the reference's own
("sparse": no vote reaches a box, so the box losses are zero) and "wide"
(boxes over most of the range: every loss term has positives).

Tolerances (f32 sums run in another order on the two sides; FPS picks,
neighbour sets and target assignments are exact):
  * loss and every tb_dict term: atol 1e-4 * max(1, |want|), rtol 1e-4;
  * the gradient of every s_* parameter: rtol 1e-3, atol 1e-4 * max|want|
    per tensor, but not below 1e-6 * the largest |want| of all s_* tensors:
    loosened for tensors whose gradient is zero in exact arithmetic and only
    float32 rounding noise here (the vote offset's bias: every train-mode BN
    downstream removes a constant shift), whose per-tensor atol would be
    the noise itself;
  * BN running stats after the step: atol 1e-5, rtol 1e-5;
  * parameters after each of two optimizer steps: rtol 1e-4 plus atol
    1e-4 * lr, for every student element whose JAX gradient in that step
    exceeds the rounding floor (1e-6 * the largest |g|). The elements under
    the floor are held within 2 * lr only: Adam divides each gradient
    element by its own magnitude, so an element whose gradient is rounding
    noise on both sides (zero in exact arithmetic) takes a noise-driven
    step of up to lr either way (the optimizer alone is held to rtol 1e-6
    in test_torch_optim.py). Adam's moments after the first step are held
    to the gradients' tolerance (mu rtol 1e-3, nu rtol 2e-3, atol 1e-6 *
    the largest, outside the floor); then the port takes the second step
    from the JAX state, as the noise elements' first moves would otherwise
    feed the second step's forward and shift other gradients by ~1e-3;
  * teacher parameters: bit-identical to before the steps.

`write_tiny_train_golden()` writes the JAX step's loss, tb terms and s_*
gradients on the "wide" batch to tsm_det_pointcloud_tpu_torch/data/
tsm_tiny_train_golden.npz, which chip_smoke.py holds the card's tiny step
against; regenerate with
    python -c "from tests.test_torch_tsm_train import write_tiny_train_golden; write_tiny_train_golden()"
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tsm_det_pointcloud_tpu.parallel.train_state import (
    TrainState,
    create_train_step,
    wrap_student_only,
)
from tsm_det_pointcloud_tpu.runtime.optimization import build_optimizer as jbuild_optimizer
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.ops.boxes import points_in_boxes
from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import restore_checkpoint
from tsm_det_pointcloud_tpu_torch.runtime.optimization import build_optimizer
from tsm_det_pointcloud_tpu_torch.runtime.train_loop import train_model
from tsm_det_pointcloud_tpu_torch.runtime.train_state import (
    freeze_teacher,
    is_student,
    student_mask,
    train_step,
)
from tsm_det_pointcloud_tpu_torch.train import synth_train_batch
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

OPTIM = {"OPTIMIZER": "adam_onecycle", "LR": 0.01, "WEIGHT_DECAY": 0.01,
         "MOMS": [0.95, 0.85], "PCT_START": 0.3, "DIV_FACTOR": 10,
         "GRAD_NORM_CLIP": 10}
TOTAL_STEPS = 10
_JMODEL = ge._tsm_model()


def _jax_batch(which):
    batch = dict(ge._synth_batch(2, with_gt=True, seed=0))
    if which != "sparse":
        gt, mask = tiny.synth_gt(2, which)
        batch["gt_boxes"], batch["gt_boxes_mask"] = gt, mask
    return {k: (np.asarray(v) if k != "batch_size" else v) for k, v in batch.items()}


def _port_batch(which):
    return {k: (torch.from_numpy(np.array(v)) if k != "batch_size" else v)
            for k, v in _jax_batch(which).items()}


def _jax_variables():
    """The PRNGKey(0) training init with seeded statistics (numpy leaves)."""
    v = jax.jit(lambda r, b: _JMODEL.init(r, b, training=True))(
        jax.random.PRNGKey(0), _jax_batch("sparse"))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["statistics"] = {"module_list_1": tiny.train_statistics()}
    return v


@jax.jit
def _jax_loss_grad(variables, batch):
    def loss_fn(params):
        out, mutated = _JMODEL.apply(
            dict(variables, params=params), batch, training=True,
            mutable=["batch_stats", "statistics"])
        return out["loss"], (out["tb_dict"], mutated["batch_stats"])

    (loss, (tb, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    return loss, tb, stats, grads


@pytest.fixture(scope="module")
def variables():
    return _jax_variables()


@pytest.fixture(scope="module")
def jax_step(variables):
    out = {}
    for which in ("sparse", "wide"):
        loss, tb, stats, grads = jax.tree_util.tree_map(
            np.asarray, _jax_loss_grad(variables, _jax_batch(which)))
        out[which] = dict(loss=loss, tb=tb,
                          stats=from_flax_variables({"batch_stats": stats}),
                          grads=from_flax_variables({"params": grads}))
    return out


def _port_model(variables):
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model


def _port_backward(variables, which):
    model = _port_model(variables).train()
    out = model(_port_batch(which))
    out["loss"].backward()
    return model, out


def _close_scalar(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-4 * max(1.0, abs(float(want))), err_msg=what)


def _close_grad(got, want, what, scale):
    """scale: the largest |want| over all s_* tensors (see the docstring)."""
    atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol, err_msg=what)


def _grad_scale(grads):
    return max(float(np.abs(np.asarray(g)).max()) for k, g in grads.items()
               if is_student(k.removeprefix("grad/")))


@pytest.mark.parametrize("which", ["sparse", "wide"])
def test_loss_and_tb_terms(variables, jax_step, which):
    _, out = _port_backward(variables, which)
    want = jax_step[which]
    _close_scalar(out["loss"].detach(), want["loss"], "loss")
    assert set(out["tb_dict"]) == set(want["tb"])
    for k, v in want["tb"].items():
        _close_scalar(torch.as_tensor(out["tb_dict"][k]).detach(), v, k)
    if which == "wide":
        assert float(want["tb"]["s_n_pos"]) > 0, "the wide boxes must give positives"


@pytest.mark.parametrize("which", ["sparse", "wide"])
def test_student_gradients(variables, jax_step, which):
    model, _ = _port_backward(variables, which)
    grads = jax_step[which]["grads"]
    scale = _grad_scale(grads)
    n = 0
    for name, p in model.named_parameters():
        if not is_student(name):
            continue
        assert p.grad is not None, f"{name} got no gradient"
        _close_grad(p.grad.numpy(), grads[name].numpy(), name, scale)
        n += 1
    assert n > 100


@pytest.mark.parametrize("which", ["sparse", "wide"])
def test_batch_stats_after_step(variables, jax_step, which):
    model, _ = _port_backward(variables, which)
    state = model.state_dict()
    stats = jax_step[which]["stats"]
    assert len(stats) > 100
    for key, want in stats.items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def _noise_mask(variables, state, batch, mask):
    """Per student tensor, the elements whose JAX gradient at `state` lies
    within the rounding floor: |g| <= 1e-6 * the largest |g| (see the
    docstring)."""
    vs = dict(variables, params=state.params, batch_stats=state.batch_stats)
    grads = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, _jax_loss_grad(vs, batch)[3])})
    scale = max(float(grads[k].abs().max()) for k in grads if mask[k])
    return {k: (g.abs() <= 1e-6 * scale).numpy() for k, g in grads.items() if mask[k]}


def _check_student_params(model, mask, noise, want, lr):
    """Student elements within rtol 1e-4 + atol 1e-4 * lr of the JAX step's;
    those in the noise mask within 2 * lr (see the docstring)."""
    for name, p in model.named_parameters():
        if not mask[name]:
            continue
        w = want[name].numpy()
        d = np.abs(p.detach().numpy() - w)
        off = ~noise[name] & (d > 1e-4 * np.abs(w) + 1e-4 * lr)
        assert not off.any(), f"{name}: {int(off.sum())} elements off, by up to {d[off].max()}"
        assert d.max() <= 2 * lr, f"{name} off by {d.max()}"


def _adam_moments(opt_state):
    """(mu, nu) of the adamw inside the JAX optimizer's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu
    if isinstance(opt_state, tuple):
        for x in opt_state:
            found = _adam_moments(x)
            if found is not None:
                return found
    return None


def test_two_steps_params_and_frozen_teacher(variables):
    batch = _jax_batch("wide")
    tx, _ = jbuild_optimizer(OPTIM, total_steps=TOTAL_STEPS)
    tx = wrap_student_only(tx, variables["params"])
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=0,
                       statistics=variables["statistics"])
    jstep = create_train_step(_JMODEL, tx, donate=False)

    model = _port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mask = student_mask(model)
    student = freeze_teacher(model)
    assert len(student) == sum(mask.values())
    opt = build_optimizer(OPTIM, student, TOTAL_STEPS)
    params = dict(model.named_parameters())
    pbatch = _port_batch("wide")
    for i in range(2):
        noise = _noise_mask(variables, state, batch, mask)
        state, _ = jstep(state, batch)
        loss, tb = train_step(model, opt, pbatch)
        assert torch.isfinite(loss) and set(tb) >= {"s_cls_loss", "sasa_loss"}
        want = from_flax_variables(jax.tree_util.tree_map(
            np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
        _check_student_params(model, mask, noise, want, opt.lr_fn(i))
        got = model.state_dict()
        for name, p in params.items():
            if not mask[name]:
                assert not p.requires_grad
                assert torch.equal(p, before[name]), f"teacher {name} changed"
        for key in want:
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=key)
        # the moments the step leaves, at the gradients' tolerance; then the
        # port takes step 2 from the JAX state, so that the noise elements'
        # step-1 moves do not feed step 2's forward
        mu, nu = (from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, m)})
                  for m in _adam_moments(state.opt_state))
        for which, moment, rtol in (("mu", mu, 1e-3), ("nu", nu, 2e-3)):
            scale = max(float(moment[k].abs().max()) for k in moment if mask[k])
            for name, m in moment.items():
                if not mask[name]:
                    continue
                got_m = opt.state[params[name]][which]
                d = np.abs(got_m.numpy() - m.numpy())
                off = ~noise[name] & (d > rtol * np.abs(m.numpy()) + 1e-6 * scale)
                assert not off.any(), f"{which} of {name}"
                got_m.copy_(m)
        missing, unexpected = model.load_state_dict(want, strict=False)
        assert not unexpected and all(k.startswith("module_list.1.object_") for k in missing)


GOLDEN = tiny.STATE_PATH.parent / "tsm_tiny_train_golden.npz"


def _train_golden(variables):
    loss, tb, _, grads = jax.tree_util.tree_map(
        np.asarray, _jax_loss_grad(variables, _jax_batch("wide")))
    grads = from_flax_variables({"params": grads})
    out = {"loss": loss}
    out.update({f"tb/{k}": v for k, v in tb.items()})
    out.update({f"grad/{k}": v.numpy() for k, v in grads.items() if is_student(k)})
    return out


def write_tiny_train_golden(path=GOLDEN):
    """Write the JAX tiny training step's loss, tb terms and s_* gradients."""
    np.savez_compressed(path, **_train_golden(_jax_variables()))


def test_committed_train_golden_is_current(variables):
    """rtol 1e-5, atol 1e-6 * max|want|: XLA's float32 sums may round
    differently on another CPU."""
    want = _train_golden(variables)
    with np.load(GOLDEN) as got:
        assert set(got.files) == set(want)
        for k in got.files:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6 * float(np.abs(want[k]).max()),
                                       err_msg=k)


def test_port_reproduces_train_golden():
    """The check chip_smoke.py makes on the card, here on the CPU: the
    committed state plus the seeded statistics reproduce the golden."""
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    model.load_state_dict(tiny.load_state(), strict=True)
    head = model.module_list[1]
    for k, v in tiny.train_statistics().items():
        getattr(head, k).copy_(torch.from_numpy(v))
    out = model.train()(_port_batch("wide"))
    out["loss"].backward()
    params = dict(model.named_parameters())
    with np.load(GOLDEN) as golden:
        scale = _grad_scale({k: golden[k] for k in golden.files if k.startswith("grad/")})
        for k in golden.files:
            want = golden[k]
            if k.startswith("grad/"):
                _close_grad(params[k[5:]].grad.numpy(), want, k, scale)
            elif k == "loss":
                _close_scalar(out["loss"].detach(), want, k)
            else:
                _close_scalar(torch.as_tensor(out["tb_dict"][k[3:]]).detach(), want, k)


def test_train_model_checkpoints_and_resumes(tmp_path):
    """train_model over two tiny batches writes the epoch's checkpoint, and
    restoring it into a fresh model gives back weights, stats and the
    optimizer's step count."""
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    model.load_state_dict(tiny.load_state(), strict=True)
    opt = build_optimizer(OPTIM, freeze_teacher(model), TOTAL_STEPS)
    logs = []
    train_model(model, opt, [_port_batch("wide"), _port_batch("sparse")], tmp_path,
                total_epochs=1, log=logs.append, log_every=1)
    assert len(logs) == 3 and "loss" in logs[0]
    model2 = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    opt2 = build_optimizer(OPTIM, freeze_teacher(model2), TOTAL_STEPS)
    assert restore_checkpoint(tmp_path / "checkpoint_epoch_1.pth", model2, opt2) == (1, 2)
    assert opt2.state["count"] == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k


def test_synth_train_batch_boxes_hold_their_clusters():
    batch = synth_train_batch(2, 2048, seed=3)
    np.testing.assert_array_equal(batch["points"].numpy(), infer.synth_points(2, 2048, 3))
    assert batch["gt_boxes"].shape == (2, 8, 8) and bool(batch["gt_boxes_mask"].all())
    assert bool((batch["gt_boxes"][..., 7] == 1).all())
    idx = points_in_boxes(batch["points"][..., :3], batch["gt_boxes"][..., :7])
    for k in range(8):
        # each cluster's 200 points lie in its own box (or an overlapping one
        # of lower index)
        assert bool((idx[:, k * 200:(k + 1) * 200] >= 0).all())
        assert bool((idx[:, k * 200:(k + 1) * 200] <= k).all())
