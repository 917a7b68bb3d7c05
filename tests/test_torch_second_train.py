"""The port's SECOND training step against the JAX package on the CPU.

Pieces: `ResidualCoder.encode`, `nearest_bev_iou` and `assign_targets` (on
the tiny model's anchors and on second.yaml's 211,200 anchors of three
classes), the two losses the head adds (`weighted_smooth_l1` with code
weights, `weighted_cross_entropy`). Then the tiny SECOND (tiny.py, the JAX
package's PRNGKey(0) init converted) in train mode on the reference's points
with two sets of gt boxes (`tiny.second_gt`): "ref", the reference batch's
own box, which its anchors barely overlap (a forced match a scan), and
"anchored" (positives of both anchor rotations and direction bins, a forced
match, a masked slot). Both sides run the same batch; the port's materialised
convs go through `_GatherConv` (K7's plain version forward, the plain
backward), the JAX package's through its XLA gather.

Tolerances (f32 sums run in another order on the two sides; voxels,
rulebooks and target assignments are exact):
  * labels exact; IoUs, regression targets, weights and box codes atol 1e-6
    (rtol 1e-6);
  * loss and every tb_dict term: atol 1e-4 * max(1, |want|), rtol 1e-4;
  * every parameter's gradient: rtol 1e-3, atol 1e-4 * max|want| of its
    tensor, not below 1e-6 * the largest |want| of all tensors (a tensor
    whose gradient is rounding noise on both sides);
  * BN running stats after the step: atol 1e-5, rtol 1e-5;
  * parameters after each of two adam_onecycle steps (second.yaml's
    OPTIMIZATION) against optax: rtol 1e-4 plus atol 1e-3 * lr, for every
    element whose two gradients agree to 1e-3 relative and exceed the
    rounding floor (1e-6 * the largest |g|): a gradient off by 1e-3 moves
    Adam's step by up to (1 - b1) / (1 - b1^t) * 1e-3 |g| / sqrt(v_hat),
    under 0.8e-3 lr in these two steps (sqrt(v_hat) >= |g| / sqrt(2) at the
    second); the other elements within 2 * lr. Adam divides each element by
    its own magnitude, so an element
    that the gradient check holds only at its absolute tolerance (rounding
    noise, or a gradient near Adam's eps) takes a step of up to lr either
    way. Adam's moments after a step are held on the same elements to what
    a gradient off by 1e-3 gives: mu within 1e-3 (|mu| + |g|), nu within
    2e-3 (nu + g^2) (plus 1e-6 * the largest); then the port takes step 2
    from the JAX state, as tests/test_torch_tsm_train.py does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_second_e2e import META as JMETA, second_model_cfg
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.dense_heads import anchor_head as janchor
from tsm_det_pointcloud_tpu.ops import box_coder_utils as jcoder
from tsm_det_pointcloud_tpu.ops import loss_utils as jloss
from tsm_det_pointcloud_tpu.runtime.optimization import build_optimizer as jbuild_optimizer
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.dense_heads import anchor_head
from tsm_det_pointcloud_tpu_torch.ops import box_coder_utils, loss_utils
from tsm_det_pointcloud_tpu_torch.runtime.optimization import build_optimizer
from tsm_det_pointcloud_tpu_torch.runtime.train_state import is_distillation, train_step
from tsm_det_pointcloud_tpu_torch.train import build_trainer

SECOND_CFG = infer.ROOT / "tools/cfgs/kitti_models/second.yaml"
OPTIM = dict(infer.load_cfg(SECOND_CFG).OPTIMIZATION)
TOTAL_STEPS = 10
_JMODEL = jbuild(second_model_cfg(), num_class=1, dataset=JMETA)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port while this module runs: beside XLA's
    CPU thread pools, torch's own pool made the tiny step ~20x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close6(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6,
                               err_msg=what)


def _random_boxes(rng, n, extra=0):
    b = np.zeros((n, 7 + extra), np.float32)
    b[:, :3] = rng.uniform(-30, 30, (n, 3))
    b[:, 3:6] = rng.uniform(0.3, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:] = rng.randn(n, extra)
    return b


@pytest.mark.parametrize("extra", [0, 2])
def test_residual_coder_encode(extra):
    rng = np.random.RandomState(extra)
    boxes, anchors = _random_boxes(rng, 500, extra), _random_boxes(rng, 500, extra)
    boxes[:5, 3:6] = 0.0                                   # clipped at 1e-5 on both sides
    want = jcoder.ResidualCoder(code_size=7 + extra).encode(jnp.asarray(boxes),
                                                            jnp.asarray(anchors))
    coder = box_coder_utils.ResidualCoder(code_size=7 + extra)
    got = coder.encode(_t(boxes), _t(anchors))
    _close6(got.numpy(), want)
    # and decode inverts it, to f32 rounding of coordinates up to 30 m
    np.testing.assert_allclose(coder.decode(got, _t(anchors))[5:].numpy(), boxes[5:],
                               rtol=1e-5, atol=1e-5)


def test_nearest_bev_iou():
    """Random boxes with headings on and next to the pi / 4 snap boundary and
    its period, and boxes that coincide: equal to the JAX IoU."""
    rng = np.random.RandomState(3)
    a, b = _random_boxes(rng, 300), _random_boxes(rng, 40)
    a[:, :2] = rng.uniform(-4, 4, (300, 2))
    b[:, :2] = rng.uniform(-4, 4, (40, 2))
    edge = np.float32(np.pi / 4)
    a[:60, 6] = np.array([edge, np.nextafter(edge, 0), np.nextafter(edge, 2), -edge,
                          3 * edge, np.pi - edge], np.float32).repeat(10)
    b[:10] = a[:10]
    want = janchor.nearest_bev_iou(jnp.asarray(a), jnp.asarray(b))
    got = anchor_head.nearest_bev_iou(_t(a), _t(b))
    _close6(got.numpy(), want)
    assert (np.asarray(want) > 0.5).sum() >= 10


@jax.jit
def _jax_assign(anchors, gt, mask, cls_ids, matched, unmatched):
    return janchor.assign_targets(anchors, gt, mask, None, cls_ids, matched, unmatched,
                                  jcoder.ResidualCoder())


def _jax_assign_for(head, gt, mask):
    return _jax_assign(*(jnp.asarray(a) for a in (
        head.anchors.numpy(), gt, mask, head.anchor_class_ids.numpy(),
        head.matched_thresholds.numpy(), head.unmatched_thresholds.numpy())))


def _second_head():
    """The port's second.yaml head on the CPU: anchors, per-anchor class ids
    and thresholds (the JAX head's, built from the same config)."""
    cfg = infer.load_cfg(SECOND_CFG)
    meta = infer.dataset_meta(cfg, 20000, "train")
    return anchor_head.AnchorHeadSingle(dict(cfg.MODEL.DENSE_HEAD), 512, 3,
                                        tuple(cfg.CLASS_NAMES), meta.grid_size,
                                        meta.point_cloud_range)


def _kitti_gt(head, rng, B=2, M=10):
    """Boxes of the three classes: half on anchors of their class (moved and
    resized a little, headings turned), half anywhere in range; some masked."""
    anchors = head.anchors.numpy()
    cls_ids = head.anchor_class_ids.numpy()
    gt = np.zeros((B, M, 8), np.float32)
    for b in range(B):
        for m in range(M):
            cls = 1 + (m % 3)
            if m % 2 == 0:
                a = anchors[rng.choice(np.flatnonzero(cls_ids == cls))]
                box = a + np.r_[rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.2, 0.2, 3),
                                rng.uniform(-0.3, 0.3)]
            else:
                box = _random_boxes(rng, 1)[0]
                box[:2] = rng.uniform([0, -40], [70.4, 40])
            gt[b, m, :7] = box
            gt[b, m, 7] = cls
    mask = rng.uniform(size=(B, M)) > 0.2
    return gt, mask


def test_assign_targets_second_anchors():
    """second.yaml's 211,200 anchors of three classes: labels exact,
    targets and weights to 1e-6."""
    head = _second_head()
    gt, mask = _kitti_gt(head, np.random.RandomState(4))
    want = _jax_assign_for(head, gt, mask)
    got = head.assign(_t(gt), _t(mask))
    labels = np.asarray(want["box_cls_labels"])
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(), labels)
    for k in ("box_reg_targets", "reg_weights"):
        _close6(got[k].numpy(), want[k], k)
    assert {-1, 0, 1, 2, 3} <= set(np.unique(labels).tolist())


@pytest.mark.parametrize("which", ["ref", "anchored"])
def test_assign_targets_tiny(which):
    model = build_network(tiny.second_model_cfg(), 1, tiny.SECOND_META, device="cpu")
    head = model.module_list[-1]
    gt, mask = tiny.second_gt(2, which)
    want = _jax_assign_for(head, gt, mask)
    got = head.assign(_t(gt), _t(mask))
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(), np.asarray(want["box_cls_labels"]))
    for k in ("box_reg_targets", "reg_weights"):
        _close6(got[k].numpy(), want[k], k)
    dir_want = np.asarray(jax.vmap(
        lambda r: janchor.limit_period(r[..., 6] + jnp.asarray(head.anchors.numpy())[:, 6]
                                       - head.dir_offset, 0, 2 * jnp.pi))(
        want["box_reg_targets"]))
    bins = np.clip(np.floor(dir_want / np.pi), 0, 1)
    np.testing.assert_array_equal(head.get_direction_target(got["box_reg_targets"]).numpy(),
                                  bins)
    if which == "anchored":
        assert (np.asarray(want["box_cls_labels"]) > 0).sum() >= 4
        assert set(np.unique(bins[np.asarray(want["box_cls_labels"]) > 0])) == {0.0, 1.0}


def test_head_losses_elementwise():
    rng = np.random.RandomState(5)
    p, t = rng.randn(2, 50, 7).astype(np.float32), rng.randn(2, 50, 7).astype(np.float32)
    w = rng.uniform(size=(2, 50)).astype(np.float32)
    cw = [1.0, 2.0, 0.5, 1.0, 1.0, 3.0, 0.25]
    _close6(loss_utils.weighted_smooth_l1(_t(p), _t(t), _t(w), code_weights=cw).numpy(),
            jloss.weighted_smooth_l1(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w),
                                     code_weights=cw))
    logits = rng.randn(2, 50, 2).astype(np.float32) * 3
    oh = np.eye(2, dtype=np.float32)[rng.randint(0, 2, (2, 50))]
    _close6(loss_utils.weighted_cross_entropy(_t(logits), _t(oh), _t(w)).numpy(),
            jloss.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(oh),
                                         jnp.asarray(w)))


def test_second_trains_every_parameter():
    """A config that is not a distillation config trains every parameter
    (JAX tools/train.py:153-159 masks only 3DSSD distillation configs)."""
    assert not is_distillation(infer.load_cfg(SECOND_CFG).MODEL)
    assert is_distillation(infer.load_cfg(
        infer.ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml").MODEL)
    _, model, opt = build_trainer(SECOND_CFG, "cpu", n_points=20000)
    params = list(model.parameters())
    assert model.training and all(p.requires_grad for p in params)
    assert sum(len(g["params"]) for g in opt.param_groups) == len(params)
    assert model.dataset_meta.max_voxels == 16000        # MAX_NUMBER_OF_VOXELS.train


# ---------------------------------------------------------------------------
# the tiny SECOND's step
# ---------------------------------------------------------------------------

def _jax_batch(which):
    gt, mask = tiny.second_gt(2, which)
    return {"points": tiny.second_points(2), "points_mask": np.ones((2, 512), bool),
            "gt_boxes": gt, "gt_boxes_mask": mask, "batch_size": 2}


def _port_batch(which):
    return {k: (_t(v) if k != "batch_size" else v) for k, v in _jax_batch(which).items()}


@jax.jit
def _jax_loss_grad(variables, batch):
    def loss_fn(params):
        out, mutated = _JMODEL.apply(dict(variables, params=params), dict(batch, batch_size=2),
                                     training=True, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], mutated["batch_stats"])

    (loss, (tb, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return loss, tb, stats, grads


def _jax_step(variables, which):
    batch = {k: v for k, v in _jax_batch(which).items() if k != "batch_size"}
    return jax.tree_util.tree_map(np.asarray, _jax_loss_grad(variables, batch))


@pytest.fixture(scope="module")
def variables():
    """The JAX tiny SECOND's PRNGKey(0) init (numpy leaves)."""
    batch = {k: v for k, v in _jax_batch("ref").items() if k != "batch_size"}
    v = jax.jit(lambda r, b: _JMODEL.init(r, dict(b, batch_size=2), training=False))(
        jax.random.PRNGKey(0), batch)
    return jax.tree_util.tree_map(np.asarray, dict(v))


@pytest.fixture(scope="module")
def jax_steps(variables):
    out = {}
    for which in ("ref", "anchored"):
        loss, tb, stats, grads = _jax_step(variables, which)
        out[which] = dict(loss=loss, tb=tb,
                          stats=from_flax_variables({"batch_stats": stats}),
                          grads=from_flax_variables({"params": grads}))
    return out


def _port_model(variables):
    model = build_network(tiny.second_model_cfg(), 1, tiny.SECOND_META, device="cpu")
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


@pytest.mark.parametrize("which", ["ref", "anchored"])
def test_loss_and_tb_terms(variables, jax_steps, which):
    _, out = _port_backward(variables, which)
    want = jax_steps[which]
    _close_scalar(out["loss"].detach(), want["loss"], "loss")
    assert set(out["tb_dict"]) == set(want["tb"])
    for k, v in want["tb"].items():
        _close_scalar(out["tb_dict"][k].detach(), v, k)
    assert float(want["tb"]["rpn_loss_loc"]) > 0


@pytest.mark.parametrize("which", ["ref", "anchored"])
def test_gradients(variables, jax_steps, which):
    model, _ = _port_backward(variables, which)
    grads = jax_steps[which]["grads"]
    scale = max(float(g.abs().max()) for g in grads.values())
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(grads)
    for name, p in model.named_parameters():
        want = grads[name].numpy()
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=atol, err_msg=name)
    assert all(float(g.abs().max()) > 0 for n, g in grads.items() if n.endswith("weight"))


@pytest.mark.parametrize("which", ["ref", "anchored"])
def test_batch_stats_after_step(variables, jax_steps, which):
    model, _ = _port_backward(variables, which)
    state = model.state_dict()
    stats = jax_steps[which]["stats"]
    assert len(stats) == 2 * sum(1 for k in state if k.endswith("running_mean"))
    for key, want in stats.items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def _adam_moments(opt_state):
    """(mu, nu) of the adamw inside the JAX optimizer's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu
    if isinstance(opt_state, tuple) or hasattr(opt_state, "inner_state"):
        for x in (opt_state if isinstance(opt_state, tuple) else (opt_state.inner_state,)):
            found = _adam_moments(x)
            if found is not None:
                return found
    return None


def test_two_adam_onecycle_steps(variables):
    """Two steps of train_step (clipped adam_onecycle over every parameter)
    against the JAX gradients through optax, on the "anchored" batch."""
    tx, _ = jbuild_optimizer(OPTIM, total_steps=TOTAL_STEPS)
    update = jax.jit(lambda g, st, p: optax.apply_updates(p, tx.update(g, st, p)[0]))
    update_state = jax.jit(lambda g, st, p: tx.update(g, st, p)[1])
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    model = _port_model(variables)
    opt = build_optimizer(OPTIM, list(model.parameters()), TOTAL_STEPS)
    named = dict(model.named_parameters())
    pbatch = _port_batch("anchored")
    for i in range(2):
        vs = dict(variables, params=params, batch_stats=batch_stats)
        loss, _, batch_stats, grads = _jax_step(vs, "anchored")
        g = from_flax_variables({"params": grads})
        floor = 1e-6 * max(float(t.abs().max()) for t in g.values())
        params, opt_state = (jax.tree_util.tree_map(np.asarray, update(grads, opt_state, params)),
                             update_state(grads, opt_state, params))
        got_loss, tb = train_step(model, opt, pbatch)
        _close_scalar(got_loss, loss, f"step {i} loss")
        # train_step leaves the step's (unclipped) gradient in .grad
        noise = {k: ((t.abs() <= floor) | ((named[k].grad - t).abs() > 1e-3 * t.abs())).numpy()
                 for k, t in g.items()}
        want = from_flax_variables({"params": params, "batch_stats": batch_stats})
        lr = opt.lr_fn(i)
        for name, p in named.items():
            w = want[name].numpy()
            d = np.abs(p.detach().numpy() - w)
            off = ~noise[name] & (d > 1e-4 * np.abs(w) + 1e-3 * lr)
            assert not off.any(), f"step {i} {name}: {int(off.sum())} off, by up to {d[off].max()}"
            assert d.max() <= 2 * lr, f"step {i} {name} off by {d.max()}"
        state = model.state_dict()
        for key in want:
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(state[key].numpy(), want[key].numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=key)
        mu, nu = (from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, m)})
                  for m in _adam_moments(opt_state))
        for which, moment, rtol, power in (("mu", mu, 1e-3, 1), ("nu", nu, 2e-3, 2)):
            scale = max(float(m.abs().max()) for m in moment.values())
            for name, m in moment.items():
                got_m = opt.state[named[name]][which]
                d = np.abs(got_m.numpy() - m.numpy())
                tol = rtol * (np.abs(m.numpy()) + np.abs(g[name].numpy()) ** power)
                off = ~noise[name] & (d > tol + 1e-6 * scale)
                assert not off.any(), f"step {i} {which} of {name}"
                got_m.copy_(m)
        model.load_state_dict(want, strict=True)
