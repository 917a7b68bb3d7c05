"""The port's TSM teacher (fast_cpc_teacher.yaml's VoxelPointNet2FSMSG +
PointHeadVoteSASAStatistic) against the JAX package on the CPU, at the tiny
teacher's widths (`tiny.tiny_teacher_model_cfg`): eval forward and
post-processing, one training step (loss, tb terms, every gradient, BN
running stats, the class statistics the step leaves), the statistic
update's zero and non-zero counts, the detach trap, and two adam_onecycle
steps against optax.

Both sides start from the JAX teacher's PRNGKey(0) training init
(converted by convert.from_flax_variables) with `tiny.teacher_overrides()`:
seeded class statistics, and a layer-1 confidence bias under which the
update counts points of classes 0 and 1 and none of class 2.

Tolerances (f32 sums run in another order on the two sides; FPS picks,
neighbour sets and target assignments are exact):
  * eval outputs: the golden one, atol 1e-3 * max(1, max|want|), rtol 1e-3;
    detection counts and labels equal;
  * loss and every tb term: atol 1e-4 * max(1, |want|), rtol 1e-4;
  * every gradient: rtol 1e-3, atol 1e-4 * max(max|want| of the tensor,
    1e-2 * the largest |want| of all tensors) (tests/test_torch_tsm_train.py's);
  * BN running stats and class statistics after the step: rtol 1e-5, atol
    1e-5 (statistics: 1e-5 * max(1, max|want|));
  * parameters after each of two optimizer steps: as in
    tests/test_torch_tsm_train.py, for every parameter.

`write_teacher_tiny_files()` writes tsm_det_pointcloud_tpu_torch/data/
tsm_teacher_tiny_state.npz (the converted init), tsm_teacher_tiny_forward.npz
(the eval forward's outputs with the overrides) and
tsm_teacher_tiny_train_golden.npz (the step's loss, tb terms, every gradient
and the statistics after it), which chip_smoke.py holds the card against;
regenerate with
    python -c "from tests.test_torch_teacher import write_teacher_tiny_files; write_teacher_tiny_files()"
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tests.test_torch_tsm_forward import _assert_golden_close, _random_variables
from tests.test_torch_tsm_train import (
    OPTIM,
    TOTAL_STEPS,
    _adam_moments,
    _close_grad,
    _close_scalar,
)
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.dense_heads import point_head_vote as jhead
from tsm_det_pointcloud_tpu.parallel.train_state import TrainState, create_train_step
from tsm_det_pointcloud_tpu.runtime.optimization import build_optimizer as jbuild_optimizer
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.dense_heads import point_head_vote as thead
from tsm_det_pointcloud_tpu_torch.runtime.optimization import build_optimizer
from tsm_det_pointcloud_tpu_torch.runtime.train_state import is_distillation, train_step

_META = ge._tsm_model().dataset_meta
_SCORE_THRESH = [0.05, 0.05, 0.05]


def _jax_teacher_cfg(score_thresh=None):
    """The JAX package's tiny config turned into its teacher phase, as
    tiny.tiny_teacher_model_cfg does for the port's copy."""
    cfg = ge._tsm_model_cfg()
    cfg["BACKBONE_3D"]["NAME"] = "VoxelPointNet2FSMSG"
    del cfg["BACKBONE_3D"]["S_SA_CONFIG"]
    cfg["POINT_HEAD"]["NAME"] = "PointHeadVoteSASAStatistic"
    del cfg["POINT_HEAD"]["S_VOTE_CONFIG"], cfg["POINT_HEAD"]["S_VSA_CONFIG"]
    if score_thresh is not None:
        cfg["POST_PROCESSING"]["SCORE_THRESH"] = score_thresh
    return cfg


_JMODEL = jbuild(_jax_teacher_cfg(), num_class=3, dataset=_META)
_JEVAL = jbuild(_jax_teacher_cfg(_SCORE_THRESH), num_class=3, dataset=_META)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port while this module runs: beside XLA's
    CPU thread pools, torch's own pool slows the tiny step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_batch(which):
    batch = dict(ge._synth_batch(2, with_gt=True, seed=0))
    if which != "sparse":
        gt, mask = tiny.synth_gt(2, which)
        batch["gt_boxes"], batch["gt_boxes_mask"] = gt, mask
    return {k: (np.asarray(v) if k != "batch_size" else v) for k, v in batch.items()}


def _port_batch(which):
    return {k: (torch.from_numpy(np.array(v)) if k != "batch_size" else v)
            for k, v in _jax_batch(which).items()}


def _jax_init():
    v = jax.jit(lambda r, b: _JMODEL.init(r, b, training=True))(
        jax.random.PRNGKey(0), _jax_batch("sparse"))
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _with_overrides(v):
    """tiny.teacher_overrides() on the flax tree."""
    v = jax.tree_util.tree_map(np.array, v)
    stats = v["statistics"]["module_list_1"]["head"]
    for k, arr in tiny.train_statistics().items():
        stats[k] = arr
    v["params"]["module_list_0"]["sa1"]["confidence_out"]["bias"] = np.asarray(
        tiny.TEACHER_CONF_BIAS, np.float32)
    return v


@jax.jit
def _jax_loss_grad(variables, batch):
    def loss_fn(params):
        out, mutated = _JMODEL.apply(
            dict(variables, params=params), batch, training=True,
            mutable=["batch_stats", "statistics"])
        return out["loss"], (out["tb_dict"], mutated["batch_stats"],
                             mutated["statistics"])

    (loss, (tb, stats, statistics)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    return loss, tb, stats, statistics, grads


@jax.jit
def _jax_eval(variables, points, mask):
    out = _JEVAL.apply(variables, {"points": points, "points_mask": mask,
                                   "batch_size": 2}, training=False)
    pred, _ = _JEVAL.apply(variables, out, method=lambda m, bd: m.post_processing(bd))
    keys = ("batch_cls_preds", "batch_box_preds", "point_coords", "point_vote_coords")
    return {k: out[k] for k in keys}, pred


@pytest.fixture(scope="module")
def init():
    return _jax_init()


@pytest.fixture(scope="module")
def variables(init):
    return _with_overrides(init)


@pytest.fixture(scope="module")
def jax_step(variables):
    out = {}
    for which in ("sparse", "wide"):
        loss, tb, stats, statistics, grads = jax.tree_util.tree_map(
            np.asarray, _jax_loss_grad(variables, _jax_batch(which)))
        out[which] = dict(
            loss=loss, tb=tb, grads=from_flax_variables({"params": grads}),
            stats=from_flax_variables({"batch_stats": stats}),
            statistics=from_flax_variables({"statistics": statistics}))
    return out


def _port_model(variables, cfg=None):
    model = build_network(cfg or tiny.tiny_teacher_model_cfg(), 3, tiny.META, device="cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model


def _port_backward(variables, which):
    model = _port_model(variables).train()
    out = model(_port_batch(which))
    out["loss"].backward()
    return model, out


def _grad_scale(grads):
    return max(float(np.abs(np.asarray(g)).max()) for g in grads.values())


# ---------------------------------------------------------------------------
# build and convert
# ---------------------------------------------------------------------------

def test_tiny_teacher_cfg_is_the_jax_one():
    import json

    assert json.dumps(tiny.tiny_teacher_model_cfg(), sort_keys=True) == json.dumps(
        _jax_teacher_cfg(), sort_keys=True)


def test_converter_consumes_every_teacher_leaf(init):
    """Every leaf of the JAX teacher's training init converts and is used
    (strict load), the branch-owned statistics and head/reg_weight too; the
    overrides name port entries that exist."""
    state = from_flax_variables(init)
    assert len(state) == len(jax.tree_util.tree_leaves(init))
    model = build_network(tiny.tiny_teacher_model_cfg(), 3, tiny.META, device="cpu")
    model.load_state_dict(state, strict=True)
    for k in ("module_list.1.head.reg_weight", "module_list.1.head.object_statistic_features",
              "module_list.1.head.object_momentum", "module_list.1.head.object_mean"):
        assert k in state
    assert not float(state["module_list.1.head.object_statistic_features"].abs().max())
    assert set(tiny.teacher_overrides()) <= set(state)
    assert not is_distillation(tiny.tiny_teacher_model_cfg())


def test_full_teacher_config_builds():
    """fast_cpc_teacher.yaml builds at full width on the CPU (no forward):
    the teacher pair, 256-wide U-Net and SHARED_FC; a mixed backbone / head
    pair raises."""
    cfg = infer.load_cfg(infer.ROOT / "tools/cfgs/kitti_models/fast_cpc_teacher.yaml")
    meta = infer.dataset_meta(cfg, 16384, "train")
    model = build_network(cfg.MODEL, 3, meta, device="cpu")
    assert [type(m).__name__ for m in model.module_list] == [
        "VoxelPointNet2FSMSG", "PointHeadVoteSASAStatistic"]
    sd = model.state_dict()
    assert tuple(sd["module_list.0.sa1.inv16x_a.weight"].shape) == (27, 256, 256)
    assert tuple(sd["module_list.1.head.object_mean"].shape) == (3, 256)
    mixed = tiny.tiny_teacher_model_cfg()
    mixed.POINT_HEAD["NAME"] = "PointHeadVoteSASAStatisticDistillation"
    with pytest.raises(NotImplementedError):
        build_network(mixed, 3, tiny.META, device="cpu")


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_eval_forward_and_post_processing(init, seed):
    v = _random_variables(init, seed)
    cfg = tiny.tiny_teacher_model_cfg()
    cfg["POST_PROCESSING"]["SCORE_THRESH"] = _SCORE_THRESH
    pts = tiny.synth_points(2, seed=seed + 7)
    want, jpred = jax.tree_util.tree_map(
        np.asarray, _jax_eval(v, pts, np.ones(pts.shape[:2], bool)))
    model = _port_model(v, cfg)
    out, pred = infer.detect(model, torch.from_numpy(pts),
                             torch.ones(pts.shape[:2], dtype=torch.bool))
    np.testing.assert_array_equal(out["point_coords"].numpy(), want["point_coords"])
    for k in ("batch_cls_preds", "batch_box_preds", "point_vote_coords"):
        _assert_golden_close(out[k].numpy(), want[k], k)
    np.testing.assert_array_equal(pred["count"].numpy(), jpred["count"])
    assert jpred["count"].sum() > 0, "the case must reach NMS"
    np.testing.assert_array_equal(pred["pred_labels"].numpy(), jpred["pred_labels"])
    _assert_golden_close(pred["pred_scores"].numpy(), jpred["pred_scores"], "scores")
    _assert_golden_close(pred["pred_boxes"].numpy(), jpred["pred_boxes"], "boxes")


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["sparse", "wide"])
def test_loss_and_tb_terms(variables, jax_step, which):
    _, out = _port_backward(variables, which)
    want = jax_step[which]
    _close_scalar(out["loss"].detach(), want["loss"], "loss")
    assert set(out["tb_dict"]) == set(want["tb"])
    for k, v in want["tb"].items():
        _close_scalar(torch.as_tensor(out["tb_dict"][k]).detach(), v, k)
    if which == "wide":
        assert float(want["tb"]["n_pos"]) > 0, "the wide boxes must give positives"


def _check_every_gradient(model, grads):
    scale = _grad_scale(grads)
    for name, p in model.named_parameters():
        assert p.grad is not None, f"{name} got no gradient"
        _close_grad(p.grad.numpy(), grads[name].numpy(), name, scale)
    assert set(grads) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("which", ["sparse", "wide"])
def test_every_gradient(variables, jax_step, which):
    """Every parameter's gradient, both SA layers (the U-Net's convs, K2's
    payload gradient into layer 0), the head and its gated regression."""
    model, _ = _port_backward(variables, which)
    _check_every_gradient(model, jax_step[which]["grads"])
    # the box losses have positives only under the wide boxes
    names = ("module_list.0.sa0.point_mlp0.fc0.weight", "module_list.0.sa1.inv16x_a.weight")
    for name in names + (("module_list.1.head.reg_weight",) if which == "wide" else ()):
        assert float(jax_step[which]["grads"][name].abs().max()) > 0, name


@pytest.mark.parametrize("which", ["sparse", "wide"])
def test_bn_stats_and_statistics_after_step(variables, jax_step, which):
    model, _ = _port_backward(variables, which)
    state = model.state_dict()
    stats = jax_step[which]["stats"]
    assert len(stats) > 50
    for key, want in stats.items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    statistics = jax_step[which]["statistics"]
    assert len(statistics) == 3
    for key, want in statistics.items():
        w = want.numpy()
        np.testing.assert_allclose(state[key].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=key)


def test_statistic_counts_zero_and_nonzero(variables, jax_step):
    """Under the overrides the update counts points of classes 0 and 1 and
    none of class 2: classes 0 and 1 move (mean, momentum, statistics) and
    class 2 keeps its values exactly, on both sides."""
    model, out = _port_backward(variables, "wide")
    counts = out["statistic_counts"].tolist()
    assert counts[0] > 0 and counts[1] > 0 and counts[2] == 0, counts
    before = tiny.train_statistics()
    for key, want in jax_step["wide"]["statistics"].items():
        leaf = key.rpartition(".")[2]
        got = model.state_dict()[key].numpy()
        np.testing.assert_array_equal(got[2], before[leaf][2])
        np.testing.assert_array_equal(want.numpy()[2], before[leaf][2])
        assert np.abs(got[:2] - before[leaf][:2]).min() > 0, key


def test_detach_trap(variables, jax_step, monkeypatch):
    """The update's new statistics are read by this step's cls conditioning
    and gated regression, in the graph: `jax.grad` reaches the backbone's
    last layer through them. Detached statistics give other gradients
    there; the port's route gives JAX's."""
    want = jax_step["wide"]["grads"]
    scale = _grad_scale(want)
    last = [k for k in want if k.startswith("module_list.0.sa1.aggregation.")]
    assert last

    def off(model):
        bad = []
        for k in last:
            try:
                _close_grad(dict(model.named_parameters())[k].grad.numpy(),
                            want[k].numpy(), k, scale)
            except AssertionError:
                bad.append(k)
        return bad

    model, _ = _port_backward(variables, "wide")
    assert off(model) == []
    orig = thead.VoteHeadBranch._update_statistics

    def detached(self, *args):
        stats, counts = orig(self, *args)
        return stats.detach(), counts

    monkeypatch.setattr(thead.VoteHeadBranch, "_update_statistics", detached)
    model, _ = _port_backward(variables, "wide")
    assert off(model), "detached statistics must change the backbone's gradients"


def test_branch_losses_teacher_route():
    """_branch_losses with teacher_out=None: quality labels to the power
    0.5, no teacher blend, un-prefixed tb keys; values and the gradient of
    every prediction it reads against the JAX function (rtol 1e-5, atol
    1e-5 * max(1, max|want|), as tests/test_torch_losses.py)."""
    import jax.numpy as jnp

    from tests.test_torch_losses import _DIFF, _branch_case, _close, _t
    from tsm_det_pointcloud_tpu.ops import box_coder_utils as jcoder
    from tsm_det_pointcloud_tpu_torch.ops import box_coder_utils as tcoder

    out, _, boxes, valid = _branch_case(10)
    cfg = tiny.tiny_teacher_model_cfg()["POINT_HEAD"]
    cfg["TARGET_CONFIG"]["GT_CENTRAL_RADIUS"] = 3.0

    def jfn(diff):
        o = dict(jax.tree_util.tree_map(jnp.asarray, out), **diff)
        _, loss, tb = jhead._branch_losses(
            o, jnp.asarray(boxes), jnp.asarray(valid),
            jcoder.PointBinResidualCoder(angle_bin_num=12), cfg, 3)
        return loss, tb

    (jl, jtb), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(out[k]) for k in _DIFF})
    diff = {k: _t(out[k]).requires_grad_(True) for k in _DIFF}
    tout = dict({k: _t(v) for k, v in out.items()}, **diff)
    _, tl, ttb = thead._branch_losses(tout, None, _t(boxes), _t(valid),
                                      tcoder.PointBinResidualCoder(angle_bin_num=12), cfg, 3)
    _close(tl, jl, "loss")
    assert set(ttb) == set(jtb) and "cls_loss" in ttb
    for k in jtb:
        _close(ttb[k], jtb[k], k)
    assert float(jtb["n_pos"]) > 0
    tl.backward()
    for k in _DIFF:
        _close(diff[k].grad, jgrad[k], f"d loss / d {k}")


# ---------------------------------------------------------------------------
# two optimizer steps
# ---------------------------------------------------------------------------

def test_two_adam_steps_every_parameter(variables):
    """adam_onecycle over every parameter of the teacher, two steps, against
    optax; BN running stats and class statistics follow JAX's. Each step's
    gradients are first held to the gradient tolerance (module docstring).
    Then, as in tests/test_torch_tsm_train.py's two-step test, parameters
    within rtol 1e-4 plus atol 1e-4 * lr, and Adam's moments within rtol
    1e-3 (mu) / 2e-3 (nu), except at the elements whose step is noise-driven,
    which are held within 2 * lr: there the JAX gradient is under the
    rounding floor (1e-6 * the largest |g|), or the two gradients differ by
    more than 1e-4 of it (still inside the gradient tolerance: the deep
    U-Net's smallest elements). Adam divides each element by its own
    magnitude, and the second step also by the first one's moments, so such
    an element's relative gradient error reaches its step."""
    batch = _jax_batch("wide")
    tx, _ = jbuild_optimizer(OPTIM, total_steps=TOTAL_STEPS)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=0,
                       statistics=variables["statistics"])
    jstep = create_train_step(_JMODEL, tx, donate=False)

    model = _port_model(variables)
    params = dict(model.named_parameters())
    opt = build_optimizer(OPTIM, list(params.values()), TOTAL_STEPS)
    pbatch = _port_batch("wide")
    for i in range(2):
        before = {k: p.detach().clone() for k, p in params.items()}
        vs = dict(variables, params=state.params, batch_stats=state.batch_stats,
                  statistics=state.statistics)
        grads = from_flax_variables({"params": jax.tree_util.tree_map(
            np.asarray, _jax_loss_grad(vs, batch)[4])})
        gscale = _grad_scale(grads)
        state, _ = jstep(state, batch)
        loss, tb = train_step(model, opt, pbatch)
        assert torch.isfinite(loss) and {"cls_loss", "sasa_loss"} <= set(tb)
        noise = {}
        for name, p in params.items():
            # every parameter trains: it moved, or its gradient and value
            # are zero (AdamW's decay moves any other)
            assert not torch.equal(p.detach(), before[name]) or not (
                p.grad.abs().max() or before[name].abs().max()), f"{name} did not move"
            gj, gp = grads[name].numpy(), p.grad.numpy()
            _close_grad(gp, gj, f"step {i} gradient of {name}", gscale)
            noise[name] = ((np.abs(gj) <= 1e-6 * gscale)
                           | (np.abs(gp - gj) > 1e-4 * np.abs(gj)))
        want = from_flax_variables(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats,
            "statistics": state.statistics}))
        lr = opt.lr_fn(i)
        for name, p in params.items():
            w = want[name].numpy()
            d = np.abs(p.detach().numpy() - w)
            bad = ~noise[name] & (d > 1e-4 * np.abs(w) + 1e-4 * lr)
            assert not bad.any(), f"{name}: {int(bad.sum())} elements off, by up to {d[bad].max()}"
            assert d.max() <= 2 * lr, f"{name} off by {d.max()}"
        got = model.state_dict()
        for key in want:
            if key in params:
                continue
            w = want[key].numpy()
            np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                       err_msg=key)
        # the moments at the gradients' tolerance; then the port takes step 2
        # from the JAX state (see tests/test_torch_tsm_train.py)
        mu, nu = (from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, m)})
                  for m in _adam_moments(state.opt_state))
        for which, moment, rtol in (("mu", mu, 1e-3), ("nu", nu, 2e-3)):
            scale = max(float(m.abs().max()) for m in moment.values())
            for name, m in moment.items():
                got_m = opt.state[params[name]][which]
                d = np.abs(got_m.numpy() - m.numpy())
                bad = ~noise[name] & (d > rtol * np.abs(m.numpy()) + 1e-6 * scale)
                assert not bad.any(), f"{which} of {name}"
                got_m.copy_(m)
        model.load_state_dict(want, strict=True)


# ---------------------------------------------------------------------------
# the committed tiny files
# ---------------------------------------------------------------------------

def _forward_golden(variables):
    pts = tiny.synth_points(2)
    want, _ = _jax_eval(variables, pts, np.ones(pts.shape[:2], bool))
    return {k: np.asarray(v) for k, v in want.items()}


def _train_golden(variables):
    loss, tb, _, statistics, grads = jax.tree_util.tree_map(
        np.asarray, _jax_loss_grad(variables, _jax_batch("wide")))
    out = {"loss": loss}
    out.update({f"tb/{k}": v for k, v in tb.items()})
    out.update({f"grad/{k}": v.numpy()
                for k, v in from_flax_variables({"params": grads}).items()})
    out.update({f"stat/{k}": v.numpy()
                for k, v in from_flax_variables({"statistics": statistics}).items()})
    return out


def write_teacher_tiny_files():
    """Write the converted init, the forward golden and the train golden."""
    init = _jax_init()
    v = _with_overrides(init)
    np.savez_compressed(tiny.TEACHER_STATE_PATH, **{
        k: t.numpy() for k, t in from_flax_variables(init).items()})
    np.savez_compressed(tiny.TEACHER_FORWARD_PATH, **_forward_golden(v))
    np.savez_compressed(tiny.TEACHER_TRAIN_GOLDEN_PATH, **_train_golden(v))


def _assert_committed(path, want, rtol, atol_scale):
    with np.load(path) as got:
        assert set(got.files) == set(want)
        for k in got.files:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       atol=atol_scale * float(np.abs(want[k]).max()),
                                       err_msg=k)


def test_committed_teacher_state_is_the_converted_init(init):
    """rtol 1e-6, atol 1e-7 * max|want|: the init's float32 arithmetic may
    round differently on another CPU."""
    want = {k: t.numpy() for k, t in from_flax_variables(init).items()}
    _assert_committed(tiny.TEACHER_STATE_PATH, want, 1e-6, 1e-7)


def test_committed_teacher_forward_golden_is_current(variables):
    """rtol 1e-5, atol 1e-6 * max|want| (XLA's f32 sums on another CPU)."""
    _assert_committed(tiny.TEACHER_FORWARD_PATH, _forward_golden(variables), 1e-5, 1e-6)


def test_committed_teacher_train_golden_is_current(variables):
    _assert_committed(tiny.TEACHER_TRAIN_GOLDEN_PATH, _train_golden(variables), 1e-5, 1e-6)


def _committed_port_model():
    model = build_network(tiny.tiny_teacher_model_cfg(), 3, tiny.META, device="cpu")
    model.load_state_dict(tiny.load_state(tiny.TEACHER_STATE_PATH), strict=True)
    state = model.state_dict()
    for k, v in tiny.teacher_overrides().items():
        state[k].copy_(torch.from_numpy(v))
    return model


def test_port_reproduces_teacher_goldens():
    """The checks chip_smoke.py makes on the card, here on the CPU: the
    committed state with the overrides reproduces the forward golden
    (golden tolerance) and the train golden (the step's tolerances)."""
    model = _committed_port_model()
    pts = torch.from_numpy(tiny.synth_points(2))
    out, _ = infer.detect(model, pts, torch.ones(pts.shape[:2], dtype=torch.bool))
    with np.load(tiny.TEACHER_FORWARD_PATH) as golden:
        for k in golden.files:
            _assert_golden_close(out[k].numpy(), golden[k], k)
    out = model.train()(_port_batch("wide"))
    out["loss"].backward()
    params = dict(model.named_parameters())
    state = model.state_dict()
    with np.load(tiny.TEACHER_TRAIN_GOLDEN_PATH) as golden:
        gold = {k: golden[k] for k in golden.files}
    scale = max(float(np.abs(v).max()) for k, v in gold.items() if k.startswith("grad/"))
    assert {k[5:] for k in gold if k.startswith("grad/")} == set(params)
    for k, want in gold.items():
        if k.startswith("grad/"):
            _close_grad(params[k[5:]].grad.numpy(), want, k, scale)
        elif k.startswith("stat/"):
            np.testing.assert_allclose(state[k[5:]].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                       err_msg=k)
        elif k == "loss":
            _close_scalar(out["loss"].detach(), want, k)
        else:
            _close_scalar(torch.as_tensor(out["tb_dict"][k[3:]]).detach(), want, k)
