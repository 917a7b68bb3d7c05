"""The port's options that no shipped config takes, held function by function
against the JAX package on the CPU: axis-aligned NMS (`nms_normal`, the
axis-aligned suppression matrix and its keep fixpoints), the NMS dispatch
on NMS_TYPE and the per-pass route of `multi_thresh_nms`, the residual
coder's sin / cos heading and the binned coder's class mean sizes, the
adam and sgd optimizers on a step-decay learning rate, and the frustum
dropouts.

Tolerances: kept index sets, counts, masks, kept points and boxes exact
(the two sides compare the same float32 products, and top-k ties go to the
lower index on both); kept scores and coder outputs 1e-6 (atol, relative to
max(1, |value|)); the optimizers' parameters after each of 5 steps rtol 1e-6,
atol 1e-7 (f32 arithmetic in nearly the same order; the JAX schedule is f32,
as the port's).
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tsm_det_pointcloud_tpu.datasets.augmentor import augmentor_utils as jaug
from tsm_det_pointcloud_tpu.datasets.augmentor.data_augmentor import (
    DataAugmentor as JDataAugmentor,
)
from tsm_det_pointcloud_tpu.models.model_utils import model_nms_utils as jnms
from tsm_det_pointcloud_tpu.ops import box_coder_utils as jcoder
from tsm_det_pointcloud_tpu.ops import iou3d as jiou
from tsm_det_pointcloud_tpu.runtime.optimization import build_optimizer as jbuild_optimizer
from tsm_det_pointcloud_tpu.utils.edict import EDict as JEDict
from tsm_det_pointcloud_tpu_torch.datasets.augmentor import augmentor_utils as aug
from tsm_det_pointcloud_tpu_torch.datasets.augmentor.data_augmentor import DataAugmentor
from tsm_det_pointcloud_tpu_torch.models.model_utils import model_nms_utils as nms
from tsm_det_pointcloud_tpu_torch.ops import box_coder_utils as coder
from tsm_det_pointcloud_tpu_torch.ops import iou3d
from tsm_det_pointcloud_tpu_torch.runtime.optimization import build_optimizer
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _boxes(n, seed, spread=20.0):
    """(n, 7) boxes in clusters (so that many pairs overlap), headings in
    [-pi, pi), and scores with repeated values (ties) and -inf slots."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-spread, spread, (max(n // 8, 1), 2))
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = centres[rng.randint(0, len(centres), n)] + rng.normal(0, 0.8, (n, 2))
    b[:, 2] = rng.uniform(-1.5, 0.5, n)
    b[:, 3:6] = rng.uniform([1.0, 0.5, 1.0], [4.5, 2.0, 2.0], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)   # ~100 distinct values
    scores[rng.uniform(size=n) < 0.1] = -np.inf
    return b, scores


def _same_selection(got, want, what):
    idx, cnt, sc = (np.asarray(x) for x in got)
    widx, wcnt, wsc = (np.asarray(x) for x in want)
    assert int(cnt) == int(wcnt), what
    np.testing.assert_array_equal(idx[:int(cnt)], widx[:int(wcnt)], err_msg=what)
    np.testing.assert_allclose(sc[:int(cnt)], wsc[:int(wcnt)], rtol=0, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("pre,post", [(64, 16), (300, 500)])
def test_nms_normal(pre, post):
    """nms_normal over 300 boxes with ties and -inf scores: the kept
    indices, count and scores of the JAX function."""
    b, s = _boxes(300, 1)
    got = iou3d.nms_normal(torch.from_numpy(b), torch.from_numpy(s), 0.1, pre, post)
    want = jiou.nms_normal(jnp.asarray(b), jnp.asarray(s), 0.1, pre, post)
    _same_selection(got, want, "nms_normal")


@pytest.mark.parametrize("rotated", [False, True])
def test_suppression_matrix_and_its_fixpoints(rotated):
    """The axis-aligned (and the rotated) suppression matrix equal to the
    JAX one; the keep fixpoints on it (`nms_from_matrix`,
    `nms_keep_mask_from_matrix`) equal to the JAX ones."""
    b, s = _boxes(200, 2)
    tm = iou3d.suppression_matrix(torch.from_numpy(b), 0.2, rotated=rotated)
    jm = jiou.suppression_matrix(jnp.asarray(b), 0.2, rotated=rotated)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _same_selection(iou3d.nms_from_matrix(tm, torch.from_numpy(s), 64, 32),
                    jiou.nms_from_matrix(jm, jnp.asarray(s), 64, 32), "from matrix")
    np.testing.assert_array_equal(
        iou3d.nms_keep_mask_from_matrix(tm, torch.from_numpy(s), 64, 32).numpy(),
        np.asarray(jiou.nms_keep_mask_from_matrix(jm, jnp.asarray(s), 64, 32)))


@pytest.mark.parametrize("nms_type", ["nms_gpu", "nms_normal"])
def test_class_agnostic_nms_dispatch(nms_type):
    b, s = _boxes(300, 3)
    cfg = {"NMS_TYPE": nms_type, "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 128,
           "NMS_POST_MAXSIZE": 32}
    got = nms.class_agnostic_nms(torch.from_numpy(s), torch.from_numpy(b), cfg, 0.3)
    want = jnms.class_agnostic_nms(jnp.asarray(s), jnp.asarray(b), cfg, 0.3)
    _same_selection(got, want, nms_type)


# n one above max(pre, 4096) takes the per-pass route, n = 4096 the matrix
# route (axis-aligned there: a rotated 4096^2 grid is too big for this test)
@pytest.mark.parametrize("n,nms_type", [(4097, "nms_normal"), (4097, "nms_gpu"),
                                        (4096, "nms_normal")])
def test_multi_thresh_nms_routes(n, nms_type):
    """multi_thresh_nms on either side of its route boundary: the kept
    indices, count and scores of the JAX function, with ties, -inf scores
    and three classes at their own thresholds."""
    b, s = _boxes(n, 4, spread=60.0)
    labels = np.random.RandomState(5).randint(1, 4, n).astype(np.int32)
    cfg = {"NMS_TYPE": nms_type, "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 96,
           "NMS_POST_MAXSIZE": 40}
    thresh = [0.3, 0.5, 0.2]
    got = nms.multi_thresh_nms(torch.from_numpy(s), torch.from_numpy(b),
                               torch.from_numpy(labels), cfg, thresh)
    want = jnms.multi_thresh_nms(jnp.asarray(s), jnp.asarray(b), jnp.asarray(labels),
                                 cfg, thresh)
    _same_selection(got, want, f"{n} {nms_type}")
    assert 0 < int(got[1]) <= 40


def _coder_case(seed=6):
    rng = np.random.RandomState(seed)
    anchors = np.zeros((64, 9), np.float32)
    anchors[:, 0:3] = rng.uniform(-20, 20, (64, 3))
    anchors[:, 3:6] = rng.uniform(0.4, 5.0, (64, 3))
    anchors[:, 6] = rng.choice([0.0, 1.57], 64)
    anchors[:, 7:9] = rng.normal(0, 1, (64, 2))
    boxes = anchors + rng.normal(0, 0.3, anchors.shape).astype(np.float32)
    boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 0.1
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 64)
    return boxes, anchors


def _close6(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=what)


def test_residual_coder_sincos():
    """encode_angle_by_sincos: code size 7 + 1 (+ the extra columns), the
    encoding and the decoding of the JAX coder, and decode(encode(b)) = b
    with the heading wrapped to (-pi, pi]."""
    boxes, anchors = _coder_case()
    port = coder.ResidualCoder(code_size=7, encode_angle_by_sincos=True)
    jc = jcoder.ResidualCoder(code_size=7, encode_angle_by_sincos=True)
    assert port.code_size == jc.code_size == 8
    enc = port.encode(torch.from_numpy(boxes), torch.from_numpy(anchors))
    _close6(enc.numpy(), jc.encode(jnp.asarray(boxes), jnp.asarray(anchors)), "encode")
    assert enc.shape[-1] == 10
    dec = port.decode(enc, torch.from_numpy(anchors))
    _close6(dec.numpy(), jc.decode(jnp.asarray(enc.numpy()), jnp.asarray(anchors)), "decode")
    _close6(dec[:, [0, 1, 2, 3, 4, 5, 7, 8]].numpy(), boxes[:, [0, 1, 2, 3, 4, 5, 7, 8]],
            "round trip")
    _close6(torch.atan2(torch.sin(dec[:, 6]), torch.cos(dec[:, 6])).numpy(),
            np.arctan2(np.sin(boxes[:, 6]), np.cos(boxes[:, 6])), "heading")


MEAN_SIZE = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]


def test_point_bin_coder_mean_size():
    """use_mean_size: the JAX coder's encoding and decoding by class, the
    round trip (heading modulo 2 pi), and a decode without classes raising
    TypeError in both packages (their vote heads pass none)."""
    boxes, anchors = _coder_case(7)
    classes = np.random.RandomState(8).randint(1, 4, 64).astype(np.int32)
    kw = dict(use_mean_size=True, mean_size=MEAN_SIZE, angle_bin_num=12)
    port, jc = coder.PointBinResidualCoder(**kw), jcoder.PointBinResidualCoder(**kw)
    pts = anchors[:, :3]
    enc = port.encode(torch.from_numpy(boxes[:, :7]), torch.from_numpy(pts),
                      torch.from_numpy(classes))
    _close6(enc.numpy(), jc.encode(jnp.asarray(boxes[:, :7]), jnp.asarray(pts),
                                   jnp.asarray(classes)), "encode")
    dec = port.decode(enc, torch.from_numpy(pts), torch.from_numpy(classes))
    _close6(dec.numpy(), jc.decode(jnp.asarray(enc.numpy()), jnp.asarray(pts),
                                   jnp.asarray(classes)), "decode")
    _close6(dec[:, :6].numpy(), boxes[:, :6], "round trip")
    _close6(np.mod(dec[:, 6].numpy() - boxes[:, 6] + np.pi, 2 * np.pi) - np.pi,
            np.zeros(64), "heading")
    with pytest.raises(TypeError):
        jc.decode(jnp.asarray(enc.numpy()), jnp.asarray(pts))
    with pytest.raises(TypeError):
        port.decode(enc, torch.from_numpy(pts))


OPTIMS = {
    "adam": {"OPTIMIZER": "adam", "LR": 0.003, "WEIGHT_DECAY": 0.01,
             "DECAY_STEP_LIST": [2, 4], "LR_DECAY": 0.1, "LR_CLIP": 1e-7,
             "GRAD_NORM_CLIP": 10},
    "sgd": {"OPTIMIZER": "sgd", "LR": 0.003, "WEIGHT_DECAY": 0.01, "MOMENTUM": 0.9,
            "DECAY_STEP_LIST": [2, 4], "LR_DECAY": 0.1, "LR_CLIP": 1e-7,
            "GRAD_NORM_CLIP": 10},
}


def _params():
    rng = np.random.RandomState(0)
    return {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}


def _grads(step):
    """Gradients of step `step`; even steps above the clip's norm 10."""
    rng = np.random.RandomState(50 + step)
    scale = 12.0 if step % 2 == 0 else 0.5
    return {"a": rng.randn(4, 3).astype(np.float32) * scale,
            "b": rng.randn(3).astype(np.float32) * scale}


def _port_steps(cfg, steps, start=None):
    """The port's parameters after `steps` steps (one epoch = one step, so
    that DECAY_STEP_LIST [2, 4] falls inside them); with `start` (an
    optimizer state dict and parameters) it resumes from there."""
    p = start[1] if start else _params()
    params = nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v.copy()))
                               for k, v in p.items()})
    opt = build_optimizer(cfg, list(params.values()), 5, steps_per_epoch=1)
    done = 0
    if start:
        opt.load_state_dict(start[0])
        done = opt.state["count"]
    out = []
    for i in range(done, done + steps):
        for k, prm in params.items():
            prm.grad = torch.from_numpy(_grads(i)[k])
        out.append((opt.lr_fn(i), {k: v.detach().numpy().copy() for k, v in params.items()}))
        opt.step()
        out[-1] = (out[-1][0], {k: v.detach().numpy().copy() for k, v in params.items()})
    return out, opt.state_dict(), {k: v.detach().numpy().copy() for k, v in params.items()}


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_against_optax(name):
    """5 steps across both DECAY_STEP_LIST boundaries with the clip on at
    every other step: each step's lr (0.003, 0.003, 3e-4, 3e-4, 3e-5) and the
    parameters after it equal optax's chain of the JAX build_optimizer."""
    cfg = OPTIMS[name]
    tx, lr_fn = jbuild_optimizer(cfg, total_steps=5, steps_per_epoch=1)
    p = {k: jnp.asarray(v) for k, v in _params().items()}
    state = tx.init(p)
    got, _, _ = _port_steps(cfg, 5)
    for i in range(5):
        np.testing.assert_allclose(got[i][0], float(lr_fn(i)), rtol=1e-6, atol=0)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in _grads(i).items()}, state, p)
        p = optax.apply_updates(p, upd)
        for k in p:
            np.testing.assert_allclose(got[i][1][k], np.asarray(p[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} step {i} {k}")
    np.testing.assert_allclose([got[i][0] for i in range(5)],
                               [0.003, 0.003, 3e-4, 3e-4, 3e-5], rtol=1e-6)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_state_resumes(name):
    """3 steps, the optimizer's state dict (its step count and moments or
    trace) carried into a new optimizer, 2 more: the parameters of 5
    straight steps, bit for bit."""
    straight, _, _ = _port_steps(OPTIMS[name], 5)
    _, sd, params = _port_steps(OPTIMS[name], 3)
    resumed, _, _ = _port_steps(OPTIMS[name], 2, start=(sd, params))
    for k in params:
        np.testing.assert_array_equal(resumed[-1][1][k], straight[-1][1][k])


def _scene(seed=9):
    rng = np.random.RandomState(seed)
    pts = np.zeros((4000, 4), np.float32)
    pts[:, 0] = rng.uniform(0, 70, 4000)
    pts[:, 1] = rng.uniform(-40, 40, 4000)
    pts[:, 2] = rng.uniform(-3, 1, 4000)
    pts[:, 3] = rng.uniform(0, 1, 4000)
    boxes = np.zeros((12, 7), np.float32)
    boxes[:, 0] = rng.uniform(5, 65, 12)
    boxes[:, 1] = np.linspace(-38, 38, 12)
    boxes[:, 2] = np.linspace(-2.8, 0.8, 12)
    boxes[:, 3:6] = [3.9, 1.6, 1.56]
    return boxes, pts


@pytest.mark.parametrize("direction", ["top", "bottom", "left", "right"])
def test_frustum_dropout(direction):
    """Each direction keeps the JAX function's points and boxes (one seed of
    the sample's generator, intensity in [0, 0.2]) and drops some of both."""
    boxes, pts = _scene()
    fn = f"global_frustum_dropout_{direction}"
    gb, gp = getattr(aug, fn)(boxes, pts, np.random.default_rng(6), [0.0, 0.2])
    wb, wp = getattr(jaug, fn)(boxes, pts, np.random.default_rng(6), [0.0, 0.2])
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(gp, wp)
    assert len(gp) < len(pts) and 0 < len(gb) < len(boxes)


def test_frustum_dropout_augmentor_and_the_mask():
    """random_world_frustum_dropout (DIRECTION top, left) draws from the
    sample's generator in the JAX order: the same points and boxes; with a
    gt_boxes_mask, a dropped box fails the mask at the end of forward in
    both packages alike (the dropout cuts neither the names nor the mask),
    and a sample that drops none passes."""
    boxes, pts = _scene()
    cfg = {"NAME": "random_world_frustum_dropout", "DIRECTION": ["top", "left"],
           "INTENSITY_RANGE": [0.0, 0.2]}
    port = DataAugmentor(None, [EDict(cfg)], ["Car"])
    jax_aug = JDataAugmentor(None, [JEDict(cfg)], ["Car"])

    def sample(b):
        return {"gt_boxes": b.copy(), "points": pts.copy(),
                "gt_names": np.array(["Car"] * len(b))}

    got = port.forward(sample(boxes), np.random.default_rng(4))
    want = jax_aug.forward(sample(boxes), np.random.default_rng(4))
    for k in ("gt_boxes", "points"):
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["gt_boxes"]) < len(boxes)
    masked = dict(sample(boxes), gt_boxes_mask=np.ones(len(boxes), bool))
    with pytest.raises(IndexError):
        jax_aug.forward(dict(masked), np.random.default_rng(4))
    with pytest.raises(IndexError):
        port.forward(dict(masked), np.random.default_rng(4))
    low = boxes[:1].copy()
    low[:, 1:3] = [0.0, -2.0]
    kept = port.forward(dict(sample(low), gt_boxes_mask=np.ones(1, bool)),
                        np.random.default_rng(4))
    assert len(kept["gt_boxes"]) == 1
