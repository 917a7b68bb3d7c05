"""The port's PointRCNN against the JAX package on the CPU.

Ops: `first_k_true` (empty rows, rows with more hits than K, K past the
hits), `three_nn` / `three_interpolate_weights` / `three_interpolate` on a
lattice (exact ties), with invalid known points and rows with fewer than
three valid (indices exact, values rtol 1e-6, NaN where the JAX weights are
NaN), PointResidualCoder's encode and decode. Modules, each fed the JAX
module's own input: one PointnetSAModuleMSG (its d-fps picks and each
scale's ball-query indices and counts exact), one PointnetFPModule (with
invalid known points), PointNet2MSG, PointHeadBox (eval outputs, labels with
the GT_EXTRA_WIDTH band, both losses), `roipoint_pool` (an empty and a
padded RoI, a RoI with more points than slots; values and gradients) and
PointRCNNHead (the in-RoI SA stack and GroupAll terminal: one d-fps and one
query_group call; RoIs and labels exact), and the RCNN losses with a
non-empty foreground: RoIs made from jittered gt boxes, the regression and
corner losses and their gradients against the JAX head's. Whole: the tiny
PointRCNN's eval outputs and post-processed predictions, the committed init
and golden, one training step (loss, tb terms, every gradient, BN
statistics) and a second step from the state the JAX step reached.

Tolerances: modules' features rtol 1e-4 / atol 1e-5; outputs at the golden
one (atol 1e-3 * max(1, max|want|), rtol 1e-3); labels, counts, picks, group
indices, RoIs' labels and kept sets exact; the training step's loss and tb
terms rtol 1e-5, gradients rtol 1e-3 above the rounding floor (atol 1e-4 *
max(the tensor's largest |g|, 1e-2 * the model's)), BN statistics 1e-5.

The state is tiny.two_stage_state("pointrcnn"), the committed converted
init redrawn (train=True for the training checks: TWO_STAGE_TRAIN_BN_LIFT,
POINTRCNN_TRAIN_GAIN). The committed files are regenerated with
    python -c "from tests.test_torch_pointrcnn import write_pointrcnn_tiny_files; write_pointrcnn_tiny_files()"
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_two_stage_cases as cases
from tests.torch_two_stage_cases import golden_close, t
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.backbones_3d.pointnet2_modules import (
    PointnetFPModule as JFP,
    PointnetSAModuleMSG as JSA,
)
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu.models.roi_heads.pointrcnn_head import (
    PointRCNNHead as JHead,
    roipoint_pool as jpool,
)
from tsm_det_pointcloud_tpu.ops import box_coder_utils as jcoder
from tsm_det_pointcloud_tpu.ops import grouping as jgrouping
from tsm_det_pointcloud_tpu.ops import loss_utils as jloss
from tsm_det_pointcloud_tpu.ops.boxes import points_in_boxes as jpoints_in_boxes
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models.roi_heads import roi_head_template as tmpl
from tsm_det_pointcloud_tpu_torch.models.roi_heads.pointrcnn_head import roipoint_pool
from tsm_det_pointcloud_tpu_torch.ops import box_coder_utils, grouping, sampling

W = "pointrcnn"
EVAL_KEYS = ("point_features", "point_coords", "point_valid", "point_cls_scores",
             "point_cls_preds", "point_box_preds_raw")
MODULE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port while this module runs (beside XLA's
    CPU thread pools, torch's own pool slows the tiny steps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jcase():
    return cases.JaxCase(W, EVAL_KEYS)


@pytest.fixture(scope="module")
def eval_case(jcase):
    out, pred = jcase.eval()
    return dict(out=out, pred=pred)


def _jax_init_state():
    cfg, meta = tiny.two_stage_model(W)
    jmodel = jbuild(cfg, num_class=1, dataset=JDatasetMeta(**dataclasses.asdict(meta)))
    batch = dict(cases.points(), gt_boxes=tiny.two_stage_gt(W)[0],
                 gt_boxes_mask=tiny.two_stage_gt(W)[1], batch_size=2)
    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=True))(batch)
    return from_flax_variables(jax.tree_util.tree_map(np.asarray, variables))


def write_pointrcnn_tiny_files():
    """The converted PRNGKey(0) training init, then the JAX eval golden on
    `tiny.two_stage_state("pointrcnn")`."""
    state = _jax_init_state()
    np.savez_compressed(tiny.POINTRCNN_STATE_PATH, **{k: v.numpy() for k, v in state.items()})
    cases.write_forward(W)


def test_committed_state_is_the_converted_init():
    state = _jax_init_state()
    committed = tiny.load_state(tiny.POINTRCNN_STATE_PATH)
    assert list(committed) == list(state)
    for k, v in state.items():
        assert torch.equal(committed[k], v), k
    assert float(committed["module_list.1.cls_out.bias"]) == pytest.approx(-np.log(99.0))


def test_committed_forward_is_current(eval_case):
    with np.load(cases.forward_path(W)) as z:
        golden = {k: z[k] for k in z.files}
    want = {**{k: eval_case["out"][k] for k in cases.FORWARD}, **eval_case["pred"]}
    assert set(golden) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert golden["count"].min() > 0
    assert golden["rois"].shape == (2, 8, 7) and (golden["roi_labels"] == 1).all()


def test_reproduces_committed_golden():
    out, pred = infer.detect(cases.port_model(W), t(cases.points()["points"]),
                             torch.ones(2, cases.N_POINTS, dtype=torch.bool))
    with np.load(cases.forward_path(W)) as golden:
        for k in ("roi_labels", "pred_labels", "count"):
            np.testing.assert_array_equal((out if k in cases.FORWARD else pred)[k].numpy(),
                                          golden[k], err_msg=k)
        for k in ("batch_cls_preds", "batch_box_preds", "rois", "pred_boxes", "pred_scores"):
            golden_close((out if k in cases.FORWARD else pred)[k].numpy(), golden[k], k)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 8, 40])
def test_first_k_true(k):
    """Rows with no hit, with more hits than k and with fewer (k 40 is past
    every row's hits)."""
    rng = np.random.RandomState(k)
    mask = rng.uniform(size=(6, 37)) < np.array([0.0, 0.1, 0.5, 0.9, 1.0, 0.03])[:, None]
    want_idx, want_cnt = jgrouping._first_k_true(jnp.asarray(mask), k)
    got_idx, got_cnt = grouping.first_k_true(t(mask), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    assert want_cnt[0] == 0 and (np.asarray(want_idx)[0] == 0).all()


def _lattice_case():
    """Known and unknown points on a 0.5 m lattice (exact d2, many ties);
    scan 0 all valid, scan 1 with a third of the known points invalid, scan 2
    with two valid and scan 3 with none."""
    rng = np.random.RandomState(0)
    known = (rng.randint(-6, 7, (4, 40, 3)) * 0.5).astype(np.float32)
    unknown = (rng.randint(-6, 7, (4, 70, 3)) * 0.5).astype(np.float32)
    valid = np.ones((4, 40), bool)
    valid[1] = rng.uniform(size=40) > 0.33
    valid[2] = False
    valid[2, [5, 17]] = True
    valid[3] = False
    feats = rng.randn(4, 40, 6).astype(np.float32)
    return known, unknown, valid, feats


def test_three_nn_and_interpolate():
    known, unknown, valid, feats = _lattice_case()
    jd, ji = jgrouping.three_nn(jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(valid),
                                chunk=32)
    gd, gi = grouping.three_nn(t(unknown), t(known), t(valid), chunk=32)
    jd, ji = np.asarray(jd), np.asarray(ji)
    d2 = ((unknown[:, :, None] - known[:, None]) ** 2).sum(-1)
    ties = sum(len(row) - len(np.unique(row)) for row in d2.reshape(-1, 40))
    assert ties > 1000      # the lattice ties d2 everywhere: the order is by index
    np.testing.assert_array_equal(gi.numpy()[:3], ji[:3])
    np.testing.assert_allclose(gd.numpy(), jd, rtol=1e-6)
    assert np.isinf(jd[2, :, 2]).all() and np.isinf(jd[3]).all()
    jw = np.asarray(jgrouping.three_interpolate_weights(jnp.asarray(jd)))
    gw = grouping.three_interpolate_weights(gd)
    np.testing.assert_allclose(gw.numpy(), jw, rtol=1e-6, equal_nan=True)
    assert (jw[2, :, 2] == 0).all() and np.isnan(jw[3]).all()
    # the weights' NaN rows gather index 0 on both sides
    want = np.asarray(jgrouping.three_interpolate(jnp.asarray(feats), jnp.asarray(ji),
                                                  jnp.asarray(jw)))
    got = grouping.three_interpolate(t(feats), gi, gw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6, equal_nan=True)


def test_point_residual_coder():
    """Encode with three mean sizes (class 0 reads the last, as the JAX index
    -1 does), decode, and the round trip; without mean sizes (the tiny
    PVSSDA's head) encode and decode as the JAX coder's."""
    rng = np.random.RandomState(2)
    sizes = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
    boxes = np.concatenate([rng.uniform(-20, 20, (50, 3)), rng.uniform(0.3, 5, (50, 3)),
                            rng.uniform(-3, 3, (50, 1))], 1).astype(np.float32)
    pts = rng.uniform(-20, 20, (50, 3)).astype(np.float32)
    cls = rng.randint(0, 4, 50)
    jc = jcoder.PointResidualCoder(use_mean_size=True, mean_size=sizes)
    pc = box_coder_utils.PointResidualCoder(use_mean_size=True, mean_size=sizes)
    want = np.asarray(jc.encode(jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(cls)))
    got = pc.encode(t(boxes), t(pts), t(cls))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    dec_want = np.asarray(jc.decode(jnp.asarray(want), jnp.asarray(pts), jnp.asarray(cls)))
    dec = pc.decode(got, t(pts), t(cls))
    np.testing.assert_allclose(dec.numpy(), dec_want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(dec.numpy()[:, :6], boxes[:, :6], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.cos(dec.numpy()[:, 6]), np.cos(boxes[:, 6]), atol=1e-5)
    jc = jcoder.PointResidualCoder(use_mean_size=False)
    pc = box_coder_utils.PointResidualCoder(use_mean_size=False)
    want = np.asarray(jc.encode(jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(cls)))
    got = pc.encode(t(boxes), t(pts), t(cls))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    dec_want = np.asarray(jc.decode(jnp.asarray(want), jnp.asarray(pts), jnp.asarray(cls)))
    np.testing.assert_allclose(pc.decode(got, t(pts), t(cls)).numpy(), dec_want, rtol=1e-6,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _sub(variables, path):
    out = {}
    for coll, tree in variables.items():
        for p in path:
            tree = tree.get(p, {})
        if tree:
            out[coll] = tree
    return out


@pytest.fixture(scope="module")
def modules():
    """The port model (eval), its flax variables and the SA levels of the
    JAX backbone on the tiny points."""
    model = cases.port_model(W)
    variables = to_flax_variables(tiny.two_stage_state(W))
    pts = cases.points()["points"]
    xyz, feats = pts[..., :3], pts[..., 3:]
    valid = np.ones(pts.shape[:2], bool)
    sa = model.module_list[0].model_cfg["SA_CONFIG"]
    levels = [(xyz, feats, valid)]
    for i in range(2):
        m = JSA(npoint=sa["NPOINTS"][i], radii=sa["RADIUS"][i], nsamples=sa["NSAMPLE"][i],
                mlps=sa["MLPS"][i])
        levels.append(tuple(np.asarray(a) for a in m.apply(
            _sub(variables, ("module_list_0", f"sa{i}")), *(jnp.asarray(a) for a in levels[-1]),
            training=False)))
    return dict(model=model, variables=variables, levels=levels)


@pytest.mark.parametrize("level", [0, 1])
def test_sa_module(modules, level, monkeypatch):
    """One SA level on the JAX level's input: picks (new_xyz, new_valid) and
    each scale's ball-query indices on the filled slots and counts exact
    (one d-fps and one query_group call), features at the module tolerance."""
    calls = {"fps": 0, "qg": 0}
    fps, qg = sampling.furthest_point_sample, grouping.query_group
    monkeypatch.setattr(sampling, "furthest_point_sample",
                        lambda *a: calls.__setitem__("fps", calls["fps"] + 1) or fps(*a))
    monkeypatch.setattr(grouping, "query_group",
                        lambda *a, **k: calls.__setitem__("qg", calls["qg"] + 1) or qg(*a, **k))
    xyz, feats, valid = modules["levels"][level]
    want = modules["levels"][level + 1]
    m = getattr(modules["model"].module_list[0], f"sa{level}")
    with torch.no_grad():
        got = m(t(xyz), t(feats), t(valid))
    assert calls == {"fps": 1, "qg": 1}
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[1].numpy(), want[1], **MODULE_TOL)
    for _, r, ns in m.scales:
        ji, jc = jgrouping.ball_query(r, ns, jnp.asarray(xyz), jnp.asarray(want[0]),
                                      jnp.asarray(valid))
        (gi, gc, _), = grouping.query_group(t(xyz), t(valid), t(want[0]), [(0.0, r, ns)])
        ji, jc = np.asarray(ji), np.asarray(jc)
        np.testing.assert_array_equal(gc.numpy(), jc)
        filled = np.arange(ns) < np.minimum(jc, ns)[..., None]
        np.testing.assert_array_equal(gi.numpy()[filled], ji[filled])
        assert filled.mean() > 0.1


def test_fp_module(modules):
    """fp1 on the JAX SA levels, with a fifth of the known points invalid."""
    (_, _, _), (x1, f1, v1), (x2, f2, v2) = modules["levels"]
    kv = v2.copy()
    kv[:, ::5] = False
    jm = JFP(mlp=[16])
    want = np.asarray(jm.apply(_sub(modules["variables"], ("module_list_0", "fp1")),
                               jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(f1),
                               jnp.asarray(f2), jnp.asarray(kv), training=False,
                               unknown_valid=jnp.asarray(v1)))
    with torch.no_grad():
        got = modules["model"].module_list[0].fp1(t(x1), t(x2), t(f1), t(f2), t(kv), t(v1))
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


def test_backbone_and_point_head(modules, eval_case):
    """PointNet2MSG on the points and PointHeadBox on the JAX backbone's
    features (eval)."""
    out = eval_case["out"]
    backbone, point_head, _ = modules["model"].module_list
    with torch.no_grad():
        got = backbone({k: t(v) for k, v in cases.points().items()})
        np.testing.assert_array_equal(got["point_valid"].numpy(), out["point_valid"])
        np.testing.assert_array_equal(got["point_coords"].numpy(), out["point_coords"])
        np.testing.assert_allclose(got["point_features"].numpy(), out["point_features"],
                                   **MODULE_TOL)
        got = point_head({k: t(out[k]) for k in ("point_features", "point_coords",
                                                 "point_valid")})
    for k in ("point_cls_preds", "point_box_preds_raw", "point_cls_scores"):
        np.testing.assert_allclose(got[k].numpy(), out[k], **MODULE_TOL, err_msg=k)


def _jax_point_targets(coords, valid, gt, gmask, extra, coder):
    """The JAX head's target rule (point_head_box.py:57-73) on JAX ops."""
    def single(p, boxes_g, bvalid):
        inside = jpoints_in_boxes(p, boxes_g[:, :7], valid_mask=bvalid)
        ext = jpoints_in_boxes(p, boxes_g[:, :7], extra_width=extra, valid_mask=bvalid)
        safe = jnp.maximum(inside, 0)
        labels = jnp.where(inside >= 0, boxes_g[safe, 7].astype(jnp.int32), 0)
        labels = jnp.where((inside < 0) & (ext >= 0), -1, labels)
        reg = coder.encode(boxes_g[safe, :7], p, boxes_g[safe, 7].astype(jnp.int32))
        return labels, jnp.where((inside >= 0)[:, None], reg, 0.0)

    labels, reg = jax.vmap(single)(jnp.asarray(coords), jnp.asarray(gt), jnp.asarray(gmask))
    return np.asarray(jnp.where(jnp.asarray(valid), labels, -1)), np.asarray(reg)


def test_point_head_targets_and_losses(train_case):
    """Labels (with the -1 band) and box targets, then the focal and the
    smooth-L1 losses apart, on the JAX training forward's points; their sum
    is the JAX step's point_loss."""
    aux = train_case["aux"]
    gt, gmask = tiny.two_stage_gt(W)
    head = cases.port_model(W, train=True).module_list[1]
    cfg = head.model_cfg
    jc = jcoder.PointResidualCoder(**cfg["TARGET_CONFIG"]["BOX_CODER_CONFIG"])
    want_lab, want_reg = _jax_point_targets(aux["point_coords"], aux["point_valid"], gt, gmask,
                                            cfg["TARGET_CONFIG"]["GT_EXTRA_WIDTH"], jc)
    lab, reg = head.assign_targets(t(aux["point_coords"]), t(aux["point_valid"]), t(gt),
                                   t(gmask))
    np.testing.assert_array_equal(lab.numpy(), want_lab)
    np.testing.assert_allclose(reg.numpy(), want_reg, rtol=1e-6, atol=1e-6)
    assert {int((want_lab == v).sum()) > 0 for v in (-1, 0, 1)} == {True}
    cls_preds, box_preds = t(aux["point_cls_preds"]), t(aux["point_box_preds_raw"])
    pos = want_lab > 0
    one_hot = np.asarray(jax.nn.one_hot(np.clip(want_lab, 0, None), 2))[..., 1:]
    n = max(pos.sum(), 1.0)
    cls_want = float(jloss.sigmoid_focal_loss(jnp.asarray(aux["point_cls_preds"]),
                                              jnp.asarray(one_hot),
                                              jnp.asarray((want_lab >= 0).astype(np.float32))
                                              ).sum()) / n
    reg_want = float(jloss.weighted_smooth_l1(jnp.asarray(aux["point_box_preds_raw"]),
                                              jnp.asarray(want_reg),
                                              weights=jnp.asarray(pos.astype(np.float32))
                                              ).sum()) / n
    head.model_cfg = dict(cfg, LOSS_CONFIG={"LOSS_WEIGHTS": {"point_cls_weight": 1.0,
                                                             "point_box_weight": 0.0}})
    bd = {"point_coords": t(aux["point_coords"]), "point_valid": t(aux["point_valid"]),
          "gt_boxes": t(gt), "gt_boxes_mask": t(gmask)}
    np.testing.assert_allclose(float(head.loss(bd, cls_preds, box_preds)), cls_want, rtol=1e-5)
    head.model_cfg = dict(cfg, LOSS_CONFIG={"LOSS_WEIGHTS": {"point_cls_weight": 0.0,
                                                             "point_box_weight": 1.0}})
    np.testing.assert_allclose(float(head.loss(bd, cls_preds, box_preds)), reg_want, rtol=1e-5)
    head.model_cfg = cfg
    np.testing.assert_allclose(float(head.loss(bd, cls_preds, box_preds)),
                               float(train_case["tb"]["point_loss"]), rtol=1e-5)


def test_roipoint_pool():
    """Points on a 1/8 m grid, some invalid; a RoI with more points than its
    8 slots, one with fewer, one that holds none and a padded all-zero one:
    canonical xyz, features, empty and slot_ok, and the gradients to the
    features and the RoIs."""
    rng = np.random.RandomState(3)
    pts = (rng.randint(-24, 40, (300, 3)) / 8.0).astype(np.float32)
    pts[:, 2] /= 4
    feats = rng.randn(300, 5).astype(np.float32)
    valid = rng.uniform(size=300) > 0.1
    rois = np.array([[0.3, 0.2, 0.0, 4.0, 3.0, 1.5, 0.4],
                     [2.1, 0.9, 0.1, 0.7, 0.6, 0.5, -0.7],
                     [30.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0],
                     [0.0] * 7], np.float32)
    g1 = rng.randn(4, 8, 3).astype(np.float32)
    g2 = rng.randn(4, 8, 5).astype(np.float32)

    def jf(f, r):
        canon, gf, empty, ok = jpool(jnp.asarray(pts), f, jnp.asarray(valid), r, 8)
        return (canon * g1).sum() + (gf * g2).sum(), (canon, gf, empty, ok)

    (_, want), (wf, wr) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(rois))
    tf, tr = t(feats).requires_grad_(True), t(rois).requires_grad_(True)
    got = roipoint_pool(t(pts), tf, t(valid), tr, 8)
    ((got[0] * t(g1)).sum() + (got[1] * t(g2)).sum()).backward()
    want = [np.asarray(a) for a in want]
    np.testing.assert_allclose(got[0].detach().numpy(), want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].detach().numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert want[3].sum(1).tolist()[0] == 8 and 0 < want[3].sum(1)[1] < 8
    assert want[2].tolist() == [False, False, True, True]
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(wf), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(wr), rtol=1e-5, atol=1e-5)


def test_roi_head_on_jax_inputs(eval_case, monkeypatch):
    """The point head and the RoI head on the JAX backbone's outputs (eval):
    RoIs and their labels, refined boxes and scores; the in-RoI encoder makes
    one d-fps (K1 on the card) and one query_group call (K2) over the B * R
    rows, the GroupAll terminal none."""
    calls = {"fps": 0, "qg": 0}
    fps, qg = sampling.furthest_point_sample, grouping.query_group
    monkeypatch.setattr(sampling, "furthest_point_sample",
                        lambda *a: calls.__setitem__("fps", calls["fps"] + 1) or fps(*a))
    monkeypatch.setattr(grouping, "query_group",
                        lambda *a, **k: calls.__setitem__("qg", calls["qg"] + 1) or qg(*a, **k))
    out = eval_case["out"]
    _, point_head, roi_head = cases.port_model(W).module_list
    with torch.no_grad():
        bd = point_head({k: t(out[k]) for k in ("point_features", "point_coords",
                                                "point_valid")})
        got = roi_head(bd)
    assert calls == {"fps": 1, "qg": 1}
    np.testing.assert_array_equal(got["roi_labels"].numpy(), out["roi_labels"])
    for k in ("rois", "batch_cls_preds", "batch_box_preds"):
        golden_close(got[k], out[k], k)


def test_post_processing_index_equal(eval_case):
    out = {k: t(eval_case["out"][k]) for k in cases.FORWARD}
    pred, _ = cases.port_model(W).post_processing(out)
    for k in ("count", "pred_labels", "pred_boxes"):
        np.testing.assert_array_equal(pred[k].numpy(), eval_case["pred"][k], err_msg=k)
    np.testing.assert_allclose(pred["pred_scores"].numpy(), eval_case["pred"]["pred_scores"],
                               rtol=2e-7)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_batch():
    return dict({k: t(v) for k, v in cases.train_batch(W).items()}, batch_size=2)


@pytest.fixture(scope="module")
def train_case(jcase):
    want = jcase.train()
    model = cases.port_model(W, train=True)
    margin = cases.relu_input_margin(cases.port_model(W, train=True), _train_batch())
    out = model(_train_batch())
    out["loss"].backward()
    return dict(want, model=model, out=out, margin=margin)


def _close5(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=what)


def test_train_loss_and_tb_terms(train_case):
    """The step's loss and tb terms (rtol 1e-5), with foreground RoIs (IoU
    0.8 and 0.6 in scan 0, 0.9 and 0.6 in scan 1) among the sampled ones;
    every ReLU input of the step lies at least 1e-5 from 0."""
    assert train_case["margin"] > 1e-5
    out = train_case["out"]
    _close5(out["loss"].detach(), train_case["loss"], "loss")
    assert set(out["tb_dict"]) == set(train_case["tb"]) == {
        "point_loss", "rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss"}
    for k, v in train_case["tb"].items():
        _close5(out["tb_dict"][k].detach(), v, k)
    tg = out["roi_targets"]
    assert tg["sampled"].sum(1).tolist() == [8, 8]
    assert (tg["fg"] & tg["sampled"]).sum(1).tolist() == [2, 2]
    assert float(train_case["tb"]["rcnn_reg_loss"]) > 0
    assert float(train_case["tb"]["rcnn_corner_loss"]) > 0


def test_train_gradients(train_case):
    cases.check_gradients(train_case["model"], train_case["grads"])


def test_train_batch_stats(train_case):
    cases.check_batch_stats(train_case["model"], train_case["stats"])


def test_second_step_from_the_jax_state(jcase, train_case):
    """A second step from the state the JAX step reached: its parameters
    moved by -1e-4 times the JAX gradients, its BN statistics after the
    step; loss, tb terms, gradients and statistics again."""
    state = tiny.two_stage_state(W, train=True)
    state.update({k: state[k] - 1e-4 * g for k, g in train_case["grads"].items()})
    state.update(train_case["stats"])
    variables = to_flax_variables(state)
    loss, tb, stats, grads, _ = jax.tree_util.tree_map(
        np.asarray, jcase._train(variables, cases.train_batch(W)))
    model = cases.port_model(W, train=True)
    model.load_state_dict(state, strict=True)
    out = model(_train_batch())
    out["loss"].backward()
    _close5(out["loss"].detach(), loss, "loss")
    for k, v in tb.items():
        _close5(out["tb_dict"][k].detach(), v, k)
    cases.check_gradients(model, from_flax_variables({"params": grads}))
    cases.check_batch_stats(model, from_flax_variables({"batch_stats": stats}))


def test_rcnn_losses_with_gt_rois(train_case):
    """The RoI head fed RoIs made from the gt boxes (foreground among the
    sampled RoIs): rcnn_reg_loss, rcnn_corner_loss and the gradients of
    their sum on the head's parameters and on the proposals' boxes against
    the JAX head's."""
    aux = train_case["aux"]
    gt, gmask = tiny.two_stage_gt(W)
    logits, boxes = tiny.gt_roi_proposals(gt, gmask, aux["point_coords"].shape[1])
    cfg, _ = tiny.two_stage_model(W)
    variables = to_flax_variables(tiny.two_stage_state(W, train=True))
    head_vars = _sub(variables, ("module_list_2",))
    jhead = JHead(model_cfg=dict(cfg.ROI_HEAD), input_channels=16, num_class=1)
    keys = ("point_coords", "point_features", "point_valid", "point_cls_scores")

    def jf(params, box):
        bd = {k: jnp.asarray(aux[k]) for k in keys}
        bd.update(batch_cls_preds=jnp.asarray(logits), batch_box_preds=box,
                  gt_boxes=jnp.asarray(gt), gt_boxes_mask=jnp.asarray(gmask))
        out, _ = jhead.apply(dict(head_vars, params=params), bd, training=True,
                             mutable=["batch_stats"])
        tb = out["tb_dict_rcnn"]
        return tb["rcnn_reg_loss"] + tb["rcnn_corner_loss"], tb

    (_, jtb), (jgp, jgb) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        head_vars["params"], jnp.asarray(boxes))
    head = cases.port_model(W, train=True).module_list[2]
    tbox = t(boxes).requires_grad_(True)
    bd = {k: t(aux[k]) for k in keys}
    bd.update(batch_cls_preds=t(logits), batch_box_preds=tbox, gt_boxes=t(gt),
              gt_boxes_mask=t(gmask))
    out = head(bd)
    tb = out["tb_dict_rcnn"]
    (tb["rcnn_reg_loss"] + tb["rcnn_corner_loss"]).backward()
    tg = out["roi_targets"]
    assert ((tg["fg"] & tg["sampled"]).sum(1) == t(gmask).sum(1)).all()
    for k in ("rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss"):
        _close5(tb[k].detach(), jtb[k], k)
    assert float(jtb["rcnn_reg_loss"]) > 0 and float(jtb["rcnn_corner_loss"]) > 0
    grads = {f"module_list.2.{k}": v for k, v in from_flax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jgp)}).items()}
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, p in head.named_parameters():
        want = grads[f"module_list.2.{name}"].numpy()
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol, err_msg=name)
    jgb = np.asarray(jgb)
    assert np.abs(jgb).max() > 0
    np.testing.assert_allclose(tbox.grad.numpy(), jgb, rtol=1e-3,
                               atol=1e-4 * float(np.abs(jgb).max()))


def test_full_width_flax_tree_loads_strictly():
    """Every flax leaf of pointrcnn.yaml's JAX init maps onto the port,
    strict; the config voxelizes nothing, so its meta has no grid."""
    variables, model, meta = cases.full_width_state(
        infer.ROOT / "tools/cfgs/kitti_models/pointrcnn.yaml")
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model.load_state_dict(state, strict=True)
    assert meta.grid_size is None and meta.voxel_size is None
    assert state["module_list.0.sa3.mlp1.fc1.weight"].shape == (384, 256)
    assert state["module_list.0.sa3.mlp1.fc0.weight"].shape == (256, 3 + 512)
    assert state["module_list.0.fp3.mlp.fc0.weight"].shape == (512, 1024 + 512)
    assert state["module_list.2.xyz_up.fc0.weight"].shape == (128, 3 + 2 + 128)
    assert state["module_list.2.roi_sa2.fc0.weight"].shape == (256, 3 + 256)
    assert state["module_list.1.box_out.weight"].shape == (8, 256)
    # every layer of the RoI head has a BN, whatever USE_BN says (ROADMAP §C)
    cfg = infer.load_cfg(infer.ROOT / "tools/cfgs/kitti_models/pointrcnn.yaml")
    assert cfg.MODEL.ROI_HEAD.USE_BN is False
    for bn in ("xyz_up.bn1", "roi_sa0.mlp0.bn2", "roi_sa2.bn2", "shared_bn1", "cls_fc.bn1",
               "reg_fc.bn1"):
        assert f"module_list.2.{bn}.running_var" in state, bn
