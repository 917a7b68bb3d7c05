"""Box geometry, box encoding, target assignment and the losses of the
distillation step (ops/boxes.py, ops/box_coder_utils.py, ops/loss_utils.py,
models/dense_heads/point_head_vote.py) against the JAX package on the CPU.

Discrete outputs (box indices, labels, bins) must be equal. Float outputs
and gradients: rtol 1e-5, atol 1e-5 * max(1, max|want|) — the same f32
formulas, reduced in another order. The gradients of `_branch_losses` are
taken with respect to every prediction it reads, so a `.detach()` placed
differently from a JAX `stop_gradient` shows as a gradient mismatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.models.dense_heads import point_head_vote as jhead
from tsm_det_pointcloud_tpu.ops import box_coder_utils as jcoder
from tsm_det_pointcloud_tpu.ops import boxes as jboxes
from tsm_det_pointcloud_tpu.ops import loss_utils as jloss
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.models.dense_heads import point_head_vote as thead
from tsm_det_pointcloud_tpu_torch.ops import box_coder_utils as tcoder
from tsm_det_pointcloud_tpu_torch.ops import boxes as tboxes
from tsm_det_pointcloud_tpu_torch.ops import loss_utils as tloss


def _close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed, B=2, N=300, M=5):
    """Points, gt boxes (B, M, 8) with 1-based classes and a box mask."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(0, 16, (B, N)), rng.uniform(-8, 8, (B, N)),
                    rng.uniform(-2, 2, (B, N))], -1).astype(np.float32)
    boxes = np.concatenate([
        np.stack([rng.uniform(2, 14, (B, M)), rng.uniform(-6, 6, (B, M)),
                  rng.uniform(-1, 1, (B, M))], -1),
        rng.uniform(1.0, 5.0, (B, M, 3)),
        rng.uniform(-4, 4, (B, M, 1)),
        rng.randint(1, 4, (B, M, 1)),
    ], -1).astype(np.float32)
    valid = np.ones((B, M), bool)
    valid[:, -1] = False
    return pts, boxes, valid


@pytest.mark.parametrize("extra", [None, (0.5, 0.5, 0.5)])
def test_points_in_boxes(extra):
    pts, boxes, valid = _scene(0)
    got = tboxes.points_in_boxes(_t(pts), _t(boxes[..., :7]), extra_width=extra,
                                 valid_mask=_t(valid))
    for b in range(pts.shape[0]):
        want = jboxes.points_in_boxes(pts[b], boxes[b, :, :7], extra_width=extra,
                                      valid_mask=valid[b])
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert (got >= 0).any() and (got < 0).any()


def test_box_frames_corners_enlarge():
    pts, boxes, _ = _scene(1)
    b7 = boxes[0, :, :7]
    _close(tboxes.in_box_frame(_t(pts[0]), _t(b7)), jboxes.in_box_frame(pts[0], b7))
    _close(tboxes.boxes_to_corners_3d(_t(b7)), jboxes.boxes_to_corners_3d(b7))
    _close(tboxes.enlarge_box3d(_t(b7), (0.2, 0.3, 0.4)),
           jboxes.enlarge_box3d(jnp.asarray(b7), (0.2, 0.3, 0.4)))
    np.testing.assert_array_equal(
        tboxes.points_in_boxes_mask(_t(pts[0]), _t(b7)).numpy(),
        np.asarray(jboxes.points_in_boxes_mask(pts[0], b7)))


def test_box_encode():
    pts, boxes, _ = _scene(2)
    boxes[0, :, 6] = [-7.0, -0.1, 0.0, 3.3, 9.5]   # wrap both ways
    boxes[1, 0, 3] = -1.0                          # clipped size
    kw = {"use_mean_size": False, "angle_bin_num": 12}
    jc, tc = jcoder.PointBinResidualCoder(**kw), tcoder.PointBinResidualCoder(**kw)
    gt = boxes[:, :3, :7]
    p = pts[:, :3]
    got = tc.encode(_t(gt), _t(p))
    want = np.asarray(jc.encode(jnp.asarray(gt), jnp.asarray(p)))
    nb = 12
    np.testing.assert_array_equal(got[..., 6:6 + nb].numpy(), want[..., 6:6 + nb])
    _close(got, want)
    # decode inverts encode for the box's own centre
    dec = tc.decode(got, _t(p))
    _close(dec[..., :3], gt[..., :3])


def test_elementwise_losses():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 50, 3).astype(np.float32) * 3
    y = rng.uniform(0, 1, x.shape).astype(np.float32)
    w = rng.uniform(0, 1, x.shape[:2]).astype(np.float32)
    _close(tloss.bce_with_logits(_t(x), _t(y)), jloss._bce_with_logits(x, y))
    _close(tloss.sigmoid_focal_loss(_t(x), _t(y), _t(w)),
           jloss.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
    _close(tloss.weighted_smooth_l1(_t(x), _t(y), _t(w)),
           jloss.weighted_smooth_l1(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
    _close(tloss.weighted_smooth_l1(_t(x), _t(y), beta=0.0),
           jloss.weighted_smooth_l1(jnp.asarray(x), jnp.asarray(y), beta=0.0))


def test_centerness_and_rdiou():
    pts, boxes, _ = _scene(4)
    b7 = boxes[..., :3, :7]
    xyz = b7[..., :3] + np.random.RandomState(5).uniform(-1, 1, b7[..., :3].shape
                                                         ).astype(np.float32)
    pos = np.array([[True, False, True], [True, True, False]])
    got = tloss.centerness_label(_t(xyz), _t(b7), _t(pos))
    for b in range(2):
        _close(got[b], jloss.centerness_label(xyz[b], b7[b], pos[b]))
    pred = b7 + np.random.RandomState(6).normal(0, 0.5, b7.shape).astype(np.float32)
    pred[0, 0, 3] = 30.0                                   # clipped at 10
    tu, tr = tloss.rdiou(_t(pred), _t(b7))
    ju, jr = jloss.rdiou(jnp.asarray(pred), jnp.asarray(b7))
    _close(tu, ju)
    _close(tr, jr)
    assert float(tr.max()) > 0.1


def test_sasa_targets_and_layer_loss():
    pts, boxes, valid = _scene(7, N=400)
    got = tloss.sasa_assign_targets(_t(pts), _t(boxes), extra_width=[1.0, 1.0, 1.0],
                                    num_class=3, gt_valid=_t(valid))
    want = np.asarray(jloss.sasa_assign_targets(
        jnp.asarray(pts), jnp.asarray(boxes), extra_width=[1.0, 1.0, 1.0],
        num_class=3, gt_valid=jnp.asarray(valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert {-1, 0}.issubset(set(want.ravel())) and want.max() > 0
    scores = np.random.RandomState(8).randn(*pts.shape[:2], 3).astype(np.float32)
    _close(tloss.sasa_layer_loss(_t(scores), got, num_class=3),
           jloss.sasa_layer_loss(jnp.asarray(scores), jnp.asarray(want), num_class=3))


def test_target_assignment_and_corner_loss():
    pts, boxes, valid = _scene(9)
    coder = tcoder.PointBinResidualCoder(angle_bin_num=12)
    jc = jcoder.PointBinResidualCoder(angle_bin_num=12)
    gl, gc = thead.assign_targets_simple(_t(pts), _t(boxes), _t(valid), [0.1, 0.1, 0.1])
    wl, wc = jhead.assign_targets_simple(pts, boxes, valid, [0.1, 0.1, 0.1])
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    _close(gc, wc)
    gl, gr, gb = thead.assign_targets_mask(_t(pts), _t(boxes), _t(valid), coder, 2.0)
    wl, wr, wb = jhead.assign_targets_mask(pts, boxes, valid, jc, 2.0)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert (np.asarray(wl) == -1).any() and (np.asarray(wl) > 0).any()
    _close(gr, wr)
    _close(gb, wb)
    pred = np.asarray(wb) + 0.3
    w = (np.asarray(wl) > 0).astype(np.float32)
    _close(thead.corner_loss_points(_t(pred), gb, _t(w)),
           jhead.corner_loss_points(jnp.asarray(pred), wb, jnp.asarray(w)))


def _branch_case(seed, B=2, M=24, nb=12):
    """A student output and a teacher output over a scene, as numpy."""
    rng = np.random.RandomState(seed)
    pts, boxes, valid = _scene(seed, B=B, N=M)
    cand = pts.copy()
    cand[:, : M // 2] = boxes[:, rng.randint(0, 4, M // 2), :3] + rng.normal(
        0, 0.4, (B, M // 2, 3))                        # candidates in boxes
    cand_valid = rng.uniform(size=(B, M)) > 0.1

    def out(scale):
        vote = cand + rng.normal(0, 0.3, cand.shape)
        reg = rng.normal(0, scale, (B, M, 6 + 2 * nb))
        box = np.concatenate([vote + reg[..., :3], np.exp(reg[..., 3:6]) + 1.0,
                              rng.uniform(-3, 3, (B, M, 1))], -1)
        return {"candidate_xyz": cand.astype(np.float32),
                "candidate_valid": cand_valid,
                "vote_xyz": vote.astype(np.float32),
                "cls_preds": rng.normal(0, 2, (B, M, 3)).astype(np.float32),
                "reg_preds": reg.astype(np.float32),
                "box_preds": box.astype(np.float32)}

    return out(0.5), out(0.5), boxes, valid


_DIFF = ("vote_xyz", "cls_preds", "reg_preds", "box_preds")


@pytest.mark.parametrize("seed", [10, 13])
def test_branch_losses(seed):
    s_out, t_out, boxes, valid = _branch_case(seed)
    cfg = tiny.tiny_model_cfg()["POINT_HEAD"]
    cfg["TARGET_CONFIG"]["GT_CENTRAL_RADIUS"] = 3.0   # ignore labels too
    jc = jcoder.PointBinResidualCoder(angle_bin_num=12)
    tc = tcoder.PointBinResidualCoder(angle_bin_num=12)

    def jfn(diff):
        out = dict(jax.tree_util.tree_map(jnp.asarray, s_out), **diff)
        teacher = jax.tree_util.tree_map(jnp.asarray, t_out)
        _, loss, tb = jhead._branch_losses(
            out, jnp.asarray(boxes), jnp.asarray(valid), jc, cfg, 3, prefix="s_",
            teacher_out=teacher)
        return loss, tb

    (jl, jtb), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(s_out[k]) for k in _DIFF})
    diff = {k: _t(s_out[k]).requires_grad_(True) for k in _DIFF}
    tout = dict({k: _t(v) for k, v in s_out.items()}, **diff)
    teacher = {k: _t(v) for k, v in t_out.items()}
    targets, tl, ttb = thead._branch_losses(tout, teacher, _t(boxes), _t(valid), tc,
                                            cfg, 3)
    _close(tl, jl, "loss")
    assert set(ttb) == set(jtb)
    for k in jtb:
        _close(ttb[k], jtb[k], k)
    assert float(jtb["s_n_pos"]) > 0
    assert (targets["labels"] == -1).any()
    tl.backward()
    for k in _DIFF:
        _close(diff[k].grad, jgrad[k], f"d loss / d {k}")
        assert float(np.abs(np.asarray(jgrad[k])).max()) > 0, k


def test_sasa_loss():
    pts, boxes, valid = _scene(11, N=200)
    rng = np.random.RandomState(12)
    cfg = tiny.tiny_model_cfg()["POINT_HEAD"]
    batch = {
        "point_coords_list": [pts, pts[:, :100]],
        "point_scores_list": [rng.randn(2, 200, 3).astype(np.float32), None],
        "point_valid_list": [rng.uniform(size=(2, 200)) > 0.2,
                             np.ones((2, 100), bool)],
    }
    want, wtb = jhead._sasa_loss(jax.tree_util.tree_map(jnp.asarray, batch),
                                 jnp.asarray(boxes), jnp.asarray(valid), cfg, 3)
    tb = {k: [None if v is None else _t(v) for v in vs] for k, vs in batch.items()}
    got, gtb = thead._sasa_loss(tb, _t(boxes), _t(valid), cfg, 3)
    _close(got, want)
    _close(gtb["sasa_loss"], wtb["sasa_loss"])
