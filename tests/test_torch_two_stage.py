"""The port's two-stage machinery against the JAX package on the CPU.

The RoI template (models/roi_heads/roi_head_template.py): `proposal_layer`
on clustered boxes of three classes (kept sets, labels and counts exact);
`assign_targets` with a scan whose ROI_PER_IMAGE slots fill (easy background
RoIs tied at priority 1.0, foreground past FG_RATIO demoted), a scan where
fewer than ROI_PER_IMAGE RoIs have a positive priority (RoIs in the
never-sampled IoU band [CLS_BG_THRESH, REG_FG_THRESH)) so that `sampled` is
all-False, and invalid slots; `roi_losses` with and without the corner loss,
its value and its gradient to the RCNN outputs and to the RoIs, through the
regression targets, the corner loss and the IoU-guided class labels of
`assign_targets`. The two-stage post-processing (`roi_labels` of three
classes, the recall dict) and the anchor head's decode in training
(`predict_boxes_when_training`: the decoded boxes and their gradient to
conv_box).

Tolerances: masks, labels, indices and counts exact; the RoIs and kept
scores exact (both sides gather the same f32 values); IoUs and class labels
1e-6; losses 1e-5 relative; gradients rtol 1e-4 with atol 1e-6 * the
largest |gradient| (conv_box's, a sum over the 512 (anchor, cell) terms of a
decode with exp: 1e-5 * the largest).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.dense_heads.anchor_head import (
    AnchorHeadSingle as JAnchorHeadSingle,
)
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu.models.roi_heads import roi_head_template as jt
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.dense_heads.anchor_head import AnchorHeadSingle
from tsm_det_pointcloud_tpu_torch.models.roi_heads import roi_head_template as tmpl
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TARGET_CFG = {"ROI_PER_IMAGE": 8, "FG_RATIO": 0.5, "REG_FG_THRESH": 0.55,
              "CLS_FG_THRESH": 0.75, "CLS_BG_THRESH": 0.25, "CLS_BG_THRESH_LO": 0.1}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _clustered_boxes(rng, B, N, n_clusters=6):
    """(B, N, 7) boxes in clusters of near-copies, so that NMS suppresses."""
    centre = rng.uniform([2, -6, -1.5], [14, 6, -0.5], (B, n_clusters, 3))
    pick = rng.randint(0, n_clusters, (B, N))
    boxes = np.zeros((B, N, 7), np.float32)
    boxes[..., :3] = np.take_along_axis(centre, pick[..., None], 1) + rng.randn(B, N, 3) * 0.3
    boxes[..., 3:6] = rng.uniform([3.2, 1.4, 1.3], [4.4, 1.9, 1.7], (B, N, 3))
    boxes[..., 6] = rng.uniform(-0.3, 0.3, (B, N))
    return boxes


def test_proposal_layer():
    rng = np.random.RandomState(0)
    boxes = _clustered_boxes(rng, 2, 300)
    cls = rng.randn(2, 300, 3).astype(np.float32) * 2
    nms = {"NMS_PRE_MAXSIZE": 200, "NMS_POST_MAXSIZE": 40, "NMS_THRESH": 0.3}
    want = _np(jax.jit(lambda c, b: jt.proposal_layer(c, b, nms))(cls, boxes))
    got = tmpl.proposal_layer(_t(cls), _t(boxes), nms)
    assert 5 < want[3].sum(1).min() and want[3].sum(1).max() < 40
    assert len(np.unique(want[2][want[3]])) == 3
    for g, w, name in zip(got, want, ("rois", "roi_scores", "roi_labels", "roi_valid")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def _box(x, y, dx, dy, heading=0.0, z=-1.0, dz=1.5):
    return [x, y, z, dx, dy, dz, heading]


def _roi(x, y, dx, dy, heading=0.0):
    """A RoI on the gt box (x, y, dx, dy, heading) but for a 3 cm shift and a
    0.02 rad turn: no edge of it lies on the gt's, where the polygon clip's
    colinear-edge rule decides by rounding (the JAX package's eager and
    jitted IoUs of such pairs differ by up to 0.03)."""
    return _box(x + 0.03, y + 0.03, dx, dy, heading + 0.02)


def _assign_case():
    """Two scans of 16 RoI slots and 4 gt slots. Scan 0: six RoIs on gt 0 at
    IoU 0.9-0.6 (foreground, the last two past FG_RATIO's four), RoIs at 0.45 (band)
    and 0.15 (hard background), seven far from every gt (easy background at
    IoU 0, priority 1.0: ties), a RoI of another class on gt 0 and an
    invalid slot. Scan 1: RoIs in the band on gts 0-2 and only seven RoIs
    with a positive priority, so nothing is sampled."""
    rois, labels, valid = np.zeros((2, 16, 7), np.float32), np.ones((2, 16), np.int32), \
        np.ones((2, 16), bool)
    gt = np.zeros((2, 4, 8), np.float32)
    gmask = np.array([[True, True, False, False], [True, True, True, False]])
    gt[0, 0] = _box(5, 0, 4, 2, 0.1) + [1]
    gt[0, 1] = _box(12, 5, 4, 2, -0.2) + [2]
    for i, s in enumerate([1.05, 1.15, 1.25, 1.4, 1.5, 1.6]):
        rois[0, i] = _roi(5, 0, 4 * s, 2, 0.1)
    rois[0, 6] = _roi(5, 0, 4 * 2.2, 2, 0.1)           # IoU 0.45: the band
    rois[0, 7] = _roi(5, 0, 4 * 6.5, 2, 0.1)           # IoU 0.15: hard background
    for i in range(8, 15):
        rois[0, i] = _box(-20 - 3 * i, 10, 4, 2)       # IoU 0: easy background
    rois[0, 15] = _roi(5, 0, 4, 2, 0.1)
    labels[0, 15] = 2                                  # another class: IoU 0 for it
    valid[0, 13] = False
    for j, (x, y) in enumerate([(3, -4), (9, 4), (14, -5)]):
        gt[1, j] = _box(x, y, 4, 2) + [1]
        for k in range(3):
            rois[1, 3 * j + k] = _roi(x, y, 4 * (2.2 + 0.1 * k), 2)
    for i in range(9, 16):
        rois[1, i] = _box(-30, -3 * i, 4, 2)
    return rois, labels, valid, gt, gmask


def test_assign_targets_full_and_empty_samples():
    rois, labels, valid, gt, gmask = _assign_case()
    want = _np(jax.jit(lambda *a: jt.assign_targets(*a, TARGET_CFG))(
        rois, labels, valid, gt, gmask))
    got = tmpl.assign_targets(*map(_t, (rois, labels, valid, gt, gmask)), TARGET_CFG)
    assert set(got) == set(want)
    for k in ("gt_cls", "fg", "sampled", "cls_interval"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("gt_of_roi", "max_iou", "cls_label"):
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    sampled, fg = want["sampled"], want["fg"]
    assert sampled[0].sum() == 8 and not sampled[1].any()
    # four foreground RoIs (FG_RATIO), the best first; the two demoted ones
    # rank under the background
    assert fg[0].sum() == 6 and sampled[0, :4].all() and not sampled[0, 4:6].any()
    assert want["cls_interval"][0, 6] and not sampled[0, 6] and sampled[0, 7]
    # the easy background RoIs tie at priority 1.0: the lower indices win
    assert sampled[0, 8:11].all() and not sampled[0, 11:].any()
    assert ((want["max_iou"][1] > 0.25) & (want["max_iou"][1] < 0.55)).sum() == 9


def _loss_inputs(seed=1):
    rng = np.random.RandomState(seed)
    rois, labels, valid, gt, gmask = _assign_case()
    rois[..., 6] += rng.uniform(-0.05, 0.05, rois.shape[:2]).astype(np.float32)
    cls = rng.randn(2, 16).astype(np.float32)
    reg = (rng.randn(2, 16, 7) * 0.1).astype(np.float32)
    return rois, labels, valid, gt, gmask, cls, reg


def _loss_cfg(corner):
    return {"CORNER_LOSS_REGULARIZATION": corner,
            "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                             "rcnn_corner_weight": 1.0, "code_weights": [1.0] * 7}}


@pytest.mark.parametrize("corner", [True, False])
def test_roi_losses_and_gradients(corner):
    """The RCNN loss of the RoIs' own targets, differentiated with respect to
    the RCNN outputs and the RoIs (no stop-gradient on either side)."""
    rois, labels, valid, gt, gmask, cls, reg = _loss_inputs()
    cfg = _loss_cfg(corner)

    def jloss(r, c, g):
        targets = jt.assign_targets(r, labels, valid, gt, gmask, TARGET_CFG)
        return jt.roi_losses(c, g, targets, r, cfg)

    (wl, wtb), wg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(rois), jnp.asarray(cls), jnp.asarray(reg))
    tr, tc, tg = (_t(a).requires_grad_(True) for a in (rois, cls, reg))
    targets = tmpl.assign_targets(tr, _t(labels), _t(valid), _t(gt), _t(gmask), TARGET_CFG)
    loss, tb = tmpl.roi_losses(tc, tg, targets, tr, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=1e-5)
    assert set(tb) == set(wtb) == ({"rcnn_cls_loss", "rcnn_reg_loss"}
                                   | ({"rcnn_corner_loss"} if corner else set()))
    for k, v in wtb.items():
        np.testing.assert_allclose(float(tb[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    for got, want, name in zip((tr.grad, tc.grad, tg.grad), wg, ("rois", "cls", "reg")):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max(), err_msg=name)
    # the RoIs' gradient includes the cls loss's, through the IoU-guided labels
    assert np.abs(np.asarray(wg[0])[0, :6]).max() > 0


def _jmodel(which):
    cfg, meta = tiny.two_stage_model(which)
    return jbuild(cfg, num_class=1, dataset=JDatasetMeta(**dataclasses.asdict(meta)))


def test_post_processing_with_roi_labels():
    """Labels are the RoIs' (three classes), not the argmax of the one RCNN
    score; counts, kept boxes and scores equal; the recall dict's roi_*
    entries stay 0, as in the JAX package."""
    rng = np.random.RandomState(2)
    boxes = _clustered_boxes(rng, 2, 40)
    bd = {"batch_cls_preds": rng.randn(2, 40, 1).astype(np.float32),
          "batch_box_preds": boxes,
          "roi_labels": rng.randint(1, 4, (2, 40)).astype(np.int32),
          "gt_boxes": np.concatenate([boxes[:, :3], np.ones((2, 3, 1), np.float32)], -1),
          "gt_boxes_mask": np.ones((2, 3), bool)}
    bd["gt_boxes"][..., 3] += 0.2
    jmodel = _jmodel("parta2")
    state = tiny.two_stage_state("parta2")
    jpred, jrec = _np(jax.jit(lambda v, b: jmodel.apply(
        v, b, method=lambda m, x: m.post_processing(x)))(to_flax_variables(state), bd))
    port = build_network(tiny.parta2_model_cfg(), 1, tiny.PARTA2_META, device="cpu")
    pred, rec = port.post_processing({k: _t(v) for k, v in bd.items()})
    assert jpred["count"].min() > 1 and len(np.unique(jpred["pred_labels"])) >= 3
    for k in ("count", "pred_labels", "pred_scores", "pred_boxes"):
        np.testing.assert_array_equal(pred[k].numpy(), jpred[k], err_msg=k)
    assert set(rec) == set(jrec)
    for k, v in jrec.items():
        np.testing.assert_allclose(float(rec[k]), float(v), err_msg=k)
    assert float(jrec["roi_0.5"]) == 0 and float(jrec["rcnn_0.3"]) > 0


def test_anchor_head_decodes_in_training():
    """With predict_boxes_when_training the head decodes in train mode too,
    and the decoded boxes carry the gradient to conv_box (of a fixed random
    weighting of every box code)."""
    cfg = tiny.parta2_model_cfg().DENSE_HEAD
    meta = tiny.PARTA2_META
    jhead = JAnchorHeadSingle(model_cfg=dict(cfg), input_channels=32, num_class=1,
                              class_names=("Car",), grid_size=meta.grid_size,
                              point_cloud_range=meta.point_cloud_range,
                              predict_boxes_when_training=True)
    x = np.random.RandomState(3).randn(2, 4, 4, 32).astype(np.float32)
    variables = _np(jhead.init(jax.random.PRNGKey(1), {"spatial_features_2d": x},
                               training=True))

    wts = np.random.RandomState(4).randn(2, 32, 7).astype(np.float32)

    def jf(params):
        out = jhead.apply({"params": params}, {"spatial_features_2d": x}, training=True)
        return (out["batch_box_preds"] * wts).sum(), out["batch_box_preds"]

    (_, jboxes), jgrad = jax.value_and_grad(jf, has_aux=True)(variables["params"])
    head = AnchorHeadSingle(dict(cfg), 32, 1, ("Car",), meta.grid_size, meta.point_cloud_range,
                            predict_boxes_when_training=True)
    head.load_state_dict(from_flax_variables(variables), strict=True)
    out = head.train()({"spatial_features_2d": _t(x)})
    (out["batch_box_preds"] * _t(wts)).sum().backward()
    np.testing.assert_allclose(out["batch_box_preds"].detach().numpy(), np.asarray(jboxes),
                               rtol=1e-5, atol=1e-5)
    want = from_flax_variables({"params": _np(jgrad)})
    for name in ("conv_box.weight", "conv_box.bias"):
        w = want[name].numpy()
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(dict(head.named_parameters())[name].grad.numpy(), w,
                                   rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=name)
    plain = AnchorHeadSingle(dict(cfg), 32, 1, ("Car",), meta.grid_size, meta.point_cloud_range)
    assert "batch_box_preds" not in plain.train()({"spatial_features_2d": _t(x)})
