"""The port's eval recall counters against the JAX package on the CPU:
`iou3d.boxes_iou3d` against the JAX `boxes_iou3d` (elementwise f32 math in
the same order on both sides; atol 1e-5 for fused-op rounding), and the
recall dict that `post_processing` returns when the batch carries
`gt_boxes`, for the tiny TSM and the tiny SECOND on their committed
converted PRNGKey(0) weights (the JAX side on the JAX init they were
converted from). Recall counts are integers: keys and values must be equal.

Both configs' SCORE_THRESH is lowered to 0 on both sides, so that the
untrained init keeps boxes; the gt boxes are seeded jitters of the port's
kept boxes (so some pass each IoU threshold and some do not), a far box,
and padded rows, one of which repeats a prediction and must not count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tests.test_second_e2e import META as SECOND_JMETA, second_model_cfg, synthetic_batch
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.ops import iou3d as jiou
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.ops import iou3d as tiou

THRESH = (0.3, 0.5, 0.7)
M_GT = 7  # gt rows a scan: jittered predictions, a far box, padding


def _boxes(seed, n):
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(0, 8, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_boxes_iou3d():
    """Rotated pairs, disjoint ones, identical ones and ones that touch in
    height only (BEV overlap, zero height overlap)."""
    a, b = _boxes(0, 60), _boxes(1, 40)
    b[:5] = a[:5]                                  # identical
    b[5:10] = a[5:10] + [100, 100, 0, 0, 0, 0, 0]  # disjoint in BEV
    b[10:15] = a[10:15]                            # stacked: touching in height
    b[10:15, 2] = a[10:15, 2] + (a[10:15, 5] + b[10:15, 5]) / 2
    want = np.asarray(jax.jit(jiou.boxes_iou3d)(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.diag(got[:5, :5]), 1.0, atol=1e-5)
    assert not got[5:10, 5:10].diagonal().any()
    assert (got[10:15, 10:15].diagonal() < 1e-6).all()
    assert (want > 0.3).sum() > 5


def _gt_from(pred_boxes, counts, seed):
    """(B, M_GT, 8) gt boxes (label last) and (B, M_GT) mask from seeded
    jitters of the kept predictions."""
    rng = np.random.RandomState(seed)
    B = pred_boxes.shape[0]
    gt = np.zeros((B, M_GT, 8), np.float32)
    mask = np.zeros((B, M_GT), bool)
    for b in range(B):
        n = min(int(counts[b]), 4)
        assert n > 0, "the case must keep boxes"
        for j in range(n):
            box = pred_boxes[b, j].copy()
            box[0:3] += rng.normal(0, [0.02, 0.3, 0.8][j % 3], 3)
            box[3:6] *= rng.uniform(0.8, 1.2, 3)
            gt[b, j, :7] = box
            mask[b, j] = True
        gt[b, n, :7] = [50, 50, 0, 2, 2, 2, 0]     # far from every prediction
        mask[b, n] = True
        gt[b, n + 1, :7] = pred_boxes[b, 0]        # padded: must not count
        gt[b, :, 7] = 1
    return gt, mask


def _compare(jrec, rec):
    assert set(rec) == set(jrec) == ({f"roi_{t}" for t in THRESH}
                                     | {f"rcnn_{t}" for t in THRESH} | {"gt"})
    for k, v in rec.items():
        assert v.dtype == torch.float32 and v.dim() == 0, k
        assert float(v) == float(jrec[k]), (k, float(v), float(jrec[k]))
    # some gt boxes pass the loosest threshold; the far ones pass none
    assert 0 < float(rec["rcnn_0.3"]) < float(rec["gt"])


def _port_detect(model, points, gt=None, mask=None):
    batch = {"points": torch.from_numpy(points),
             "points_mask": torch.ones(points.shape[:2], dtype=torch.bool),
             "batch_size": points.shape[0]}
    if gt is not None:
        batch.update(gt_boxes=torch.from_numpy(gt), gt_boxes_mask=torch.from_numpy(mask))
    with torch.no_grad():
        return model.eval().post_processing(model.eval()(batch))


def _jax_recall(jmodel, variables, points, gt, mask):
    @jax.jit
    def run(v, pts, g, gm):
        out = jmodel.apply(v, {"points": pts, "points_mask": jnp.ones(pts.shape[:2], bool),
                               "batch_size": pts.shape[0]}, training=False)
        out = dict(out, gt_boxes=g, gt_boxes_mask=gm)
        return jmodel.apply(v, out, method=lambda m, bd: m.post_processing(bd))

    return jax.tree_util.tree_map(np.asarray, run(variables, points, gt, mask))


def _lowered(cfg):
    cfg["POST_PROCESSING"]["SCORE_THRESH"] = (
        [0.0] * len(cfg["POST_PROCESSING"]["SCORE_THRESH"])
        if isinstance(cfg["POST_PROCESSING"]["SCORE_THRESH"], (list, tuple)) else 0.0)
    assert list(cfg["POST_PROCESSING"]["RECALL_THRESH_LIST"]) == list(THRESH)
    return cfg


@pytest.fixture(scope="module")
def tsm_case():
    init_model = ge._tsm_model()
    v = jax.jit(lambda r, b: init_model.init(r, b, training=True))(
        jax.random.PRNGKey(0), dict(ge._synth_batch(2, with_gt=True, seed=0)))
    jmodel = jbuild(_lowered(ge._tsm_model_cfg()), num_class=3,
                    dataset=init_model.dataset_meta)
    model = build_network(_lowered(tiny.tiny_model_cfg()), 3, tiny.META, device="cpu")
    model.load_state_dict(tiny.load_state(), strict=True)
    return jmodel, v, model, tiny.synth_points(2)


@pytest.fixture(scope="module")
def second_case():
    cfg = second_model_cfg()
    init_model = jbuild(cfg, num_class=1, dataset=SECOND_JMETA)
    v = jax.jit(lambda r, b: init_model.init(r, b, training=False))(
        jax.random.PRNGKey(0), dict(synthetic_batch()))
    jmodel = jbuild(_lowered(second_model_cfg()), num_class=1, dataset=SECOND_JMETA)
    model = build_network(_lowered(tiny.second_model_cfg()), 1, tiny.SECOND_META,
                          device="cpu")
    model.load_state_dict(tiny.load_state(tiny.SECOND_STATE_PATH), strict=True)
    return jmodel, v, model, tiny.second_points(2)


@pytest.mark.parametrize("which", ["tsm", "second"])
def test_recall_dict_matches_jax(request, which):
    jmodel, v, model, points = request.getfixturevalue(f"{which}_case")
    # the gt boxes are made from the port's kept boxes; both sides then
    # count them against their own predictions
    pred, _ = _port_detect(model, points)
    gt, mask = _gt_from(pred["pred_boxes"].numpy(), pred["count"].numpy(), seed=11)
    jpred, jrec = _jax_recall(jmodel, v, points, gt, mask)
    tpred, rec = _port_detect(model, points, gt, mask)
    np.testing.assert_array_equal(tpred["count"].numpy(), jpred["count"])
    _compare(jrec, rec)


def test_no_gt_boxes_no_recall(tsm_case):
    _, _, model, points = tsm_case
    pred, rec = _port_detect(model, points)
    assert rec == {} and int(pred["count"].sum()) > 0
