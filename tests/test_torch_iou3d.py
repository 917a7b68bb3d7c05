"""Port rotated BEV IoU and suppression-matrix NMS (ops/iou3d.py,
model_nms_utils.py) against the JAX package. IoU is elementwise f32 math in
the same order on both sides (tolerance 1e-5 for fused-op rounding);
keep sets, counts and labels must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.models.model_utils import model_nms_utils as jnms
from tsm_det_pointcloud_tpu.ops import iou3d as jiou
from tsm_det_pointcloud_tpu_torch.models.model_utils import model_nms_utils as tnms
from tsm_det_pointcloud_tpu_torch.ops import iou3d as tiou

NMS_CFG = {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 64,
           "NMS_POST_MAXSIZE": 24}


THRESH = [0.5, 0.3, 0.3]
_jax_multi_thresh = jax.jit(
    lambda s, b, l: jnms.multi_thresh_nms(s, b, l, NMS_CFG, THRESH))


def _boxes(seed, n=80):
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(0, 12, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[n // 2:n // 2 + 5] = b[:5]          # identical boxes
    b[n // 2 + 5:n // 2 + 8, 6] = 0.0     # axis-aligned edges
    return b


def test_boxes_iou_bev():
    a, b = _boxes(0), _boxes(1, 50)
    want = np.asarray(jax.jit(jiou.boxes_iou_bev)(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert want.max() > 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multi_thresh_nms(seed):
    rng = np.random.RandomState(seed)
    boxes = _boxes(seed)
    scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
    labels = rng.randint(1, 4, len(boxes)).astype(np.int32)
    wi, wc, ws = _jax_multi_thresh(jnp.asarray(scores), jnp.asarray(boxes),
                                   jnp.asarray(labels))
    gi, gc, gs = tnms.multi_thresh_nms(torch.from_numpy(scores),
                                       torch.from_numpy(boxes),
                                       torch.from_numpy(labels), NMS_CFG, THRESH)
    n = int(wc)
    assert int(gc) == n and n > 0
    np.testing.assert_array_equal(gi.numpy()[:n], np.asarray(wi)[:n])
    np.testing.assert_array_equal(gs.numpy()[:n], np.asarray(ws)[:n])


def test_class_agnostic_nms():
    rng = np.random.RandomState(5)
    boxes = _boxes(5)
    scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
    wi, wc, _ = jax.jit(lambda s_, b_: jnms.class_agnostic_nms(
        s_, b_, NMS_CFG, score_thresh=0.2))(jnp.asarray(scores), jnp.asarray(boxes))
    gi, gc, _ = tnms.class_agnostic_nms(torch.from_numpy(scores),
                                        torch.from_numpy(boxes), NMS_CFG,
                                        score_thresh=0.2)
    n = int(wc)
    assert int(gc) == n and n > 0
    np.testing.assert_array_equal(gi.numpy()[:n], np.asarray(wi)[:n])


def test_fixpoint_iterations_counted():
    """`FIXPOINT_ITERS` counts the keep fixpoint's passes (each ends in one
    host sync): a chain of four boxes, each overlapping its neighbours
    alone, in falling score order, settles on the first and third after
    four passes (all kept, the first alone, three, two, two)."""
    boxes = np.zeros((4, 7), np.float32)
    boxes[:, 0] = [0.0, 1.5, 3.0, 4.5]
    boxes[:, 3:6] = 2.0
    scores = np.array([0.9, 0.8, 0.7, 0.6], np.float32)
    tiou.FIXPOINT_ITERS[0] = 0
    idx, count, _ = tiou.nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores), 0.1)
    assert int(count) == 2 and idx[:2].tolist() == [0, 2]
    assert tiou.FIXPOINT_ITERS[0] == 4
