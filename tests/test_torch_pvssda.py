"""The port's PVSSDA (the TSM project's point detector) against the JAX package
on the CPU: the tiny PVSSDA on 3DSSD's PointNet2FSMSG ("fsmsg": d-fps,
f-fps, s-fps, dilated groups of up to 40 samples, confidence scores) and on
PointNet2MSG ("msg", the JAX package's own test topology, whose head codes
boxes without mean sizes), each on `tiny.pvssda_state(which)`.

Checks: PointResidualCoder without mean sizes; the head aliases; each tiny
model's eval outputs and post-processed predictions (golden tolerance:
atol 1e-3 * max(1, max|want|), rtol 1e-3; picks, labels and counts exact)
and the committed golden `data/pvssda_tiny_forward.npz`; one training step
(loss and tb terms rtol 1e-4, every gradient rtol 1e-3 above the rounding
floor, BN statistics 1e-5); and the full-width pvssda_3dssd.yaml: the JAX
model's flax tree loads strictly into the port's, through `convert.py`.

The golden is regenerated with
    python -c "from tests.test_torch_pvssda import write_pvssda_golden; write_pvssda_golden()"
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_two_stage_cases import (
    check_batch_stats,
    check_gradients,
    close_scalar,
    full_width_state,
    golden_close,
)
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu.ops import box_coder_utils as jcoder
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.dense_heads import point_head_box
from tsm_det_pointcloud_tpu_torch.ops import box_coder_utils

EVAL = ("batch_cls_preds", "batch_box_preds", "point_coords", "point_valid",
        "point_features")
PRED = ("pred_boxes", "pred_scores", "pred_labels", "count")
CFG = "tools/cfgs/kitti_models/pvssda_3dssd.yaml"


def t(a):
    return torch.from_numpy(np.array(a))


def _batch(train=False):
    pts = tiny.pvssda_points(2)
    b = {"points": pts, "points_mask": np.ones(pts.shape[:2], bool)}
    if train:
        b["gt_boxes"], b["gt_boxes_mask"] = tiny.pvssda_gt()
    return b


class JaxPVSSDA:
    """The JAX tiny PVSSDA `which` and its jitted eval (with post-processing)
    and training step, on the port states converted to flax variables."""

    def __init__(self, which):
        self.which = which
        self.model = jbuild(tiny.pvssda_model_cfg(which), num_class=1,
                            dataset=JDatasetMeta(**dataclasses.asdict(tiny.PVSSDA_META)))

    def eval(self):
        m = self.model

        @jax.jit
        def run(v, b):
            out = m.apply(v, dict(b, batch_size=2), training=False)
            pred, _ = m.apply(v, out, method=lambda mm, bd: mm.post_processing(bd))
            return {k: out[k] for k in EVAL}, pred

        return jax.tree_util.tree_map(np.asarray, run(
            to_flax_variables(tiny.pvssda_state(self.which)), _batch()))

    def train(self):
        m = self.model
        variables = to_flax_variables(tiny.pvssda_state(self.which, train=True))

        @jax.jit
        def step(params, b):
            def loss_fn(p):
                out, mut = m.apply(dict(variables, params=p), dict(b, batch_size=2),
                                   training=True, mutable=["batch_stats"])
                return out["loss"], (out["tb_dict"], mut["batch_stats"])
            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        (loss, (tb, stats)), grads = jax.tree_util.tree_map(
            np.asarray, step(variables["params"], _batch(train=True)))
        return dict(loss=loss, tb=tb, stats=from_flax_variables({"batch_stats": stats}),
                    grads=from_flax_variables({"params": grads}))


_CASES = {}


def _case(which):
    """The JAX eval outputs, predictions and training step of the tiny
    `which`, computed once a module run."""
    if which not in _CASES:
        j = JaxPVSSDA(which)
        out, pred = j.eval()
        _CASES[which] = dict(which=which, out=out, pred=pred, train=j.train())
    return _CASES[which]


@pytest.fixture(scope="module", params=["fsmsg", "msg"])
def case(request):
    return _case(request.param)


def _port(which, train=False):
    model = build_network(tiny.pvssda_model_cfg(which), 1, tiny.PVSSDA_META, device="cpu")
    model.load_state_dict(tiny.pvssda_state(which, train=train), strict=True)
    return model.train(train)


def write_pvssda_golden():
    """The JAX eval outputs and predictions of the tiny PVSSDA on
    PointNet2FSMSG."""
    out, pred = JaxPVSSDA("fsmsg").eval()
    np.savez_compressed(tiny.PVSSDA_FORWARD_PATH,
                        **{k: out[k] for k in ("batch_cls_preds", "batch_box_preds")},
                        **{k: pred[k] for k in PRED})


def test_point_residual_coder_without_mean_size():
    rng = np.random.RandomState(3)
    boxes = np.concatenate([rng.uniform(-5, 5, (40, 3)), rng.uniform(0.5, 4, (40, 3)),
                            rng.uniform(-3, 3, (40, 1)), np.ones((40, 1))], 1).astype(np.float32)
    pts = (boxes[:, :3] + rng.uniform(-1, 1, (40, 3))).astype(np.float32)
    cls = np.ones(40, np.int32)
    j = jcoder.PointResidualCoder(use_mean_size=False)
    p = box_coder_utils.PointResidualCoder(use_mean_size=False)
    enc = p.encode(t(boxes), t(pts), t(cls))
    dec = p.decode(enc[:, :8], t(pts), t(cls))
    # both JAX sides in one jit: one compile, not one a primitive
    jenc, jdec = jax.jit(lambda b, q, c, e: (j.encode(b, q, c), j.decode(e, q, c)))(
        boxes, pts, cls, enc[:, :8].numpy())
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dec[:, :6].numpy(), boxes[:, :6], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["PVSSDAHead", "VPCNetHead", "DSASNetHead"])
def test_head_aliases(name):
    """The three TSM heads are PointHeadBox under other names: PVSSDA builds
    with each, with the same parameters, and the same forward."""
    cfg = tiny.pvssda_model_cfg("msg")
    cfg.POINT_HEAD.NAME = name
    model = build_network(cfg, 1, tiny.PVSSDA_META, device="cpu")
    head = model.module_list[1]
    assert type(head).__name__ == name and isinstance(head, point_head_box.PointHeadBox)
    model.load_state_dict(tiny.pvssda_state("msg"), strict=True)
    out, _ = infer.detect(model, t(_batch()["points"]), torch.ones(2, 512, dtype=torch.bool))
    want, _ = infer.detect(_port("msg"), t(_batch()["points"]),
                           torch.ones(2, 512, dtype=torch.bool))
    assert torch.equal(out["batch_box_preds"], want["batch_box_preds"])


def test_tiny_eval_matches_jax(case):
    model = _port(case["which"])
    out, pred = infer.detect(model, t(_batch()["points"]), torch.ones(2, 512, dtype=torch.bool))
    for k in ("point_coords", "point_valid"):
        np.testing.assert_array_equal(out[k].numpy(), case["out"][k], err_msg=k)
    for k in ("point_features", "batch_cls_preds", "batch_box_preds"):
        golden_close(out[k].numpy(), case["out"][k], k)
    for k in ("pred_labels", "count"):
        np.testing.assert_array_equal(pred[k].numpy(), case["pred"][k], err_msg=k)
    for k in ("pred_boxes", "pred_scores"):
        golden_close(pred[k].numpy(), case["pred"][k], k)
    assert case["pred"]["count"].min() > 0
    if case["which"] == "fsmsg":
        assert out["batch_box_preds"].shape == (2, 64, 7) and len(out["point_scores_list"]) == 2


def test_committed_golden():
    """The committed golden is the JAX package's, and the port reproduces it."""
    case = _case("fsmsg")
    with np.load(tiny.PVSSDA_FORWARD_PATH) as z:
        golden = {k: z[k] for k in z.files}
    want = {**{k: case["out"][k] for k in ("batch_cls_preds", "batch_box_preds")},
            **case["pred"]}
    assert set(golden) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    out, pred = infer.detect(_port("fsmsg"), t(_batch()["points"]),
                             torch.ones(2, 512, dtype=torch.bool))
    for k in ("pred_labels", "count"):
        np.testing.assert_array_equal(pred[k].numpy(), golden[k], err_msg=k)
    for k in ("batch_cls_preds", "batch_box_preds"):
        golden_close(out[k].numpy(), golden[k], k)
    for k in ("pred_boxes", "pred_scores"):
        golden_close(pred[k].numpy(), golden[k], k)


def test_tiny_training_step(case):
    model = _port(case["which"], train=True)
    b = {k: t(v) for k, v in _batch(train=True).items()}
    out = model(dict(b, batch_size=2))
    want = case["train"]
    close_scalar(out["loss"], want["loss"], "loss")
    assert set(out["tb_dict"]) == set(want["tb"]) == {"point_loss"}
    close_scalar(out["tb_dict"]["point_loss"], want["tb"]["point_loss"], "point_loss")
    labels, _ = model.module_list[1].assign_targets(out["point_coords"], out["point_valid"],
                                                    b["gt_boxes"], b["gt_boxes_mask"])
    assert int((labels > 0).sum()) > 0          # the box loss has terms
    out["loss"].backward()
    # no loss of PVSSDA reads the confidence scores (layer 0's feed layer
    # 1's s-fps, which has no gradient; layer 1's nothing): their MLPs get no
    # gradient, and JAX's is zero there
    idle = {n for n, p in model.named_parameters() if p.grad is None}
    assert idle == {n for n in want["grads"] if ".confidence" in n}
    assert bool(idle) == (case["which"] == "fsmsg")
    for n in idle:
        assert not want["grads"][n].any(), n
        dict(model.named_parameters())[n].grad = torch.zeros_like(want["grads"][n])
    check_gradients(model, want["grads"])
    check_batch_stats(model, want["stats"])


def test_full_width_flax_tree_loads_strictly():
    """pvssda_3dssd.yaml at its widths: every leaf of the JAX model's flax
    tree (eval_shape, zeros) converts to the port model's state dict and
    loads strictly, and the port's state round-trips to the same tree."""
    variables, model, _ = full_width_state(CFG)
    state = from_flax_variables(variables)
    model.load_state_dict(state, strict=True)
    ported = to_flax_variables(model.state_dict())
    flat = lambda tree: {jax.tree_util.keystr(p): np.shape(v)
                         for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(ported) == flat(variables)
    sa = model.module_list[0]
    assert [s[2] for s in sa.sa0.scales] == [32, 32, 64] and sa.sa0.scales[2][0] == 0.4
    assert sa.num_point_features == 256 and not sa.sa2.has_confidence
    assert type(model.module_list[1]).__name__ == "PVSSDAHead"
