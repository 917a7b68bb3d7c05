"""The port's Part-A2 against the JAX package on the CPU.

Modules, each fed the JAX module's own input: MeanVFE (exact), UNetV2
(point_features and the dense encoded_spconv_tensor; 21 by-key convs, every
one through gather_matmul_bykey, no probe), the BEV backbone, the anchor
head, PointIntraPartOffsetHead (eval outputs, and its loss on the JAX
training forward's features), PartA2FCHead (RoIs and labels exact, refined
boxes and scores; its RCNN loss on the JAX training forward's inputs) and
`roiaware_pool` (max and average, empty cells, points in two RoIs, tied
features and the gradient, which splits evenly among tied maxima as
segment_max's does). Whole: the tiny Part-A2's eval outputs and
post-processed predictions, the committed golden, one training step (loss,
tb terms, every gradient, conv_box's through the RoIs included, BN
statistics after it) with one scan whose sampled set is full and one whose
is empty (tiny.TWO_STAGE_GT), and PartA2.yaml's full-width flax tree loaded
strictly.

Tolerances: outputs at the golden one (atol 1e-3 * max(1, max|want|), rtol
1e-3), labels, counts, RoIs' labels and kept sets exact; the pool 1e-6 and
its gradient exact; the training step's loss and tb terms 1e-4, gradients
rtol 1e-3 above the rounding floor (atol 1e-4 * max(the tensor's largest
|g|, 1e-2 * the model's)), BN statistics 1e-5.

The state is tiny.two_stage_state("parta2"), for the training checks with
train=True (see TWO_STAGE_TRAIN_BN_LIFT there); the golden
tsm_det_pointcloud_tpu_torch/data/parta2_tiny_forward.npz is regenerated
with tests/torch_two_stage_cases.py's write_forward("parta2").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_two_stage_cases as cases
from tests.torch_two_stage_cases import golden_close, t
from tsm_det_pointcloud_tpu.models.roi_heads.partA2_head import roiaware_pool as jpool
from tsm_det_pointcloud_tpu_torch import infer
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models.roi_heads.partA2_head import roiaware_pool
from tsm_det_pointcloud_tpu_torch.ops import spconv

EVAL_KEYS = ("voxel_features", "voxel_coords", "voxel_mask", "encoded_spconv_tensor",
             "spatial_features", "spatial_features_2d", "cls_preds", "box_preds",
             "dir_cls_preds", "point_features", "point_coords_voxel", "point_valid",
             "point_coords", "point_cls_scores", "point_part_offset")


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
    return cases.JaxCase("parta2", EVAL_KEYS)


@pytest.fixture(scope="module")
def eval_case(jcase):
    out, pred = jcase.eval()
    return dict(out=out, pred=pred)


def test_committed_forward_is_current(eval_case):
    """The committed golden is the JAX package's output now (1e-5), with
    scores on both sides of SCORE_THRESH and kept detections."""
    with np.load(cases.forward_path("parta2")) as z:
        golden = {k: z[k] for k in z.files}
    want = {**{k: eval_case["out"][k] for k in cases.FORWARD}, **eval_case["pred"]}
    assert set(golden) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert golden["count"].min() > 0
    assert golden["rois"].shape == (2, 8, 7) and (golden["roi_labels"] == 1).all()


def test_reproduces_committed_golden():
    out, pred = infer.detect(cases.port_model("parta2"), t(cases.points()["points"]),
                             torch.ones(2, cases.N_POINTS, dtype=torch.bool))
    with np.load(cases.forward_path("parta2")) as golden:
        for k in ("roi_labels", "pred_labels", "count"):
            np.testing.assert_array_equal((out if k in cases.FORWARD else pred)[k].numpy(),
                                          golden[k], err_msg=k)
        for k in ("batch_cls_preds", "batch_box_preds", "rois", "pred_boxes", "pred_scores"):
            golden_close((out if k in cases.FORWARD else pred)[k].numpy(), golden[k], k)


def test_modules_against_jax(eval_case, monkeypatch):
    out = eval_case["out"]
    vfe, unet, to_bev, b2d, head, point_head, roi_head = cases.port_model("parta2").module_list
    calls = {"gather_matmul_bykey": 0, "probe": 0}
    for name in calls:
        orig = getattr(spconv, name)

        def counted(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)

        monkeypatch.setattr(spconv, name, counted)
    with torch.no_grad():
        got = vfe({k: t(v) for k, v in cases.points().items()})
        for k in ("voxel_features", "voxel_coords", "voxel_mask"):
            np.testing.assert_array_equal(got[k].numpy(), out[k], err_msg=k)
        got = unet({k: t(out[k]) for k in ("voxel_features", "voxel_coords", "voxel_mask")})
        assert calls == {"gather_matmul_bykey": 21, "probe": 0}
        assert out["encoded_spconv_tensor"].shape == (2, 2, 4, 4, 128)
        for k in ("encoded_spconv_tensor", "point_features"):
            assert np.abs(out[k]).max() > 0
            golden_close(got[k], out[k], k)
        for k in ("point_coords_voxel", "point_valid"):
            np.testing.assert_array_equal(got[k].numpy(), out[k], err_msg=k)
        ms = got["multi_scale_3d_features"]
        assert [ms[f"x_conv{i}"].features.shape[-1] for i in (1, 2, 3, 4)] == [16, 32, 64, 64]
        got = to_bev({"encoded_spconv_tensor": t(out["encoded_spconv_tensor"])})
        np.testing.assert_array_equal(got["spatial_features"].numpy(), out["spatial_features"])
        got = b2d({"spatial_features": t(out["spatial_features"])})
        golden_close(got["spatial_features_2d"], out["spatial_features_2d"], "sf2d")
        dense = head({"spatial_features_2d": t(out["spatial_features_2d"])})
        for k in ("cls_preds", "box_preds", "dir_cls_preds"):
            golden_close(dense[k], out[k], k)
        got = point_head({k: t(out[k]) for k in ("point_features", "point_valid",
                                                 "point_coords_voxel")})
        for k in ("point_coords", "point_cls_scores", "point_part_offset"):
            golden_close(got[k], out[k], k)
        bd = {k: t(out[k]) for k in ("point_features", "point_valid", "point_coords",
                                     "point_cls_scores", "point_part_offset")}
        got = roi_head(dict(bd, batch_cls_preds=dense["batch_cls_preds"],
                            batch_box_preds=dense["batch_box_preds"]))
    np.testing.assert_array_equal(got["roi_labels"].numpy(), out["roi_labels"])
    for k in ("rois", "batch_cls_preds", "batch_box_preds"):
        golden_close(got[k], out[k], k)


def test_post_processing_index_equal(eval_case):
    """The template's post-processing with roi_labels on the JAX outputs:
    counts, labels and kept boxes equal, kept scores within 1 ulp (the two
    sigmoids round apart)."""
    out = {k: t(eval_case["out"][k]) for k in cases.FORWARD}
    pred, _ = cases.port_model("parta2").post_processing(out)
    for k in ("count", "pred_labels", "pred_boxes"):
        np.testing.assert_array_equal(pred[k].numpy(), eval_case["pred"][k], err_msg=k)
    np.testing.assert_allclose(pred["pred_scores"].numpy(), eval_case["pred"]["pred_scores"],
                               rtol=2e-7)


def _pool_case():
    """Points on a 1/8 m grid in and around two overlapping RoIs (points in
    both), features on a coarse grid of values with many ties (ReLU zeros
    among them), some points invalid; 4^3 cells a RoI, so that many are
    empty."""
    rng = np.random.RandomState(0)
    pts = (rng.randint(-24, 40, (300, 3)) / 8.0).astype(np.float32)
    pts[:, 2] /= 4
    feats = np.maximum(rng.randint(-3, 4, (300, 5)), 0).astype(np.float32) / 2
    valid = rng.uniform(size=300) > 0.1
    rois = np.array([[0.3, 0.2, 0.0, 4.0, 3.0, 1.5, 0.4],
                     [2.1, 0.9, 0.1, 3.0, 3.0, 1.6, -0.7],
                     [30.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]], np.float32)
    return pts, feats, valid, rois


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_roiaware_pool(pool):
    pts, feats, valid, rois = _pool_case()
    g = np.random.RandomState(1).randn(3, 64, 5).astype(np.float32)

    def jf(f):
        out = jpool(jnp.asarray(pts), f, jnp.asarray(valid), jnp.asarray(rois), 4, pool=pool)
        return (out * g).sum(), out

    (_, want), wgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(feats))
    tf = t(feats).requires_grad_(True)
    got = roiaware_pool(t(pts), tf, t(valid), t(rois), 4, pool=pool)
    (got * t(g)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    filled = (want != 0).any(-1)
    assert 10 < filled[:2].sum() < 2 * 64 and not filled[2].any()
    from tsm_det_pointcloud_tpu_torch.ops.boxes import points_in_boxes_mask
    inside = points_in_boxes_mask(t(pts), t(rois)).numpy() & valid[:, None]
    assert (inside[:, 0] & inside[:, 1]).sum() > 5
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(wgrad), rtol=1e-6, atol=1e-6)
    if pool == "max":
        # tied maxima share the cell's gradient evenly: some points get a
        # fraction of a cell's cotangent
        assert np.abs(np.asarray(wgrad)).max() > 0


def _train_batch():
    return dict({k: t(v) for k, v in cases.train_batch("parta2").items()}, batch_size=2)


@pytest.fixture(scope="module")
def train_case(jcase):
    want = jcase.train()
    model = cases.port_model("parta2", train=True)
    margin = cases.relu_input_margin(cases.port_model("parta2", train=True), _train_batch())
    out = model(_train_batch())
    out["loss"].backward()
    return dict(want, model=model, out=out, margin=margin)


def test_train_loss_and_tb_terms(train_case):
    """The step's loss and tb terms; every ReLU input of the step lies at
    least 1e-5 from 0 (tiny.TWO_STAGE_TRAIN_BN_LIFT)."""
    assert train_case["margin"] > 1e-5
    out = train_case["out"]
    cases.close_scalar(out["loss"].detach(), train_case["loss"], "loss")
    assert set(out["tb_dict"]) == set(train_case["tb"]) == {
        "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss", "point_loss",
        "rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss"}
    for k, v in train_case["tb"].items():
        cases.close_scalar(out["tb_dict"][k].detach(), v, k)
    sampled = out["roi_targets"]["sampled"]
    assert sampled[0].sum() == 8 and not sampled[1].any()
    assert (out["roi_targets"]["fg"] & sampled).sum() == 2
    assert float(train_case["tb"]["rcnn_corner_loss"]) > 0


def test_train_gradients(train_case):
    cases.check_gradients(train_case["model"], train_case["grads"])


def test_rcnn_loss_reaches_conv_box(train_case):
    """The RCNN loss alone has a gradient on the anchor head's conv_box,
    through the RoIs, of the size of the tolerance's scale or more (the JAX
    package's, which the whole gradient matches, has it too)."""
    model = cases.port_model("parta2", train=True)
    out = model(_train_batch())
    w = model.module_list[4].conv_box.weight
    g = torch.autograd.grad(out["loss_rcnn"], w)[0]
    assert float(g.abs().max()) > 1e-2 * float(train_case["grads"]["module_list.4.conv_box.weight"]
                                               .abs().max())


def test_train_batch_stats(train_case):
    cases.check_batch_stats(train_case["model"], train_case["stats"])


def test_head_losses_on_jax_inputs(train_case):
    """The point head's and the RoI head's losses on the JAX training
    forward's own inputs."""
    aux, tb = train_case["aux"], train_case["tb"]
    gt, gmask = (t(a) for a in cases.tiny.two_stage_gt("parta2"))
    head, point_head, roi_head = cases.port_model("parta2", train=True).module_list[4:]
    out = point_head({"point_features": t(aux["point_features"]),
                      "point_valid": t(aux["point_valid"]),
                      "point_coords": t(aux["point_coords"]), "gt_boxes": gt,
                      "gt_boxes_mask": gmask})
    cases.close_scalar(out["loss_point"].detach(), tb["point_loss"], "point_loss")
    cls, box = head.generate_predicted_boxes(t(aux["cls_preds"]), t(aux["box_preds"]),
                                             t(aux["dir_cls_preds"]))
    out = roi_head({"batch_cls_preds": cls, "batch_box_preds": box, "gt_boxes": gt,
                    "gt_boxes_mask": gmask,
                    **{k: t(aux[k]) for k in ("point_features", "point_valid", "point_coords",
                                              "point_cls_scores", "point_part_offset")}})
    for k, v in out["tb_dict_rcnn"].items():
        cases.close_scalar(v.detach(), tb[k], k)


def test_full_width_flax_tree_loads_strictly():
    """Every flax leaf of PartA2.yaml's JAX init maps onto the port, strict."""
    variables, model, meta = cases.full_width_state(
        infer.ROOT / "tools/cfgs/kitti_models/PartA2.yaml")
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model.load_state_dict(state, strict=True)
    assert meta.grid_size == (1408, 1600, 40) and meta.max_voxels == 40000
    assert state["module_list.6.shared_fc0.weight"].shape == (256, 12 ** 3 * 19)
    assert state["module_list.5.cls_out.weight"].shape == (3, 16)
    assert state["module_list.1.up4to3_fuse.weight"].shape == (27, 128, 64)
