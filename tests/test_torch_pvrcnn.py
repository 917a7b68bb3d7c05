"""The port's PV-RCNN against the JAX package on the CPU.

Modules, each fed the JAX module's own input: MeanVFE (exact), the sparse
stem (8 probes and 12 index gather-GEMMs), the BEV backbone, the anchor
head, VoxelSetAbstraction (each FEATURES_SOURCE alone, then all fused: its
keypoints index-equal, one d-fps and one query_group call per point source),
PointHeadSimple (eval scores, and its loss on the JAX training forward's
keypoints) and PVRCNNHead (RoIs and labels exact, refined boxes and scores
through one RoI-grid query_group call; its RCNN loss on the JAX training
forward's inputs). Whole: the tiny PV-RCNN's eval outputs and
post-processed predictions, the committed golden, one training step (loss,
tb terms, every gradient, conv_box's through the RoIs included, BN
statistics after it), and pvrcnn.yaml's full-width flax tree loaded
strictly.

Tolerances: outputs at the golden one (atol 1e-3 * max(1, max|want|), rtol
1e-3), labels, counts, keypoint sets, RoIs' labels and kept sets exact; the
training step's loss and tb terms 1e-4, gradients rtol 1e-3 above the
rounding floor (atol 1e-4 * max(the tensor's largest |g|, 1e-2 * the
model's)), BN statistics 1e-5.

The state is tiny.two_stage_state("pvrcnn"), for the training checks with
train=True (see TWO_STAGE_TRAIN_BN_LIFT there); the golden
tsm_det_pointcloud_tpu_torch/data/pvrcnn_tiny_forward.npz is regenerated
with tests/torch_two_stage_cases.py's write_forward("pvrcnn").
"""
import jax
import numpy as np
import pytest
import torch

from tests import torch_two_stage_cases as cases
from tests.torch_two_stage_cases import golden_close, t
from tsm_det_pointcloud_tpu.models.backbones_3d.pfe.voxel_set_abstraction import (
    VoxelSetAbstraction as JVSA,
)
from tsm_det_pointcloud_tpu.models.backbones_3d.spconv_backbone import (
    SparseTensor as JSparseTensor,
)
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.pfe.voxel_set_abstraction import (
    VoxelSetAbstraction,
)
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.spconv_backbone import SparseTensor
from tsm_det_pointcloud_tpu_torch.ops import grouping, sampling, spconv

EVAL_KEYS = ("voxel_features", "voxel_coords", "voxel_mask", "encoded_spconv_tensor",
             "spatial_features", "spatial_features_2d", "cls_preds", "box_preds",
             "dir_cls_preds", "point_features_before_fusion", "point_features",
             "point_coords", "point_valid", "point_cls_scores", "x_conv3", "x_conv4")
SOURCES = ("bev", "x_conv3", "x_conv4", "raw_points")
GRIDS = {"x_conv3": ((11, 8, 8), 4), "x_conv4": ((5, 4, 4), 8)}


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
    return cases.JaxCase("pvrcnn", EVAL_KEYS)


@pytest.fixture(scope="module")
def eval_case(jcase):
    out, pred = jcase.eval()
    return dict(out=out, pred=pred)


def test_committed_forward_is_current(eval_case):
    with np.load(cases.forward_path("pvrcnn")) as z:
        golden = {k: z[k] for k in z.files}
    want = {**{k: eval_case["out"][k] for k in cases.FORWARD}, **eval_case["pred"]}
    assert set(golden) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert golden["count"].min() > 0
    assert golden["rois"].shape == (2, 16, 7)


def test_reproduces_committed_golden():
    out, pred = infer.detect(cases.port_model("pvrcnn"), t(cases.points()["points"]),
                             torch.ones(2, cases.N_POINTS, dtype=torch.bool))
    with np.load(cases.forward_path("pvrcnn")) as golden:
        for k in ("roi_labels", "pred_labels", "count"):
            np.testing.assert_array_equal((out if k in cases.FORWARD else pred)[k].numpy(),
                                          golden[k], err_msg=k)
        for k in ("batch_cls_preds", "batch_box_preds", "rois", "pred_boxes", "pred_scores"):
            golden_close((out if k in cases.FORWARD else pred)[k].numpy(), golden[k], k)


def _counted(monkeypatch, calls, module, name):
    orig = getattr(module, name)

    def counted(*a, **kw):
        calls[name] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, counted)


def _port_sparse(out, src):
    feats, coords, valid = out[src]
    grid, stride = GRIDS[src]
    return SparseTensor(t(feats), t(coords), t(valid), grid, stride)


def test_modules_against_jax(eval_case, monkeypatch):
    out = eval_case["out"]
    vfe, b3d, to_bev, vsa, b2d, head, point_head, roi_head = \
        cases.port_model("pvrcnn").module_list
    calls = dict.fromkeys(("probe", "gather_matmul", "query_group", "furthest_point_sample"), 0)
    for mod, name in ((spconv, "probe"), (spconv, "gather_matmul"), (grouping, "query_group"),
                      (sampling, "furthest_point_sample")):
        _counted(monkeypatch, calls, mod, name)
    with torch.no_grad():
        got = vfe({k: t(v) for k, v in cases.points().items()})
        for k in ("voxel_features", "voxel_coords", "voxel_mask"):
            np.testing.assert_array_equal(got[k].numpy(), out[k], err_msg=k)
        got = b3d({k: t(out[k]) for k in ("voxel_features", "voxel_coords", "voxel_mask")})
        assert calls == {"probe": 8, "gather_matmul": 12, "query_group": 0,
                         "furthest_point_sample": 0}
        golden_close(got["encoded_spconv_tensor"], out["encoded_spconv_tensor"], "encoded")
        for src in GRIDS:
            st = got["multi_scale_3d_features"][src]
            assert (st.grid, st.stride) == GRIDS[src]
            np.testing.assert_array_equal(st.coords.numpy(), out[src][1], err_msg=src)
            golden_close(st.features, out[src][0], src)
        bd = {"points": t(cases.points()["points"]), "points_mask": t(cases.points()[
            "points_mask"]), "spatial_features": t(out["spatial_features"]),
              "spatial_features_stride": 8,
              "multi_scale_3d_features": {s: _port_sparse(out, s) for s in GRIDS},
              "multi_scale_3d_strides": {s: GRIDS[s][1] for s in GRIDS}}
        got = vsa(bd)
        assert calls["query_group"] == 3 and calls["furthest_point_sample"] == 1
        np.testing.assert_array_equal(got["point_coords"].numpy(), out["point_coords"])
        np.testing.assert_array_equal(got["point_valid"].numpy(), out["point_valid"])
        for k in ("point_features_before_fusion", "point_features"):
            golden_close(got[k], out[k], k)
        got = b2d({"spatial_features": t(out["spatial_features"])})
        golden_close(got["spatial_features_2d"], out["spatial_features_2d"], "sf2d")
        dense = head({"spatial_features_2d": t(out["spatial_features_2d"])})
        for k in ("cls_preds", "box_preds", "dir_cls_preds"):
            golden_close(dense[k], out[k], k)
        kp = {k: t(out[k]) for k in ("point_features_before_fusion", "point_features",
                                     "point_coords", "point_valid")}
        got = point_head(dict(kp))
        golden_close(got["point_cls_scores"], out["point_cls_scores"], "point_cls_scores")
        got = roi_head(dict(kp, point_cls_scores=t(out["point_cls_scores"]),
                            batch_cls_preds=dense["batch_cls_preds"],
                            batch_box_preds=dense["batch_box_preds"]))
    assert calls["query_group"] == 4
    np.testing.assert_array_equal(got["roi_labels"].numpy(), out["roi_labels"])
    for k in ("rois", "batch_cls_preds", "batch_box_preds"):
        golden_close(got[k], out[k], k)


def _vsa_cfg(sources):
    cfg = tiny.pvrcnn_model_cfg().PFE
    cfg["FEATURES_SOURCE"] = list(sources)
    cfg["SA_LAYER"] = {k: v for k, v in cfg["SA_LAYER"].items() if k in sources}
    return dict(cfg)


@pytest.mark.parametrize("sources", [("bev",), ("x_conv3",), ("x_conv4",), ("raw_points",),
                                     SOURCES])
def test_vsa_sources(eval_case, sources):
    """The flax VoxelSetAbstraction of these sources alone (its own init) and
    the port's on its converted weights, at eval and in train mode (batch
    statistics), on the JAX forward's BEV map and sparse levels."""
    out = eval_case["out"]
    meta = tiny.PVRCNN_META
    cfg = _vsa_cfg(sources)
    jvsa = JVSA(model_cfg=cfg, voxel_size=meta.voxel_size,
                point_cloud_range=meta.point_cloud_range, num_bev_features=256,
                num_rawpoint_features=4)
    jbd = dict(cases.points(), spatial_features=out["spatial_features"],
               spatial_features_stride=8,
               multi_scale_3d_features={s: JSparseTensor(*out[s], *GRIDS[s]) for s in GRIDS},
               multi_scale_3d_strides={s: GRIDS[s][1] for s in GRIDS})
    keys = ("point_features_before_fusion", "point_features", "point_coords", "point_valid")

    @jax.jit
    def run(rng):
        variables = jvsa.init(rng, dict(jbd), training=False)
        ev = jvsa.apply(variables, dict(jbd), training=False)
        tr, _ = jvsa.apply(variables, dict(jbd), training=True, mutable=["batch_stats"])
        return variables, {k: ev[k] for k in keys}, {k: tr[k] for k in keys}

    variables, want_ev, want_tr = jax.tree_util.tree_map(np.asarray, run(jax.random.PRNGKey(2)))
    port = VoxelSetAbstraction(cfg, meta.voxel_size, meta.point_cloud_range, 256, 4)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    bd = {"points": t(cases.points()["points"]),
          "points_mask": t(cases.points()["points_mask"]),
          "spatial_features": t(out["spatial_features"]), "spatial_features_stride": 8,
          "multi_scale_3d_features": {s: _port_sparse(out, s) for s in GRIDS},
          "multi_scale_3d_strides": {s: GRIDS[s][1] for s in GRIDS}}
    for mode, want in (("eval", want_ev), ("train", want_tr)):
        with torch.no_grad():
            got = port.train(mode == "train")(dict(bd))
        np.testing.assert_array_equal(got["point_coords"].numpy(), want["point_coords"])
        np.testing.assert_array_equal(got["point_valid"].numpy(), want["point_valid"])
        for k in ("point_features_before_fusion", "point_features"):
            assert np.abs(want[k]).max() > 0, (mode, k)
            golden_close(got[k], want[k], f"{mode} {k}")


def test_post_processing_index_equal(eval_case):
    out = {k: t(eval_case["out"][k]) for k in cases.FORWARD}
    pred, _ = cases.port_model("pvrcnn").post_processing(out)
    for k in ("count", "pred_labels", "pred_boxes"):
        np.testing.assert_array_equal(pred[k].numpy(), eval_case["pred"][k], err_msg=k)
    np.testing.assert_allclose(pred["pred_scores"].numpy(), eval_case["pred"]["pred_scores"],
                               rtol=2e-7)


def _train_batch():
    return dict({k: t(v) for k, v in cases.train_batch("pvrcnn").items()}, batch_size=2)


@pytest.fixture(scope="module")
def train_case(jcase):
    want = jcase.train()
    model = cases.port_model("pvrcnn", train=True)
    margin = cases.relu_input_margin(cases.port_model("pvrcnn", train=True), _train_batch())
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
    assert sampled.sum(1).tolist() == [16, 16]
    assert (out["roi_targets"]["fg"] & sampled).sum(1).tolist() == [2, 1]


def test_train_gradients(train_case):
    cases.check_gradients(train_case["model"], train_case["grads"])


def test_rcnn_loss_reaches_conv_box(train_case):
    """The RCNN loss alone has a gradient on conv_box through the RoIs (and
    on the RoI grid's pool_mlp through the re-centred lattice)."""
    model = cases.port_model("pvrcnn", train=True)
    out = model(_train_batch())
    w = model.module_list[5].conv_box.weight
    g = torch.autograd.grad(out["loss_rcnn"], w)[0]
    assert float(g.abs().max()) > 1e-2 * float(train_case["grads"]["module_list.5.conv_box.weight"]
                                               .abs().max())


def test_train_batch_stats(train_case):
    cases.check_batch_stats(train_case["model"], train_case["stats"])


def test_head_losses_on_jax_inputs(train_case):
    aux, tb = train_case["aux"], train_case["tb"]
    gt, gmask = (t(a) for a in tiny.two_stage_gt("pvrcnn"))
    head, point_head, roi_head = cases.port_model("pvrcnn", train=True).module_list[5:]
    kp = {k: t(aux[k]) for k in ("point_features", "point_valid", "point_coords")}
    feats = t(aux["point_features_before_fusion"])
    out = point_head(dict(kp, point_features_before_fusion=feats, gt_boxes=gt,
                          gt_boxes_mask=gmask))
    cases.close_scalar(out["loss_point"].detach(), tb["point_loss"], "point_loss")
    cls, box = head.generate_predicted_boxes(t(aux["cls_preds"]), t(aux["box_preds"]),
                                             t(aux["dir_cls_preds"]))
    out = roi_head(dict(kp, point_cls_scores=t(aux["point_cls_scores"]), batch_cls_preds=cls,
                        batch_box_preds=box, gt_boxes=gt, gt_boxes_mask=gmask))
    for k, v in out["tb_dict_rcnn"].items():
        cases.close_scalar(v.detach(), tb[k], k)


def test_full_width_flax_tree_loads_strictly():
    variables, model, meta = cases.full_width_state(
        infer.ROOT / "tools/cfgs/kitti_models/pvrcnn.yaml")
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model.load_state_dict(state, strict=True)
    assert state["module_list.3.vsa_point_feature_fusion.weight"].shape == (128, 640)
    assert state["module_list.6.cls_fc.fc0.weight"].shape == (256, 640)
    assert state["module_list.7.shared_fc0.weight"].shape == (256, 6 ** 3 * 128)
    assert state["module_list.7.pool_mlp0.fc0.weight"].shape == (64, 131)
