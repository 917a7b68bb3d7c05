"""The port's SECONDNetIoU against the JAX package on the CPU.

Modules, each fed the JAX module's own input: MeanVFE (exact), the sparse
stem (8 probes and 12 index gather-GEMMs), the BEV backbone, the anchor
head, and SECONDHead (RoIs and labels exact, its rectified scores, no K2
call). SECONDHead alone: its lattice pooling (the BEV map sampled at the xy
of each RoI's 3^3 lattice) against the JAX `bilinear_interpolate` on the JAX
lattice, the pooled rows through `shared_fc0` against the flax head's
intermediates, `iou_preds` and the rectified scores, at eval and in train
mode. Whole: the tiny SECONDNetIoU's eval outputs and post-processed
predictions, the committed golden, one training step (loss, tb terms,
every gradient, conv_box's through the RoIs included, BN statistics after
it; most RoIs touch no gt box, so their IoU target is a max over zeros
whose gradient splits), a second step from the state the JAX step reached,
`bilinear_interpolate`'s gradient against `jax.grad` on pixel edges and
off the map, and second_iou.yaml's full-width flax tree loaded strictly.
(chip_smoke.py phase 49 holds the IoU loss on RoIs made from the gt boxes
on the card against the CPU.)

Tolerances: outputs at the golden one (atol 1e-3 * max(1, max|want|), rtol
1e-3), labels, counts and the RoIs' labels exact; the training step's loss
and tb terms 1e-4, gradients rtol 1e-3 above the rounding floor (atol 1e-4
* max(the tensor's largest |g|, 1e-2 * the model's)), BN statistics 1e-5.

The state is tiny.two_stage_state("secondnetiou"), for the training checks
with train=True (tiny.TWO_STAGE_TRAIN_BN_LIFT); the golden
tsm_det_pointcloud_tpu_torch/data/secondnetiou_tiny_forward.npz is
regenerated with tests/torch_two_stage_cases.py's
write_forward("secondnetiou").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_two_stage_cases as cases
from tests.torch_two_stage_cases import golden_close, t
from tsm_det_pointcloud_tpu.models.backbones_3d.pfe.voxel_set_abstraction import (
    bilinear_interpolate as jbilinear_interpolate,
)
from tsm_det_pointcloud_tpu.models.roi_heads.pvrcnn_head import (
    roi_grid_points as jroi_grid_points,
)
from tsm_det_pointcloud_tpu.models.roi_heads.second_head import SECONDHead as JHead
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.pfe.voxel_set_abstraction import (
    bilinear_interpolate,
)
from tsm_det_pointcloud_tpu_torch.ops import grouping, spconv

W = "secondnetiou"
EVAL_KEYS = ("voxel_features", "voxel_coords", "voxel_mask", "encoded_spconv_tensor",
             "spatial_features", "spatial_features_2d", "cls_preds", "box_preds",
             "dir_cls_preds", "iou_preds", "roi_scores")


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


def test_committed_forward_is_current(eval_case):
    with np.load(cases.forward_path(W)) as z:
        golden = {k: z[k] for k in z.files}
    want = {**{k: eval_case["out"][k] for k in cases.FORWARD}, **eval_case["pred"]}
    assert set(golden) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert golden["count"].min() > 0
    assert golden["rois"].shape == (2, 8, 7)


def test_reproduces_committed_golden():
    out, pred = infer.detect(cases.port_model(W), t(cases.points()["points"]),
                             torch.ones(2, cases.N_POINTS, dtype=torch.bool))
    with np.load(cases.forward_path(W)) as golden:
        for k in ("roi_labels", "pred_labels", "count"):
            np.testing.assert_array_equal((out if k in cases.FORWARD else pred)[k].numpy(),
                                          golden[k], err_msg=k)
        for k in ("batch_cls_preds", "batch_box_preds", "rois", "pred_boxes", "pred_scores"):
            golden_close((out if k in cases.FORWARD else pred)[k].numpy(), golden[k], k)
    rect = out["batch_cls_preds"]
    assert out["cls_preds_normalized"] and float(rect.min()) >= 0 and float(rect.max()) <= 1


def _counted(monkeypatch, calls, module, name):
    orig = getattr(module, name)

    def counted(*a, **kw):
        calls[name] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, counted)


def test_modules_against_jax(eval_case, monkeypatch):
    out = eval_case["out"]
    vfe, b3d, to_bev, b2d, head, roi_head = cases.port_model(W).module_list
    calls = dict.fromkeys(("probe", "gather_matmul", "query_group"), 0)
    for mod, name in ((spconv, "probe"), (spconv, "gather_matmul"), (grouping, "query_group")):
        _counted(monkeypatch, calls, mod, name)
    with torch.no_grad():
        got = vfe({k: t(v) for k, v in cases.points().items()})
        for k in ("voxel_features", "voxel_coords", "voxel_mask"):
            np.testing.assert_array_equal(got[k].numpy(), out[k], err_msg=k)
        got = b3d({k: t(out[k]) for k in ("voxel_features", "voxel_coords", "voxel_mask")})
        golden_close(got["encoded_spconv_tensor"], out["encoded_spconv_tensor"], "encoded")
        got = to_bev({"encoded_spconv_tensor": t(out["encoded_spconv_tensor"])})
        golden_close(got["spatial_features"], out["spatial_features"], "spatial_features")
        got = b2d({"spatial_features": t(out["spatial_features"])})
        golden_close(got["spatial_features_2d"], out["spatial_features_2d"], "sf2d")
        dense = head({"spatial_features_2d": t(out["spatial_features_2d"])})
        for k in ("cls_preds", "box_preds", "dir_cls_preds"):
            golden_close(dense[k], out[k], k)
        got = roi_head({"batch_cls_preds": dense["batch_cls_preds"],
                        "batch_box_preds": dense["batch_box_preds"],
                        "spatial_features_2d": t(out["spatial_features_2d"]),
                        "spatial_features_stride": 8})
    assert calls == {"probe": 8, "gather_matmul": 12, "query_group": 0}
    np.testing.assert_array_equal(got["roi_labels"].numpy(), out["roi_labels"])
    for k in ("rois", "batch_cls_preds", "batch_box_preds", "iou_preds", "roi_scores"):
        golden_close(got[k], out[k], k)


def _jax_head(cfg):
    meta = tiny.VOXELRCNN_META
    return JHead(model_cfg=dict(cfg.ROI_HEAD), input_channels=128, num_class=1,
                 voxel_size=meta.voxel_size, point_cloud_range=meta.point_cloud_range)


def _proposals(out):
    head = cases.port_model(W).module_list[4]
    with torch.no_grad():
        return head.generate_predicted_boxes(t(out["cls_preds"]), t(out["box_preds"]),
                                             t(out["dir_cls_preds"]))


def test_lattice_pool_against_jax_bilinear(eval_case):
    """The pooled rows of the eval RoIs: the BEV map at the xy of each
    lattice point, against the JAX bilinear_interpolate on the JAX lattice
    (lattice points off the map included: their corners are clamped)."""
    out = eval_case["out"]
    meta = tiny.VOXELRCNN_META
    rois = out["rois"]
    bev = out["spatial_features_2d"]
    grid = np.asarray(jroi_grid_points(jnp.asarray(rois), 3))[..., :2].reshape(2, -1, 2)
    pcr, vx = meta.point_cloud_range, meta.voxel_size[0] * 8
    want = np.stack([np.asarray(jbilinear_interpolate(
        jnp.asarray(bm), (g[:, 0] - pcr[0]) / vx, (g[:, 1] - pcr[1]) / vx))
        for bm, g in zip(bev, grid)]).reshape(2, 8, -1)
    roi_head = cases.port_model(W).module_list[5]
    got = roi_head.roi_grid_pool({"spatial_features_2d": t(bev), "spatial_features_stride": 8},
                                 t(rois))
    assert got.shape == (2, 8, 27 * 32)
    golden_close(got.numpy(), want, "pooled")
    off = (grid[..., 0] < pcr[0]) | (grid[..., 0] > pcr[3]) | (grid[..., 1] < pcr[1]) \
        | (grid[..., 1] > pcr[4])
    assert off.any()


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_head_against_flax_intermediates(eval_case, mode):
    """SECONDHead on the dense head's decoded boxes and the JAX forward's
    BEV map: `shared_fc0`'s output, `iou_preds`, the rectified scores (in
    [0, 1]) and, in train mode, the IoU loss against the flax head's own
    forward."""
    out = eval_case["out"]
    cfg, _ = tiny.two_stage_model(W)
    cls, box = _proposals(out)
    train = mode == "train"
    head_vars = cases.sub_variables(to_flax_variables(tiny.two_stage_state(W, train=train)),
                                    ("module_list_5",))
    jhead = _jax_head(cfg)
    jbd = {"batch_cls_preds": cls.numpy(), "batch_box_preds": box.numpy(),
           "spatial_features_2d": out["spatial_features_2d"], "spatial_features_stride": 8}
    if train:
        gt, gmask = tiny.two_stage_gt(W)
        jbd.update(gt_boxes=gt, gt_boxes_mask=gmask)

    @jax.jit
    def run(v, bd):
        o, inter = jhead.apply(v, bd, training=train, capture_intermediates=True,
                               mutable=["intermediates", "batch_stats"])
        keep = {k: o[k] for k in ("rois", "roi_labels", "batch_cls_preds", "iou_preds")}
        if train:
            keep["loss_rcnn"] = o["loss_rcnn"]
        return keep, inter["intermediates"]

    jout, inter = jax.tree_util.tree_map(np.asarray, run(head_vars, jbd))
    roi_head = cases.port_model(W, train=train).module_list[5]
    seen = {}
    hook = roi_head.shared_fc0.register_forward_hook(lambda m, a, o: seen.update(fc0=o))
    bd = {"batch_cls_preds": cls, "batch_box_preds": box,
          "spatial_features_2d": t(out["spatial_features_2d"]), "spatial_features_stride": 8}
    if train:
        bd.update(gt_boxes=t(gt), gt_boxes_mask=t(gmask))
    with torch.no_grad():
        got = roi_head(bd)
    hook.remove()
    np.testing.assert_array_equal(got["roi_labels"].numpy(), jout["roi_labels"])
    golden_close(got["rois"], jout["rois"], "rois")
    golden_close(seen["fc0"].numpy(), inter["shared_fc0"]["__call__"][0], f"{mode} shared_fc0")
    for k in ("iou_preds", "batch_cls_preds"):
        golden_close(got[k], jout[k], f"{mode} {k}")
    rect = got["batch_cls_preds"]
    assert float(rect.min()) >= 0 and float(rect.max()) <= 1
    if train:
        cases.close_scalar(got["loss_rcnn"], jout["loss_rcnn"], "loss_rcnn")
        assert float(jout["loss_rcnn"]) > 0


def test_post_processing_index_equal(eval_case):
    out = {k: t(eval_case["out"][k]) for k in cases.FORWARD}
    out["cls_preds_normalized"] = True
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


def test_train_loss_and_tb_terms(train_case):
    """The step's loss and tb terms; every ReLU input of the step lies at
    least 1e-5 from 0 (tiny.TWO_STAGE_TRAIN_BN_LIFT)."""
    assert train_case["margin"] > 1e-5
    out = train_case["out"]
    cases.close_scalar(out["loss"].detach(), train_case["loss"], "loss")
    assert set(out["tb_dict"]) == set(train_case["tb"]) == {
        "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss", "rcnn_iou_loss"}
    for k, v in train_case["tb"].items():
        cases.close_scalar(out["tb_dict"][k].detach(), v, k)
    assert out["roi_valid"].sum(1).tolist() == [16, 16]


def test_train_gradients(train_case):
    cases.check_gradients(train_case["model"], train_case["grads"])


def test_iou_loss_reaches_conv_box(train_case):
    """The IoU loss alone has a gradient on conv_box through the RoIs (the
    lattice's sample points and the IoU target, which is not detached)."""
    model = cases.port_model(W, train=True)
    out = model(_train_batch())
    w = model.module_list[4].conv_box.weight
    g = torch.autograd.grad(out["loss_rcnn"], w)[0]
    assert float(g.abs().max()) > 1e-3 * float(
        train_case["grads"]["module_list.4.conv_box.weight"].abs().max())


def test_train_batch_stats(train_case):
    cases.check_batch_stats(train_case["model"], train_case["stats"])


def test_second_step_from_the_jax_state(jcase, train_case):
    """A second step from the state the JAX step reached: its parameters
    moved by -1e-4 times the JAX gradients, its BN statistics after the
    step; loss, tb terms, gradients and statistics again."""
    state = tiny.two_stage_state(W, train=True)
    state.update({k: state[k] - 1e-4 * g for k, g in train_case["grads"].items()})
    state.update(train_case["stats"])
    loss, tb, stats, grads, _ = jax.tree_util.tree_map(
        np.asarray, jcase._train(to_flax_variables(state), cases.train_batch(W)))
    model = cases.port_model(W, train=True)
    model.load_state_dict(state, strict=True)
    out = model(_train_batch())
    out["loss"].backward()
    cases.close_scalar(out["loss"].detach(), loss, "loss")
    for k, v in tb.items():
        cases.close_scalar(out["tb_dict"][k].detach(), v, k)
    cases.check_gradients(model, from_flax_variables({"params": grads}))
    cases.check_batch_stats(model, from_flax_variables({"batch_stats": stats}))


def test_bilinear_gradient_matches_jax_at_edges_and_off_the_map():
    """bilinear_interpolate's value and its gradient on the map and on the
    sample coordinates against jax.grad of the JAX function, at points
    inside cells, on pixel edges (a weight at a bound: jnp.clip passes half
    the gradient there, which a RoI lattice on a pixel edge meets) and off
    the map (clamped corners: no gradient through the weights)."""
    rng = np.random.RandomState(3)
    bev = rng.randn(6, 7, 3).astype(np.float32)
    x = np.array([2.3, 3.0, 0.0, 5.0, -1.5, 8.7, 4.25, 1.0], np.float32)
    y = np.array([1.7, 2.0, 4.0, 0.0, 2.5, 3.5, -0.3, 6.2], np.float32)
    w = rng.randn(8, 3).astype(np.float32)

    def jf(b, xx, yy):
        return (jbilinear_interpolate(b, xx, yy) * w).sum()

    want = jax.value_and_grad(jf, argnums=(0, 1, 2))(jnp.asarray(bev), jnp.asarray(x),
                                                     jnp.asarray(y))
    tb, tx, ty = (t(a).requires_grad_(True) for a in (bev, x, y))
    got = (bilinear_interpolate(tb, tx, ty) * t(w)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want[0]), rtol=1e-6)
    for g, v, what in ((tb.grad, want[1][0], "map"), (tx.grad, want[1][1], "x"),
                       (ty.grad, want[1][2], "y")):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=what)


def test_full_width_flax_tree_loads_strictly():
    """Every flax leaf of second_iou.yaml's JAX init maps onto the port,
    strict: shared_fc0 takes the 7^3 lattice of the 512-channel BEV map."""
    variables, model, meta = cases.full_width_state(
        infer.ROOT / "tools/cfgs/kitti_models/second_iou.yaml")
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model.load_state_dict(state, strict=True)
    assert state["module_list.5.shared_fc0.weight"].shape == (256, 7 ** 3 * 512)
    assert state["module_list.5.iou_fc.fc1.weight"].shape == (256, 256)
    assert state["module_list.5.iou_out.weight"].shape == (1, 256)
    assert state["module_list.4.conv_cls.weight"].shape == (18, 512, 1, 1)
