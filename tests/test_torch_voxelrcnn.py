"""The port's Voxel R-CNN against the JAX package on the CPU.

Modules, each fed the JAX module's own input: MeanVFE (exact), the sparse
stem (8 probes and 12 index gather-GEMMs), the BEV backbone, the anchor
head, and VoxelRCNNHead (RoIs and labels exact, refined boxes and scores
through one K2 window query a pool layer). The RoI-grid pool alone: each
pool layer's window query (counts and nearest-k indices equal to the JAX
`voxel_query`'s), its SharedMLP's output on the filled slots and the pooled
lattice through `shared_fc0`, against the flax head's intermediates.
Whole: the tiny Voxel R-CNN's eval outputs and post-processed predictions,
the committed golden, one training step (loss, tb terms with foreground
RoIs, every gradient, conv_box's through the RoIs included, BN statistics
after it), a second step from the state the JAX step reached, and
voxel_rcnn_car.yaml's full-width flax tree loaded strictly. (chip_smoke.py
phase 49 holds the RCNN losses on RoIs made from the gt boxes on the card
against the CPU.)

Tolerances: outputs at the golden one (atol 1e-3 * max(1, max|want|), rtol
1e-3), labels, counts, query counts and indices, RoIs' labels and kept sets
exact; the training step's loss and tb terms 1e-4, gradients rtol 1e-3
above the rounding floor (atol 1e-4 * max(the tensor's largest |g|, 1e-2 *
the model's)), BN statistics 1e-5.

The state is tiny.two_stage_state("voxelrcnn"), for the training checks
with train=True (tiny.TWO_STAGE_TRAIN_BN_LIFT); the golden
tsm_det_pointcloud_tpu_torch/data/voxelrcnn_tiny_forward.npz is regenerated
with tests/torch_two_stage_cases.py's write_forward("voxelrcnn").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_two_stage_cases as cases
from tests.torch_two_stage_cases import golden_close, t
from tsm_det_pointcloud_tpu.models.backbones_3d.pfe.voxel_set_abstraction import (
    voxel_centers as jvoxel_centers,
)
from tsm_det_pointcloud_tpu.models.backbones_3d.spconv_backbone import (
    SparseTensor as JSparseTensor,
)
from tsm_det_pointcloud_tpu.models.roi_heads.pvrcnn_head import (
    roi_grid_points as jroi_grid_points,
)
from tsm_det_pointcloud_tpu.models.roi_heads.voxelrcnn_head import VoxelRCNNHead as JHead
from tsm_det_pointcloud_tpu.ops.voxel import voxel_query as jvoxel_query
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.pfe.voxel_set_abstraction import (
    voxel_centers,
)
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.spconv_backbone import SparseTensor
from tsm_det_pointcloud_tpu_torch.models.roi_heads.pvrcnn_head import roi_grid_points
from tsm_det_pointcloud_tpu_torch.ops import grouping, spconv

W = "voxelrcnn"
EVAL_KEYS = ("voxel_features", "voxel_coords", "voxel_mask", "encoded_spconv_tensor",
             "spatial_features", "spatial_features_2d", "cls_preds", "box_preds",
             "dir_cls_preds", "x_conv3", "x_conv4")
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


def _counted(monkeypatch, calls, module, name):
    orig = getattr(module, name)

    def counted(*a, **kw):
        calls[name] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, counted)


def _levels(out):
    return ({s: SparseTensor(*(t(a) for a in out[s]), *GRIDS[s]) for s in GRIDS},
            {s: GRIDS[s][1] for s in GRIDS})


def _proposals(out):
    """The anchor head's decoded boxes of the JAX forward's dense outputs
    (the port's decode, held against JAX's in tests/test_torch_pvrcnn.py)."""
    head = cases.port_model(W).module_list[4]
    with torch.no_grad():
        return head.generate_predicted_boxes(t(out["cls_preds"]), t(out["box_preds"]),
                                             t(out["dir_cls_preds"]))


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
        assert calls == {"probe": 8, "gather_matmul": 12, "query_group": 0}
        golden_close(got["encoded_spconv_tensor"], out["encoded_spconv_tensor"], "encoded")
        for src in GRIDS:
            st = got["multi_scale_3d_features"][src]
            assert (st.grid, st.stride) == GRIDS[src]
            np.testing.assert_array_equal(st.coords.numpy(), out[src][1], err_msg=src)
            golden_close(st.features, out[src][0], src)
        got = to_bev({"encoded_spconv_tensor": t(out["encoded_spconv_tensor"])})
        golden_close(got["spatial_features"], out["spatial_features"], "spatial_features")
        got = b2d({"spatial_features": t(out["spatial_features"])})
        golden_close(got["spatial_features_2d"], out["spatial_features_2d"], "sf2d")
        dense = head({"spatial_features_2d": t(out["spatial_features_2d"])})
        for k in ("cls_preds", "box_preds", "dir_cls_preds"):
            golden_close(dense[k], out[k], k)
        levels, strides = _levels(out)
        got = roi_head({"batch_cls_preds": dense["batch_cls_preds"],
                        "batch_box_preds": dense["batch_box_preds"],
                        "multi_scale_3d_features": levels, "multi_scale_3d_strides": strides})
    assert calls["query_group"] == 2
    np.testing.assert_array_equal(got["roi_labels"].numpy(), out["roi_labels"])
    for k in ("rois", "batch_cls_preds", "batch_box_preds"):
        golden_close(got[k], out[k], k)


def _jax_head(cfg):
    meta = tiny.VOXELRCNN_META
    return JHead(model_cfg=dict(cfg.ROI_HEAD), input_channels=128, num_class=1,
                 voxel_size=meta.voxel_size, point_cloud_range=meta.point_cloud_range)


def test_pool_layer_queries_against_jax_voxel_query(eval_case):
    """Each pool layer's window query on the eval RoIs' lattice (outside the
    grid too: a 3 x 3 x 3 lattice of a RoI at the range's edge): the counts
    and the filled slots' nearest-k indices equal the JAX voxel_query's, on
    the JAX lattice coords; the port's lattice coords equal the JAX head's.
    Some queries find nothing; at nsample 2 as well as the config's, some
    find more than nsample, so that the nearest-k choice is held too."""
    out = eval_case["out"]
    cfg, meta = tiny.two_stage_model(W)
    roi_head = cases.port_model(W).module_list[5]
    rois = out["rois"]
    jgrid = np.asarray(jroi_grid_points(jnp.asarray(rois), 3)).reshape(2, -1, 3)
    grid = roi_grid_points(t(rois), 3).reshape(2, -1, 3)
    golden_close(grid.numpy(), jgrid, "lattice")
    levels, strides = _levels(out)
    outside = saturated = 0
    for src, sc in cfg.ROI_HEAD.ROI_GRID_POOL.POOL_LAYERS.items():
        stride = strides[src]
        vs = np.asarray(meta.voxel_size) * stride
        jcoords = np.asarray(jnp.floor((jnp.asarray(jgrid) - jnp.asarray(
            meta.point_cloud_range[:3], jnp.float32)) / jnp.asarray(vs, jnp.float32)).astype(
                jnp.int32)[..., ::-1])
        pcoords = roi_head.lattice_coords(t(jgrid), stride).numpy()
        np.testing.assert_array_equal(pcoords, jcoords, err_msg=f"{src} lattice coords")
        outside += int((jcoords < 0).any(-1).sum() + (jcoords >= np.asarray(
            GRIDS[src][0])).any(-1).sum())
        feats, coords, valid = out[src]
        centers = jax.vmap(lambda c: jvoxel_centers(c, stride, meta.voxel_size,
                                                    meta.point_cloud_range))(coords)
        radius, qr = sc.POOL_RADIUS[0], tuple(sc.QUERY_RANGES[0])
        st = levels[src]
        pc = voxel_centers(st.coords, stride, meta.voxel_size, meta.point_cloud_range)
        golden_close(pc.numpy(), np.asarray(centers), f"{src} centres")
        # the config's NSAMPLE, and 2, which more queries overfill
        for ns in (sc.NSAMPLE[0], 2):
            jidx, jcnt = jax.vmap(lambda q, qc, c, cc, v: jvoxel_query(
                q, qc, c, cc, v, radius=radius, nsample=ns, query_range=qr))(
                    jgrid, jcoords, centers, coords, valid)
            jidx, jcnt = np.asarray(jidx), np.asarray(jcnt)
            (idx, cnt, _), = grouping.query_group(pc, st.valid, t(jgrid),
                                                  [(0.0, radius, ns, qr)], src_coords=st.coords,
                                                  q_coords=t(jcoords))
            np.testing.assert_array_equal(cnt.numpy(), jcnt, err_msg=f"{src} counts")
            filled = np.arange(ns)[None, None, :] < np.minimum(jcnt, ns)[..., None]
            np.testing.assert_array_equal(np.where(filled, idx.numpy(), -1),
                                          np.where(filled, jidx, -1),
                                          err_msg=f"{src} indices, nsample {ns}")
            assert (jcnt > 0).any() and (jcnt == 0).any(), src
            saturated += int((jcnt > ns).sum())
    assert outside > 0 and saturated > 0


def test_roi_grid_pool_against_flax_intermediates(eval_case):
    """The RoI-grid pool on the JAX forward's sparse levels and the dense
    head's decoded boxes: each pool layer's SharedMLP output on the filled
    slots and the pooled lattice through `shared_fc0` against the flax
    head's intermediates, and the head's outputs (train mode, the pool's
    batch statistics included, is held by the training step's gradients and
    BN statistics)."""
    out = eval_case["out"]
    cfg, _ = tiny.two_stage_model(W)
    cls, box = _proposals(out)
    head_vars = cases.sub_variables(to_flax_variables(tiny.two_stage_state(W)),
                                    ("module_list_5",))
    jhead = _jax_head(cfg)
    jbd = {"batch_cls_preds": cls.numpy(), "batch_box_preds": box.numpy(),
           "multi_scale_3d_features": {s: JSparseTensor(*out[s], *GRIDS[s]) for s in GRIDS},
           "multi_scale_3d_strides": {s: GRIDS[s][1] for s in GRIDS}}

    @jax.jit
    def run(v, bd):
        o, inter = jhead.apply(v, bd, training=False, capture_intermediates=True,
                               mutable=["intermediates"])
        keep = {k: o[k] for k in ("rois", "roi_labels", "batch_cls_preds", "batch_box_preds")}
        return keep, inter["intermediates"]

    jout, inter = jax.tree_util.tree_map(np.asarray, run(head_vars, jbd))
    roi_head = cases.port_model(W).module_list[5]
    seen = {}
    hooks = [getattr(roi_head, n).register_forward_hook(
        lambda m, a, o, n=n: seen.__setitem__(n, (a, o)))
        for n in ("pool_x_conv3_0", "pool_x_conv4_0", "shared_fc0")]
    levels, strides = _levels(out)
    bd = {"batch_cls_preds": cls, "batch_box_preds": box, "multi_scale_3d_features": levels,
          "multi_scale_3d_strides": strides}
    with torch.no_grad():
        got = roi_head(bd)
    for h in hooks:
        h.remove()
    np.testing.assert_array_equal(got["roi_labels"].numpy(), jout["roi_labels"])
    golden_close(got["rois"], jout["rois"], "rois")
    for n in ("pool_x_conv3_0", "pool_x_conv4_0"):
        (x, mask), h = seen[n]
        want = inter[n]["__call__"][0]
        m = mask.numpy()
        assert m.any() and (~m).any(), n
        golden_close(h.numpy()[m], want[m], n)
    golden_close(seen["shared_fc0"][1].numpy(), inter["shared_fc0"]["__call__"][0],
                 "shared_fc0")
    for k in ("batch_cls_preds", "batch_box_preds"):
        golden_close(got[k], jout[k], k)


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


def test_train_loss_and_tb_terms(train_case):
    """The step's loss and tb terms, with foreground RoIs (IoU 0.8 and 0.6 in
    scan 0, 0.865 in scan 1) among the sampled ones; every ReLU input of the
    step lies at least 1e-5 from 0 (tiny.TWO_STAGE_TRAIN_BN_LIFT)."""
    assert train_case["margin"] > 1e-5
    out = train_case["out"]
    cases.close_scalar(out["loss"].detach(), train_case["loss"], "loss")
    assert set(out["tb_dict"]) == set(train_case["tb"]) == {
        "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss", "rcnn_cls_loss",
        "rcnn_reg_loss", "rcnn_corner_loss"}
    for k, v in train_case["tb"].items():
        cases.close_scalar(out["tb_dict"][k].detach(), v, k)
    tg = out["roi_targets"]
    assert tg["sampled"].sum(1).tolist() == [8, 8]
    assert (tg["fg"] & tg["sampled"]).sum(1).tolist() == [2, 1]
    assert float(train_case["tb"]["rcnn_reg_loss"]) > 0


def test_train_gradients(train_case):
    cases.check_gradients(train_case["model"], train_case["grads"])


def test_rcnn_loss_reaches_conv_box(train_case):
    """The RCNN loss alone has a gradient on conv_box through the RoIs (the
    re-centred lattice and the regression targets)."""
    model = cases.port_model(W, train=True)
    out = model(_train_batch())
    w = model.module_list[4].conv_box.weight
    g = torch.autograd.grad(out["loss_rcnn"], w)[0]
    assert float(g.abs().max()) > 1e-2 * float(
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


def test_full_width_flax_tree_loads_strictly():
    """Every flax leaf of voxel_rcnn_car.yaml's JAX init (one class) maps onto
    the port, strict, at the published head widths."""
    variables, model, meta = cases.full_width_state(
        infer.ROOT / "tools/cfgs/kitti_models/voxel_rcnn_car.yaml")
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model.load_state_dict(state, strict=True)
    assert meta.class_names == ("Car",)
    for src, c in (("x_conv2", 32), ("x_conv3", 64), ("x_conv4", 64)):
        assert state[f"module_list.5.pool_{src}_0.fc0.weight"].shape == (32, 3 + c)
    assert state["module_list.5.shared_fc0.weight"].shape == (256, 6 ** 3 * 96)
    assert state["module_list.5.cls_fc.fc1.weight"].shape == (256, 256)
    assert state["module_list.5.reg_out.weight"].shape == (7, 256)
    assert state["module_list.4.conv_cls.weight"].shape == (2, 256, 1, 1)
    assert state["module_list.3.deblock1.weight"].shape == (128, 128, 2, 2)
