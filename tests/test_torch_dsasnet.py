"""The port's DSASNet and its SparsePointBackbone against the JAX package on
the CPU, and the parts the hybrids share.

Helpers: `split_select` (training, with and without d-fps of the top
partition, and eval; scores with ties), `subset_fps` and
`subset_fps_weighted` (rows with all-zero weights, partly masked rows)
index-equal; `interp_bev`, `interp_bev3d`, `nearest_cell`,
`lookup_sp_at_points` and `scale_centroids` within 1e-6 (hits and counts
exact), with points on and off the grid's edges; `ClassStatistics` before,
at and after its start iteration. SparsePointBackbone on the synthetic
pyramid of tests/test_experimental_variants.py (`ModuleCase`, one jit):
eval and training outputs and key points, the statistics after a step, and
f64 gradients. The tiny DSASNet on it (`DetectorCase`, one jit): eval
outputs and post-processing, a training step (loss and tb terms, every
gradient: none where the JAX package's is zero, which is the hybrid's fg,
cls and statistic-tag layers and the trunk's conv_out), and the committed
golden `data/dsasnet_tiny_forward.npz`. dsasnet.yaml at full width builds
and the JAX model's flax tree loads strictly. Every detector NAME of the
JAX registry builds; the RoI-head and trunk aliases are their modules.

Tolerances as tests/test_torch_point_bev_hybrids.py's. The golden is
regenerated with
    python -c "from tests.test_torch_dsasnet import write_dsasnet_golden; write_dsasnet_golden()"
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_experimental_variants import make_sparse
from tests.torch_hybrid_cases import (
    PCR, POOL, PRED, PYRAMID, VOXEL, DetectorCase, ModuleCase, check_grads, check_stats, close,
    port_batch,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_two_stage_cases import close_scalar, full_width_state
from tsm_det_pointcloud_tpu.models.backbones_2d import point_bev_hybrids as jh
from tsm_det_pointcloud_tpu.models.detectors import __all__ as jax_detectors
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models import _PORTED, build_network
from tsm_det_pointcloud_tpu_torch.models.backbones_2d import point_bev_hybrids as ph
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.spconv_backbone import (
    DSASNetVoxelBackBone8x, SparseTensor, VoxelBackBone8x,
)
from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as port_detectors
from tsm_det_pointcloud_tpu_torch.models.roi_heads.pvrcnn_head import PVRCNNHead

CFG = "tools/cfgs/kitti_models/dsasnet.yaml"
SPB_CFG = {"FG_CORNER_POINTS": [128, 64], "PTS_NUM_SAMPLE": [48, 16],
           "MAX_TRANSLATION_RANGE": [3.0, 3.0, 2.0], "N_CLS": 3, "NUM_POINT_FEATURES": 32,
           "SP_SOURCE": "x_conv4", "POINT_GRID_POOL": POOL, "STAT_START_ITER": 0}
SPB_KEYS = ("point_coords", "point_valid", "vote_coords", "fg_preds", "point_center_preds",
            "point_cls_preds", "features_for_reg", "vote_cls_aware", "pts_depth",
            "score_density", "scores_fg")
SPB_LOSS = ("point_cls_preds", "features_for_reg", "point_center_preds", "vote_cls_aware",
            "fg_preds")
_CACHE = {}


def t(a):
    return torch.from_numpy(np.array(a))


def _spb_case():
    if "spb" not in _CACHE:
        case = ModuleCase(jh.SparsePointBackbone(model_cfg=SPB_CFG, input_channels=32,
                                                 voxel_size=VOXEL, point_cloud_range=PCR),
                          ph.SparsePointBackbone(SPB_CFG, VOXEL, PCR, PYRAMID),
                          SPB_KEYS, SPB_LOSS)
        _CACHE["spb"] = (case, case.run())
    return _CACHE["spb"]


def _det_case():
    if "det" not in _CACHE:
        case = DetectorCase("spb")
        _CACHE["det"] = (case, case.run())
    return _CACHE["det"]


def write_dsasnet_golden():
    """The JAX eval outputs and predictions of the tiny DSASNet on
    SparsePointBackbone (`tiny.dsasnet_state("spb")`)."""
    want = DetectorCase("spb").run()
    np.savez_compressed(tiny.DSASNET_FORWARD_PATH,
                        **{k: want["out"][k] for k in ("batch_cls_preds", "batch_box_preds",
                                                       "rois")},
                        **{k: want["pred"][k] for k in PRED})


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _scored_points(seed=0, b=2, n=64):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(0, 10, (b, n, 3)).astype(np.float32)
    score = np.round(rng.randn(b, n), 1).astype(np.float32)    # ties
    valid = rng.uniform(size=(b, n)) > 0.2
    return xyz, score, valid


@pytest.mark.parametrize("training,fps_top", [(True, False), (True, True), (False, False)])
def test_split_select(training, fps_top):
    xyz, score, valid = _scored_points()
    want = np.asarray(jh.split_select(jnp.asarray(xyz), jnp.asarray(score), jnp.asarray(valid),
                                      8, 12, training, fps_top=fps_top, n_eval=20))
    got = ph.split_select(t(xyz), t(score), t(valid), 8, 12, training, fps_top=fps_top,
                          n_eval=20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_subset_fps_and_zero_weights():
    """d-fps and s-fps over a masked subset: a row with all-zero weights
    (every later pick a tie: the lowest index, as the JAX package's), a row
    with half its weights zero, a row masked down to 5 points under 12
    picks."""
    xyz, _, _ = _scored_points(1, b=3)
    rng = np.random.RandomState(2)
    mask = rng.uniform(size=(3, 64)) > 0.3
    mask[2] = False
    mask[2, [3, 9, 20, 41, 60]] = True
    w = rng.uniform(0.1, 1.0, (3, 64)).astype(np.float32)
    w[0] = 0.0
    w[1, ::2] = 0.0
    want = np.asarray(jh.subset_fps(jnp.asarray(xyz), jnp.asarray(mask), 12))
    np.testing.assert_array_equal(ph.subset_fps(t(xyz), t(mask), 12).numpy(), want)
    want_w = np.asarray(jh.subset_fps_weighted(jnp.asarray(xyz), jnp.asarray(w),
                                               jnp.asarray(mask), 12))
    got_w = ph.subset_fps_weighted(t(xyz), t(w), t(mask), 12).numpy()
    np.testing.assert_array_equal(got_w, want_w)
    assert mask[np.arange(3)[:, None], got_w[:, :5]].all()


def _edge_pixels(rng, n, hi):
    """Pixel coordinates in [-1.5, hi + 1.5], some exactly on cell edges and
    on the last cells."""
    p = rng.uniform(-1.5, hi + 1.5, n).astype(np.float32)
    p[:6] = [0.0, hi - 2, hi - 1, hi - 1.5, hi, -1.0]
    return p


def test_interpolation_helpers():
    rng = np.random.RandomState(3)
    vol = rng.randn(2, 5, 6, 4, 3).astype(np.float32)
    px = np.stack([_edge_pixels(rng, 40, 6) for _ in range(2)])
    py = np.stack([_edge_pixels(rng, 40, 5) for _ in range(2)])
    pz = np.stack([_edge_pixels(rng, 40, 4) for _ in range(2)])
    jv, jx, jy, jz = map(jnp.asarray, (vol, px, py, pz))
    np.testing.assert_allclose(ph.interp_bev3d(t(vol), t(px), t(py), t(pz)).numpy(),
                               np.asarray(jh.interp_bev3d(jv, jx, jy, jz)), rtol=1e-6, atol=1e-6)
    feat, offs = ph.nearest_cell(t(vol), t(px), t(py), t(pz))
    jfeat, joffs = jh.nearest_cell(jv, jx, jy, jz)
    np.testing.assert_array_equal(feat.numpy(), np.asarray(jfeat))
    np.testing.assert_allclose(offs.numpy(), np.asarray(joffs), rtol=1e-6, atol=1e-6)
    bev = vol.reshape(2, 5, 6, 12)
    np.testing.assert_allclose(ph.interp_bev(t(bev), t(px), t(py)).numpy(),
                               np.asarray(jh.interp_bev(jnp.asarray(bev), jx, jy)),
                               rtol=1e-6, atol=1e-6)


def _sparse_and_points(seed=4):
    rng = np.random.default_rng(seed)
    st = make_sparse(rng, 2, 48, 16, (5, 4, 4), 8)
    pts = np.concatenate([rng.uniform(-2, 18, (2, 80, 1)), rng.uniform(-10, 10, (2, 80, 1)),
                          rng.uniform(-4, 2, (2, 80, 1))], -1).astype(np.float32)
    pts[:, :4] = [[0.0, -8.0, -3.0], [4.0, 0.0, -1.0], [16.0, 8.0, 1.0], [15.999, 7.999, 0.999]]
    valid = rng.uniform(size=(2, 80)) > 0.15
    port = SparseTensor(t(st.features), t(st.coords), t(st.valid), st.grid, st.stride)
    return st, port, pts, valid


def test_lookup_sp_at_points():
    """A point outside the grid clamps onto its border voxel; on an edge it
    belongs to the voxel above."""
    st, pst, pts, valid = _sparse_and_points()
    want = jh.lookup_sp_at_points(st, 8, jnp.asarray(pts), jnp.asarray(valid), VOXEL, PCR)
    got = ph.lookup_sp_at_points(pst, 8, t(pts), t(valid), VOXEL, PCR)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any() and not got[2].all()
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_scale_centroids():
    """Points outside the grid are dropped; each voxel's centroid lands on
    its row of the sparse tensor."""
    st, pst, pts, valid = _sparse_and_points(5)
    points = np.concatenate([pts, np.ones(pts.shape[:2] + (1,), np.float32)], -1)
    want = jh.scale_centroids(jnp.asarray(points), jnp.asarray(valid), st, 8, VOXEL, PCR)
    got = ph.scale_centroids(t(points), t(valid), pst, 8, VOXEL, PCR)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,decay_only", [("maxmean", True), ("mean", False)])
def test_class_statistics(mode, decay_only):
    """Before STAT_START_ITER: zero rows and no update; at it: replaced; after
    it: the momentum update; a class with no weighted row keeps its row."""
    rng = np.random.RandomState(6)
    feats = rng.randn(2, 20, 5).astype(np.float32)
    cls = rng.randint(0, 3, (2, 20)).astype(np.int32)
    cls[cls == 2] = 1                                         # class 2: no row
    w = (rng.uniform(size=(2, 20)) > 0.3).astype(np.float32)
    init = rng.randn(3, 5).astype(np.float32)
    jmod = jh.ClassStatistics(num_class=3, feat_dim=5, start_iter=2, momentum=0.9, mode=mode,
                              decay_only=decay_only)
    pmod = ph.ClassStatistics(3, 5, 2, momentum=0.9, mode=mode, decay_only=decay_only).train()
    pmod.object_statistic_features.copy_(t(init))
    variables = {"statistics": {"object_statistic_features": jnp.asarray(init)}}
    for it in (1, 2, 3):
        (jrow, jrows), mut = jmod.apply(variables, jnp.asarray(feats), jnp.asarray(cls),
                                        jnp.asarray(w), it, training=True,
                                        mutable=["statistics"])
        variables = mut
        prow, prows = pmod(t(feats), t(cls), t(w), it)
        np.testing.assert_allclose(prows.numpy(), np.asarray(jrows), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pmod.object_statistic_features.numpy(),
                                   np.asarray(mut["statistics"]["object_statistic_features"]),
                                   rtol=1e-6, atol=1e-6)
    assert not prows.numpy()[:2].__eq__(init[:2]).all()
    np.testing.assert_array_equal(prows.numpy()[2], init[2])


# ---------------------------------------------------------------------------
# SparsePointBackbone and the tiny DSASNet
# ---------------------------------------------------------------------------

def test_sparse_point_backbone_eval_and_training():
    case, want = _spb_case()
    ev, tr = case.port_run()
    for got, ref, what in ((ev, want["eval"], "eval"), (tr, want["train"], "train")):
        for k, w in ref.items():
            if k in ("point_coords", "point_valid"):
                np.testing.assert_array_equal(got[k].numpy(), w, err_msg=f"{what} {k}")
            else:
                close(got[k], w, f"spb {what} {k}")
    delta = (tr["vote_coords"] - tr["point_coords"]).abs().numpy()
    assert (delta <= np.array([3.0, 3.0, 2.0]) + 1e-5).all()
    check_stats(case.port.state_dict(), want["stats"], "spb")
    key = "object_statistics.object_statistic_features"
    assert not np.allclose(want["stats"][key].numpy(), case.state[key].numpy())


def test_sparse_point_backbone_gradients():
    case, want = _spb_case()
    idle = check_grads(case.port_grads().named_parameters(), want["grads"], "spb")
    assert not idle


def test_tiny_dsasnet_eval():
    case, want = _det_case()
    model = case.port()
    out = model(port_batch())
    pred, _ = model.post_processing(out)
    for k, w in want["out"].items():
        if k in ("point_coords", "point_valid", "roi_labels"):
            np.testing.assert_array_equal(out[k].numpy(), w, err_msg=k)
        else:
            close(out[k], w, k)
    for k in ("pred_labels", "count"):
        np.testing.assert_array_equal(pred[k].numpy(), want["pred"][k], err_msg=k)
    for k in ("pred_boxes", "pred_scores"):
        close(pred[k], want["pred"][k], k)
    assert want["pred"]["count"].min() > 0


def test_tiny_dsasnet_training_step():
    """Loss, tb terms, gradients and statistics; no loss reaches the
    hybrid's fg, cls and statistic-tag layers (the point head overwrites its
    `point_cls_preds`) nor the trunk's conv_out (no module reads the BEV
    map): the JAX package's gradients there are zero."""
    case, want = _det_case()
    model = case.port(train=True)
    out = model(port_batch(train=True))
    close_scalar(out["loss"].detach(), want["loss"], "loss")
    assert set(out["tb_dict"]) == set(want["tb"]) >= {"point_loss", "rcnn_cls_loss"}
    for k, v in out["tb_dict"].items():
        close_scalar(torch.as_tensor(v).detach(), want["tb"][k], k)
    out["loss"].backward()
    idle = check_grads(model.named_parameters(), want["grads"], "dsasnet")
    layers = {n.split(".")[2] for n in idle}
    assert layers == {"conv_out", "features_fg", "fg_hidden", "fg_pred_out", "temp_features",
                      "features_cls", "cls_block0", "cls_block1", "cls_block2", "cls_out0",
                      "cls_out1", "cls_out2"}
    check_stats(model.state_dict(), want["stats"], "dsasnet")
    assert model.unused_parameters


def test_committed_golden():
    """The committed golden is the JAX package's, and the port reproduces it."""
    _, want = _det_case()
    with np.load(tiny.DSASNET_FORWARD_PATH) as z:
        golden = {k: z[k] for k in z.files}
    ref = {**{k: want["out"][k] for k in ("batch_cls_preds", "batch_box_preds", "rois")},
           **want["pred"]}
    assert set(golden) == set(ref)
    for k, w in ref.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    model = _det_case()[0].port()
    out, pred = infer.detect(model, t(tiny.second_points(2, 256)), torch.ones(2, 256, dtype=torch.bool))
    for k in ("pred_labels", "count"):
        np.testing.assert_array_equal(pred[k].numpy(), golden[k], err_msg=k)
    for k in ("batch_cls_preds", "batch_box_preds", "rois", "pred_boxes", "pred_scores"):
        close((out if k in out else pred)[k], golden[k], k)


def test_full_width_flax_tree_loads_strictly():
    """dsasnet.yaml at its widths: every leaf of the JAX model's flax tree
    (eval_shape, zeros: params, batch_stats and the hybrid's statistics)
    converts to the port model's state dict and loads strictly, and the
    port's state round-trips to the same tree."""
    variables, model, _ = full_width_state(CFG)
    state = from_flax_variables(variables)
    model.load_state_dict(state, strict=True)
    ported = to_flax_variables(model.state_dict())
    flat = lambda tree: {jax.tree_util.keystr(p): np.shape(v)
                         for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(ported) == flat(variables)
    assert variables["statistics"]["module_list_3"]["object_statistics"][
        "object_statistic_features"].shape == (3, 128)
    names = [type(m).__name__ for m in model.module_list]
    assert names == ["MeanVFE", "DSASNetVoxelBackBone8x", "HeightCompression",
                     "SparsePointBackbone", "DSASNetHead", "DSASNetRoIHead"]
    assert model.module_list[4].cls_fc.fc0.in_features == 128
    assert model.module_list[5].pool_mlp0.fc0.in_features == 131


def test_every_jax_detector_builds():
    """Every detector NAME of the JAX registry is a detector of the port's,
    with its sections; a NAME the JAX registry lacks raises."""
    assert set(jax_detectors) <= set(port_detectors) and set(jax_detectors) <= set(_PORTED)
    cfg = tiny.dsasnet_model_cfg("spb")
    for name in ("DSASNet", "PVSSDA", "Detector3DTemplate"):
        cfg["NAME"] = name
        model = build_network(cfg, 1, tiny.DSASNET_META, device="cpu")
        assert type(model).__name__ == name
    cfg["NAME"] = "NoSuchDetector"
    with pytest.raises(NotImplementedError, match="NoSuchDetector"):
        build_network(cfg, 1, tiny.DSASNET_META, device="cpu")


@pytest.mark.parametrize("name", ["EPointRoIHead", "EPointRoIHeadV2", "PVRCNNHead"])
def test_roi_head_and_trunk_aliases(name):
    """The RoI-head aliases and DSASNetVoxelBackBone8x are PVRCNNHead and
    VoxelBackBone8x under other names: the tiny DSASNet builds with each,
    with the same parameters and the same forward; a trunk or head NAME the
    port lacks raises."""
    cfg = tiny.dsasnet_model_cfg("spb")
    cfg.ROI_HEAD.NAME = name
    cfg.BACKBONE_3D.NAME = "VoxelBackBone8x" if name == "PVRCNNHead" else "DSASNetVoxelBackBone8x"
    model = build_network(cfg, 1, tiny.DSASNET_META, device="cpu")
    assert type(model.module_list[5]).__name__ == name
    assert isinstance(model.module_list[5], PVRCNNHead)
    assert isinstance(model.module_list[1], VoxelBackBone8x)
    assert issubclass(DSASNetVoxelBackBone8x, VoxelBackBone8x)
    model.load_state_dict(tiny.dsasnet_state("spb"), strict=True)
    pts = t(tiny.second_points(2, 256))
    mask = torch.ones(2, 256, dtype=torch.bool)
    out, _ = infer.detect(model, pts, mask)
    want, _ = infer.detect(_det_case()[0].port(), pts, mask)
    assert torch.equal(out["batch_box_preds"], want["batch_box_preds"])
    cfg.ROI_HEAD.NAME = "NoSuchRoIHead"
    with pytest.raises(NotImplementedError, match="NoSuchRoIHead"):
        build_network(cfg, 1, tiny.DSASNET_META, device="cpu")


def test_build_trainer_refuses_set_cfgs_on_a_loaded_config():
    """`--set` overrides apply to a config file; with a loaded config (a
    variant's, `infer.variant_cfg`) `build_trainer` refuses them instead of
    dropping them."""
    from tsm_det_pointcloud_tpu_torch.train import build_trainer

    with pytest.raises(ValueError, match="loaded config"):
        build_trainer(infer.variant_cfg("BEVPoint"), "cpu",
                      set_cfgs=["OPTIMIZATION.LR", "0.1"])
