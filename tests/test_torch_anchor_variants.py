"""The JAX registry's module variants in the port, against the JAX package
on the CPU (the JAX references: tests/test_anchor_extras.py and
tests/test_experimental_variants.py::test_spvfe_path, slow-marked there).

  * the VFEs DynamicMeanVFE, MeanDensityVFE, SPVFE, VPCVFE (the tiny
    SECOND's geometry) and DynamicPillarVFE (the tiny PointPillars'), in
    eval and in training (the BN statistics after the forward);
  * AnchorHeadMulti (with its shared conv) on a random BEV map: every
    prediction and decoded box, the loss, its tb terms and the gradients;
  * AnchorHeadSingleCls over a random stride-8 sparse level and
    AnchorHeadMultiCls (two class groups) on a random BEV map: cls_preds,
    the cls-only loss and its gradients; the grouped head's class-order
    check;
  * `atss_assign_targets`, `softmax_focal_loss` and the legacy decoders
    PreviousResidualDecoder / PreviousResidualRoIDecoder;
  * every variant of `tiny.VARIANTS` builds on its tiny topology and takes a
    training step; SpaceVoxelBackBone8x is VoxelBackBone8x's trunk.

Tolerances: voxel coordinates, masks, target labels and the grouped head's
zero columns exact; features, predictions and boxes atol 1e-3 * max(1,
max|want|), rtol 1e-3 (f32 sums in another order); losses atol 1e-4 *
max(1, |want|), rtol 1e-4; gradients rtol 1e-3, atol 1e-4 * max|want| of
the tensor; BN statistics and focal / decoder values rtol 1e-5, atol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.models.backbones_3d import vfe as jvfe
from tsm_det_pointcloud_tpu.models.backbones_3d.spconv_backbone import (
    SparseTensor as JSparseTensor,
)
from tsm_det_pointcloud_tpu.models.dense_heads import anchor_head as janchor
from tsm_det_pointcloud_tpu.ops import box_coder_utils as jcoder
from tsm_det_pointcloud_tpu.ops import loss_utils as jloss
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.backbones_3d import vfe
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.spconv_backbone import (
    SpaceVoxelBackBone8x,
    SparseTensor,
    VoxelBackBone8x,
)
from tsm_det_pointcloud_tpu_torch.models.dense_heads import anchor_head
from tsm_det_pointcloud_tpu_torch.ops import box_coder_utils, loss_utils


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=1e-3, err_msg=what)


def _close_scalar(got, want, what):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-4 * max(1.0, abs(float(want))), err_msg=what)


def _random_like(init, seed):
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*a.shape) / np.sqrt(int(np.prod(a.shape[:-1])))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.randn(*a.shape) * 0.2).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(init))


def _init_shapes(module, batch, training):
    """The shapes of a flax module's variables (its init traced, not run)."""
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), batch, training=training))


def _grads_close(model, jgrads):
    want = from_flax_variables({"params": jgrads})
    assert {n for n, _ in model.named_parameters()} == set(want)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-6), err_msg=name)


# ---------------------------------------------------------------------------
# VFEs
# ---------------------------------------------------------------------------

VFES = {"DynamicMeanVFE": {}, "MeanDensityVFE": {}, "SPVFE": {"NUM_FILTERS": [16, 8]},
        "VPCVFE": {"NUM_FILTERS": [16]},
        "DynamicPillarVFE": {"NUM_FILTERS": [16], "USE_NORM": True, "WITH_DISTANCE": False,
                             "USE_ABSLOTE_XYZ": True}}


def _vfe_geom(name):
    meta = tiny.POINTPILLAR_META if name in ("DynamicPillarVFE", "VPCVFE") else tiny.SECOND_META
    return dict(num_point_features=4, voxel_size=meta.voxel_size,
                point_cloud_range=meta.point_cloud_range, max_voxels=meta.max_voxels,
                max_points_per_voxel=meta.max_points_per_voxel)


def _vfe_points():
    pts = tiny.second_points(2)
    return pts, np.random.RandomState(1).uniform(size=pts.shape[:2]) > 0.1


@functools.lru_cache(maxsize=None)
def _jax_vfe(name):
    """A JAX VFE's random weights and its eval and training outputs (one jit
    for both)."""
    pts, mask = _vfe_points()
    batch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)}
    jm = getattr(jvfe, name)(model_cfg={"NAME": name, **VFES[name]}, **_vfe_geom(name))
    v = _random_like(jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b), batch), 2)
    # a VFE writes its outputs into the batch dict it is given: one copy each
    ev, tr = jax.jit(lambda v_, b: (jm.apply(v_, dict(b), False),
                                    jm.apply(v_, dict(b), True, mutable=["batch_stats"])))(
        v, batch)
    return v, ev, tr


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("name", sorted(VFES))
def test_vfe_variant_against_jax(name, training):
    geom = _vfe_geom(name)
    cfg = {"NAME": name, **VFES[name]}
    pts, mask = _vfe_points()
    v, jev, (jtr, mutated) = _jax_vfe(name)
    jout = jtr if training else jev
    port = getattr(vfe, name)(cfg, **geom)
    port.load_state_dict(from_flax_variables(v), strict=True)
    port.train(training)
    with torch.no_grad():
        out = port({"points": _t(pts), "points_mask": _t(mask)})
    assert port.get_output_feature_dim() == out["voxel_features"].shape[-1]
    for k in ("voxel_coords", "voxel_mask"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
    _close(out["voxel_features"], jout["voxel_features"], "voxel_features")
    if training and v.get("batch_stats"):
        want = from_flax_variables({"batch_stats": mutated["batch_stats"]})
        state = port.state_dict()
        for k, w in want.items():
            np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# dense heads
# ---------------------------------------------------------------------------

def _head_batch(channels, H=16, W=16, seed=1):
    gt, mask = tiny.second_gt(2)
    x = np.random.RandomState(seed).randn(2, H, W, channels).astype(np.float32)
    return {"spatial_features_2d": x, "gt_boxes": gt, "gt_boxes_mask": mask, "batch_size": 2}


def _jax_head_step(head, v, batch):
    """The JAX head's training forward, loss, tb terms and gradients."""
    def loss_fn(params):
        out = head.apply(dict(v, params=params), batch, training=True)
        loss, tb = head.apply(dict(v, params=params), out, method=lambda m, b: m.loss(b))
        return loss, (tb, out)

    (loss, (tb, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return jax.tree_util.tree_map(np.asarray, (loss, tb, out, grads))


def _port_head_step(head, batch):
    head.train()
    out = head({k: (_t(a) if isinstance(a, np.ndarray) else a) for k, a in batch.items()})
    loss, tb = head.loss(out)
    loss.backward()
    return loss, tb, out


def _head_args(cfg, channels):
    meta = tiny.POINTPILLAR_META
    return dict(model_cfg=cfg, input_channels=channels, num_class=len(meta.class_names),
                class_names=meta.class_names, grid_size=meta.grid_size,
                point_cloud_range=meta.point_cloud_range)


def test_anchor_head_multi_against_jax():
    """AnchorHeadMulti with a 16-wide shared conv: eval predictions and
    decoded boxes, then the training loss, tb terms and gradients."""
    cfg, _ = tiny.variant_model("AnchorHeadMulti")
    cfg = dict(cfg.DENSE_HEAD)
    batch = _head_batch(32)
    jhead = janchor.AnchorHeadMulti(**_head_args(cfg, 32))
    v = _random_like(_init_shapes(jhead, batch, False), 3)
    jev = jax.jit(lambda v_, b: jhead.apply(v_, b, training=False))(v, batch)
    port = anchor_head.AnchorHeadMulti(*_head_args(cfg, 32).values())
    port.load_state_dict(from_flax_variables(v), strict=True)
    with torch.no_grad():
        ev = port.eval()({k: _t(a) if isinstance(a, np.ndarray) else a for k, a in batch.items()})
    for k in ("spatial_features_2d", "cls_preds", "box_preds", "dir_cls_preds",
              "batch_cls_preds", "batch_box_preds"):
        _close(ev[k], jev[k], k)
    loss, tb, out, grads = _jax_head_step(jhead, v, batch)
    ploss, ptb, _ = _port_head_step(port, batch)
    _close_scalar(ploss, loss, "loss")
    assert set(ptb) == set(tb)
    for k in tb:
        _close_scalar(ptb[k], tb[k], k)
    _grads_close(port, grads)


def _sparse_level(B=2, V=64, C=16, grid=(2, 8, 8), seed=0):
    """A random stride-8 level: V rows a scan at distinct cells, some
    invalid, as both packages' SparseTensor."""
    rng = np.random.RandomState(seed)
    cells = np.stack([rng.choice(int(np.prod(grid)), V, replace=False) for _ in range(B)])
    coords = np.stack(np.unravel_index(cells, grid), -1).astype(np.int32)
    valid = rng.uniform(size=(B, V)) > 0.2
    coords[~valid] = -1
    feats = rng.randn(B, V, C).astype(np.float32)
    return (JSparseTensor(features=jnp.asarray(feats), coords=jnp.asarray(coords),
                          valid=jnp.asarray(valid), grid=grid, stride=8),
            SparseTensor(_t(feats), _t(coords), _t(valid), grid, 8))


def _cls_head_cfg():
    cfg, _ = tiny.variant_model("AnchorHeadMultiCls")
    cfg = dict(cfg.DENSE_HEAD)
    cfg.pop("SHARED_CONV_NUM_FILTER")
    cfg.pop("RPN_HEAD_CFGS")
    return cfg


def test_anchor_head_single_cls_against_jax():
    """AnchorHeadSingleCls over x_conv4 (two z cells of 16 channels, an 8 x 8
    map at stride 8 of the 64 x 64 grid): cls_preds, the cls-only loss and
    its gradients."""
    cfg = _cls_head_cfg()
    for a in cfg["ANCHOR_GENERATOR_CONFIG"]:
        a["feature_map_stride"] = 8
    jst, st = _sparse_level()
    gt, mask = tiny.variant_gt(tiny.variant_model("AnchorHeadMultiCls")[1])
    args = dict(model_cfg=cfg, input_channels=32, num_class=2,
                class_names=("Car", "Pedestrian"), grid_size=(64, 64, 2),
                point_cloud_range=(0.0, -32.0, -3.0, 64.0, 32.0, 1.0))
    jhead = janchor.AnchorHeadSingleCls(**args)
    jb = {"multi_scale_3d_features": {"x_conv4": jst}, "gt_boxes": jnp.asarray(gt),
          "gt_boxes_mask": jnp.asarray(mask), "batch_size": 2}
    v = _random_like(_init_shapes(jhead, jb, True), 4)

    def loss_fn(params):
        out = jhead.apply({"params": params}, jb, training=True)
        loss, tb = jhead.apply({"params": params}, out, method=lambda m, b: m.loss(b))
        return loss, (tb, out["cls_preds"])

    (loss, (tb, jcls)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    port = anchor_head.AnchorHeadSingleCls(*args.values())
    port.load_state_dict(from_flax_variables(v), strict=True)
    out = port.train()({"multi_scale_3d_features": {"x_conv4": st}, "gt_boxes": _t(gt),
                        "gt_boxes_mask": _t(mask), "batch_size": 2})
    assert out["cls_preds"].shape == (2, 8 * 8 * 4, 2)
    _close(out["cls_preds"], jcls, "cls_preds")
    ploss, ptb = port.loss(out)
    ploss.backward()
    _close_scalar(ploss, loss, "loss")
    assert set(ptb) == set(tb) == {"rpn_loss_cls", "rpn_loss"}
    _grads_close(port, grads)


def test_anchor_head_multi_cls_against_jax():
    """AnchorHeadMultiCls, two groups behind a shared conv: each group's
    logits in its class's column and zeros in the other, the values, the
    cls-only loss and its gradients."""
    cfg, meta = tiny.variant_model("AnchorHeadMultiCls")
    cfg = dict(cfg.DENSE_HEAD)
    gt, mask = tiny.variant_gt(meta)
    batch = dict(_head_batch(32), gt_boxes=gt, gt_boxes_mask=mask)
    args = dict(model_cfg=cfg, input_channels=32, num_class=2, class_names=meta.class_names,
                grid_size=meta.grid_size, point_cloud_range=meta.point_cloud_range)
    jhead = janchor.AnchorHeadMultiCls(**args)
    v = _random_like(_init_shapes(jhead, batch, True), 5)
    loss, tb, jout, grads = _jax_head_step(jhead, v, batch)
    port = anchor_head.AnchorHeadMultiCls(*args.values())
    port.load_state_dict(from_flax_variables(v), strict=True)
    ploss, ptb, out = _port_head_step(port, batch)
    per_loc = out["cls_preds"].detach().numpy().reshape(2, 16 * 16, 4, 2)
    np.testing.assert_array_equal(per_loc == 0, np.asarray(jout["cls_preds"]).reshape(
        per_loc.shape) == 0)
    assert (per_loc[:, :, :2, 1] == 0).all() and (per_loc[:, :, 2:, 0] == 0).all()
    assert (per_loc[:, :, :2, 0] != 0).all()
    _close(out["cls_preds"], jout["cls_preds"], "cls_preds")
    _close_scalar(ploss, loss, "loss")
    for k in tb:
        _close_scalar(ptb[k], tb[k], k)
    _grads_close(port, grads)


def test_anchor_head_multi_cls_class_order():
    """Groups that do not partition CLASS_NAMES in order are refused, as the
    JAX head's assert refuses them."""
    cfg, meta = tiny.variant_model("AnchorHeadMultiCls")
    cfg = dict(cfg.DENSE_HEAD)
    cfg["RPN_HEAD_CFGS"] = [{"HEAD_CLS_NAME": ["Pedestrian"]}, {"HEAD_CLS_NAME": ["Car"]}]
    args = dict(model_cfg=cfg, input_channels=32, num_class=2, class_names=meta.class_names,
                grid_size=meta.grid_size, point_cloud_range=meta.point_cloud_range)
    with pytest.raises(AssertionError):
        janchor.AnchorHeadMultiCls(**args).init(
            jax.random.PRNGKey(0), {"spatial_features_2d": jnp.zeros((1, 16, 16, 32))})
    with pytest.raises(ValueError, match="partition CLASS_NAMES"):
        anchor_head.AnchorHeadMultiCls(*args.values())


# ---------------------------------------------------------------------------
# ATSS, softmax focal loss, legacy decoders
# ---------------------------------------------------------------------------

def _grid_anchors():
    anchors = np.zeros((64, 7), np.float32)
    anchors[:, 0] = np.repeat(np.linspace(0, 30, 8), 8)
    anchors[:, 1] = np.tile(np.linspace(-10, 10, 8), 8)
    anchors[:, 2] = -1
    anchors[:, 3:6] = [3.9, 1.6, 1.56]
    anchors[1::2, 6] = 1.57
    return anchors


def test_atss_assign_targets_against_jax():
    """The JAX test's case (a gt box on an anchor centre) and two scans of
    three boxes (rotated, two classes, one invalid): labels exact, targets
    and weights at 1e-5."""
    anchors = _grid_anchors()
    cls_ids = np.tile(np.array([1, 1, 2, 1], np.int32), 16)
    gts = np.zeros((2, 3, 8), np.float32)
    gts[0, 0] = [*anchors[20][:6], 0.0, 1]
    gts[0, 1] = [*(anchors[46][:3] + [0.4, -0.3, 0.1]), 4.2, 1.7, 1.5, 0.3, 2]
    gts[1, 0] = [*(anchors[9][:3] + [-0.5, 0.2, 0.0]), 4.0, 1.6, 1.6, -0.2, 1]
    gts[1, 1] = [*(anchors[53][:3] + [0.3, 0.3, 0.0]), 3.9, 1.6, 1.56, 1.5, 1]
    gts[1, 2] = [12.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.0, 1]
    valid = np.array([[True, True, False], [True, True, False]])
    coder = box_coder_utils.ResidualCoder()
    wants = jax.jit(lambda *a: [janchor.atss_assign_targets(*a[:3], None, a[3],
                                                            jcoder.ResidualCoder(), topk)
                                for topk in (9, 4)])(
        jnp.asarray(anchors), jnp.asarray(gts), jnp.asarray(valid), jnp.asarray(cls_ids))
    for topk, want in zip((9, 4), wants):
        got = anchor_head.atss_assign_targets(_t(anchors), _t(gts), _t(valid), None,
                                              _t(cls_ids), coder, topk=topk)
        np.testing.assert_array_equal(got["box_cls_labels"].numpy(),
                                      np.asarray(want["box_cls_labels"]))
        assert (got["box_cls_labels"] > 0).sum() >= 3
        for k in ("box_reg_targets", "reg_weights"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_softmax_focal_loss_against_jax():
    rng = np.random.RandomState(6)
    logits = (rng.randn(3, 50, 4) * 3).astype(np.float32)
    targets = rng.randint(0, 4, (3, 50))
    weights = rng.uniform(0, 2, (3, 50)).astype(np.float32)
    for w in (None, weights):
        want = jloss.softmax_focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                                        None if w is None else jnp.asarray(w))
        got = loss_utils.softmax_focal_loss(_t(logits), _t(targets),
                                            None if w is None else _t(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["PreviousResidualDecoder", "PreviousResidualRoIDecoder"])
def test_previous_residual_decoders_against_jax(name):
    """Random codes (one extra channel) on random anchors, headings past
    pi included."""
    rng = np.random.RandomState(7)
    anchors = np.concatenate([rng.randn(40, 3) * 10, rng.uniform(0.5, 4, (40, 3)),
                              rng.uniform(-4, 4, (40, 1)), rng.randn(40, 1)], 1)
    codes = (rng.randn(40, 8) * 0.5).astype(np.float32)
    codes[:5, 6] += 4.0
    want = getattr(jcoder, name).decode(jnp.asarray(codes), jnp.asarray(anchors, np.float32))
    got = getattr(box_coder_utils, name).decode(_t(codes), _t(anchors.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert getattr(box_coder_utils, name)(code_size=8).code_size == 8


# ---------------------------------------------------------------------------
# the variants' topologies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(tiny.VARIANTS))
def test_variant_builds_and_trains(name):
    """Each variant builds on its tiny topology in the JAX package's module
    order, and its training forward gives a finite loss with the head's tb
    terms (the cls-only heads: rpn_loss_cls and rpn_loss) and a gradient to
    the VFE and the head."""
    cfg, meta = tiny.variant_model(name)
    model = build_network(cfg, len(meta.class_names), meta, device="cpu").train()
    assert name in [type(m).__name__ for m in model.module_list]
    gt, mask = tiny.variant_gt(meta)
    out = model({"points": _t(tiny.second_points(2)),
                 "points_mask": torch.ones(2, 512, dtype=torch.bool), "batch_size": 2,
                 "gt_boxes": _t(gt), "gt_boxes_mask": _t(mask)})
    out["loss"].backward()
    assert torch.isfinite(out["loss"])
    cls_only = name.endswith("Cls")
    assert set(out["tb_dict"]) == ({"rpn_loss_cls", "rpn_loss"} if cls_only else
                                   {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss"})
    head = model.module_list[-1]
    assert all(p.grad is not None for p in head.parameters())


def test_space_trunk_is_second_trunk_and_cls_head_needs_x_conv4():
    cfg, meta = tiny.variant_model("SpaceVoxelBackBone8x")
    model = build_network(cfg, 1, meta, device="cpu")
    plain = build_network(tiny.second_model_cfg(), 1, meta, device="cpu")
    assert issubclass(SpaceVoxelBackBone8x, VoxelBackBone8x)
    assert set(model.state_dict()) == set(plain.state_dict())
    cfg = tiny.pointpillar_model_cfg()
    cfg.DENSE_HEAD.NAME = "AnchorHeadSingleCls"
    with pytest.raises(NotImplementedError, match="AnchorHeadSingleCls"):
        build_network(cfg, 1, tiny.POINTPILLAR_META, device="cpu")
