"""The port's SECOND eval path against the JAX package on the CPU: voxels
and MeanVFE exactly; VoxelBackBone8x, HeightCompression, BaseBEVBackbone
and AnchorHeadSingle module by module, each fed the JAX module's own input,
with the JAX model's weights carried across by convert.from_flax_variables;
anchors, box decode, nms_bev and the whole tiny model with its
post-processing. Tolerance: the golden one of tests/test_golden_forwards.py
(atol 1e-3 * max(1, max|want|), rtol 1e-3) — sums run in another order on
the two sides; rulebooks and voxels are exact, so nothing larger may differ.

The golden case runs on the committed converted weights of the JAX model's
PRNGKey(0) eval init, tsm_det_pointcloud_tpu_torch/data/second_tiny_state.npz
(the card's check reproduces the golden with them too); regenerate with
    python -c "from tests.test_torch_second_forward import write_second_tiny_state; write_second_tiny_state()"
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_second_e2e import META as JMETA, second_model_cfg, synthetic_batch
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.backbones_3d.vfe import MeanVFE as JMeanVFE
from tsm_det_pointcloud_tpu.models.dense_heads import anchor_head as janchor
from tsm_det_pointcloud_tpu.models.model_utils import model_nms_utils as jnms_utils
from tsm_det_pointcloud_tpu.ops import box_coder_utils as jcoder
from tsm_det_pointcloud_tpu.ops import iou3d as jiou3d
from tsm_det_pointcloud_tpu.ops import voxel as jvoxel
from tsm_det_pointcloud_tpu.utils.common_utils import limit_period as jlimit_period
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.vfe import MeanVFE
from tsm_det_pointcloud_tpu_torch.models.dense_heads.anchor_head import generate_anchors
from tsm_det_pointcloud_tpu_torch.models.model_utils import model_nms_utils
from tsm_det_pointcloud_tpu_torch.ops import box_coder_utils, iou3d, voxel
from tsm_det_pointcloud_tpu_torch.utils.common_utils import limit_period

GOLDEN = "tests/goldens/second_forward.npz"


def _assert_golden_close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3 * scale, rtol=1e-3,
                               err_msg=what)


def _jax_init():
    model = jbuild(second_model_cfg(), num_class=1, dataset=JMETA)
    v = jax.jit(lambda r, b: model.init(r, b, training=False))(
        jax.random.PRNGKey(0), dict(synthetic_batch()))
    return model, jax.tree_util.tree_map(np.asarray, v)


def write_second_tiny_state(path=tiny.SECOND_STATE_PATH):
    """Write the converted PRNGKey(0) tiny-SECOND eval init."""
    _, v = _jax_init()
    sd = from_flax_variables(v)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{k: t.numpy() for k, t in sd.items()})


def _random_variables(init, seed):
    """Random flax variables from numpy in the init's structure: kernels
    scaled by fan-in, BN scales and shifts, non-trivial running stats, and
    conv_cls's bias lifted so that boxes pass the 0.1 score gate."""
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.randn(*a.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias" and path[-2].key == "conv_cls":
            return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        return (rng.randn(*a.shape) * 0.2).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, init)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX tiny SECOND: its PRNGKey(0) init, random variables, and the
    eval forward's batch_dict + post-processing with the random variables."""
    model, init = _jax_init()
    v = _random_variables(init, 3)
    batch = synthetic_batch()
    ev = {k: batch[k] for k in ("points", "points_mask")}

    @jax.jit
    def fwd(variables, b):
        out = model.apply(variables, dict(b, batch_size=2), training=False)
        pred, _ = model.apply(variables, out, method=lambda m, bd: m.post_processing(bd))
        keep = ("voxel_features", "voxel_coords", "voxel_mask", "voxel_num_points",
                "encoded_spconv_tensor", "spatial_features", "spatial_features_2d",
                "cls_preds", "box_preds", "dir_cls_preds", "batch_cls_preds",
                "batch_box_preds")
        return {k: out[k] for k in keep}, pred

    out, pred = jax.tree_util.tree_map(np.asarray, fwd(v, ev))
    return dict(model=model, init=init, variables=v, out=out, pred=pred,
                points=np.asarray(batch["points"]))


def _port_model(variables):
    model = build_network(tiny.second_model_cfg(), 1, tiny.SECOND_META, device="cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model


def _t(a):
    return torch.from_numpy(np.array(a))


def test_committed_second_state_is_the_converted_init(jax_case):
    """The committed state is a fresh conversion of the JAX tiny SECOND's
    PRNGKey(0) eval init, leaf for leaf (rtol 1e-6, atol 1e-7: the init's
    float32 arithmetic may round differently on another CPU)."""
    want = from_flax_variables(jax_case["init"])
    got = tiny.load_state(tiny.SECOND_STATE_PATH)
    assert set(got) == set(want)
    for k, t in want.items():
        np.testing.assert_allclose(got[k].numpy(), t.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_reproduces_committed_golden():
    model = build_network(tiny.second_model_cfg(), 1, tiny.SECOND_META, device="cpu")
    model.load_state_dict(tiny.load_state(tiny.SECOND_STATE_PATH), strict=True)
    out, pred = infer.detect(model, _t(tiny.second_points(2)),
                             torch.ones(2, 512, dtype=torch.bool))
    golden = np.load(GOLDEN)
    for key in golden.files:
        _assert_golden_close(out[key].numpy(), golden[key], key)
    assert (pred["count"] <= 8).all()


def test_tiny_points_are_the_reference_batch():
    np.testing.assert_array_equal(tiny.second_points(2),
                                  np.asarray(synthetic_batch()["points"]))


@pytest.mark.parametrize("capacity", [48, 512])
def test_voxelize_and_mean_vfe_exact(capacity):
    """Many points share voxels (more than 5 in some) and, at capacity 48,
    the scan has more voxels than the capacity: voxels, coordinates, counts,
    point slots and the mean features are equal bit for bit."""
    rng = np.random.RandomState(11)
    pcr, vs = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0), (1.0, 1.0, 0.5)
    pts = np.zeros((2, 600, 4), np.float32)
    pts[..., 0] = rng.uniform(0.2, 4.0, (2, 600))
    pts[..., 1] = rng.uniform(-2.0, 2.0, (2, 600))
    pts[..., 2] = rng.uniform(-2.9, -1.0, (2, 600))
    pts[..., 3] = rng.uniform(0, 1, (2, 600))
    pts[:, 500:, 0] = 20.0                      # out of range
    mask = rng.uniform(size=(2, 600)) > 0.1
    gdims = jvoxel.grid_size(pcr, vs)
    assert gdims == voxel.grid_size(pcr, vs)

    jc, jin = jvoxel.compute_voxel_coords(jnp.asarray(pts[..., :3]), pcr, vs)
    tc, tin = voxel.compute_voxel_coords(_t(pts[..., :3]), pcr, vs)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    want = jax.vmap(lambda p, c, m: jvoxel.voxelize(
        p, c, m, num_voxels=capacity, max_points=5, grid_dims=gdims))(
        jnp.asarray(pts), jc, jnp.asarray(mask) & jin)
    got = voxel.voxelize(_t(pts), tc, _t(mask) & tin, capacity, 5, gdims)
    for k in ("voxels", "coordinates", "num_points", "num_voxels", "point_voxel_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert np.asarray(want["num_points"]).max() == 5
    assert (np.asarray(want["num_voxels"]) == capacity).any() == (capacity == 48)

    cfg = dict(num_point_features=4, voxel_size=vs, point_cloud_range=pcr,
               max_voxels=capacity, max_points_per_voxel=5)
    jout = JMeanVFE(model_cfg={}, **cfg).apply(
        {}, {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)})
    tout = MeanVFE({}, **cfg)({"points": _t(pts), "points_mask": _t(mask)})
    for k in ("voxel_features", "voxel_coords", "voxel_num_points", "voxel_mask"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)


def test_modules_against_jax(jax_case):
    """Each port module on the JAX module's own input, random weights."""
    out = jax_case["out"]
    model = _port_model(jax_case["variables"])
    vfe, b3d, to_bev, b2d, head = model.module_list
    with torch.no_grad():
        got = vfe({"points": _t(jax_case["points"]),
                   "points_mask": torch.ones(2, 512, dtype=torch.bool)})
        for k in ("voxel_features", "voxel_coords", "voxel_mask", "voxel_num_points"):
            np.testing.assert_array_equal(got[k].numpy(), out[k], err_msg=k)
        got = b3d({k: _t(out[k]) for k in ("voxel_features", "voxel_coords",
                                           "voxel_mask")})
        assert np.abs(out["encoded_spconv_tensor"]).max() > 0
        _assert_golden_close(got["encoded_spconv_tensor"], out["encoded_spconv_tensor"],
                             "encoded_spconv_tensor")
        ms = got["multi_scale_3d_features"]
        assert [ms[f"x_conv{i}"].features.shape[-1] for i in (1, 2, 3, 4)] == [16, 32, 64, 64]
        got = to_bev({"encoded_spconv_tensor": _t(out["encoded_spconv_tensor"])})
        np.testing.assert_array_equal(got["spatial_features"].numpy(),
                                      out["spatial_features"])
        got = b2d({"spatial_features": _t(out["spatial_features"])})
        _assert_golden_close(got["spatial_features_2d"], out["spatial_features_2d"],
                             "spatial_features_2d")
        got = head({"spatial_features_2d": _t(out["spatial_features_2d"])})
        for k in ("cls_preds", "box_preds", "dir_cls_preds", "batch_cls_preds",
                  "batch_box_preds"):
            _assert_golden_close(got[k], out[k], k)


def test_deblock_needs_the_flip(jax_case):
    """The stride-2 deblock's kernel is flipped on conversion: without the
    flip its output differs from the JAX one by far more than the tolerance."""
    out = jax_case["out"]
    model = _port_model(jax_case["variables"])
    b2d = model.module_list[3]
    with torch.no_grad():
        b2d.deblock1.weight.copy_(b2d.deblock1.weight.flip(2, 3))
        got = b2d({"spatial_features": _t(out["spatial_features"])})["spatial_features_2d"]
    want = out["spatial_features_2d"]
    assert np.abs(got.numpy()[..., 32:] - want[..., 32:]).max() > 1e-2
    _assert_golden_close(got.numpy()[..., :32], want[..., :32], "deblock0 half")


def test_whole_tiny_second_and_post_processing(jax_case):
    out, pred = infer.detect(_port_model(jax_case["variables"]), _t(jax_case["points"]),
                             torch.ones(2, 512, dtype=torch.bool))
    jout, jpred = jax_case["out"], jax_case["pred"]
    _assert_golden_close(out["batch_cls_preds"], jout["batch_cls_preds"], "cls")
    _assert_golden_close(out["batch_box_preds"], jout["batch_box_preds"], "box")
    np.testing.assert_array_equal(pred["count"].numpy(), jpred["count"])
    assert jpred["count"].min() > 0, "the case must reach NMS"
    np.testing.assert_array_equal(pred["pred_labels"].numpy(), jpred["pred_labels"])
    _assert_golden_close(pred["pred_scores"], jpred["pred_scores"], "scores")
    _assert_golden_close(pred["pred_boxes"], jpred["pred_boxes"], "boxes")


@pytest.mark.parametrize("which", ["tiny", "second.yaml"])
def test_generate_anchors_equal(which):
    if which == "tiny":
        cfg, meta = tiny.second_model_cfg(), tiny.SECOND_META
    else:
        full = infer.load_cfg(infer.ROOT / "tools/cfgs/kitti_models/second.yaml")
        cfg, meta = full.MODEL, infer.dataset_meta(full, 20000)
    acfg = [dict(a) for a in cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG]
    grids = [(meta.grid_size[0] // 8, meta.grid_size[1] // 8)] * len(acfg)
    got, n_got = generate_anchors(meta.point_cloud_range, grids, acfg)
    want, n_want = janchor.generate_anchors(meta.point_cloud_range, grids, acfg)
    assert n_got == n_want
    np.testing.assert_array_equal(got, want)
    if which != "tiny":
        assert got.shape == (211200, 7) and n_got == 6


def test_residual_decode_and_direction():
    rng = np.random.RandomState(5)
    anchors = np.concatenate([rng.uniform(-40, 40, (300, 3)), rng.uniform(0.5, 4, (300, 3)),
                              rng.uniform(-3, 3, (300, 1))], -1).astype(np.float32)
    enc = (rng.randn(2, 300, 7) * 2).astype(np.float32)
    dirs = rng.randn(2, 300, 2).astype(np.float32)
    dirs[0, :10, 1] = dirs[0, :10, 0]                 # ties: the first maximum
    want = jcoder.ResidualCoder().decode(jnp.asarray(enc), jnp.asarray(anchors)[None])
    got = box_coder_utils.ResidualCoder().decode(_t(enc), _t(anchors)[None])
    _assert_golden_close(got, want, "decode")
    jrot = jlimit_period(np.asarray(want)[..., 6] - 0.78539, 0.0, np.pi) + 0.78539 \
        + np.pi * np.argmax(dirs, -1)
    from tsm_det_pointcloud_tpu_torch.models.dense_heads.anchor_head import AnchorHeadSingle
    head = AnchorHeadSingle(dict(tiny.second_model_cfg().DENSE_HEAD), 64, 1, ("Car",),
                            (16, 16, 40), tiny.SECOND_META.point_cloud_range)
    head.anchors = _t(anchors)
    _, boxes = head.generate_predicted_boxes(None, _t(enc), _t(dirs))
    _assert_golden_close(boxes[..., 6], jrot, "direction-corrected heading")
    _assert_golden_close(limit_period(_t(np.linspace(-7, 7, 50, dtype=np.float32)), 0.0,
                                      np.pi),
                         jlimit_period(np.linspace(-7, 7, 50, dtype=np.float32), 0.0, np.pi),
                         "limit_period")


def _boxes(n, seed):
    rng = np.random.RandomState(seed)
    b = np.concatenate([rng.uniform(0, 30, (n, 2)), rng.uniform(-1, 1, (n, 1)),
                        rng.uniform(1, 5, (n, 2)), rng.uniform(1, 2, (n, 1)),
                        rng.uniform(-3, 3, (n, 1))], -1).astype(np.float32)
    s = rng.uniform(0, 1, n).astype(np.float32)
    return b, s


@pytest.mark.parametrize("n,pre,post", [(200, 64, 16), (20000, 64, 16), (500, 4096, 500)])
def test_nms_bev_index_equal(monkeypatch, n, pre, post):
    """Index-equal to the JAX nms_bev; only the top-pre boxes' k x k pairs
    are clipped, also when n >> pre."""
    boxes, scores = _boxes(n, n)
    scores[scores < 0.3] = -np.inf
    want = jax.jit(lambda b, s: jiou3d.nms_bev(b, s, 0.1, pre_maxsize=pre,
                                               post_maxsize=post))(boxes, scores)
    shapes = []
    grid = iou3d._pair_intersection_area_grid

    def spy(ca, cb):
        shapes.append((ca.shape[0], cb.shape[0]))
        return grid(ca, cb)

    monkeypatch.setattr(iou3d, "_pair_intersection_area_grid", spy)
    got = iou3d.nms_bev(_t(boxes), _t(scores), 0.1, pre_maxsize=pre, post_maxsize=post)
    k = min(pre, n)
    assert shapes == [(k, k)]
    cnt = int(want[1])
    assert int(got[1]) == cnt and cnt > 1
    np.testing.assert_array_equal(got[0].numpy()[:cnt], np.asarray(want[0])[:cnt])
    np.testing.assert_array_equal(got[2].numpy()[:cnt], np.asarray(want[2])[:cnt])

    cfg = {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": pre,
           "NMS_POST_MAXSIZE": post}
    raw = np.abs(scores)
    want = jax.jit(lambda b, s: jnms_utils.class_agnostic_nms(s, b, cfg, score_thresh=0.3))(
        boxes, raw)
    got = model_nms_utils.class_agnostic_nms(_t(raw), _t(boxes), cfg, score_thresh=0.3)
    cnt = int(want[1])
    assert int(got[1]) == cnt
    np.testing.assert_array_equal(got[0].numpy()[:cnt], np.asarray(want[0])[:cnt])


@pytest.mark.parametrize("mode,voxels", [("test", 40000), ("train", 16000)])
def test_dataset_meta_reads_the_mode(mode, voxels):
    cfg = infer.load_cfg(infer.ROOT / "tools/cfgs/kitti_models/second.yaml")
    meta = infer.dataset_meta(cfg, 20000, mode)
    assert meta.max_voxels == voxels
    assert meta.max_points_per_voxel == 5
    assert tuple(meta.grid_size) == (1408, 1600, 40)
    assert tuple(meta.voxel_size) == (0.05, 0.05, 0.1)
    assert meta.num_point_features == 4
    if mode == "test":
        assert infer.dataset_meta(cfg, 20000) == meta
