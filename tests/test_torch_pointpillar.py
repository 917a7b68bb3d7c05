"""The port's PointPillars against the JAX package on the CPU.

Modules: PillarVFE (eval and train-mode BN, 32 points a pillar, scans that
overflow both the points a pillar and the pillars a scan; the PFN options no
shipped config takes, with gradients), PointPillarScatter
(and its gradient), and the tiny model's VFE, scatter, BEV backbone and
anchor head each fed the JAX module's own input, with random weights carried
across by convert.from_flax_variables. Whole: the tiny model's eval outputs
and post-processed predictions, one training step's loss, tb terms, every
gradient and the BN statistics after it, the committed golden
tests/goldens/pointpillar_forward.npz, and pointpillar.yaml's full-width
flax tree loaded strictly.

Tolerances: outputs at the golden one (atol 1e-3 * max(1, max|want|),
rtol 1e-3; sums run in another order on the two sides), voxels and pillar
coordinates exact; the training step as tests/test_torch_second_train.py
holds it (loss and tb terms 1e-4, gradients rtol 1e-3 above the JAX
gradient's rounding floor, BN statistics 1e-5).

The golden case runs on the committed converted weights of the JAX model's
PRNGKey(0) eval init, tsm_det_pointcloud_tpu_torch/data/pointpillar_tiny_state.npz;
regenerate with
    python -c "from tests.test_torch_pointpillar import write_pointpillar_tiny_state; write_pointpillar_tiny_state()"
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pointpillar_e2e import META as JMETA, synthetic_batch, tiny_model_cfg
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.backbones_2d.map_to_bev import (
    PointPillarScatter as JScatter,
)
from tsm_det_pointcloud_tpu.models.backbones_3d.vfe import PillarVFE as JPillarVFE
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.backbones_2d.map_to_bev import PointPillarScatter
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.vfe import PillarVFE

GOLDEN = "tests/goldens/pointpillar_forward.npz"
PP_CFG = infer.ROOT / "tools/cfgs/kitti_models/pointpillar.yaml"
_JMODEL = jbuild(tiny_model_cfg(), num_class=1, dataset=JMETA)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port while this module runs (beside XLA's
    CPU thread pools, torch's own pool slows the tiny steps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _golden_close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3 * scale, rtol=1e-3,
                               err_msg=what)


def _close_scalar(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-4 * max(1.0, abs(float(want))), err_msg=what)


def _jax_batch(training=False):
    b = synthetic_batch()
    keep = ("points", "points_mask", "gt_boxes", "gt_boxes_mask") if training else (
        "points", "points_mask")
    return {k: np.asarray(b[k]) for k in keep}


def _jax_init():
    v = jax.jit(lambda r, b: _JMODEL.init(r, dict(b, batch_size=2), training=False))(
        jax.random.PRNGKey(0), _jax_batch())
    return jax.tree_util.tree_map(np.asarray, dict(v))


def write_pointpillar_tiny_state(path=tiny.POINTPILLAR_STATE_PATH):
    """Write the converted PRNGKey(0) tiny-PointPillars eval init."""
    sd = from_flax_variables(_jax_init())
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
            return (rng.randn(*a.shape) / np.sqrt(int(np.prod(a.shape[:-1])))).astype(
                np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias" and path[-2].key == "conv_cls":
            return rng.uniform(0.0, 1.0, a.shape).astype(np.float32)
        return (rng.randn(*a.shape) * 0.2).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, init)


@pytest.fixture(scope="module")
def init():
    return _jax_init()


@pytest.fixture(scope="module")
def jax_case(init):
    """The eval forward's batch_dict and post-processing with random
    variables."""
    v = _random_variables(init, 3)

    @jax.jit
    def fwd(variables, b):
        out = _JMODEL.apply(variables, dict(b, batch_size=2), training=False)
        pred, _ = _JMODEL.apply(variables, out, method=lambda m, bd: m.post_processing(bd))
        keep = ("voxel_features", "voxel_coords", "voxel_mask", "spatial_features",
                "spatial_features_2d", "cls_preds", "box_preds", "dir_cls_preds",
                "batch_cls_preds", "batch_box_preds")
        return {k: out[k] for k in keep}, pred

    out, pred = jax.tree_util.tree_map(np.asarray, fwd(v, _jax_batch()))
    return dict(variables=v, out=out, pred=pred)


def _port_model(variables):
    model = build_network(tiny.pointpillar_model_cfg(), 1, tiny.POINTPILLAR_META, device="cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model


def test_tiny_config_is_the_reference_one():
    """tiny.py's copy: the same batch, gt boxes, geometry and config."""
    b = synthetic_batch()
    np.testing.assert_array_equal(tiny.second_points(2), np.asarray(b["points"]))
    gt, mask = tiny.pointpillar_gt(2)
    np.testing.assert_array_equal(gt, np.asarray(b["gt_boxes"]))
    np.testing.assert_array_equal(mask, np.asarray(b["gt_boxes_mask"]))
    for f in ("class_names", "point_cloud_range", "voxel_size", "grid_size", "max_voxels",
              "max_points_per_voxel", "num_point_features", "max_points"):
        assert getattr(tiny.POINTPILLAR_META, f) == getattr(JMETA, f), f
    assert tiny.pointpillar_model_cfg() == tiny_model_cfg()


def test_committed_pointpillar_state_is_the_converted_init(init):
    """The committed state is a fresh conversion of the JAX tiny
    PointPillars' PRNGKey(0) eval init (rtol 1e-6, atol 1e-7)."""
    want = from_flax_variables(init)
    got = tiny.load_state(tiny.POINTPILLAR_STATE_PATH)
    assert set(got) == set(want)
    for k, t in want.items():
        np.testing.assert_allclose(got[k].numpy(), t.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_reproduces_committed_golden():
    model = build_network(tiny.pointpillar_model_cfg(), 1, tiny.POINTPILLAR_META, device="cpu")
    model.load_state_dict(tiny.load_state(tiny.POINTPILLAR_STATE_PATH), strict=True)
    out, pred = infer.detect(model, _t(tiny.second_points(2)),
                             torch.ones(2, 512, dtype=torch.bool))
    golden = np.load(GOLDEN)
    assert set(golden.files) == {"batch_cls_preds", "batch_box_preds"}
    for key in golden.files:
        assert out[key].shape == golden[key].shape
        _golden_close(out[key].numpy(), golden[key], key)
    assert (pred["count"] <= 16).all()


def _pillar_points(seed=4):
    """Two scans of 3000 points on a 16 x 16 pillar grid: 1200 in two
    pillars (more than 32 each), the rest spread over most of the grid
    (more pillars than the capacity of 64), some masked, some out of range."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((2, 3000, 4), np.float32)
    pts[..., 0] = rng.uniform(0.0, 8.0, (2, 3000))
    pts[..., 1] = rng.uniform(-4.0, 4.0, (2, 3000))
    pts[..., 2] = rng.uniform(-2.9, 0.9, (2, 3000))
    pts[..., 3] = rng.uniform(0, 1, (2, 3000))
    pts[:, :600, 0] = rng.uniform(2.01, 2.49, (2, 600))
    pts[:, :600, 1] = rng.uniform(0.01, 0.49, (2, 600))
    pts[:, 600:1200, 0] = rng.uniform(5.51, 5.99, (2, 600))
    pts[:, 600:1200, 1] = rng.uniform(-3.49, -3.01, (2, 600))
    pts[:, 2900:, 0] = 9.0                              # out of range
    mask = rng.uniform(size=(2, 3000)) > 0.05
    return pts, mask


PILLAR_GEOMETRY = dict(num_point_features=4, voxel_size=(0.5, 0.5, 4.0),
                       point_cloud_range=(0.0, -4.0, -3.0, 8.0, 4.0, 1.0), max_voxels=64,
                       max_points_per_voxel=32)


@pytest.mark.parametrize("training", [False, True])
def test_pillar_vfe_against_jax(training):
    """Pooled features, coordinates and masks; in train mode the BN
    normalises by the statistics of all B x V x P rows (no mask) and the
    running statistics after the forward match flax's batch_stats."""
    pts, mask = _pillar_points()
    cfg = {"WITH_DISTANCE": False, "USE_ABSLOTE_XYZ": True, "USE_NORM": True,
           "NUM_FILTERS": [64]}
    jm = JPillarVFE(model_cfg=cfg, **PILLAR_GEOMETRY)
    batch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)}
    init = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(1), batch)))
    rng = np.random.RandomState(2)
    v = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.3 + (1.0 if a.ndim == 1 else 0.0)).astype(
            np.float32), init)
    v["batch_stats"]["pfn_bn_0"]["var"] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    if training:
        jout, mutated = jm.apply(v, batch, training=True, mutable=["batch_stats"])
    else:
        jout = jm.apply(v, batch)
    port = PillarVFE(cfg, **PILLAR_GEOMETRY)
    port.load_state_dict(from_flax_variables(v), strict=True)
    port.train(training)
    with torch.no_grad():
        tout = port({"points": _t(pts), "points_mask": _t(mask)})
    npts = np.asarray(jout["voxel_mask"])
    assert npts.all(1).all(), "every one of the 64 pillar slots is filled: the scans overflow"
    for k in ("voxel_coords", "voxel_mask"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    _golden_close(tout["voxel_features"].numpy(), jout["voxel_features"], "pooled")
    np.testing.assert_array_equal(tout["pillar_features"].numpy(),
                                  tout["voxel_features"].numpy())
    if training:
        want = from_flax_variables({"batch_stats": mutated["batch_stats"]})
        state = port.state_dict()
        for k, w in want.items():
            np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_pillar_vfe_keeps_the_first_32_points():
    """A pillar of 600 points keeps its first 32 in scan order: moving a later
    point leaves the pillar's feature unchanged, moving one of the first 32
    changes it. (The pillar lies among the first 64 by key, which the
    capacity keeps.)"""
    pts, mask = _pillar_points()
    mask[:] = True
    port = PillarVFE({"NUM_FILTERS": [8]}, **PILLAR_GEOMETRY).eval()
    torch.nn.init.normal_(port.pfn_0.weight, generator=torch.Generator().manual_seed(0))

    def pillar_feature(p):
        with torch.no_grad():
            out = port({"points": _t(p), "points_mask": _t(mask)})
        c = out["voxel_coords"][0].numpy()
        row = np.nonzero((c[:, 1] == 1) & (c[:, 2] == 11))[0]     # y -3.5 to -3, x 5.5-6
        return out["voxel_features"][0, row[0]].numpy()

    base = pillar_feature(pts)
    late, early = pts.copy(), pts.copy()
    late[0, 700, 2] += 0.5
    early[0, 610, 2] += 0.5
    np.testing.assert_array_equal(pillar_feature(late), base)
    assert np.abs(pillar_feature(early) - base).max() > 1e-3


@pytest.mark.parametrize("override", [{"NUM_FILTERS": [32, 64]}, {"USE_NORM": False},
                                      {"USE_ABSLOTE_XYZ": False}, {"WITH_DISTANCE": True}])
def test_pillar_vfe_options_no_config_takes_raise(override):
    """The PFN options no shipped config takes (two layers, no BN, no
    absolute xyz, the distance), each on pointpillar.yaml's others: the
    train-mode pooled features and the gradient of a fixed weighting of them
    with respect to every weight equal the flax module's (jax.grad), at the
    golden tolerance; a two-layer PFN reads twice the first layer's width,
    as the JAX package's does."""
    pts, mask = _pillar_points()
    cfg = dict({"WITH_DISTANCE": False, "USE_ABSLOTE_XYZ": True, "USE_NORM": True,
                "NUM_FILTERS": [64]}, **override)
    jm = JPillarVFE(model_cfg=cfg, **PILLAR_GEOMETRY)
    batch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)}
    init = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(1), batch)))
    rng = np.random.RandomState(3)
    v = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.3 + (1.0 if a.ndim == 1 else 0.0)).astype(
            np.float32), init)
    out_w = rng.randn(2, 64, cfg["NUM_FILTERS"][-1]).astype(np.float32)

    def jloss(params):
        out, _ = jm.apply({**v, "params": params}, dict(batch), training=True,
                          mutable=["batch_stats"])
        return jnp.sum(out["voxel_features"] * out_w), out["voxel_features"]

    (_, jfeat), jgrad = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    port = PillarVFE(cfg, **PILLAR_GEOMETRY)
    port.load_state_dict(from_flax_variables(v), strict=True)
    if len(cfg["NUM_FILTERS"]) > 1:
        assert port.pfn_1.in_features == 2 * cfg["NUM_FILTERS"][0]
    port.train()
    tout = port({"points": _t(pts), "points_mask": _t(mask)})
    (tout["voxel_features"] * _t(out_w)).sum().backward()
    _golden_close(tout["voxel_features"].detach().numpy(), jfeat, "pooled")
    want = from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, jgrad)})
    params = dict(port.named_parameters())
    assert set(want) == set(params)
    for k, w in want.items():
        _golden_close(params[k].grad.numpy(), w.numpy(), f"d/d {k}")


def test_pointpillar_scatter_and_its_gradient():
    """The canvas equals the JAX scatter's exactly; the gradient with respect
    to the pillar features equals jax.vjp's (an invalid pillar's is 0)."""
    rng = np.random.RandomState(7)
    B, V, C, nx, ny = 2, 40, 5, 12, 9
    feats = rng.randn(B, V, C).astype(np.float32)
    coords = np.full((B, V, 3), -1, np.int32)
    vmask = np.zeros((B, V), bool)
    for b in range(B):
        cells = rng.choice(nx * ny, 30, replace=False)
        coords[b, :30, 0] = 0
        coords[b, :30, 1] = cells // nx
        coords[b, :30, 2] = cells % nx
        vmask[b, :30] = True
    jm = JScatter(model_cfg={}, grid_size=(nx, ny, 1))

    def jscatter(f):
        return jm.apply({}, {"pillar_features": f, "voxel_coords": jnp.asarray(coords),
                             "voxel_mask": jnp.asarray(vmask)})["spatial_features"]

    want, vjp = jax.vjp(jscatter, jnp.asarray(feats))
    port = PointPillarScatter({}, (nx, ny, 1))
    f = _t(feats).requires_grad_(True)
    got = port({"pillar_features": f, "voxel_coords": _t(coords),
                "voxel_mask": _t(vmask)})["spatial_features"]
    assert got.shape == (B, ny, nx, C)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    cot = rng.randn(*got.shape).astype(np.float32)
    got.backward(_t(cot))
    np.testing.assert_array_equal(f.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))
    assert not f.grad[~_t(vmask)].any()


def test_modules_against_jax(jax_case):
    """Each port module on the JAX module's own input, random weights."""
    out = jax_case["out"]
    vfe, scatter, b2d, head = _port_model(jax_case["variables"]).module_list
    with torch.no_grad():
        got = vfe({"points": _t(tiny.second_points(2)),
                   "points_mask": torch.ones(2, 512, dtype=torch.bool)})
        for k in ("voxel_coords", "voxel_mask"):
            np.testing.assert_array_equal(got[k].numpy(), out[k], err_msg=k)
        _golden_close(got["voxel_features"], out["voxel_features"], "voxel_features")
        got = scatter({k: _t(out[k]) for k in ("voxel_features", "voxel_coords",
                                               "voxel_mask")})
        np.testing.assert_array_equal(got["spatial_features"].numpy(), out["spatial_features"])
        got = b2d({"spatial_features": _t(out["spatial_features"])})
        _golden_close(got["spatial_features_2d"], out["spatial_features_2d"],
                      "spatial_features_2d")
        got = head({"spatial_features_2d": _t(out["spatial_features_2d"])})
        for k in ("cls_preds", "box_preds", "dir_cls_preds", "batch_cls_preds",
                  "batch_box_preds"):
            _golden_close(got[k], out[k], k)


def test_whole_tiny_pointpillar_and_post_processing(jax_case):
    out, pred = infer.detect(_port_model(jax_case["variables"]), _t(tiny.second_points(2)),
                             torch.ones(2, 512, dtype=torch.bool))
    jout, jpred = jax_case["out"], jax_case["pred"]
    _golden_close(out["batch_cls_preds"], jout["batch_cls_preds"], "cls")
    _golden_close(out["batch_box_preds"], jout["batch_box_preds"], "box")
    np.testing.assert_array_equal(pred["count"].numpy(), jpred["count"])
    assert jpred["count"].min() > 1, "the case must reach NMS"
    np.testing.assert_array_equal(pred["pred_labels"].numpy(), jpred["pred_labels"])
    _golden_close(pred["pred_scores"], jpred["pred_scores"], "scores")
    _golden_close(pred["pred_boxes"], jpred["pred_boxes"], "boxes")


@jax.jit
def _jax_loss_grad(variables, batch):
    def loss_fn(params):
        out, mutated = _JMODEL.apply(dict(variables, params=params), dict(batch, batch_size=2),
                                     training=True, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], mutated["batch_stats"])

    (loss, (tb, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return loss, tb, stats, grads


@pytest.fixture(scope="module")
def train_case(init):
    """The JAX step on the PRNGKey(0) init and the port's on its conversion."""
    loss, tb, stats, grads = jax.tree_util.tree_map(
        np.asarray, _jax_loss_grad(init, _jax_batch(training=True)))
    model = _port_model(init).train()
    gt, gmask = tiny.pointpillar_gt(2)
    out = model({"points": _t(tiny.second_points(2)),
                 "points_mask": torch.ones(2, 512, dtype=torch.bool), "batch_size": 2,
                 "gt_boxes": _t(gt), "gt_boxes_mask": _t(gmask)})
    out["loss"].backward()
    return dict(loss=loss, tb=tb, stats=from_flax_variables({"batch_stats": stats}),
                grads=from_flax_variables({"params": grads}), model=model, out=out)


def test_train_loss_and_tb_terms(train_case):
    out = train_case["out"]
    _close_scalar(out["loss"].detach(), train_case["loss"], "loss")
    assert set(out["tb_dict"]) == set(train_case["tb"])
    for k, v in train_case["tb"].items():
        _close_scalar(out["tb_dict"][k].detach(), v, k)
    assert float(train_case["tb"]["rpn_loss_loc"]) > 0


def test_train_gradients(train_case):
    grads, model = train_case["grads"], train_case["model"]
    scale = max(float(g.abs().max()) for g in grads.values())
    assert {n for n, _ in model.named_parameters()} == set(grads)
    for name, p in model.named_parameters():
        want = grads[name].numpy()
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=atol, err_msg=name)
    assert float(grads["module_list.0.pfn_0.weight"].abs().max()) > 0


def test_train_batch_stats(train_case):
    state = train_case["model"].state_dict()
    stats = train_case["stats"]
    assert "module_list.0.pfn_bn_0.running_mean" in stats
    assert len(stats) == 2 * sum(1 for k in state if k.endswith("running_mean"))
    for key, want in stats.items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_full_width_flax_tree_loads_strictly():
    """Every flax leaf of pointpillar.yaml's JAX init (eval_shape, no
    forward) maps onto the port's model, strict=True; the head has 321,408
    anchors a scan."""
    from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
        DatasetMeta as JDatasetMeta,
    )

    cfg = infer.load_cfg(PP_CFG)
    meta = infer.dataset_meta(cfg, 20000)
    jmodel = jbuild(cfg.MODEL, num_class=3, dataset=JDatasetMeta(**meta.__dict__))
    batch = {"points": jnp.zeros((1, 20000, 4), jnp.float32),
             "points_mask": jnp.ones((1, 20000), bool), "batch_size": 1}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False),
                            batch)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model = build_network(cfg.MODEL, 3, meta, device="cpu")
    model.load_state_dict(state, strict=True)
    assert meta.grid_size == (432, 496, 1) and meta.max_points_per_voxel == 32
    assert meta.max_voxels == 40000
    assert model.module_list[-1].anchors.shape == (321408, 7)
