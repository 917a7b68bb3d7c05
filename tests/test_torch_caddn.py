"""The port's CaDDN against the JAX package on the CPU.

Modules: `lid_to_bin` over a sweep of depths through both ends of the range
(exact); the depth networks (CompactDDN and the DDNDeepLabV3 plan LAYERS
[1, 1, 1, 1], WIDTH 8) in eval and in training (outputs and the BN
statistics after the forward) at 64 x 96 (batch 2) and at KITTI's 375 x
1242 (batch 1: flax SAME's asymmetric pads at both parities, the ASPP
pooling branch's one value per channel, features 47 x 155 against logits
47 x 156); ImageVFE's volume and depth loss with and without 2D gt boxes;
Conv2DCollapse in eval and training. Whole: the tiny CaDDN of both depth
networks (tiny.py, on `tiny.caddn_state`) through eval, post-processing and
a training step (loss, tb terms, every gradient, the BN statistics after
it), and the committed golden data/caddn_tiny_forward.npz; CaDDN.yaml at
full width builds and its flax tree (JAX eval_shape, no weights computed)
loads strictly; the processor's two CaDDN steps at odd sizes; the
converter round trip of the tiny CaDDN.

Tolerances (f32 sums run in another order on the two sides): outputs at
the golden one (atol 1e-3 * max(1, max|want|), rtol 1e-3), predictions'
labels and counts exact; bins, pixel masks and the volume's zero pattern
exact (the tiny projections are exact in f32 on both sides); loss and tb
terms atol 1e-4 * max(1, |want|), rtol 1e-4; gradients rtol 1e-3, atol
1e-4 * max(max|want| of the tensor, 1e-2 * the largest of all); BN
statistics rtol 1e-5, atol 1e-5.

The training step's reference runs the JAX package in f64
(`jax.enable_x64`, every variable and float input widened): the port's f32
loss, tb terms and BN statistics, and its f64 gradients (the model and the
batch widened with `.double()`), are held against it; the converter keeps
the reference's gradients and statistics in f32 (6e-8 relative). The tiny
DDNDeepLabV3's ASPP image-pooling BN sees two near-equal values a channel
at batch 2, and f32 gradients behind it keep ~2 digits in either package
(JAX's own f32 step against its f64 one: 8e-3 relative); in f64 they meet
the tolerances above. The CompactDDN model's f32 gradients are also held
against the f64 reference.

The golden is regenerated with
    python -c "from tests.test_torch_caddn import write_caddn_golden; write_caddn_golden()"
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_caddn_e2e as jtest
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.datasets.processor.data_processor import (
    DataProcessor as JDataProcessor,
)
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.backbones_2d.map_to_bev import Conv2DCollapse as JCollapse
from tsm_det_pointcloud_tpu.models.backbones_3d import ddn as jddn
from tsm_det_pointcloud_tpu.models.backbones_3d.image_vfe import ImageVFE as JImageVFE
from tsm_det_pointcloud_tpu.models.backbones_3d.image_vfe import lid_to_bin as jlid_to_bin
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu.utils.edict import EDict
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.datasets.processor.data_processor import DataProcessor
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.backbones_2d.map_to_bev import Conv2DCollapse
from tsm_det_pointcloud_tpu_torch.models.backbones_3d import ddn
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.image_vfe import ImageVFE, lid_to_bin

JMETA = JDatasetMeta(**dataclasses.asdict(tiny.CADDN_META))
CADDN_CFG = infer.ROOT / "tools/cfgs/kitti_models/CaDDN.yaml"
WHICH = ("compact", "deeplab")
_JMODELS = {w: jbuild(tiny.caddn_model_cfg(w), num_class=1, dataset=JMETA) for w in WHICH}
EVAL_KEYS = ("spatial_features_3d", "spatial_features", "spatial_features_2d", "cls_preds",
             "box_preds", "dir_cls_preds", "batch_cls_preds", "batch_box_preds")


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


def _stats_close(state, mutated, what):
    want = from_flax_variables({"batch_stats": mutated})
    assert want
    for k, w in want.items():
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{what} {k}")


def _batch(which, training):
    """The tiny batch; the deeplab model's training batch adds the 2D boxes
    (`tiny.caddn_train_batch`)."""
    return tiny.caddn_train_batch(which) if training else tiny.caddn_batch()


def _random_like(init, seed):
    """numpy-seeded flax variables in the init's structure: kernels over
    fan-in, BN scales and running variances U(0.5, 1.5), other vectors
    N(0, 0.2^2)."""
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*a.shape) / np.sqrt(int(np.prod(a.shape[:-1])))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.randn(*a.shape) * 0.2).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(init))


# ---------------------------------------------------------------------------
# the JAX side of the tiny models, once a module
# ---------------------------------------------------------------------------

# the two tiny models share the head, its anchors and POST_PROCESSING, so
# one jitted post-processing serves both
_jax_post = jax.jit(lambda out: _JMODELS["compact"].apply(
    {}, out, method=lambda m, bd: m.post_processing(bd))[0])


def _jax_eval(which, variables, batch):
    model = _JMODELS[which]
    out = jax.jit(lambda v, b: model.apply(v, dict(b, batch_size=2), training=False))(
        variables, batch)
    pred = _jax_post({k: out[k] for k in ("batch_cls_preds", "batch_box_preds")})
    return jax.tree_util.tree_map(np.asarray, ({k: out[k] for k in EVAL_KEYS}, pred))


def _widen(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


def _jax_train(which, variables, batch):
    """The JAX training step in f64: loss, tb terms, BN statistics and
    gradients."""
    model = _JMODELS[which]

    def step(v, b):
        def loss_fn(params):
            out, mutated = model.apply(dict(v, params=params), dict(b, batch_size=2),
                                       training=True, mutable=["batch_stats"])
            return out["loss"], (out["tb_dict"], mutated["batch_stats"])

        (loss, (tb, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
        return loss, tb, stats, grads

    with jax.enable_x64(True):
        got = jax.jit(step)(_widen(variables), _widen(batch))
        assert got[0].dtype == jnp.float64
        return jax.tree_util.tree_map(np.asarray, got)


@pytest.fixture(scope="module")
def cases():
    """Per depth network: the drawn state, the JAX eval outputs and
    predictions, and the JAX f64 training step's loss, tb terms, BN
    statistics and gradients (as port state dicts, and as the flax tree of
    every variable of a training apply)."""
    out = {}
    for w in WHICH:
        state = tiny.caddn_state(w)
        v = to_flax_variables(state)
        ev, pred = _jax_eval(w, v, tiny.caddn_batch())
        loss, tb, stats, grads = _jax_train(w, v, _batch(w, True))
        out[w] = dict(state=state, eval=ev, pred=pred, loss=loss, tb=tb,
                      stats=from_flax_variables({"batch_stats": stats}),
                      grads=from_flax_variables({"params": grads}),
                      tree={"params": grads, "batch_stats": stats})
    return out


def _port(which, state):
    model = build_network(tiny.caddn_model_cfg(which), 1, tiny.CADDN_META, device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def write_caddn_golden(path=tiny.CADDN_FORWARD_PATH):
    """Write the JAX package's eval outputs, predictions and training loss
    terms (its f64 step, stored in f32) of both tiny CaDDNs on their drawn
    states."""
    arrays = {}
    for w in WHICH:
        v = to_flax_variables(tiny.caddn_state(w))
        ev, pred = _jax_eval(w, v, tiny.caddn_batch())
        loss, tb, _, _ = _jax_train(w, v, _batch(w, True))
        for k in ("batch_cls_preds", "batch_box_preds"):
            arrays[f"{w}/{k}"] = ev[k]
        for k, a in pred.items():
            arrays[f"{w}/{k}"] = a
        arrays[f"{w}/loss"] = loss.astype(np.float32)
        for k, a in tb.items():
            arrays[f"{w}/tb/{k}"] = a.astype(np.float32)
    np.savez_compressed(path, **arrays)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_tiny_config_is_the_reference_one():
    """tiny.py's copy of the JAX test's config, geometry and batch."""
    assert tiny.caddn_model_cfg("compact") == jtest.model_cfg()
    want = jtest.model_cfg()
    want["VFE"]["DDN"] = {"NAME": "DDNDeepLabV3", "LAYERS": [1, 1, 1, 1], "WIDTH": 8}
    want["VFE"]["FG_WEIGHT"] = 13.0
    want["VFE"]["BG_WEIGHT"] = 1.0
    assert tiny.caddn_model_cfg("deeplab") == want
    assert dataclasses.asdict(tiny.CADDN_META) == dataclasses.asdict(jtest.META)
    b = jtest.batch()
    for k, a in tiny.caddn_batch().items():
        np.testing.assert_array_equal(a, np.asarray(b[k]), err_msg=k)


def test_lid_to_bin_sweep():
    """Bins of 4001 depths from below the range to past its end, both ends
    and each bin edge's neighbours among them, at the tiny and the full
    configs' ranges: exact."""
    for bins, lo, hi in ((16, 1.0, 20.0), (80, 2.0, 46.8)):
        d = np.concatenate([np.linspace(lo - 2, hi + 5, 4001), [lo, hi]]).astype(np.float32)
        want = np.asarray(jlid_to_bin(jnp.asarray(d), bins, lo, hi))
        got = lid_to_bin(_t(d), bins, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.min() == 0 and want.max() == bins - 1


@pytest.mark.parametrize("h,w,n", [(64, 96, 2), (375, 1242, 1)])
def test_same_pads_and_shapes(h, w, n):
    """flax SAME's pads: 0 before, 1 after a stride-2 3x3 on an even side,
    2 and 3 for the 7x7 stem; the tiny DDNDeepLabV3's features and logits at
    stride 8 (at 375 x 1242: 47 x 155 against 47 x 156)."""
    assert ddn.same_pads(1242, 7, 2) == (2, 3) and ddn.same_pads(375, 7, 2) == (3, 3)
    assert ddn.same_pads(188, 3, 2) == (0, 1) and ddn.same_pads(311, 3, 2) == (1, 1)
    assert ddn.same_pads(47, 3, 1, 36) == (36, 36)
    net = ddn.DDNDeepLabV3(8, 12, layers=(1, 1, 1, 1), width=8).eval()
    with torch.no_grad():
        feats, logits = net(torch.zeros(n, h, w, 3))
    want_f = (h // 8, w // 8) if (h, w) == (64, 96) else (47, 155)
    want_l = (h // 8, w // 8) if (h, w) == (64, 96) else (47, 156)
    assert feats.shape == (n, *want_f, 8) and logits.shape == (n, *want_l, 12)


DDN_CASES = [(name, size, training) for name in ("CompactDDN", "DDNDeepLabV3")
             for size in ((64, 96, 2), (375, 1242, 1)) for training in (False, True)]


def _ddn_kw(name):
    return dict(layers=(1, 1, 1, 1), width=8) if name == "DDNDeepLabV3" else {}


@functools.lru_cache(maxsize=None)
def _jax_ddn(name, size):
    """A JAX depth network's random weights (its variables do not depend on
    the image size), seeded images, and its eval and training outputs on
    them (one jit for both)."""
    h, w, n = size
    jnet = getattr(jddn, name)(num_feat=16, num_logits=16, **_ddn_kw(name))
    images = np.random.RandomState(3).rand(n, h, w, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda x: jnet.init(jax.random.PRNGKey(0), x, False),
                            jnp.zeros((1, 64, 96, 3)))
    v = _random_like(shapes, 5)
    ev, tr = jax.jit(lambda v_, x: (jnet.apply(v_, x, False),
                                    jnet.apply(v_, x, True, mutable=["batch_stats"])))(v, images)
    return v, images, ev, tr


@pytest.mark.parametrize("name,size,training", DDN_CASES)
def test_ddn_against_jax(name, size, training):
    """Features and logits of a depth network on seeded images, random
    weights; in training the batch statistics, and the running statistics
    after the forward."""
    v, images, ev, tr = _jax_ddn(name, size)
    if training:
        (jf, jl), mutated = tr
    else:
        jf, jl = ev
    net = getattr(ddn, name)(16, 16, **_ddn_kw(name))
    net.load_state_dict(from_flax_variables(v), strict=True)
    net.train(training)
    with torch.no_grad():
        f, lg = net(_t(images))
    _close(f, jf, "features")
    _close(lg, jl, "logits")
    if training:
        _stats_close(net.state_dict(), mutated["batch_stats"], name)


def _vfe_case(with_boxes):
    cfg = dict(tiny.caddn_model_cfg("compact")["VFE"])
    geom = dict(grid_size=JMETA.grid_size, point_cloud_range=JMETA.point_cloud_range,
                voxel_size=JMETA.voxel_size)
    b = tiny.caddn_batch()
    if with_boxes:
        b["gt_boxes2d"] = tiny.caddn_boxes2d()
    return cfg, geom, b


@pytest.mark.parametrize("with_boxes", [False, True])
def test_image_vfe_volume_and_depth_loss(with_boxes):
    """ImageVFE (CompactDDN) on the tiny batch, random weights: the eval
    volume, and in training the volume and the depth loss (balanced by the
    2D boxes, or plain) and the BN statistics; the volume's zero pattern
    (voxels outside the image or the depth range) is exact."""
    cfg, geom, b = _vfe_case(with_boxes)
    jm = JImageVFE(model_cfg=cfg, downsample_factor=8, **geom)
    jb = {k: jnp.asarray(a) for k, a in b.items()}
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, True), jb)
    v = _random_like(shapes, 8)
    # the VFE writes its outputs into the batch dict it is given: one copy each
    jev, (jtr, mutated) = jax.jit(lambda v_, x: (
        jm.apply(v_, dict(x), False)["spatial_features_3d"],
        jm.apply(v_, dict(x), True, mutable=["batch_stats"])))(v, jb)
    port = ImageVFE(cfg, downsample_factor=8, **geom)
    port.load_state_dict(from_flax_variables(v), strict=True)
    tb = {k: _t(a) for k, a in b.items()}
    with torch.no_grad():
        ev = port.eval()(dict(tb))
        tr = port.train()(dict(tb))
    for got, want in ((ev["spatial_features_3d"], jev), (tr["spatial_features_3d"],
                                                           jtr["spatial_features_3d"])):
        np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)
        _close(got, want, "volume")
    assert 0 < int(ev["voxels_in_frustum"][0]) < np.prod(JMETA.grid_size)
    _close_scalar(tr["loss_depth"], jtr["loss_depth"], "loss_depth")
    _stats_close(port.state_dict(), mutated["batch_stats"], "ImageVFE")


@pytest.mark.parametrize("training", [False, True])
def test_conv2d_collapse(training):
    """The z-major collapse of a random volume: 1x1 conv, BN, ReLU."""
    rng = np.random.RandomState(4)
    vox = rng.randn(2, 6, 5, 4, 3).astype(np.float32)
    jm = JCollapse(model_cfg={"NUM_BEV_FEATURES": 7})
    init = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), {"spatial_features_3d": x}),
                          jnp.asarray(vox))
    v = _random_like(init, 6)
    port = Conv2DCollapse({"NUM_BEV_FEATURES": 7}, 3, (6, 5, 4))
    port.load_state_dict(from_flax_variables(v), strict=True)
    port.train(training)
    with torch.no_grad():
        got = port({"spatial_features_3d": _t(vox)})["spatial_features"]
    if training:
        want, mutated = jm.apply(v, {"spatial_features_3d": jnp.asarray(vox)}, True,
                                 mutable=["batch_stats"])
        _stats_close(port.state_dict(), mutated["batch_stats"], "collapse")
    else:
        want = jm.apply(v, {"spatial_features_3d": jnp.asarray(vox)}, False)
    assert got.shape == (2, 5, 6, 7)
    _close(got, want["spatial_features"], "spatial_features")


# ---------------------------------------------------------------------------
# the whole tiny CaDDN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", WHICH)
def test_tiny_caddn_eval_and_post_processing(cases, which):
    case = cases[which]
    model = _port(which, case["state"])
    b = {k: _t(a) for k, a in tiny.caddn_batch().items()}
    out, pred = infer.detect(model, b.pop("points"), b.pop("points_mask"), b)
    for k in EVAL_KEYS:
        _close(out[k], case["eval"][k], k)
    jpred = case["pred"]
    assert jpred["count"].min() > 1, "the case must reach NMS"
    for k in ("count", "pred_labels"):
        np.testing.assert_array_equal(pred[k].numpy(), jpred[k], err_msg=k)
    for k in ("pred_scores", "pred_boxes"):
        _close(pred[k], jpred[k], k)


def _port_step(which, state, dtype):
    model = _port(which, state).to(dtype).train()
    b = {k: _t(a) for k, a in _batch(which, True).items()}
    out = model(dict({k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()},
                     batch_size=2))
    out["loss"].backward()
    return model, out


def _grads_close(model, grads):
    scale = max(float(g.abs().max()) for g in grads.values())
    assert {n for n, _ in model.named_parameters()} == set(grads)
    for name, p in model.named_parameters():
        want, got = grads[name].numpy(), p.grad.numpy()
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        bad = np.abs(got - want) > 1e-3 * np.abs(want) + atol
        assert not bad.any(), (name, got.dtype, int(bad.sum()), float(np.abs(got - want).max()))


@pytest.mark.parametrize("which", WHICH)
def test_tiny_caddn_training_step(cases, which):
    """The f32 loss, every tb term (the depth loss included) and the BN
    statistics after the step; every parameter's f64 gradient against the
    JAX package's f64 step, and the CompactDDN model's f32 ones."""
    case = cases[which]
    model, out = _port_step(which, case["state"], torch.float32)
    _close_scalar(out["loss"], case["loss"], "loss")
    assert set(out["tb_dict"]) == set(case["tb"])
    for k, want in case["tb"].items():
        _close_scalar(out["tb_dict"][k], want, k)
    assert float(case["tb"]["depth_loss"]) > 0
    state = model.state_dict()
    for key, want in case["stats"].items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    grads = case["grads"]
    if which == "compact":
        _grads_close(model, grads)
    model64, _ = _port_step(which, case["state"], torch.float64)
    _grads_close(model64, grads)
    assert float(grads["module_list.0.ddn.depth_head.weight" if which == "compact" else
                       "module_list.0.ddn.classifier.weight"].abs().max()) > 0


def test_committed_golden(cases):
    """data/caddn_tiny_forward.npz holds the JAX values of `cases`, and the
    port reproduces it."""
    with np.load(tiny.CADDN_FORWARD_PATH) as z:
        golden = {k: z[k] for k in z.files}
    for w in WHICH:
        case = cases[w]
        for k in ("batch_cls_preds", "batch_box_preds"):
            np.testing.assert_allclose(golden[f"{w}/{k}"], case["eval"][k], rtol=1e-6, atol=1e-6)
        for k, a in case["pred"].items():
            np.testing.assert_allclose(golden[f"{w}/{k}"], a, rtol=1e-6, atol=1e-6)
        _close_scalar(golden[f"{w}/loss"], case["loss"], "loss")
        model = _port(w, case["state"])
        b = {k: _t(a) for k, a in tiny.caddn_batch().items()}
        out, pred = infer.detect(model, b.pop("points"), b.pop("points_mask"), b)
        _close(out["batch_cls_preds"], golden[f"{w}/batch_cls_preds"], "cls")
        _close(out["batch_box_preds"], golden[f"{w}/batch_box_preds"], "box")
        np.testing.assert_array_equal(pred["count"].numpy(), golden[f"{w}/count"])


def test_converter_round_trip(cases):
    """Every leaf of the tiny CaDDN's JAX variables in training (the
    gradients' params and the BN statistics of its training step) is
    consumed by the converter and maps onto the port strictly, and back."""
    for w in WHICH:
        variables = jax.tree_util.tree_map(lambda a: np.full(a.shape, 0.5, np.float32),
                                           cases[w]["tree"])
        state = from_flax_variables(variables)
        assert len(state) == len(jax.tree_util.tree_leaves(variables))
        model = build_network(tiny.caddn_model_cfg(w), 1, tiny.CADDN_META, device="cpu")
        model.load_state_dict(state, strict=True)
        back = from_flax_variables(to_flax_variables(cases[w]["state"]))
        assert set(back) == set(cases[w]["state"])
        for k, t in cases[w]["state"].items():
            assert torch.equal(back[k], t), k


def test_full_width_flax_tree_loads_strictly():
    """CaDDN.yaml (ResNet-101 DDN, a 280 x 376 x 25 grid): every flax leaf of
    the JAX init (eval_shape, no forward) maps onto the port's model,
    strict=True; the collapse reads 25 x 64 channels, the classifier gives 80
    logits (no out-of-range bin) and the head has 157,920 anchors a scan."""
    cfg = infer.load_cfg(CADDN_CFG)
    meta = infer.dataset_meta(cfg, 1024)
    assert meta.grid_size == (280, 376, 25) and meta.depth_downsample_factor is None
    jmodel = jbuild(cfg.MODEL, num_class=3, dataset=JDatasetMeta(**dataclasses.asdict(meta)))
    batch = {"images": jnp.zeros((1, 64, 96, 3)),
             "trans_lidar_to_cam_img": jnp.asarray(infer.KITTI_LIDAR_TO_IMAGE[None]),
             "points": jnp.zeros((1, 1024, 4)), "points_mask": jnp.ones((1, 1024), bool),
             "batch_size": 1}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False),
                            batch)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model = build_network(cfg.MODEL, 3, meta, device="cpu")
    model.load_state_dict(state, strict=True)
    vfe, collapse, _, head = model.module_list
    assert vfe.ddn.n_blocks == 33 and collapse.collapse.in_channels == 25 * 64
    # 80 depth logits: the reference's DDN adds an out-of-range bin (81)
    assert vfe.ddn.classifier.out_channels == 80
    assert head.anchors.shape == (157920, 7)


def test_processor_steps_at_odd_sizes():
    """downsample_depth_map (edge blocks zero-padded) and calculate_grid_size
    against the JAX data processor: exact."""
    steps = [EDict({"NAME": "calculate_grid_size", "VOXEL_SIZE": [0.16, 0.16, 0.16]}),
             EDict({"NAME": "downsample_depth_map", "DOWNSAMPLE_FACTOR": 4})]
    pcr = np.array([2, -30.08, -3.0, 46.8, 30.08, 1.0])
    jdp = JDataProcessor(steps, point_cloud_range=pcr, training=True, num_point_features=4)
    dp = DataProcessor(steps, point_cloud_range=pcr, training=True, num_point_features=4)
    np.testing.assert_array_equal(dp.grid_size, jdp.grid_size)
    np.testing.assert_array_equal(dp.grid_size, [280, 376, 25])
    rng = np.random.RandomState(9)
    for h, w in ((375, 1242), (9, 7), (8, 5)):
        dm = rng.uniform(0, 80, (h, w)).astype(np.float32)
        want = jdp.forward({"depth_maps": dm.copy()})["depth_maps"]
        got = dp.forward({"depth_maps": dm.copy()})["depth_maps"]
        assert got.shape == (-(-h // 4), -(-w // 4))
        np.testing.assert_array_equal(got, want)


class _FixedDDN(torch.nn.Module):
    """A depth network that returns given feature and logit maps."""

    def __init__(self, feats, logits):
        super().__init__()
        self.feats, self.logits = feats, logits

    def forward(self, images):
        return self.feats, self.logits


def _fixed_vfe():
    """The tiny ImageVFE on a fixed network: features that name their pixel
    (1000 v + u + c / 100) and seeded logits; hf, wf = 8, 12, 16 bins."""
    cfg, geom, b = _vfe_case(False)
    vfe = ImageVFE(cfg, downsample_factor=8, **geom)
    v, u, c = np.meshgrid(np.arange(8), np.arange(12), np.arange(16), indexing="ij")
    feats = np.broadcast_to((1000.0 * v + u + c / 100.0)[None], (2, 8, 12, 16))
    logits = np.random.RandomState(12).randn(2, 8, 13, 16)   # one more logit column
    vfe.ddn = _FixedDDN(_t(feats.astype(np.float32)), _t(logits.astype(np.float32)))
    return vfe, b, feats, logits


def test_departures_from_the_reference():
    """Where the JAX CaDDN departs from OpenPCDet's, the port follows the JAX
    package (ROADMAP §C): (1) each voxel takes the feature of the one pixel
    its centre projects into, the coordinate truncated (the reference
    samples the frustum bilinearly), times the softmax probability of its
    LID bin there, and the last logit column (wider than the features) is
    read nowhere; (2) the depth loss is mean((1 - pt)^2 nll) over the
    supervised points, no alpha (the reference's DDNLoss takes alpha 0.25);
    (3) its targets come from the points' projections: `depth_maps` is read
    nowhere."""
    vfe, b, feats, logits = _fixed_vfe()
    vfe.eval()
    with torch.no_grad():
        vol = vfe(dict({k: _t(a) for k, a in b.items()}))["spatial_features_3d"].numpy()
    nx, ny, nz = JMETA.grid_size
    x0, y0, z0 = JMETA.point_cloud_range[:3]
    vs = JMETA.voxel_size
    gx, gy, gz = ((np.arange(n) + 0.5) * s + o for n, s, o in zip((nx, ny, nz), vs, (x0, y0, z0)))
    X, Y, Z = np.meshgrid(gx, gy, gz, indexing="ij")
    u, v = (-50 * Y + 48) / X / 8, (-50 * Z + 32) / X / 8     # exact in f32 here
    inside = (u >= 0) & (u < 12) & (v >= 0) & (v < 8) & (X > 1.0) & (X < 20.0)
    ui, vi = np.clip(u.astype(int), 0, 11), np.clip(v.astype(int), 0, 7)
    bins = lid_to_bin(_t(X.astype(np.float32)), 16, 1.0, 20.0).numpy()
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = feats[0][vi, ui] * prob[0][vi, ui, bins][..., None] * inside[..., None]
    np.testing.assert_allclose(vol[0], want, rtol=1e-5, atol=1e-6)
    assert inside.sum() > 1000 and not np.array_equal(prob[0][:, 12], prob[0][:, 11])

    vfe.train()
    batch = dict({k: _t(a) for k, a in b.items()})
    loss = float(vfe(dict(batch))["loss_depth"])
    pts = b["points"][..., :3].astype(np.float64)
    pu = ((-50 * pts[..., 1] + 48) / pts[..., 0] / 8).astype(int)
    pv = ((-50 * pts[..., 2] + 32) / pts[..., 0] / 8).astype(int)
    ok = (pu >= 0) & (pu < 12) & (pv >= 0) & (pv < 8) & (pts[..., 0] > 1) & (pts[..., 0] < 20)
    pbins = lid_to_bin(_t(pts[..., 0].astype(np.float32)), 16, 1.0, 20.0).numpy()
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    nll = -np.take_along_axis(logp[np.arange(2)[:, None], np.clip(pv, 0, 7), np.clip(pu, 0, 11)],
                              pbins[..., None], -1)[..., 0]
    want_loss = ((1 - np.exp(-nll)) ** 2 * nll * ok).sum() / ok.sum()
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    depth_maps = _t(np.random.RandomState(13).uniform(0, 80, (2, 16, 24)).astype(np.float32))
    assert float(vfe(dict(batch, depth_maps=depth_maps))["loss_depth"]) == loss
    moved = dict(batch, points=batch["points"].clone())
    moved["points"][:, :, 0] += 1.0
    assert float(vfe(moved)["loss_depth"]) != loss
