"""OpenPCDet's cbgs_pp_multihead.yaml in the port against the JAX package on
the CPU: the BEV backbone's strided-conv deblock (an upsample stride below 1)
and its deblock_final, the tiny multi-head (tiny.pp_multihead_model_cfg:
the config's ten anchor classes, sin / cos coder, strided first deblock and
shared conv at tiny widths) whole, and the full-width config.

  * BaseBEVBackbone with UPSAMPLE_STRIDES [0.5, 1, 2, 2] (a strided-conv
    deblock0, a transposed deblock2, a deblock_final over the
    concatenation) on random weights: eval and train-mode outputs, the
    gradient of a fixed weighting of the output with respect to every
    weight and the BN statistics after the train-mode forward, against
    flax; the weights carried by `convert.from_flax_variables` with the
    port model (module types decide which kernels flip);
  * the tiny multi-head on `tiny.pp_multihead_state()` (carried to flax by
    `convert.to_flax_variables` with the model): eval outputs and
    post-processed predictions, the committed golden
    data/pp_multihead_tiny_forward.npz, and one training step's loss, tb
    terms, every gradient and the BN statistics;
  * the full-width config: both packages build it from the yaml, the flax
    tree of its JAX init (eval_shape) loads strictly into the port's model,
    327,680 anchors on a 128 x 128 x 384 map.

Tolerances: the golden one for outputs (atol 1e-3 * max(1, max|want|),
rtol 1e-3; sums in another order); labels, counts and indices exact; the
training step as tests/test_torch_second_train.py holds it (loss and tb
terms 1e-4, gradients rtol 1e-3 above the JAX gradient's rounding floor, BN
statistics 1e-5); the golden against the JAX package 1e-5. The PFN's
gradients are held against the JAX package's PillarVFE run without jit on
the jitted model's cotangent at the pillar features: XLA's CPU compile of the
whole jitted step splits the pillar max-pool's gradient among the pooled
points otherwise than the JAX function does without jit (pfn_0's gradient
1.2 of 11.3 apart; every other gradient, and the unjitted whole step's
pfn_0, within the tolerance).

The golden is regenerated with
    python -c "from tests.test_torch_pp_multihead import write_pp_multihead_golden; write_pp_multihead_golden()"
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.backbones_2d.base_bev_backbone import (
    BaseBEVBackbone as JBEV,
)
from tsm_det_pointcloud_tpu.models.backbones_3d.vfe import PillarVFE as JPillarVFE
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.backbones_2d.base_bev_backbone import BaseBEVBackbone
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

PP_CFG = infer.ROOT / "tools/cfgs/nuscenes_models/cbgs_pp_multihead.yaml"
META = tiny.PP_MULTIHEAD_META
_JMODEL = jbuild(tiny.pp_multihead_model_cfg(), num_class=10,
                 dataset=JDatasetMeta(**dataclasses.asdict(META)))
FORWARD = ("cls_preds", "box_preds", "batch_cls_preds", "batch_box_preds",
           "spatial_features_2d")
PRED = ("pred_boxes", "pred_scores", "pred_labels", "count")


def _t(a):
    return torch.from_numpy(np.array(a))


def _golden_close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3 * scale, rtol=1e-3,
                               err_msg=what)


def _port_model(state):
    model = build_network(tiny.pp_multihead_model_cfg(), 10, META, device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def _batch(training=False):
    b = {"points": tiny.nusc_points(2), "points_mask": np.ones((2, 512), bool)}
    if training:
        b["gt_boxes"], b["gt_boxes_mask"] = tiny.pp_multihead_gt(2)
    return b


@jax.jit
def _jax_eval(variables, b):
    out = _JMODEL.apply(variables, dict(b, batch_size=2), training=False)
    pred, _ = _JMODEL.apply(variables, out, method=lambda m, bd: m.post_processing(bd))
    return {k: out[k] for k in FORWARD}, {k: pred[k] for k in PRED}


@jax.jit
def _jax_loss_grad(variables, batch):
    def loss_fn(params):
        out, mutated = _JMODEL.apply(dict(variables, params=params), dict(batch, batch_size=2),
                                     training=True, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], mutated["batch_stats"])

    (loss, (tb, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return loss, tb, stats, grads


@jax.jit
def _jax_pillar_cotangent(variables, batch, vout):
    """d loss / d pillar_features of the jitted model: modules 1-3 and the
    head's loss on the VFE's outputs `vout`."""
    def rest(pf):
        bd = dict(batch, batch_size=2, pillar_features=pf, voxel_features=pf,
                  voxel_coords=vout["voxel_coords"], voxel_mask=vout["voxel_mask"])

        def run(mdl, bd):
            for m in mdl.module_list[1:]:
                bd = m(bd, training=True)
            return mdl.get_training_loss(bd)[0]

        return _JMODEL.apply(variables, bd, method=run, mutable=["batch_stats"])[0]

    return jax.grad(rest)(vout["pillar_features"])


def _jax_pfn_grads(variables, batch):
    """The PFN's gradients: the JAX PillarVFE without jit, its pillar
    features' cotangent from the jitted rest of the model."""
    vfe = JPillarVFE(model_cfg=dict(tiny.pp_multihead_model_cfg().VFE),
                     num_point_features=5, voxel_size=META.voxel_size,
                     point_cloud_range=META.point_cloud_range, max_voxels=META.max_voxels,
                     max_points_per_voxel=META.max_points_per_voxel)
    vv = {c: variables[c]["module_list_0"] for c in ("params", "batch_stats")}
    pts = {k: jnp.asarray(batch[k]) for k in ("points", "points_mask")}
    vout, _ = vfe.apply(vv, dict(pts), training=True, mutable=["batch_stats"])
    cot = _jax_pillar_cotangent(variables, batch, vout)

    def pooled(params):
        out, _ = vfe.apply({**vv, "params": params}, dict(pts), training=True,
                           mutable=["batch_stats"])
        return jnp.sum(out["pillar_features"] * cot)

    return {"module_list_0": jax.grad(pooled)(vv["params"])}


@pytest.fixture(scope="module")
def state():
    return tiny.pp_multihead_state()


@pytest.fixture(scope="module")
def jvars(state):
    return to_flax_variables(state, _port_model(state))


def write_pp_multihead_golden():
    """Write the JAX eval outputs and predictions with tiny.pp_multihead_state()."""
    s = tiny.pp_multihead_state()
    out, pred = jax.tree_util.tree_map(
        np.asarray, _jax_eval(to_flax_variables(s, _port_model(s)), _batch()))
    np.savez_compressed(tiny.PP_MULTIHEAD_FORWARD_PATH,
                        **{k: out[k] for k in ("batch_cls_preds", "batch_box_preds")}, **pred)


@pytest.fixture(scope="module")
def jax_case(jvars):
    out, pred = jax.tree_util.tree_map(np.asarray, _jax_eval(jvars, _batch()))
    return dict(out=out, pred=pred)


def _bev_case():
    cfg = {"LAYER_NUMS": [1, 1, 1], "LAYER_STRIDES": [2, 2, 2], "NUM_FILTERS": [8, 8, 16],
           "UPSAMPLE_STRIDES": [0.5, 1, 2, 2], "NUM_UPSAMPLE_FILTERS": [8, 8, 8]}
    x = np.random.RandomState(11).randn(2, 16, 24, 6).astype(np.float32)
    return cfg, x


@pytest.mark.parametrize("training", [False, True])
def test_strided_and_final_deblocks(training):
    """deblock0 a strided Conv (2 x 2, stride 2), deblock_final a transposed
    conv over the 24-channel stride-4 concatenation back to stride 2: the
    outputs, every weight's gradient and (in train mode) the BN statistics
    of the flax module."""
    cfg, x = _bev_case()
    jm = JBEV(model_cfg=cfg, input_channels=6)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(2), {"spatial_features": a}),
                            jnp.asarray(x))
    rng = np.random.RandomState(12)
    v = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * (0.5 if len(a.shape) > 1 else 0.2)
                   + (1.0 if len(a.shape) == 1 else 0.0)).astype(np.float32), dict(shapes))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    w = rng.randn(2, 8, 12, 24).astype(np.float32)

    def jloss(params):
        if training:
            out, mut = jm.apply({**v, "params": params}, {"spatial_features": jnp.asarray(x)},
                                training=True, mutable=["batch_stats"])
        else:
            out, mut = jm.apply({**v, "params": params},
                                {"spatial_features": jnp.asarray(x)}), {}
        y = out["spatial_features_2d"]
        return jnp.sum(y * w), (y, mut)

    (_, (jy, mut)), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])
    port = BaseBEVBackbone(cfg, 6)
    assert isinstance(port.deblock0, torch.nn.Conv2d)
    assert isinstance(port.deblock_final, torch.nn.ConvTranspose2d)
    assert port.get_output_feature_dim() == 24 and jm.get_output_feature_dim() == 48
    port.load_state_dict(from_flax_variables(v, port), strict=True)
    port.train(training)
    y = port({"spatial_features": _t(x)})["spatial_features_2d"]
    assert y.shape == (2, 8, 12, 24)
    (y * _t(w)).sum().backward()
    _golden_close(y.detach().numpy(), jy, "output")
    want = from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, jgrad)}, port)
    params = dict(port.named_parameters())
    assert set(want) == set(params)
    for k, g in want.items():
        _golden_close(params[k].grad.numpy(), g.numpy(), f"d/d {k}")
    if training:
        stats = from_flax_variables({"batch_stats": jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"])}, port)
        sd = port.state_dict()
        for k, s in stats.items():
            np.testing.assert_allclose(sd[k].numpy(), s.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_whole_tiny_multihead_and_post_processing(state, jax_case):
    """Eval outputs (the 8-column sin / cos box codes, 1280 anchors) and the
    post-processed predictions of the JAX model."""
    out, pred = infer.detect(_port_model(state), _t(tiny.nusc_points(2)),
                             torch.ones(2, 512, dtype=torch.bool))
    jout, jpred = jax_case["out"], jax_case["pred"]
    assert out["box_preds"].shape == (2, 1280, 8)
    for k in FORWARD:
        _golden_close(out[k], jout[k], k)
    np.testing.assert_array_equal(pred["count"].numpy(), jpred["count"])
    assert jpred["count"].min() > 1, "the case must reach NMS"
    np.testing.assert_array_equal(pred["pred_labels"].numpy(), jpred["pred_labels"])
    _golden_close(pred["pred_scores"], jpred["pred_scores"], "scores")
    _golden_close(pred["pred_boxes"], jpred["pred_boxes"], "boxes")


def test_golden_is_current_and_reproduces(state, jax_case):
    """The committed golden equals the JAX package's outputs now (1e-5), and
    the port reproduces it at the golden tolerance."""
    golden = np.load(tiny.PP_MULTIHEAD_FORWARD_PATH)
    for k in ("batch_cls_preds", "batch_box_preds"):
        np.testing.assert_allclose(golden[k], jax_case["out"][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k in PRED:
        np.testing.assert_allclose(golden[k], jax_case["pred"][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    out, pred = infer.detect(_port_model(state), _t(tiny.nusc_points(2)),
                             torch.ones(2, 512, dtype=torch.bool))
    for k in ("batch_cls_preds", "batch_box_preds"):
        _golden_close(out[k], golden[k], k)
    np.testing.assert_array_equal(pred["count"].numpy(), golden["count"])


@pytest.fixture(scope="module")
def train_case(state, jvars):
    loss, tb, stats, grads = jax.tree_util.tree_map(
        np.asarray, _jax_loss_grad(jvars, _batch(training=True)))
    grads = dict(grads, **jax.tree_util.tree_map(np.asarray,
                                                 _jax_pfn_grads(jvars, _batch(training=True))))
    model = _port_model(state).train()
    b = _batch(training=True)
    out = model({**{k: _t(v) for k, v in b.items()}, "batch_size": 2})
    out["loss"].backward()
    return dict(loss=loss, tb=tb, stats=from_flax_variables({"batch_stats": stats}, model),
                grads=from_flax_variables({"params": grads}, model), model=model, out=out)


def test_train_loss_tb_terms_and_gradients(train_case):
    out, model, grads = train_case["out"], train_case["model"], train_case["grads"]
    np.testing.assert_allclose(float(out["loss"].detach()), float(train_case["loss"]), rtol=1e-4,
                               atol=1e-4)
    assert set(out["tb_dict"]) == set(train_case["tb"])
    for k, v in train_case["tb"].items():
        np.testing.assert_allclose(float(out["tb_dict"][k].detach()), float(v), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert float(train_case["tb"]["rpn_loss_loc"]) > 0
    scale = max(float(g.abs().max()) for g in grads.values())
    assert {n for n, _ in model.named_parameters()} == set(grads)
    for name, p in model.named_parameters():
        want = grads[name].numpy()
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=atol, err_msg=name)
    assert float(grads["module_list.2.deblock0.weight"].abs().max()) > 0


def test_train_batch_stats(train_case):
    state = train_case["model"].state_dict()
    stats = train_case["stats"]
    assert "module_list.2.deblock0_bn.running_mean" in stats
    for key, want in stats.items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_full_width_config_builds_in_both_packages():
    """cbgs_pp_multihead.yaml: the flax tree of the JAX init (eval_shape, no
    forward) maps onto the port's model, strict=True; 512 x 512 pillars of up
    to 20 points, 30000 a scan, 327,680 anchors, a 384-channel BEV map, the
    8-column sin / cos code, a strided-conv deblock0."""
    cfg = infer.load_cfg(PP_CFG)
    meta = infer.dataset_meta(cfg, 300000)
    jmodel = jbuild(cfg.MODEL, num_class=10, dataset=JDatasetMeta(**meta.__dict__))
    batch = {"points": jnp.zeros((1, 300000, 5), jnp.float32),
             "points_mask": jnp.ones((1, 300000), bool), "batch_size": 1}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False),
                            batch)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = build_network(cfg.MODEL, 10, meta, device="cpu")
    state = from_flax_variables(variables, model)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model.load_state_dict(state, strict=True)
    assert meta.grid_size == (512, 512, 1) and meta.max_points_per_voxel == 20
    assert meta.max_voxels == 30000
    head = model.module_list[-1]
    assert head.anchors.shape == (327680, 7) and head.box_coder.code_size == 8
    assert model.module_list[2].get_output_feature_dim() == 384
    assert isinstance(model.module_list[2].deblock0, torch.nn.Conv2d)
    assert variables["params"]["module_list_2"]["deblock0"]["kernel"].shape == (2, 2, 64, 128)
