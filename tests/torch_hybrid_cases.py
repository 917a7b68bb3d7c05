"""The JAX side of the checks of the port's BEV / point hybrids, its
VoxelPointCross neck and the tiny DSASNets (tests/test_torch_dsasnet.py,
tests/test_torch_point_bev_hybrids.py). Imports JAX: the CPU tests' helper
only.

Modules run on the synthetic pyramid of tests/test_experimental_variants.py
(`make_pyramid`: x_conv2-4 as sorted-key sparse tensors over a 16 x 16 x 4 m
range, a 16 x 16 x 32 BEV map, 256 points), each in one jit a module: its
eval forward, its training forward (BN statistics and class statistics
mutated) and the gradient of a fixed random projection of its outputs
(`ModuleCase`). The tiny detectors (`tiny.dsasnet_model`) run in one jit
each too: the eval forward with post-processing and the training step
(`DetectorCase`). Both sides take the port's state (`tiny.redraw_state`
draws for the modules, `tiny.dsasnet_state` for the detectors) through
`convert.to_flax_variables`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_experimental_variants import POOL, PCR, VOXEL, make_pyramid  # noqa: F401 (re-exported)
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.pointnet2_modules import BatchNorm
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.spconv_backbone import SparseTensor

# make_pyramid's levels: (channels, grid (gz, gy, gx), stride)
PYRAMID = {"x_conv2": (8, (20, 16, 16), 2), "x_conv3": (16, (10, 8, 8), 4),
           "x_conv4": (16, (5, 4, 4), 8)}
SOURCE_CHANNELS = {s: v[0] for s, v in PYRAMID.items()}
# added to the channels-last BN biases of the modules' checks (`ModuleCase`'s
# `lift`), as tiny.TWO_STAGE_TRAIN_BN_LIFT in the detectors' (no ReLU input
# within rounding of 0)
BN_LIFT = 3.0
PRED = ("pred_boxes", "pred_scores", "pred_labels", "count")
DET_EVAL = ("point_coords", "point_valid", "point_features", "spatial_features_2d",
            "batch_cls_preds", "batch_box_preds", "rois", "roi_labels")


def t(a):
    return torch.from_numpy(np.array(a))


def pyramid_batch():
    """make_pyramid() as numpy (JAX side) and as torch (port side)."""
    bd = make_pyramid()
    msf = {k: (np.asarray(st.features), np.asarray(st.coords), np.asarray(st.valid), st.grid,
               st.stride) for k, st in bd["multi_scale_3d_features"].items()}
    plain = {k: np.asarray(v) for k, v in bd.items()
             if k not in ("multi_scale_3d_features", "multi_scale_3d_strides", "batch_size",
                          "encoded_spconv_tensor_stride")}
    port = {k: t(v) for k, v in plain.items() if k != "accumulated_iter"}
    port.update(
        batch_size=2, accumulated_iter=0, encoded_spconv_tensor_stride=8,
        multi_scale_3d_strides=dict(bd["multi_scale_3d_strides"]),
        multi_scale_3d_features={k: SparseTensor(t(f), t(c), t(v), g, s)
                                 for k, (f, c, v, g, s) in msf.items()})
    return bd, port


def _port_state(module, seed, lift):
    """The port module's state dict redrawn (`tiny.redraw_state`), its
    channels-last BN biases lifted by `lift`."""
    lifted = {f"{n}.bias" for n, m in module.named_modules() if isinstance(m, BatchNorm)}
    return {k: torch.from_numpy((v + lift if k in lifted else v).astype(np.float32))
            for k, v in tiny.redraw_state(module.state_dict(), seed).items()}


def projection(shapes, seed=7):
    """Fixed random weights of the outputs a gradient check sums."""
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


class ModuleCase:
    """A JAX module and its port on the pyramid batch, on the port's redrawn
    state (`state`). `run()` gives the JAX eval outputs `keys`, the training
    outputs and the mutated collections (port state dicts), in f32; and, in
    f64 (`jax.enable_x64`, every variable and float input widened), the
    gradient (port names) of sum(w_k * out_k) over `loss_keys` in a
    training forward: f32 gradients of these modules keep ~2 digits in
    either package (the JAX package's f32 step against its f64 one: 1e-2
    relative), the f64 ones meet the gradient tolerance."""

    def __init__(self, jmodule, port, keys, loss_keys, seed=21, lift=BN_LIFT, extra=None):
        self.jmodule, self.port, self.keys = jmodule, port, tuple(keys)
        self.loss_keys = tuple(loss_keys)
        self.state = _port_state(port, seed, lift)
        port.load_state_dict(self.state, strict=True)
        self.bd, self.port_bd = pyramid_batch()
        for k, v in (extra or {}).items():   # more numpy inputs, on both sides
            self.bd[k] = jnp.asarray(v)
            self.port_bd[k] = t(v)

    def run(self):
        bd, keys, m = self.bd, self.keys, self.jmodule

        def fwd(v):
            ev = m.apply(v, dict(bd), training=False)
            out, mut = m.apply(v, dict(bd), training=True, mutable=["batch_stats", "statistics"])
            return {k: ev[k] for k in keys}, {k: out[k] for k in keys}, mut

        variables = to_flax_variables(self.state)
        ev, tr, mut = jax.tree_util.tree_map(np.asarray, jax.jit(fwd)(variables))
        self.weights = projection({k: tr[k].shape for k in self.loss_keys})
        with jax.enable_x64(True):
            bd64, w = _widen(bd), {k: jnp.asarray(v, jnp.float64) for k, v in self.weights.items()}
            v64 = _widen(variables)

            def lf(p):
                out, _ = m.apply(dict(v64, params=p), dict(bd64), training=True,
                                 mutable=["batch_stats", "statistics"])
                return sum((out[k] * w[k]).sum() for k in self.loss_keys)

            g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       jax.jit(jax.grad(lf))(v64["params"]))
        return dict(eval=ev, train=tr, stats=from_flax_variables({k: mut[k] for k in mut}),
                    grads=from_flax_variables({"params": g}))

    def port_run(self):
        """The port's eval outputs and training outputs (one training
        forward, from the state: its BN statistics and class statistics
        move), in f32."""
        self.port.load_state_dict(self.state, strict=True)
        self.port.float().eval()
        with torch.no_grad():
            ev = self.port(dict(self.port_bd))
            ev = {k: ev[k] for k in self.keys}
            tr = self.port.train()(dict(self.port_bd))
        return ev, {k: tr[k] for k in self.keys}

    def port_grads(self):
        """The port's f64 training forward and the backward of the
        projection, from the state; the module keeps its gradients."""
        self.port.load_state_dict(self.state, strict=True)
        self.port.double().train()
        self.port.zero_grad(set_to_none=True)
        tr = self.port(_widen_port(self.port_bd))
        sum((tr[k] * torch.from_numpy(self.weights[k]).double()).sum()
            for k in self.loss_keys).backward()
        return self.port


def _widen(tree):
    """Every float leaf of a JAX pytree (SparseTensors included) in f64."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        else a, tree)


def _widen_port(bd):
    out = {}
    for k, v in bd.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            v = v.double()
        elif k == "multi_scale_3d_features":
            v = {s: st._replace(features=st.features.double()) for s, st in v.items()}
        out[k] = v
    return out


class DetectorCase:
    """A tiny DSASNet (or the neck's PVSSDA) in the JAX package, in one jit:
    its eval forward and post-processing on `tiny.dsasnet_state(which)`
    and its training step on `tiny.dsasnet_state(which, train=True)`."""

    def __init__(self, which):
        cfg, meta = tiny.dsasnet_model(which)
        self.which, self.cfg, self.meta = which, cfg, meta
        self.model = jbuild(cfg, num_class=1, dataset=JDatasetMeta(**dataclasses.asdict(meta)))

    def run(self):
        m = self.model
        eval_vars = to_flax_variables(tiny.dsasnet_state(self.which))
        train_vars = to_flax_variables(tiny.dsasnet_state(self.which, train=True))
        eb, tb = batch(), batch(train=True)

        def fn(ev_vars, tr_vars):
            out = m.apply(ev_vars, dict(eb, batch_size=2), training=False)
            pred, _ = m.apply(ev_vars, out, method=lambda mm, bd: mm.post_processing(bd))

            def lf(p):
                o, mut = m.apply(dict(tr_vars, params=p), dict(tb, batch_size=2),
                                 training=True, mutable=["batch_stats", "statistics"])
                return o["loss"], (o["tb_dict"], mut)

            (loss, (tbd, mut)), g = jax.value_and_grad(lf, has_aux=True)(tr_vars["params"])
            return {k: out[k] for k in DET_EVAL if k in out}, pred, loss, tbd, mut, g

        out, pred, loss, tbd, mut, g = jax.tree_util.tree_map(
            np.asarray, jax.jit(fn)(eval_vars, train_vars))
        return dict(out=out, pred=pred, loss=float(loss), tb=tbd,
                    stats=from_flax_variables({k: mut[k] for k in mut}),
                    grads=from_flax_variables({"params": g}))

    def port(self, train=False):
        model = build_network(self.cfg, 1, self.meta, device="cpu")
        model.load_state_dict(tiny.dsasnet_state(self.which, train=train), strict=True)
        return model.train(train)


def batch(train=False):
    pts = tiny.second_points(2, 256)
    b = {"points": pts, "points_mask": np.ones(pts.shape[:2], bool),
         "accumulated_iter": np.int32(0)}
    if train:
        b["gt_boxes"], b["gt_boxes_mask"] = tiny.pvssda_gt()
    return b


def port_batch(train=False):
    b = {k: t(v) for k, v in batch(train).items() if k != "accumulated_iter"}
    return dict(b, batch_size=2, accumulated_iter=0)


def close(got, want, what, rtol=1e-3):
    """The golden tolerance: atol rtol * max(1, max|want|), rtol."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=rtol, err_msg=what)


def check_grads(named_parameters, grads, what=""):
    """Every gradient against the JAX one (rtol 1e-3, atol 1e-4 * max(the
    tensor's largest |g|, 1e-2 * the largest |g| of all)); a parameter the
    port's backward did not reach must have a zero JAX gradient. Returns
    the names of those."""
    scale = max(float(g.abs().max()) for g in grads.values())
    params = dict(named_parameters)
    assert set(params) == set(grads), what
    idle = set()
    for name, p in params.items():
        want = grads[name].numpy()
        if p.grad is None:
            assert not want.any(), f"{what} {name}: no port gradient, JAX's is not zero"
            idle.add(name)
            continue
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=atol,
                                   err_msg=f"{what} {name}")
    return idle


def check_stats(state, stats, what=""):
    """BN running statistics and class statistics after a step: atol 1e-5 *
    max(1, max|want|), rtol 1e-4 (a class statistic is a mean or a maximum
    over features that sums ran in another order)."""
    for key, want in stats.items():
        w = want.numpy()
        np.testing.assert_allclose(state[key].numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"{what} {key}")

