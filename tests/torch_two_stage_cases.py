"""The JAX side of the tiny two-stage detectors' checks
(tests/test_torch_parta2.py, tests/test_torch_pvrcnn.py,
tests/test_torch_pointrcnn.py): the JAX model of
`tiny.two_stage_model(which)` on `tiny.second_points(2, 256)`, its jitted
eval forward with post-processing and its jitted training step, with the
port state `tiny.two_stage_state(which)` converted to flax variables
(`convert.to_flax_variables`). Imports JAX: the CPU tests' helper only.

The committed goldens `data/parta2_tiny_forward.npz`,
`data/pvrcnn_tiny_forward.npz` and `data/pvrcnnplusplus_tiny_forward.npz`
(FORWARD keys of the eval forward and the post-processed predictions) are
regenerated with
    python -c "from tests.torch_two_stage_cases import write_forward; write_forward('parta2'); write_forward('pvrcnn'); write_forward('pvrcnnplusplus')"
(PointRCNN's, with its state, by tests/test_torch_pointrcnn.py's
write_pointrcnn_tiny_files).
"""
import dataclasses

import jax
import numpy as np
import torch

from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network

N_POINTS = 256
# the eval outputs a golden keeps, and the post-processed predictions
FORWARD = ("batch_cls_preds", "batch_box_preds", "rois", "roi_labels")
PRED = ("pred_boxes", "pred_scores", "pred_labels", "count")
# the training forward's outputs the module checks read
TRAIN_AUX = ("voxel_features", "voxel_coords", "voxel_mask", "spatial_features_2d",
             "cls_preds", "box_preds", "dir_cls_preds", "point_coords", "point_valid",
             "point_features", "point_cls_scores", "point_features_before_fusion",
             "point_part_offset", "point_cls_preds", "point_box_preds_raw", "rois",
             "roi_labels", "batch_cls_preds", "batch_box_preds")


def forward_path(which):
    return {"parta2": tiny.PARTA2_FORWARD_PATH, "pvrcnn": tiny.PVRCNN_FORWARD_PATH,
            "pointrcnn": tiny.POINTRCNN_FORWARD_PATH,
            "voxelrcnn": tiny.VOXELRCNN_FORWARD_PATH,
            "secondnetiou": tiny.SECONDNETIOU_FORWARD_PATH,
            "pvrcnnplusplus": tiny.PVRCNNPLUSPLUS_FORWARD_PATH}[which]


def points():
    return {"points": tiny.second_points(2, N_POINTS),
            "points_mask": np.ones((2, N_POINTS), bool)}


def train_batch(which):
    gt, gmask = tiny.two_stage_gt(which)
    return dict(points(), gt_boxes=gt, gt_boxes_mask=gmask)


def t(a):
    return torch.from_numpy(np.array(a))


def port_model(which, train=False):
    """The port model on `tiny.two_stage_state(which, train=train)`, in
    train mode with `train`."""
    cfg, meta = tiny.two_stage_model(which)
    model = build_network(cfg, 1, meta, device="cpu")
    model.load_state_dict(tiny.two_stage_state(which, train=train), strict=True)
    return model.train(train)


def relu_input_margin(model, batch):
    """The smallest |output| of the model's channels-last and 2D BNs over
    their masked rows in one forward of `batch`: every one of them feeds a
    ReLU. The training checks need it well above the two packages' rounding
    distance (tiny.TWO_STAGE_TRAIN_BN_LIFT)."""
    from torch import nn

    from tsm_det_pointcloud_tpu_torch.models.backbones_3d.pointnet2_modules import BatchNorm

    mins = []

    def hook(module, inputs, out):
        if len(inputs) > 1 and inputs[1] is not None:
            out = out[inputs[1]]
        if out.numel():
            mins.append(float(out.abs().min()))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (BatchNorm, nn.BatchNorm2d))]
    with torch.no_grad():
        model(dict(batch))
    for h in handles:
        h.remove()
    return min(mins)


class JaxCase:
    """The JAX model of the tiny `which` and its jitted eval and training
    functions (each compiled at its first call)."""

    def __init__(self, which, eval_keys=()):
        cfg, meta = tiny.two_stage_model(which)
        self.which = which
        self.model = jbuild(cfg, num_class=1, dataset=JDatasetMeta(**dataclasses.asdict(meta)))
        self.eval_keys = tuple(eval_keys)
        self._eval = jax.jit(self._eval_fn)
        self._train = jax.jit(self._train_fn)

    def _eval_fn(self, variables, b):
        out = self.model.apply(variables, dict(b, batch_size=2), training=False)
        pred, _ = self.model.apply(variables, out, method=lambda m, bd: m.post_processing(bd))
        keep = {k: out[k] for k in FORWARD + self.eval_keys if not k.startswith("x_conv")}
        for k in self.eval_keys:     # a sparse level as (features, coords, valid)
            if k.startswith("x_conv"):
                st = out["multi_scale_3d_features"][k]
                keep[k] = (st.features, st.coords, st.valid)
        return keep, pred

    def _train_fn(self, variables, b):
        def loss_fn(params):
            out, mutated = self.model.apply(dict(variables, params=params),
                                            dict(b, batch_size=2), training=True,
                                            mutable=["batch_stats"])
            aux = {k: out[k] for k in TRAIN_AUX if k in out}
            return out["loss"], (out["tb_dict"], mutated["batch_stats"], aux)

        (loss, (tb, stats, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        return loss, tb, stats, grads, aux

    def eval(self):
        """(eval outputs, predictions) as numpy, on `points()`, with
        `tiny.two_stage_state(which)`."""
        variables = to_flax_variables(tiny.two_stage_state(self.which))
        return jax.tree_util.tree_map(np.asarray, self._eval(variables, points()))

    def train(self):
        """The training step on `train_batch` from
        `tiny.two_stage_state(which, train=True)`: dict of loss, tb, stats
        and grads (port state dicts) and aux (numpy)."""
        variables = to_flax_variables(tiny.two_stage_state(self.which, train=True))
        loss, tb, stats, grads, aux = jax.tree_util.tree_map(
            np.asarray, self._train(variables, train_batch(self.which)))
        return dict(loss=loss, tb=tb, aux=aux,
                    stats=from_flax_variables({"batch_stats": stats}),
                    grads=from_flax_variables({"params": grads}))


def write_forward(which):
    """Write the JAX eval outputs and predictions of `tiny.two_stage_state`."""
    out, pred = JaxCase(which).eval()
    np.savez_compressed(forward_path(which), **{k: out[k] for k in FORWARD},
                        **{k: pred[k] for k in PRED})


def golden_close(got, want, what):
    """The golden tolerance: atol 1e-3 * max(1, max|want|), rtol 1e-3."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3 * scale, rtol=1e-3,
                               err_msg=what)


def close_scalar(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-4 * max(1.0, abs(float(want))), err_msg=what)


def check_gradients(model, grads):
    """Every parameter's gradient against the JAX one: rtol 1e-3, atol 1e-4
    * max(the tensor's largest |g|, 1e-2 * the largest |g| of the model)."""
    scale = max(float(g.abs().max()) for g in grads.values())
    assert {n for n, _ in model.named_parameters()} == set(grads)
    for name, p in model.named_parameters():
        want = grads[name].numpy()
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=atol, err_msg=name)


def check_batch_stats(model, stats):
    state = model.state_dict()
    assert len(stats) == 2 * sum(1 for k in state if k.endswith("running_mean"))
    for key, want in stats.items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def sub_variables(variables, path):
    """The flax variables of the submodule at `path` (a tuple of names)."""
    out = {}
    for coll, tree in variables.items():
        for p in path:
            tree = tree.get(p, {})
        if tree:
            out[coll] = tree
    return out


def full_width_state(cfg_path):
    """(flax variables of the config's JAX init by eval_shape, zeros, no
    forward; the port model; its DatasetMeta), with the config's classes."""
    import jax.numpy as jnp

    from tsm_det_pointcloud_tpu_torch import infer

    cfg = infer.load_cfg(cfg_path)
    meta = infer.dataset_meta(cfg, 20000)
    n_cls = len(cfg.CLASS_NAMES)
    jmodel = jbuild(cfg.MODEL, num_class=n_cls, dataset=JDatasetMeta(**dataclasses.asdict(meta)))
    batch = {"points": jnp.zeros((1, 20000, 4), jnp.float32),
             "points_mask": jnp.ones((1, 20000), bool), "batch_size": 1}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False),
                            batch)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return variables, build_network(cfg.MODEL, n_cls, meta, device="cpu"), meta
