"""The port's nuScenes CenterPoint (CenterHead's velocity branch) against the
JAX package on the CPU.

The tiny nuScenes CenterPoint (tiny.py: two class groups, a `vel` head each,
5 point features) on `tiny.centerpoint_nusc_state()`: its eval outputs (9-
column decoded boxes) and post-processed predictions, the committed golden,
the decode with a velocity map and the velocity targets at code_size 10, the
post-processing on the JAX package's decoded boxes (with the recall dict on
10-column gt), one training step's loss, tb terms, every gradient, the BN
statistics and the parameters after one adam_onecycle step of the nuScenes
config's OPTIMIZATION, the velocity the detector drops before NDS, and
cbgs_voxel01_res3d_centerpoint.yaml's full-width flax tree loaded strictly.

Tolerances: labels, counts, indices and masks exact; the eval outputs and
the loss and tb terms rtol 1e-5 (atol 1e-5 times the largest magnitude of
the output); the targets 1e-6; gradients rtol 1e-3 above the JAX gradient's
rounding floor and the optimizer step as tests/test_torch_second_train.py
holds them; the golden against the JAX package now 1e-5.

The golden data/centerpoint_nusc_tiny_forward.npz (the JAX eval outputs and
predictions on tiny.nusc_points(2)) is regenerated with
    python -c "from tests.test_torch_centerpoint_nusc import write_centerpoint_nusc_golden; write_centerpoint_nusc_golden()"
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tsm_det_pointcloud_tpu.datasets.nuscenes.nuscenes_dataset import (
    NuScenesDataset as JNuScenesDataset,
)
from tsm_det_pointcloud_tpu.eval import nuscenes_eval as jnds
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu.models.model_utils import centernet_utils as jcn
from tsm_det_pointcloud_tpu.runtime.optimization import build_optimizer as jbuild_optimizer
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset
from tsm_det_pointcloud_tpu_torch.eval import nuscenes_eval as nds
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.model_utils import centernet_utils as cn
from tsm_det_pointcloud_tpu_torch.runtime.optimization import build_optimizer
from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step

NUSC_CFG = infer.ROOT / "tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml"
META = tiny.CENTERPOINT_NUSC_META
JMETA = JDatasetMeta(**dataclasses.asdict(META))
_JMODEL = jbuild(tiny.centerpoint_nusc_model_cfg(), num_class=3, dataset=JMETA)
FINAL = ("final_boxes", "final_scores", "final_labels")
PRED = ("pred_boxes", "pred_scores", "pred_labels", "count")


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


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def _points():
    return {"points": tiny.nusc_points(2), "points_mask": np.ones((2, 512), bool)}


@jax.jit
def _jax_eval(variables, b):
    out = _JMODEL.apply(variables, dict(b, batch_size=2), training=False)
    pred, _ = _JMODEL.apply(variables, out, method=lambda m, bd: m.post_processing(bd))
    return {k: out[k] for k in FINAL}, pred


def write_centerpoint_nusc_golden():
    """Write the JAX eval outputs and predictions with
    tiny.centerpoint_nusc_state()."""
    out, pred = jax.tree_util.tree_map(
        np.asarray, _jax_eval(to_flax_variables(tiny.centerpoint_nusc_state()), _points()))
    np.savez_compressed(tiny.CENTERPOINT_NUSC_FORWARD_PATH, **out, **pred)


@pytest.fixture(scope="module")
def state():
    return tiny.centerpoint_nusc_state()


@pytest.fixture(scope="module")
def jax_case(state):
    out, pred = jax.tree_util.tree_map(np.asarray,
                                       _jax_eval(to_flax_variables(state), _points()))
    return dict(out=out, pred=pred)


def _port_model(state):
    model = build_network(tiny.centerpoint_nusc_model_cfg(), 3, META, device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def test_committed_forward_is_current(jax_case):
    """The committed golden is the JAX package's output now (1e-5): 9-column
    decoded boxes with nonzero velocities, scores at least 1e-6 apart in each
    group, some of them under SCORE_THRESH."""
    with np.load(tiny.CENTERPOINT_NUSC_FORWARD_PATH) as z:
        golden = {k: z[k] for k in z.files}
    want = {**jax_case["out"], **jax_case["pred"]}
    assert set(golden) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert golden["final_boxes"].shape == (2, 64, 9) and golden["pred_boxes"].shape[-1] == 7
    assert np.abs(golden["final_boxes"][..., 7:9]).min() > 0
    scores = golden["final_scores"]
    for part in (scores[:, :32], scores[:, 32:]):
        assert (-np.diff(part, axis=1)).min() > 1e-6
    assert (scores <= 0.1).any() and (scores > 0.1).any()


def test_forward_against_jax(jax_case, state):
    out, pred = infer.detect(_port_model(state), _t(tiny.nusc_points(2)),
                             torch.ones(2, 512, dtype=torch.bool))
    np.testing.assert_array_equal(out["final_labels"].numpy(), jax_case["out"]["final_labels"])
    for k in ("final_boxes", "final_scores"):
        _close(out[k].numpy(), jax_case["out"][k], k)
    for k in ("count", "pred_labels"):
        np.testing.assert_array_equal(pred[k].numpy(), jax_case["pred"][k], err_msg=k)
    for k in ("pred_boxes", "pred_scores"):
        _close(pred[k].numpy(), jax_case["pred"][k], k)


def test_post_processing_index_equal(jax_case, state):
    """The port's post-processing on the JAX package's 9-column decoded boxes
    (nms_gpu, pre 48, post 16): counts, labels, kept scores and 7-column
    boxes equal, and the recall dict on 10-column gt boxes."""
    gt, gmask = tiny.centerpoint_nusc_gt(2)
    bd = dict(jax_case["out"], gt_boxes=gt, gt_boxes_mask=gmask)
    jpred, jrec = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: _JMODEL.apply(v, b, method=lambda m, x: m.post_processing(x)))(
        to_flax_variables(state), bd))
    pred, rec = _port_model(state).post_processing({k: _t(v) for k, v in bd.items()})
    assert jpred["count"].min() > 0
    for k in PRED:
        np.testing.assert_array_equal(pred[k].numpy(), jpred[k], err_msg=k)
    assert set(rec) == set(jrec) and float(jrec["gt"]) == 10
    for k, v in jrec.items():
        np.testing.assert_allclose(float(rec[k]), float(v), err_msg=k)


def test_velocity_dropped_before_nds(jax_case):
    """The head decodes 9-column boxes, but the detector keeps 7 (as the JAX
    one does), so the prediction dicts carry no velocity and every matched
    class's AVE is undefined: mAVE is 1 in both packages, whose NDS on the
    same predictions are equal (ROADMAP §C)."""
    assert jax_case["out"]["final_boxes"].shape[-1] == 9
    names = ["car", "pedestrian", "barrier"]
    pred = jax_case["pred"]
    dicts = [{k: pred[k][b][:pred["count"][b]] for k in PRED[:3]} for b in range(2)]
    got = NuScenesDataset.generate_prediction_dicts({"metadata": [None, None]}, dicts, names)
    want = JNuScenesDataset.generate_prediction_dicts({"metadata": [None, None]}, dicts, names)
    assert all(a["boxes_lidar"].shape[-1] == 7 for a in got)
    # gt: the kept boxes themselves, velocities from the decode
    gt = []
    for b in range(2):
        fb = jax_case["out"]["final_boxes"][b]
        keep = [int(np.argmin(np.abs(fb[:, :7] - box).sum(1))) for box in dicts[b]["pred_boxes"]]
        gt.append({"name": got[b]["name"], "gt_boxes_lidar": fb[keep],
                   "num_lidar_pts": np.ones(len(keep), np.int64)})
    s_got, d_got = nds.nuscenes_evaluation(gt, got, names)
    s_want, d_want = jnds.nuscenes_evaluation(gt, want, names)
    assert s_got == s_want and d_got == d_want
    present = {str(n) for a in got for n in a["name"]}
    assert d_got["mAVE"] == 1.0 and present and all(d_got[f"{c}_AP"] > 0.99 for c in present)
    with_vel = [dict(a, boxes_lidar=g["gt_boxes_lidar"]) for a, g in zip(got, gt)]
    d_vel = nds.nuscenes_evaluation(gt, with_vel, names)[1]
    moving = present - {"barrier"}
    assert moving and all(d_vel[f"{c}_vel_err"] < 1e-6 for c in moving)
    assert all(d_got[f"{c}_vel_err"] == 1.0 for c in moving)


def test_decode_with_velocity():
    """The decode with a vel map over C x H x W = 12288 (JAX: approx_max_k,
    distinct scores): scores and labels exact, the 9-column boxes 1e-6."""
    rng = np.random.RandomState(3)
    B, C, H, W = 2, 3, 64, 64
    n = C * H * W
    hm = (np.stack([rng.permutation(n) for _ in range(B)]).astype(np.float32) / n).reshape(
        B, C, H, W)
    maps = {name: rng.randn(B, c, H, W).astype(np.float32)
            for name, c in (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2), ("vel", 2))}
    pcr, vs = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), (0.1, 0.1, 0.2)
    got = cn.decode_bbox_from_heatmap(_t(hm), _t(maps["rot"][:, 1:2]), _t(maps["rot"][:, 0:1]),
                                      _t(maps["center"]), _t(maps["center_z"]),
                                      _t(maps["dim"]), pcr, vs, 8, vel=_t(maps["vel"]), K=500)
    assert got[0].shape == (B, 500, 9)
    for b in range(B):
        want = jax.tree_util.tree_map(np.asarray, jcn.decode_bbox_from_heatmap(
            hm[b], maps["rot"][b, 1:2], maps["rot"][b, 0:1], maps["center"][b],
            maps["center_z"][b], maps["dim"][b], pcr, vs, 8, vel=maps["vel"][b], K=500))
        np.testing.assert_array_equal(got[1][b].numpy(), want[1])
        np.testing.assert_array_equal(got[2][b].numpy(), want[2])
        np.testing.assert_allclose(got[0][b].numpy(), want[0], rtol=1e-6, atol=1e-5)


def test_velocity_targets():
    """assign_center_targets at code_size 10 on 10-column gt boxes (off-map,
    masked and other groups' boxes among them) on the nuScenes 128 x 128 map:
    the velocity columns last; heatmaps, indices and masks as at code 8."""
    rng = np.random.RandomState(2)
    gt = np.zeros((2, 30, 10), np.float32)
    gt[..., 0:2] = rng.uniform(-56, 56, (2, 30, 2))
    gt[..., 2] = rng.uniform(-2, 0, (2, 30))
    gt[..., 3:6] = rng.uniform(0.4, 12, (2, 30, 3))
    gt[..., 6] = rng.uniform(-3, 3, (2, 30))
    gt[..., 7:9] = rng.uniform(-10, 10, (2, 30, 2))
    gt[..., 9] = rng.randint(1, 4, (2, 30))
    valid = rng.uniform(size=(2, 30)) > 0.2
    local = np.where(gt[..., 9] == 2, 0, np.where(gt[..., 9] == 3, 2, 1)).astype(np.int32)
    args = (2, (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), (0.1, 0.1, 0.2), 8, (128, 128))
    got = cn.assign_center_targets(_t(gt), _t(valid), _t(local), *args, code_size=10)
    assert got["box_targets"].shape == (2, 30, 10)
    for b in range(2):
        want = jax.tree_util.tree_map(np.asarray, jcn.assign_center_targets(
            gt[b], valid[b], local[b], *args, gaussian_overlap=0.1, min_radius=2,
            code_size=10))
        m = want["mask"]
        np.testing.assert_array_equal(got["mask"][b].numpy(), m)
        assert 0 < m.sum() < m.size
        np.testing.assert_array_equal(got["inds"][b].numpy()[m], want["inds"][m])
        np.testing.assert_array_equal(got["heatmap"][b].numpy() == 1, want["heatmap"] == 1)
        np.testing.assert_allclose(got["heatmap"][b].numpy(), want["heatmap"], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got["box_targets"][b].numpy(), want["box_targets"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["box_targets"][b, m, 8:].numpy(), gt[b, m, 7:9])


def _train_batch():
    gt, gmask = tiny.centerpoint_nusc_gt(2)
    return dict(_points(), gt_boxes=gt, gt_boxes_mask=gmask)


@jax.jit
def _jax_loss_grad(variables, batch):
    def loss_fn(params):
        out, mutated = _JMODEL.apply(dict(variables, params=params), dict(batch, batch_size=2),
                                     training=True, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], mutated["batch_stats"])

    (loss, (tb, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    return loss, tb, stats, grads


@pytest.fixture(scope="module")
def train_case(state):
    variables = to_flax_variables(state)
    loss, tb, stats, grads = jax.tree_util.tree_map(
        np.asarray, _jax_loss_grad(variables, _train_batch()))
    model = _port_model(state).train()
    out = model(dict({k: _t(v) for k, v in _train_batch().items()}, batch_size=2))
    out["loss"].backward()
    return dict(loss=loss, tb=tb, stats=from_flax_variables({"batch_stats": stats}),
                grads=grads, model=model, out=out, variables=variables)


def test_train_loss_and_tb_terms(train_case):
    out = train_case["out"]
    np.testing.assert_allclose(float(out["loss"].detach()), float(train_case["loss"]), rtol=1e-5)
    assert set(out["tb_dict"]) == set(train_case["tb"]) == {
        "hm_loss_0", "reg_loss_0", "hm_loss_1", "reg_loss_1"}
    for k, v in train_case["tb"].items():
        np.testing.assert_allclose(float(out["tb_dict"][k].detach()), float(v), rtol=1e-5,
                                   err_msg=k)


def test_train_gradients(train_case):
    grads, model = from_flax_variables({"params": train_case["grads"]}), train_case["model"]
    scale = max(float(g.abs().max()) for g in grads.values())
    assert {n for n, _ in model.named_parameters()} == set(grads)
    for name, p in model.named_parameters():
        want = grads[name].numpy()
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=atol, err_msg=name)
    vel = [n for n in grads if ".vel_" in n]
    assert len(vel) == 2 * 6 and all(float(grads[n].abs().max()) > 0 for n in vel)


def test_train_batch_stats(train_case):
    state = train_case["model"].state_dict()
    for key, want in train_case["stats"].items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_adam_onecycle_step(train_case, state):
    """One train_step (clipped adam_onecycle of the nuScenes config over
    every parameter) against the JAX gradients through optax: parameters
    rtol 1e-4 plus atol 1e-3 * lr, outside the gradients' rounding noise,
    and within 2 lr everywhere."""
    optim = infer.load_cfg(NUSC_CFG).OPTIMIZATION
    tx, _ = jbuild_optimizer(optim, total_steps=10)
    params = train_case["variables"]["params"]
    grads = train_case["grads"]
    new = jax.tree_util.tree_map(np.asarray, optax.apply_updates(
        params, tx.update(grads, tx.init(params), params)[0]))
    model = _port_model(state).train()
    opt = build_optimizer(optim, list(model.parameters()), 10)
    loss, _ = train_step(model, opt, dict({k: _t(v) for k, v in _train_batch().items()},
                                          batch_size=2))
    np.testing.assert_allclose(float(loss), float(train_case["loss"]), rtol=1e-5)
    g = from_flax_variables({"params": grads})
    want = from_flax_variables({"params": new})
    floor = 1e-6 * max(float(t.abs().max()) for t in g.values())
    lr = opt.lr_fn(0)
    moved = 0
    for name, p in model.named_parameters():
        gt_ = g[name]
        noise = ((gt_.abs() <= floor) | ((p.grad - gt_).abs() > 1e-3 * gt_.abs())).numpy()
        w = want[name].numpy()
        d = np.abs(p.detach().numpy() - w)
        off = ~noise & (d > 1e-4 * np.abs(w) + 1e-3 * lr)
        assert not off.any(), f"{name}: {int(off.sum())} off, by up to {d[off].max()}"
        assert d.max() <= 2 * lr, name
        moved += int((w != state[name].numpy()).sum())
    assert moved > 0


def test_full_width_flax_tree_loads_strictly():
    """Every flax leaf of cbgs_voxel01_res3d_centerpoint.yaml's JAX init
    (eval_shape, no forward) maps onto the port's model, strict=True: six
    groups of SeparateHeads with a vel branch each."""
    cfg = infer.load_cfg(NUSC_CFG)
    meta = infer.dataset_meta(cfg, 4096)
    jmodel = jbuild(cfg.MODEL, num_class=10, dataset=JDatasetMeta(**dataclasses.asdict(meta)))
    batch = {"points": jnp.zeros((1, 4096, 5), jnp.float32),
             "points_mask": jnp.ones((1, 4096), bool), "batch_size": 1}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False),
                            batch)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model = build_network(cfg.MODEL, 10, meta, device="cpu")
    model.load_state_dict(state, strict=True)
    assert meta.grid_size == (1024, 1024, 40) and meta.max_voxels == 60000
    assert meta.num_point_features == 5
    assert state["module_list.4.shared_conv.weight"].shape == (64, 512, 3, 3)
    for g, n in enumerate((1, 2, 2, 1, 2, 2)):
        assert state[f"module_list.4.head_{g}.vel_out.weight"].shape == (2, 64, 3, 3)
        assert state[f"module_list.4.head_{g}.hm_out.weight"].shape == (n, 64, 3, 3)
