"""The port's CenterPoint against the JAX package on the CPU.

Modules: VoxelResBackBone8x (the dense encoded_spconv_tensor; 8 probes and
21 convs a forward on shared materialised rulebooks), each centernet_utils
function (the decode also at C x H x W > 8192, where the JAX top_k takes
approx_max_k), centernet_focal with and without positives, CenterHead (its
eval maps and decoded boxes, its training loss), each fed the JAX module's
own input. Whole: the tiny CenterPoint's (tiny.py) eval outputs and
post-processed predictions with circle NMS and with nms_gpu, one training
step's loss, tb terms, every gradient and the BN statistics after it, the
committed goldens, the head with nuScenes' velocity branch on a seeded
state (tests/test_torch_centerpoint_nusc.py holds the whole nuScenes
CenterPoint), and centerpoint.yaml's full-width flax tree loaded strictly.

Tolerances: outputs at the golden one (atol 1e-3 * max(1, max|want|),
rtol 1e-3; sums run in another order on the two sides), labels, counts and
kept sets exact; heatmap targets, indices and masks of the targets exact
where they are (the gaussians' peaks are exactly 1 on both sides), their
values 1e-6; the training step as tests/test_torch_second_train.py holds it
(loss and tb terms 1e-4, gradients rtol 1e-3 above the JAX gradient's
rounding floor, BN statistics 1e-5).

The committed files: the converted PRNGKey(0) eval init
tsm_det_pointcloud_tpu_torch/data/centerpoint_tiny_state.npz and the JAX
eval outputs with tiny.centerpoint_eval_state() on tiny.second_points(2),
data/centerpoint_tiny_forward.npz; regenerate both with
    python -c "from tests.test_torch_centerpoint import write_centerpoint_tiny_files; write_centerpoint_tiny_files()"
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.dense_heads.center_head import (
    CenterHead as JCenterHead,
    SeparateHead as JSeparateHead,
)
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu.models.model_utils import centernet_utils as jcn
from tsm_det_pointcloud_tpu.ops import loss_utils as jloss
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.models.dense_heads.center_head import SeparateHead
from tsm_det_pointcloud_tpu_torch.models.model_utils import centernet_utils as cn
from tsm_det_pointcloud_tpu_torch.ops import loss_utils, spconv

CP_CFG = infer.ROOT / "tools/cfgs/kitti_models/centerpoint.yaml"
JMETA = JDatasetMeta(**dataclasses.asdict(tiny.CENTERPOINT_META))
_JMODEL = jbuild(tiny.centerpoint_model_cfg(), num_class=3, dataset=JMETA)
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


def _golden_close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3 * scale, rtol=1e-3,
                               err_msg=what)


def _close_scalar(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-4 * max(1.0, abs(float(want))), err_msg=what)


def _points():
    return {"points": tiny.second_points(2), "points_mask": np.ones((2, 512), bool)}


def _jax_init():
    v = jax.jit(lambda r, b: _JMODEL.init(r, dict(b, batch_size=2), training=False))(
        jax.random.PRNGKey(0), _points())
    return jax.tree_util.tree_map(np.asarray, dict(v))


@jax.jit
def _jax_eval(variables, b):
    """The eval forward's batch_dict, its post-processing and the separate
    heads' maps (capture_intermediates)."""
    out, inter = _JMODEL.apply(
        variables, dict(b, batch_size=2), training=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JSeparateHead))
    pred, _ = _JMODEL.apply(variables, out, method=lambda m, bd: m.post_processing(bd))
    keep = ("voxel_features", "voxel_coords", "voxel_mask", "encoded_spconv_tensor",
            "spatial_features", "spatial_features_2d") + FINAL
    heads = inter["intermediates"]["module_list_4"]
    maps = {g: heads[g]["__call__"][0] for g in ("head_0", "head_1")}
    return {k: out[k] for k in keep}, pred, maps


def write_centerpoint_tiny_files():
    """Write the converted PRNGKey(0) tiny-CenterPoint eval init, then the
    JAX eval outputs with tiny.centerpoint_eval_state() (which reads it)."""
    sd = from_flax_variables(_jax_init())
    np.savez_compressed(tiny.CENTERPOINT_STATE_PATH, **{k: t.numpy() for k, t in sd.items()})
    out, pred, _ = jax.tree_util.tree_map(
        np.asarray, _jax_eval(to_flax_variables(tiny.centerpoint_eval_state()), _points()))
    np.savez_compressed(tiny.CENTERPOINT_FORWARD_PATH, **{k: out[k] for k in FINAL},
                        **{k: pred[k] for k in PRED})


@pytest.fixture(scope="module")
def init():
    return _jax_init()


@pytest.fixture(scope="module")
def jax_case():
    state = tiny.centerpoint_eval_state()
    out, pred, maps = jax.tree_util.tree_map(
        np.asarray, _jax_eval(to_flax_variables(state), _points()))
    return dict(state=state, out=out, pred=pred, maps=maps)


def _port_model(state):
    model = build_network(tiny.centerpoint_model_cfg(), 3, tiny.CENTERPOINT_META, device="cpu")
    model.load_state_dict(state, strict=True)
    return model


def test_committed_centerpoint_state_is_the_converted_init(init):
    """A fresh conversion of the JAX tiny CenterPoint's PRNGKey(0) eval init
    (rtol 1e-6, atol 1e-7)."""
    want = from_flax_variables(init)
    got = tiny.load_state(tiny.CENTERPOINT_STATE_PATH)
    assert set(got) == set(want)
    for k, t in want.items():
        np.testing.assert_allclose(got[k].numpy(), t.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_committed_forward_is_current(jax_case):
    """The committed golden is the JAX package's output now (1e-5), its
    decoded scores lie at least 1e-6 apart in each group (the port's scores
    differ from the JAX ones by ~3e-7 on the CPU, so no order turns on
    rounding), some of them under SCORE_THRESH, and circle NMS suppresses."""
    with np.load(tiny.CENTERPOINT_FORWARD_PATH) as z:
        golden = {k: z[k] for k in z.files}
    want = {**{k: jax_case["out"][k] for k in FINAL}, **jax_case["pred"]}
    assert set(golden) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    scores = golden["final_scores"]
    for part in (scores[:, :32], scores[:, 32:]):
        assert (-np.diff(part, axis=1)).min() > 1e-6
    assert (scores <= 0.1).any() and (scores > 0.1).any()
    assert _suppressed(golden)


def _suppressed(d):
    """Whether NMS dropped some of each scan's 16 best boxes over the
    threshold: its kept scores are not simply those."""
    best = -np.sort(-np.where(d["final_scores"] > 0.1, d["final_scores"], 0), axis=1)[:, :16]
    return all(not np.array_equal(k, b) for k, b in zip(d["pred_scores"], best))


def test_reproduces_committed_golden():
    out, pred = infer.detect(_port_model(tiny.centerpoint_eval_state()),
                             _t(tiny.second_points(2)), torch.ones(2, 512, dtype=torch.bool))
    with np.load(tiny.CENTERPOINT_FORWARD_PATH) as golden:
        for k in ("final_labels", "pred_labels", "count"):
            np.testing.assert_array_equal((out if k in FINAL else pred)[k].numpy(), golden[k],
                                          err_msg=k)
        for k in ("final_boxes", "final_scores", "pred_boxes", "pred_scores"):
            _golden_close((out if k in FINAL else pred)[k].numpy(), golden[k], k)
    assert out["final_boxes"].shape == (2, 32 + 32, 7)


def test_modules_against_jax(jax_case, monkeypatch):
    """Each port module on the JAX module's own input; the sparse stem makes
    8 probes (4 subm rulebooks, 4 plans) and 21 convs a forward."""
    out, maps = jax_case["out"], jax_case["maps"]
    vfe, b3d, to_bev, b2d, head = _port_model(jax_case["state"]).module_list
    calls = {"probe": 0, "gather_matmul": 0}
    for name in calls:
        orig = getattr(spconv, name)

        def counted(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)

        monkeypatch.setattr(spconv, name, counted)
    with torch.no_grad():
        got = vfe({k: _t(v) for k, v in _points().items()})
        for k in ("voxel_features", "voxel_coords", "voxel_mask"):
            np.testing.assert_array_equal(got[k].numpy(), out[k], err_msg=k)
        got = b3d({k: _t(out[k]) for k in ("voxel_features", "voxel_coords", "voxel_mask")})
        assert calls == {"probe": 8, "gather_matmul": 21}
        assert np.abs(out["encoded_spconv_tensor"]).max() > 0
        assert out["encoded_spconv_tensor"].shape == (2, 2, 8, 8, 128)
        _golden_close(got["encoded_spconv_tensor"], out["encoded_spconv_tensor"],
                      "encoded_spconv_tensor")
        ms = got["multi_scale_3d_features"]
        assert [ms[f"x_conv{i}"].features.shape[-1] for i in (1, 2, 3, 4)] == [16, 32, 64, 128]
        got = to_bev({"encoded_spconv_tensor": _t(out["encoded_spconv_tensor"])})
        np.testing.assert_array_equal(got["spatial_features"].numpy(), out["spatial_features"])
        got = b2d({"spatial_features": _t(out["spatial_features"])})
        _golden_close(got["spatial_features_2d"], out["spatial_features_2d"],
                      "spatial_features_2d")
        seen = {}
        for g in ("head_0", "head_1"):
            getattr(head, g).register_forward_hook(
                lambda m, i, o, g=g: seen.update({g: o}))
        got = head({"spatial_features_2d": _t(out["spatial_features_2d"])})
    for g, want in maps.items():
        assert set(seen[g]) == set(want) == {"hm", "center", "center_z", "dim", "rot"}
        for k, w in want.items():                       # flax NHWC, the port NCHW
            _golden_close(seen[g][k].permute(0, 2, 3, 1), w, f"{g} {k}")
    np.testing.assert_array_equal(got["final_labels"].numpy(), out["final_labels"])
    for k in ("final_boxes", "final_scores"):
        _golden_close(got[k], out[k], k)


@pytest.mark.parametrize("nms", ["circle_nms", "nms_gpu"])
def test_post_processing_index_equal(jax_case, nms):
    """Both NMS routes on the JAX package's decoded boxes: counts, labels
    and kept scores / boxes equal, and the recall dict with gt boxes. For
    nms_gpu the boxes' BEV sizes are tripled on both sides, so that boxes
    of neighbouring cells (2 m apart) overlap."""
    cfg = tiny.centerpoint_model_cfg()
    final = {k: jax_case["out"][k] for k in FINAL}
    if nms == "nms_gpu":
        cfg.POST_PROCESSING["NMS_CONFIG"] = {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.1,
                                             "NMS_PRE_MAXSIZE": 48, "NMS_POST_MAXSIZE": 16}
        final["final_boxes"] = final["final_boxes"].copy()
        final["final_boxes"][..., 3:5] *= 3
    jmodel = jbuild(cfg, num_class=3, dataset=JMETA)
    gt, gmask = tiny.centerpoint_gt(2)
    bd = dict(final, gt_boxes=gt, gt_boxes_mask=gmask)
    jpred, jrec = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, b: jmodel.apply(v, b, method=lambda m, x: m.post_processing(x)))(
        to_flax_variables(jax_case["state"]), bd))
    port = build_network(cfg, 3, tiny.CENTERPOINT_META, device="cpu")
    pred, rec = port.post_processing({k: _t(v) for k, v in bd.items()})
    assert jpred["count"].min() > 0 and _suppressed(dict(final, **jpred))
    for k in ("count", "pred_labels"):
        np.testing.assert_array_equal(pred[k].numpy(), jpred[k], err_msg=k)
    np.testing.assert_array_equal(pred["pred_scores"].numpy(), jpred["pred_scores"])
    np.testing.assert_array_equal(pred["pred_boxes"].numpy(), jpred["pred_boxes"])
    assert set(rec) == set(jrec)
    for k, v in jrec.items():
        np.testing.assert_allclose(float(rec[k]), float(v), err_msg=k)


def _boxes(rng, B, M, lo=(0.5, -7.5), hi=(15.5, 7.5)):
    b = np.zeros((B, M, 8), np.float32)
    b[..., 0] = rng.uniform(lo[0], hi[0], (B, M))
    b[..., 1] = rng.uniform(lo[1], hi[1], (B, M))
    b[..., 2] = rng.uniform(-2, 0, (B, M))
    b[..., 3:6] = rng.uniform(0.5, 5, (B, M, 3))
    b[..., 6] = rng.uniform(-3, 3, (B, M))
    b[..., 7] = rng.randint(1, 4, (B, M))
    return b


def test_gaussian_radius_and_draw():
    rng = np.random.RandomState(1)
    h, w = rng.uniform(0.1, 30, 200).astype(np.float32), rng.uniform(0.1, 30, 200).astype(
        np.float32)
    for ov in (0.1, 0.5):
        np.testing.assert_allclose(cn.gaussian_radius(_t(h), _t(w), ov).numpy(),
                                   np.asarray(jcn.gaussian_radius(h, w, ov)), rtol=1e-6)
    centers = rng.uniform(-2, 40, (2, 12, 2)).astype(np.float32)
    radii = rng.randint(0, 6, (2, 12)).astype(np.float32)
    valid = rng.uniform(size=(2, 12)) > 0.3
    got = cn.draw_gaussians(_t(centers), _t(radii), _t(valid), (30, 36)).numpy()
    want = np.stack([np.asarray(jcn.draw_gaussians(centers[b], radii[b], valid[b], (30, 36)))
                     for b in range(2)])
    np.testing.assert_array_equal(got == 1, want == 1)
    assert (want == 1).sum() >= 5
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_assign_center_targets():
    """Heatmaps (the peaks exactly 1), indices, masks and box targets on
    centerpoint.yaml's 200 x 176 map at stride 8, with boxes off the map,
    masked ones and boxes of other groups' classes."""
    rng = np.random.RandomState(2)
    gt = _boxes(rng, 2, 30, lo=(-5, -45), hi=(75, 45))
    valid = rng.uniform(size=(2, 30)) > 0.2
    local = np.where(gt[..., 7] == 2, 0, np.where(gt[..., 7] == 3, 2, 1)).astype(np.int32)
    args = (2, (0, -40, -3, 70.4, 40, 1), (0.05, 0.05, 0.1), 8, (200, 176))
    got = cn.assign_center_targets(_t(gt), _t(valid), _t(local), *args)
    for b in range(2):
        want = jax.tree_util.tree_map(np.asarray, jcn.assign_center_targets(
            gt[b], valid[b], local[b], *args, gaussian_overlap=0.1, min_radius=2))
        np.testing.assert_array_equal(got["mask"][b].numpy(), want["mask"])
        m = want["mask"]
        assert 0 < m.sum() < m.size
        np.testing.assert_array_equal(got["inds"][b].numpy()[m], want["inds"][m])
        hm = got["heatmap"][b].numpy()
        np.testing.assert_array_equal(hm == 1, want["heatmap"] == 1)
        np.testing.assert_allclose(hm, want["heatmap"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["box_targets"][b].numpy(), want["box_targets"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,k,ties", [((2, 3, 64, 64), 500, False),
                                          ((2, 2, 16, 16), 40, True)])
def test_decode_bbox_from_heatmap(shape, k, ties):
    """The decode over C x H x W: at 12288 > 8192 the JAX top_k takes
    approx_max_k (distinct scores); at 512 lax.top_k, where ties go to the
    lower index on both sides."""
    rng = np.random.RandomState(3)
    B, C, H, W = shape
    n = C * H * W
    if ties:
        hm = rng.randint(0, 20, (B, n)).astype(np.float32) / 20
    else:
        hm = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.float32) / n
    hm = hm.reshape(shape)
    maps = {name: rng.randn(B, c, H, W).astype(np.float32)
            for name, c in (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2))}
    pcr, vs = (0, -40, -3, 70.4, 40, 1), (0.05, 0.05, 0.1)
    got = cn.decode_bbox_from_heatmap(_t(hm), _t(maps["rot"][:, 1:2]), _t(maps["rot"][:, 0:1]),
                                      _t(maps["center"]), _t(maps["center_z"]),
                                      _t(maps["dim"]), pcr, vs, 8, K=k)
    for b in range(B):
        want = jax.tree_util.tree_map(np.asarray, jcn.decode_bbox_from_heatmap(
            hm[b], maps["rot"][b, 1:2], maps["rot"][b, 0:1], maps["center"][b],
            maps["center_z"][b], maps["dim"][b], pcr, vs, 8, K=k))
        np.testing.assert_array_equal(got[1][b].numpy(), want[1])
        np.testing.assert_array_equal(got[2][b].numpy(), want[2])
        np.testing.assert_allclose(got[0][b].numpy(), want[0], rtol=1e-6, atol=1e-5)


def test_circle_nms():
    rng = np.random.RandomState(4)
    for trial in range(3):
        n = 60
        centers = rng.uniform(0, 10, (n, 2)).astype(np.float32)
        scores = np.sort(rng.uniform(0, 1, n).astype(np.float32))[::-1].copy()
        valid = scores > 0.2
        want = jax.tree_util.tree_map(np.asarray, jcn.circle_nms(centers, scores, valid, 1.5,
                                                                 20))
        got = cn.circle_nms(_t(centers), _t(scores), _t(valid), 1.5, 20)
        cnt = int(want[1])
        assert int(got[1]) == cnt and 0 < cnt
        np.testing.assert_array_equal(got[0].numpy()[:cnt], want[0][:cnt])
        np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("positives", [True, False])
def test_centernet_focal(positives):
    rng = np.random.RandomState(5)
    pred = rng.uniform(0, 1, (2, 3, 20, 24)).astype(np.float32)
    gt = rng.uniform(0, 0.99, (2, 3, 20, 24)).astype(np.float32)
    if positives:
        gt.reshape(-1)[rng.choice(gt.size, 7, replace=False)] = 1.0
    got = loss_utils.centernet_focal(_t(pred), _t(gt))
    want = jloss.centernet_focal(jnp.clip(pred, 1e-4, 1 - 1e-4), gt)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@jax.jit
def _jax_loss_grad(variables, batch):
    def loss_fn(params):
        out, mutated = _JMODEL.apply(dict(variables, params=params), dict(batch, batch_size=2),
                                     training=True, mutable=["batch_stats"])
        return out["loss"], (out["tb_dict"], mutated["batch_stats"],
                             out["spatial_features_2d"])

    (loss, (tb, stats, sf2d)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    return loss, tb, stats, grads, sf2d


def _train_batch():
    gt, gmask = tiny.centerpoint_gt(2)
    return dict(_points(), gt_boxes=gt, gt_boxes_mask=gmask)


@pytest.fixture(scope="module")
def train_case(init):
    loss, tb, stats, grads, sf2d = jax.tree_util.tree_map(
        np.asarray, _jax_loss_grad(init, _train_batch()))
    model = _port_model(from_flax_variables(init)).train()
    out = model(dict({k: _t(v) for k, v in _train_batch().items()}, batch_size=2))
    out["loss"].backward()
    return dict(loss=loss, tb=tb, stats=from_flax_variables({"batch_stats": stats}),
                grads=from_flax_variables({"params": grads}), sf2d=sf2d, model=model, out=out,
                init=init)


def test_train_loss_and_tb_terms(train_case):
    out = train_case["out"]
    _close_scalar(out["loss"].detach(), train_case["loss"], "loss")
    assert set(out["tb_dict"]) == set(train_case["tb"]) == {
        "hm_loss_0", "reg_loss_0", "hm_loss_1", "reg_loss_1"}
    for k, v in train_case["tb"].items():
        _close_scalar(out["tb_dict"][k].detach(), v, k)


def test_center_head_training_loss(train_case):
    """The head alone in train mode on the JAX step's BEV features gives the
    JAX loss and tb terms."""
    head = _port_model(from_flax_variables(train_case["init"])).module_list[4].train()
    bd = {k: _t(v) for k, v in _train_batch().items()}
    out = head(dict(bd, spatial_features_2d=_t(train_case["sf2d"])))
    _close_scalar(out["loss_center"].detach(), train_case["loss"], "loss")
    for k, v in train_case["tb"].items():
        _close_scalar(out["tb_dict_center"][k].detach(), v, k)


def test_train_gradients(train_case):
    grads, model = train_case["grads"], train_case["model"]
    scale = max(float(g.abs().max()) for g in grads.values())
    assert {n for n, _ in model.named_parameters()} == set(grads)
    for name, p in model.named_parameters():
        want = grads[name].numpy()
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=atol, err_msg=name)
    assert all(float(g.abs().max()) > 0 for n, g in grads.items() if n.endswith("weight"))


def test_train_batch_stats(train_case):
    state = train_case["model"].state_dict()
    stats = train_case["stats"]
    assert len(stats) == 2 * sum(1 for k in state if k.endswith("running_mean"))
    for key, want in stats.items():
        np.testing.assert_allclose(state[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_velocity_head_raises():
    """CenterHead with nuScenes' velocity head on the tiny CenterPoint's BEV
    map builds and decodes as the JAX head does: on the same seeded state,
    9-column boxes (the velocity read off the vel map), labels exact, boxes
    and scores at the golden tolerance."""
    cfg = tiny.centerpoint_model_cfg()
    cfg.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT["vel"] = {"out_channels": 2, "num_conv": 2}
    cfg.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_ORDER = ["center", "center_z", "dim", "rot", "vel"]
    head = build_network(cfg, 3, tiny.CENTERPOINT_META, device="cpu").module_list[4].eval()
    state = {k: _t(v.astype(np.float32)) for k, v in tiny.redraw_state(head.state_dict(), 7).items()}
    head.load_state_dict(state, strict=True)
    meta = tiny.CENTERPOINT_META
    jhead = JCenterHead(model_cfg=cfg.DENSE_HEAD, input_channels=64, num_class=3,
                        class_names=meta.class_names, grid_size=meta.grid_size,
                        point_cloud_range=meta.point_cloud_range, voxel_size=meta.voxel_size)
    x = np.random.RandomState(8).randn(2, 8, 8, 64).astype(np.float32)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, f: jhead.apply(v, {"spatial_features_2d": f}, training=False))(
        to_flax_variables(state), x))
    with torch.no_grad():
        got = head({"spatial_features_2d": _t(x)})
    assert got["final_boxes"].shape == want["final_boxes"].shape == (2, 64, 9)
    np.testing.assert_array_equal(got["final_labels"].numpy(), want["final_labels"])
    for k in ("final_boxes", "final_scores"):
        _golden_close(got[k], want[k], k)
    assert np.abs(want["final_boxes"][..., 7:]).min() > 0


def test_full_width_flax_tree_loads_strictly():
    """Every flax leaf of centerpoint.yaml's JAX init (eval_shape, no
    forward) maps onto the port's model, strict=True."""
    cfg = infer.load_cfg(CP_CFG)
    meta = infer.dataset_meta(cfg, 20000)
    jmodel = jbuild(cfg.MODEL, num_class=3, dataset=JDatasetMeta(**dataclasses.asdict(meta)))
    batch = {"points": jnp.zeros((1, 20000, 4), jnp.float32),
             "points_mask": jnp.ones((1, 20000), bool), "batch_size": 1}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False),
                            batch)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model = build_network(cfg.MODEL, 3, meta, device="cpu")
    model.load_state_dict(state, strict=True)
    assert meta.grid_size == (1408, 1600, 40) and meta.max_voxels == 40000
    assert state["module_list.1.conv_out.weight"].shape == (3, 128, 128)
    assert state["module_list.4.shared_conv.weight"].shape == (64, 512, 3, 3)
    assert isinstance(model.module_list[4].head_0, SeparateHead)
