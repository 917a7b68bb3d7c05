"""3DSSD's fusion-sampling ops and modules of the port against the JAX package
on the CPU, from numpy seeds.

Sampling: `sample_by_methods` (d-fps, f-fps with PointNet2FSMSG's distance
d_xyz + d_feat, s-fps on sigmoid(largest logit) ** gamma, over index
ranges), the TSM backbone's f-fps (d_xyz + gamma * d_feat, against
`furthest_point_sample_matrix` on the matrix the JAX backbone builds), and
the plain weighted FPS on rows past K1's 16384 points against
`_furthest_point_sample_weights_xla` (with K6's weighted CPU twin, the plain
block-pruned s-fps). Their inputs lie on exact grids, where every distance
and feature sum is exact in f32 in any order (the JAX sums reduce in another
order). Picks: equal.

Grouping: `query_group_plain` at 64 samples with an annulus scale against
`ball_query` / `ball_query_dilated` (counts and filled indices equal).

Modules: `PointnetSAModuleFSMSG` (all three methods, three dilated scales,
the widest of 40 samples, aggregation and confidence MLPs) and the tiny
PVSSDA's `PointNet2FSMSG`, each on random converted weights: eval outputs,
train-mode outputs and BN statistics (rtol 1e-4 / atol 1e-5 on features,
picks exact), and the module's gradients of a fixed linear function of its
outputs (rtol 1e-3 above the rounding floor). And the TSM backbone's other sample
methods (f-fps, s-topk) swapped into the tiny TSM's layer 1: the
distillation backbone's eval outputs against the JAX one's on the committed
tiny state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.models.backbones_3d import pointnet2_modules as jmods
from tsm_det_pointcloud_tpu.models.backbones_3d.pointnet2_backbone import (
    PointNet2FSMSG as JFSMSG,
)
from tsm_det_pointcloud_tpu.models.backbones_3d.voxel_pointnet2_backbone import (
    VoxelPointNet2FSMSGDistillation as JTSMBackbone,
)
from tsm_det_pointcloud_tpu.ops import grouping as jgrouping
from tsm_det_pointcloud_tpu.ops import sampling as jsampling
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models.backbones_3d import pointnet2_modules as tmods
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.pointnet2_backbone import PointNet2FSMSG
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.voxel_pointnet2_backbone import (
    VoxelPointNet2FSMSGDistillation,
)
from tsm_det_pointcloud_tpu_torch.ops import grouping, sampling

TOL = dict(rtol=1e-4, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def _grid_case(seed, B=2, N=300, C=8, n_cls=3):
    """xyz on a 0.25 m grid, features on a 0.5 grid, logits on a 0.25
    grid, a tenth of the points invalid (none of the first)."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randint(-24, 24, (B, N, 3)) * 0.25).astype(np.float32)
    feats = (rng.randint(-6, 6, (B, N, C)) * 0.5).astype(np.float32)
    scores = (rng.randint(-12, 12, (B, N, n_cls)) * 0.25).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.1
    valid[:, 0] = True
    return xyz, feats, scores, valid


@pytest.mark.parametrize("methods, ranges, npoints, gamma", [
    (["d-fps"], [[0, 300]], [40], 1.0),
    (["f-fps"], [[0, 300]], [40], 1.0),
    (["s-fps"], [[0, 300]], [40], 1.0),
    (["f-fps", "s-fps", "d-fps"], [[0, 200], [50, 300], [100, 180]], [24, 24, 16], 2.0),
])
def test_sample_by_methods(methods, ranges, npoints, gamma):
    xyz, feats, scores, valid = _grid_case(len(methods) + int(gamma))
    want = np.asarray(jmods.sample_by_methods(
        jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(scores), jnp.asarray(valid),
        npoints, ranges, methods, gamma))
    got = tmods.sample_by_methods(t(xyz), t(feats), t(scores), t(valid), npoints, ranges,
                                  methods, gamma)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got.shape == (2, sum(npoints))


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_feature_fps_tsm_form(gamma):
    """The TSM backbone's f-fps: the JAX backbone's matrix d_xyz + gamma *
    d_f through `furthest_point_sample_matrix`, the port's row a step."""
    xyz, feats, _, valid = _grid_case(5, N=600, C=16)
    x, f = jnp.asarray(xyz), jnp.asarray(feats)
    d_xyz = jnp.sum((x[:, :, None, :] - x[:, None, :, :]) ** 2, -1)
    d_f = jnp.sum((f[:, :, None, :] - f[:, None, :, :]) ** 2, -1)
    want = np.asarray(jsampling.furthest_point_sample_matrix(d_xyz + gamma * d_f, 96,
                                                             jnp.asarray(valid)))
    got = sampling.furthest_point_sample_feature(t(xyz), t(feats), 96, t(valid), gamma=gamma)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w_lo, w_hi", [(0.0, 1.0), (0.01, 0.2)], ids=["uniform", "dim"])
def test_weighted_fps_past_k1_rows(w_lo, w_hi):
    """s-fps over 20000 points a row (past K1's FPS_MAX_POINTS): the plain
    version and K6's weighted CPU twin (the plain block-pruned s-fps)
    against the JAX package's XLA s-fps, with invalid points, a row with
    100 valid points and zero weights. With dim weights a block's largest
    key lies far below its largest min-distance: a skip test on the key
    would leave blocks stale (their picks then differ)."""
    rng = np.random.RandomState(9)
    B, N = 2, 20000
    xyz = (rng.randint(-640, 640, (B, N, 3)) / 16.0).astype(np.float32)
    w = rng.uniform(w_lo, w_hi, size=(B, N)).astype(np.float32)
    w[:, ::9] = 0.0
    valid = rng.uniform(size=(B, N)) > 0.15
    valid[1, 100:] = False
    assert N > sampling.FPS_MAX_POINTS
    want = np.asarray(jsampling._furthest_point_sample_weights_xla(
        jnp.asarray(xyz), jnp.asarray(w), 64, jnp.asarray(valid)))
    got = sampling.furthest_point_sample_plain(t(xyz), 64, t(valid), t(w))
    np.testing.assert_array_equal(got.numpy(), want)
    pruned, visits = sampling._block_pruned_plain(t(xyz), 64, t(valid), t(w))
    np.testing.assert_array_equal(pruned.numpy(), want)
    nb = -(-N // sampling.FPS_BLOCK)
    assert 0 < int(visits.sum()) < 63 * nb * B     # the rule skipped blocks


def test_query_group_plain_wide_annulus():
    """64 samples, an annulus scale and a ball beside it: counts and the
    filled indices equal the JAX nearest-k queries'."""
    rng = np.random.RandomState(10)
    B, N, M = 2, 900, 120
    xyz = (np.round(rng.uniform(-1.5, 1.5, (B, N, 3)) * 32) / 32).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.1
    q = xyz[:, :M] + np.float32(1 / 64)
    got_idx, got_cnt, _ = grouping.query_group_plain(
        t(xyz), t(valid), t(q), [(0.0, 0.4, 32), (0.4, 0.8, 64)])
    want = [jgrouping.ball_query(0.4, 32, jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(valid)),
            jgrouping.ball_query_dilated(0.4, 0.8, 64, jnp.asarray(xyz), jnp.asarray(q),
                                         jnp.asarray(valid))]
    off = 0
    for s, (wi, wc) in enumerate(want):
        wi, wc = np.asarray(wi), np.asarray(wc)
        ns = wi.shape[-1]
        np.testing.assert_array_equal(got_cnt[..., s].numpy(), wc)
        filled = np.arange(ns) < np.minimum(wc, ns)[..., None]
        np.testing.assert_array_equal(got_idx[..., off:off + ns].numpy()[filled], wi[filled])
        off += ns
    assert int(got_cnt[..., 1].max()) > 64


# ---------------------------------------------------------------------------
# modules on random converted weights
# ---------------------------------------------------------------------------

SA_KW = dict(npoint_list=[16, 16, 8], sample_range_list=[[0, 256], [0, 256], [128, 256]],
             sample_method_list=["d-fps", "f-fps", "s-fps"], radii=[0.4, 0.8, 1.6],
             nsamples=[8, 16, 40], mlps=[[8], [8], [8, 8]], dilated_group=True,
             aggregation_mlp=[16], confidence_mlp=[8], num_class=2, weight_gamma=2.0)


def _sa_inputs():
    rng = np.random.RandomState(11)
    B, N = 2, 256
    xyz = (np.round(rng.uniform(-2, 2, (B, N, 3)) * 32) / 32).astype(np.float32)
    feats = rng.randn(B, N, 6).astype(np.float32)
    scores = rng.randn(B, N, 2).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.1
    valid[:, 0] = True
    return xyz, feats, valid, scores


def _port_sa():
    return tmods.PointnetSAModuleFSMSG(**{**SA_KW, "in_channels": 6})


def _jax_sa():
    return jmods.PointnetSAModuleFSMSG(**SA_KW)


def _drawn(model, seed):
    return {k: torch.from_numpy(v.astype(np.float32))
            for k, v in tiny.redraw_state(model.state_dict(), seed).items()}


def _fixed_cotangent(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.fixture(scope="module")
def sa_case():
    """The JAX module's eval and train outputs, its statistics after the
    train forward and the gradient of sum(cot * (features, scores)), on
    the port module's drawn state."""
    port = _port_sa()
    state = _drawn(port, 13)
    xyz, feats, valid, scores = _sa_inputs()
    jm = _jax_sa()
    variables = to_flax_variables(state)
    M = sum(SA_KW["npoint_list"])
    cot = _fixed_cotangent([(2, M, 16), (2, M, 2)], 14)

    def loss_fn(params, v):
        tr, mut = jm.apply(dict(v, params=params), xyz, feats, valid, scores=scores,
                           training=True, mutable=["batch_stats"])
        _, f, _, s = tr
        loss = jnp.sum(f * cot[0]) + jnp.sum(jnp.where(s > -1e8, s, 0.0) * cot[1])
        return loss, (tr, mut["batch_stats"])

    @jax.jit
    def all_outputs(v):     # one compile: eval, train-mode outputs, statistics, gradients
        ev = jm.apply(v, xyz, feats, valid, scores=scores, training=False)
        (_, (tr, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"], v)
        return ev, tr, stats, grads

    ev, tr, stats, grads = jax.tree_util.tree_map(np.asarray, all_outputs(variables))
    return dict(state=state, ev=ev, tr=tr, stats=from_flax_variables({"batch_stats": stats}),
                grads=from_flax_variables({"params": grads}), cot=cot,
                inputs=(xyz, feats, valid, scores))


def _check_outputs(got, want):
    nx, nf, nv, ns = got
    np.testing.assert_array_equal(nx.detach().numpy(), want[0])
    np.testing.assert_array_equal(nv.numpy(), want[2])
    np.testing.assert_allclose(nf.detach().numpy(), want[1], **TOL)
    np.testing.assert_allclose(ns.detach().numpy(), want[3], **TOL)


def test_sa_module_fsmsg_eval_and_train(sa_case):
    xyz, feats, valid, scores = (t(a) for a in sa_case["inputs"])
    port = _port_sa()
    port.load_state_dict(sa_case["state"], strict=True)
    with torch.no_grad():
        _check_outputs(port.eval()(xyz, feats, valid, scores), sa_case["ev"])
        _check_outputs(port.train()(xyz, feats, valid, scores), sa_case["tr"])
    got = port.state_dict()
    assert len(sa_case["stats"]) == 2 * sum(1 for k in got if k.endswith("running_mean"))
    for k, want in sa_case["stats"].items():
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the widest scale is an annulus with more hits than its 40 samples
    new_xyz = port.eval()(xyz, feats, valid, scores)[0]
    cnt = grouping.query_group_plain(xyz, valid, new_xyz, port.scales)[1]
    assert port.scales[2][0] == 0.8 and int(cnt[..., 2].max()) > 40


def test_sa_module_fsmsg_gradients(sa_case):
    """rtol 1e-3 above the rounding floor: atol 1e-4 * max(the tensor's
    largest |g|, 1e-2 * the module's)."""
    xyz, feats, valid, scores = (t(a) for a in sa_case["inputs"])
    port = _port_sa()
    port.load_state_dict(sa_case["state"], strict=True)
    port.train()
    _, f, _, s = port(xyz, feats, valid, scores)
    cot = [t(c) for c in sa_case["cot"]]
    (torch.sum(f * cot[0]) + torch.sum(torch.where(s > -1e8, s, 0.0) * cot[1])).backward()
    grads = sa_case["grads"]
    assert {n for n, _ in port.named_parameters()} == set(grads)
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, p in port.named_parameters():
        want = grads[name].numpy()
        atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * scale)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def backbone_case():
    """The tiny PVSSDA's PointNet2FSMSG (module_list.0 of its drawn state):
    the JAX backbone's eval and train outputs and statistics."""
    cfg = tiny.pvssda_model_cfg("fsmsg").BACKBONE_3D
    state = {k[len("module_list.0."):]: v for k, v in tiny.pvssda_state("fsmsg").items()
             if k.startswith("module_list.0.")}
    jm = JFSMSG(model_cfg=cfg, input_channels=4)
    pts = tiny.pvssda_points(2)
    batch = {"points": pts, "points_mask": np.ones(pts.shape[:2], bool)}
    keys = ("point_features", "point_coords", "point_valid", "point_scores",
            "point_coords_list", "point_scores_list", "point_valid_list")

    @jax.jit
    def both(v):
        ev = jm.apply(v, dict(batch), training=False)
        tr, mut = jm.apply(v, dict(batch), training=True, mutable=["batch_stats"])
        return ({k: ev[k] for k in keys}, {k: tr[k] for k in keys}, mut["batch_stats"])

    ev, tr, stats = jax.tree_util.tree_map(np.asarray, both(to_flax_variables(state)))
    return dict(cfg=cfg, state=state, batch=batch, ev=ev, tr=tr,
                stats=from_flax_variables({"batch_stats": stats}))


def _check_backbone(out, want):
    for k in ("point_coords", "point_valid"):
        np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=k)
    for k in ("point_features", "point_scores"):
        np.testing.assert_allclose(out[k].numpy(), want[k], **TOL, err_msg=k)
    for k in ("point_coords_list", "point_valid_list", "point_scores_list"):
        assert len(out[k]) == len(want[k]) == 2, k
        for g, w in zip(out[k], want[k]):
            np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=k)


def test_pointnet2_fsmsg_backbone(backbone_case):
    port = PointNet2FSMSG(backbone_case["cfg"], 4)
    port.load_state_dict(backbone_case["state"], strict=True)
    assert port.num_point_features == 32
    batch = {k: t(v) for k, v in backbone_case["batch"].items()}
    with torch.no_grad():
        _check_backbone(port.eval()(dict(batch)), backbone_case["ev"])
        _check_backbone(port.train()(dict(batch)), backbone_case["tr"])
    got = port.state_dict()
    for k, want in backbone_case["stats"].items():
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # layer 1's s-fps reads layer 0's scores: 24 f-fps, 24 s-fps, 16 d-fps picks
    assert backbone_case["ev"]["point_coords"].shape == (2, 64, 3)


# ---------------------------------------------------------------------------
# the TSM backbone's other sample methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["f-fps", "s-topk"])
def test_tsm_backbone_sample_method_swapped(method):
    """f-fps (d_xyz + WEIGHT_GAMMA * d_feat over the layer's input
    features) and s-topk at the tiny TSM's layer 1, teacher and student:
    the distillation backbone's eval outputs on the committed tiny state
    against the JAX backbone's."""
    cfg = tiny.tiny_model_cfg().BACKBONE_3D
    for sec in ("SA_CONFIG", "S_SA_CONFIG"):
        cfg[sec]["SAMPLE_METHOD_LIST"] = [["d-fps"], [method]]
    state = {k[len("module_list.0."):]: v for k, v in tiny.load_state().items()
             if k.startswith("module_list.0.")}
    pts = tiny.synth_points(2, seed=3)
    batch = {"points": pts, "points_mask": np.ones(pts.shape[:2], bool), "batch_size": 2}
    keys = ("s_point_coords", "s_point_features", "point_coords", "point_features")
    jm = JTSMBackbone(model_cfg=cfg, input_channels=4, meta=None)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v: {k: v_ for k, v_ in jm.apply(v, dict(batch), training=False).items()
                   if k in keys})(to_flax_variables(state)))
    port = VoxelPointNet2FSMSGDistillation(cfg, 4, tiny.META)
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = port.eval()({k: t(v) if isinstance(v, np.ndarray) else v
                           for k, v in batch.items()})
    np.testing.assert_array_equal(out["s_point_coords"].numpy(), want["s_point_coords"])
    assert "s_point_features" in want
    for k in set(want) - {"s_point_coords"}:
        np.testing.assert_allclose(out[k].numpy(), want[k], **TOL, err_msg=k)
