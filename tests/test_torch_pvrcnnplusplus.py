"""The port's PV-RCNN++ against the JAX package on the CPU.

Sector keypoint sampling: the sector ids of both packages equal; the port's
`sectorized_fps` index-equal to the JAX function at 4 and 6 sectors on scans
with an empty sector, an under-filled one (fewer valid points than its
share), point 0 outside every sector but one and a scan with no valid point;
its one d-fps call over the B * S sector rows equal to S separate calls; the
plain block-pruned d-fps (K6's CPU twin) on those sector rows equal to the
JAX d-fps. VectorPool: `VectorPoolAggregationModuleMSG` with and without
its aggregation MLP against flax on the flax init's weights, at eval and in
train mode, on inputs kept off the cells' edges and the balls' rims; the
VoxelSetAbstraction with VectorPool sources against the flax one. Whole:
the tiny PV-RCNN++'s eval outputs and predictions (one d-fps and six
query_group calls a forward), the committed golden, one training step (loss
and tb terms 1e-4, every gradient at the two-stage tolerance, BN statistics)
and pv_rcnn_plusplus.yaml's full-width flax tree loaded strictly.

Tolerances are those of tests/test_torch_pvrcnn.py: outputs at the golden
one (atol 1e-3 * max(1, max|want|), rtol 1e-3), indices, labels, counts and
keypoints exact. The state is tiny.two_stage_state("pvrcnnplusplus"), with
train=True for the training checks (tiny.TWO_STAGE_TRAIN_BN_LIFT); the golden
tsm_det_pointcloud_tpu_torch/data/pvrcnnplusplus_tiny_forward.npz is
regenerated with tests/torch_two_stage_cases.py's
write_forward("pvrcnnplusplus").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_two_stage_cases as cases
from tests.torch_two_stage_cases import golden_close, t
from tsm_det_pointcloud_tpu.models.backbones_3d.pfe import vector_pool as jvp
from tsm_det_pointcloud_tpu.models.backbones_3d.pfe.voxel_set_abstraction import (
    VoxelSetAbstraction as JVSA,
)
from tsm_det_pointcloud_tpu.models.backbones_3d.spconv_backbone import (
    SparseTensor as JSparseTensor,
)
from tsm_det_pointcloud_tpu.ops import sampling as jsampling
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.pfe import vector_pool
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.pfe.voxel_set_abstraction import (
    VoxelSetAbstraction,
)
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.spconv_backbone import SparseTensor
from tsm_det_pointcloud_tpu_torch.ops import grouping, sampling

WHICH = "pvrcnnplusplus"
EVAL_KEYS = ("spatial_features", "point_coords", "point_valid",
             "point_features_before_fusion", "point_features", "x_conv3", "x_conv4")
SOURCES = ("bev", "x_conv3", "x_conv4", "raw_points")
GRIDS = {"x_conv3": ((11, 8, 8), 4), "x_conv4": ((5, 4, 4), 8)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port while this module runs (beside XLA's
    CPU thread pools, torch's own pool slows the tiny steps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# sector keypoint sampling
# ---------------------------------------------------------------------------

N_SECTOR_POINTS = 600


def sector_scans(num_sectors, seed=0):
    """(xyz (3, N, 3) f32, valid (3, N) bool) whose points each lie at least
    1e-3 rad inside their azimuth sector: scan 0 has no point in sector 1,
    3 valid points in sector 2 (below any share of the tests) and point 0 in
    sector 3, with every 7th point invalid; scan 1 has every point valid, none
    in sector 0 and point 0 in the last sector; scan 2 has no valid point."""
    rng = np.random.RandomState(seed)
    S, N = num_sectors, N_SECTOR_POINTS
    width = 2 * np.pi / S
    sector = np.zeros((3, N), np.int64)
    sector[0] = rng.choice([s for s in range(S) if s not in (1, 2)], N)
    sector[0, 1:4] = 2
    sector[0, 0] = 3
    sector[1] = rng.randint(1, S, N)
    sector[1, 0] = S - 1
    sector[2] = rng.randint(0, S, N)
    angle = -np.pi + (sector + rng.uniform(1e-3 / width, 1 - 1e-3 / width, (3, N))) * width
    radius = rng.uniform(1.0, 30.0, (3, N))
    xyz = np.stack([radius * np.cos(angle), radius * np.sin(angle),
                    rng.uniform(-2.0, 1.0, (3, N))], -1).astype(np.float32)
    valid = np.ones((3, N), bool)
    valid[0, 7::7] = False
    valid[2] = False
    return xyz, valid


def _jax_sector_ids(xyz, num_sectors):
    """The JAX package's sector ids (vector_pool.sectorized_fps's own lines)."""
    angle = jnp.arctan2(xyz[..., 1], xyz[..., 0])
    return np.asarray(jnp.floor((angle + np.pi) / (2 * np.pi / num_sectors)).astype(jnp.int32)
                      % num_sectors)


@pytest.mark.parametrize("num_sectors,npoint", [(4, 42), (6, 40)])
def test_sectorized_fps_equals_jax(num_sectors, npoint):
    """Index-equal to the JAX function, after both packages agree on every
    point's sector; the scans hold an empty sector, an under-filled one
    (its picks repeat its lowest valid index once spent), a sector 0 that
    index 0 lies outside of, and an empty scan (index 0 throughout)."""
    xyz, valid = sector_scans(num_sectors)
    sector = vector_pool.sector_ids(t(xyz), num_sectors).numpy()
    np.testing.assert_array_equal(sector, _jax_sector_ids(jnp.asarray(xyz), num_sectors))
    shares = vector_pool.sector_shares(npoint, num_sectors)
    counts = np.array([[(valid[b] & (sector[b] == s)).sum() for s in range(num_sectors)]
                       for b in range(3)])
    assert counts[0, 1] == 0 and counts[0, 2] == 3 < min(shares) and sector[0, 0] == 3
    assert counts[1, 0] == 0 and sector[1, 0] == num_sectors - 1 and counts[2].sum() == 0
    got = vector_pool.sectorized_fps(t(xyz), t(valid), npoint, num_sectors).numpy()
    want = np.asarray(jvp.sectorized_fps(jnp.asarray(xyz), jnp.asarray(valid), npoint,
                                         num_sectors))
    np.testing.assert_array_equal(got, want)
    # the empty scan and scan 0's empty sector pick index 0 throughout; the
    # under-filled sector its 3 points, then its lowest valid index
    starts = np.cumsum([0] + shares)
    assert (got[2] == 0).all() and (got[0, starts[1]:starts[2]] == 0).all()
    two = got[0, starts[2]:starts[3]]
    assert sorted(set(two[1:4].tolist())) == [1, 2, 3] and (two[4:] == 1).all()


def test_one_call_equals_separate_calls(monkeypatch):
    """The one d-fps call over the B * S sector rows at sector 0's share
    equals S calls, one a sector at its own share (prefix consistency)."""
    S, npoint = 6, 40
    xyz, valid = sector_scans(S, seed=1)
    calls = []
    orig = sampling.furthest_point_sample

    def counted(x, k, m=None):
        calls.append((tuple(x.shape), k))
        return orig(x, k, m)

    monkeypatch.setattr(sampling, "furthest_point_sample", counted)
    got = vector_pool.sectorized_fps(t(xyz), t(valid), npoint, S)
    shares = vector_pool.sector_shares(npoint, S)
    assert calls == [((3 * S, N_SECTOR_POINTS, 3), shares[0])]
    sector = vector_pool.sector_ids(t(xyz), S)
    want = torch.cat([orig(t(xyz), k, t(valid) & (sector == s)) for s, k in enumerate(shares)],
                     1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("num_sectors", [4, 6])
def test_block_pruned_plain_on_sector_rows_equals_jax(num_sectors):
    """K6's CPU twin (the plain block-pruned d-fps, 5 Morton blocks a row)
    on the sector rows equals the JAX d-fps: rows whose valid set excludes
    index 0, empty rows and under-filled rows."""
    xyz, valid = sector_scans(num_sectors, seed=2)
    rows, masks = vector_pool.sector_rows(t(xyz), t(valid), num_sectors)
    k = 30
    got = sampling.furthest_point_sample_block_pruned_plain(rows, k, masks).numpy()
    want = np.asarray(jsampling._furthest_point_sample_xla(
        jnp.asarray(rows.numpy()), k, jnp.asarray(masks.numpy())))
    np.testing.assert_array_equal(got, want)
    assert not masks[:, 0].all() and (~masks).all(1).any() and (masks.sum(1) < k).any()


# ---------------------------------------------------------------------------
# VectorPool
# ---------------------------------------------------------------------------

RADII, NSAMPLES = (0.6, 1.0), (8, 16)
LOCAL_GRIDS, MLPS = ((2, 2, 2), (3, 3, 3)), ((8,), (8, 8))


def vector_pool_inputs(seed=0, B=2, N=300, M=40, C=5):
    """Queries (B, M, 3), support xyz (B, N, 3) and features (B, N, C) on a
    2^-5 m lattice, support validity (B, N): every 9th support invalid, and
    any support whose offset from some query lies within 1e-3 of a ball's
    rim (relative to r^2) or within 1e-4 of a cell edge (in cells) made
    invalid too; the last two queries are far from every support."""
    rng = np.random.RandomState(seed)
    sup = np.round(rng.uniform(0.0, 3.0, (B, N, 3)) * 32) / 32
    q = sup[:, rng.choice(N, M, replace=False)] + np.round(
        rng.uniform(-0.1, 0.1, (B, M, 3)) * 32) / 32
    q[:, -2:] += 20.0
    feats = rng.randn(B, N, C)
    valid = np.ones((B, N), bool)
    valid[:, ::9] = False
    d = sup[:, None] - q[:, :, None]                 # (B, M, N, 3)
    d2 = (d ** 2).sum(-1)
    for r, grid in zip(RADII, LOCAL_GRIDS):
        near_rim = np.abs(d2 - r * r) < 1e-3 * r * r
        cell = (d / (2 * r) + 0.5) * np.asarray(grid)
        on_edge = (np.abs(cell - np.round(cell)) < 1e-4).any(-1) & (d2 < r * r)
        valid &= ~(near_rim | on_edge).any(1)
    f32 = (lambda a: a.astype(np.float32))
    return f32(q), f32(sup), f32(feats), valid


@pytest.mark.parametrize("agg", [None, (16,)])
def test_vector_pool_msg_against_flax(agg):
    """The port's VectorPoolAggregationModuleMSG on the flax init's weights
    against flax, at eval and in train mode (the unmasked post_mlp BNs over
    every query, the empty balls' included); the gathered slots of both
    scales and the ball counts as the plain query_group gives them."""
    q, sup, feats, valid = vector_pool_inputs()
    jmod = jvp.VectorPoolAggregationModuleMSG(radii=RADII, nsamples=NSAMPLES,
                                              local_grids=LOCAL_GRIDS, mlps=MLPS,
                                              aggregation_mlp=agg)
    args = tuple(jnp.asarray(a) for a in (q, sup, feats, valid))
    variables = jmod.init(jax.random.PRNGKey(1), *args, training=False)
    want_ev = np.asarray(jmod.apply(variables, *args, training=False))
    want_tr, mutated = jmod.apply(variables, *args, training=True, mutable=["batch_stats"])
    port = vector_pool.VectorPoolAggregationModuleMSG(feats.shape[-1], RADII, NSAMPLES,
                                                      LOCAL_GRIDS, MLPS, agg)
    port.load_state_dict(from_flax_variables(jax.tree_util.tree_map(np.asarray, variables)),
                         strict=True)
    assert port.out_channels == (agg[-1] if agg else 8 + 8) == want_ev.shape[-1]
    cnt = [grouping.query_group(t(sup), t(valid), t(q), [(0.0, r, ns)])[0][1]
           for r, ns in zip(RADII, NSAMPLES)]
    assert all(int((c == 0).sum()) >= 4 for c in cnt) and int((cnt[1] > NSAMPLES[1]).sum()) > 0
    with torch.no_grad():
        got_ev = port.eval()(t(q), t(sup), t(feats), t(valid))
        got_tr = port.train()(t(q), t(sup), t(feats), t(valid))
    assert np.abs(want_ev).max() > 0
    golden_close(got_ev, want_ev, "eval")
    golden_close(got_tr, np.asarray(want_tr), "train")
    stats = from_flax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mutated["batch_stats"])})
    state = port.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_cells_divide_by_the_diameter():
    """An offset of float32(0.1) in a ball of radius 0.3 lies on the edge of
    3^3 cells 1 and 2 along x: dividing by 2 r, as the JAX package does,
    puts it in cell 1; multiplying by the reciprocal 1 / (2 r) would put it
    in cell 2."""
    vp = vector_pool.VectorPoolAggregation(0, 0.3, 4, (3, 3, 3), (4,))
    g, two_r = np.float32(0.1), np.float32(0.6)
    assert int((g / two_r + np.float32(0.5)) * 3) == 1
    assert int((g * (np.float32(1) / two_r) + np.float32(0.5)) * 3) == 2
    want = np.asarray(jnp.clip(jnp.asarray([g]) / (2.0 * 0.3) + 0.5, 0.0, 1.0 - 1e-6) * 3
                      ).astype(np.int32)[0]
    cell = vp.cells(torch.tensor([[g, 0.0, 0.0]], dtype=torch.float32))
    assert int(want) == 1 and int(cell[0]) == 1 * 9 + 1 * 3 + 1


# ---------------------------------------------------------------------------
# the tiny PV-RCNN++
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jcase():
    return cases.JaxCase(WHICH, EVAL_KEYS)


@pytest.fixture(scope="module")
def eval_case(jcase):
    out, pred = jcase.eval()
    return dict(out=out, pred=pred)


def test_committed_forward_is_current(eval_case):
    with np.load(cases.forward_path(WHICH)) as z:
        golden = {k: z[k] for k in z.files}
    want = {**{k: eval_case["out"][k] for k in cases.FORWARD}, **eval_case["pred"]}
    assert set(golden) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(golden[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert golden["count"].min() > 0 and golden["rois"].shape == (2, 16, 7)


def _counted(monkeypatch, calls, module, name):
    orig = getattr(module, name)

    def counted(*a, **kw):
        calls[name] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, counted)


def test_eval_and_golden(eval_case, monkeypatch):
    """The tiny PV-RCNN++'s eval forward (one d-fps call over the 2 x 6 sector
    rows; VectorPool's four query_group calls, x_conv4's SAGroup one, the
    RoI grid one) reproduces the committed golden and the JAX forward's
    keypoints, features and RoIs; its post-processing is index-equal."""
    calls = dict.fromkeys(("query_group", "furthest_point_sample"), 0)
    _counted(monkeypatch, calls, grouping, "query_group")
    _counted(monkeypatch, calls, sampling, "furthest_point_sample")
    model = cases.port_model(WHICH)
    out, pred = infer.detect(model, t(cases.points()["points"]),
                             torch.ones(2, cases.N_POINTS, dtype=torch.bool))
    assert calls == {"query_group": 6, "furthest_point_sample": 1}
    want = eval_case["out"]
    np.testing.assert_array_equal(out["point_coords"].numpy(), want["point_coords"])
    np.testing.assert_array_equal(out["point_valid"].numpy(), want["point_valid"])
    np.testing.assert_array_equal(out["roi_labels"].numpy(), want["roi_labels"])
    for k in ("point_features_before_fusion", "point_features", "rois", "batch_cls_preds",
              "batch_box_preds"):
        golden_close(out[k], want[k], k)
    with np.load(cases.forward_path(WHICH)) as golden:
        for k in ("roi_labels", "pred_labels", "count"):
            np.testing.assert_array_equal((out if k in cases.FORWARD else pred)[k].numpy(),
                                          golden[k], err_msg=k)
        for k in ("batch_cls_preds", "batch_box_preds", "rois", "pred_boxes", "pred_scores"):
            golden_close((out if k in cases.FORWARD else pred)[k].numpy(), golden[k], k)
    pred2, _ = model.post_processing({k: t(want[k]) for k in cases.FORWARD})
    for k in ("count", "pred_labels", "pred_boxes"):
        np.testing.assert_array_equal(pred2[k].numpy(), eval_case["pred"][k], err_msg=k)
    # the tiny scans lie at x >= 0: sectors 0 and 5 have no point, and each
    # of their 10 picks a scan is index 0, marked valid as in the JAX package
    idx0 = (out["point_coords"] == t(cases.points()["points"])[:, :1, :3]).all(-1)
    assert (idx0.sum(1) >= 20).all() and bool(out["point_valid"][idx0].all())


def _port_sparse(out, src):
    feats, coords, valid = out[src]
    grid, stride = GRIDS[src]
    return SparseTensor(t(feats), t(coords), t(valid), grid, stride)


@pytest.mark.parametrize("sources", [("raw_points",), ("x_conv3",), SOURCES])
def test_vsa_vectorpool_sources(eval_case, sources):
    """The flax VoxelSetAbstraction of the tiny PV-RCNN++'s PFE on these
    sources (its own init) and the port's on its converted weights, at eval
    and in train mode, on the JAX forward's BEV map and sparse levels."""
    out = eval_case["out"]
    meta = tiny.PVRCNN_META
    cfg = dict(tiny.pvrcnnplusplus_model_cfg().PFE)
    cfg["FEATURES_SOURCE"] = list(sources)
    cfg["SA_LAYER"] = {k: v for k, v in cfg["SA_LAYER"].items() if k in sources}
    jvsa = JVSA(model_cfg=cfg, voxel_size=meta.voxel_size,
                point_cloud_range=meta.point_cloud_range, num_bev_features=256,
                num_rawpoint_features=4)
    jbd = dict(cases.points(), spatial_features=out["spatial_features"],
               spatial_features_stride=8,
               multi_scale_3d_features={s: JSparseTensor(*out[s], *GRIDS[s]) for s in GRIDS},
               multi_scale_3d_strides={s: GRIDS[s][1] for s in GRIDS})
    keys = ("point_features_before_fusion", "point_features", "point_coords", "point_valid")

    @jax.jit
    def run(rng):
        variables = jvsa.init(rng, dict(jbd), training=False)
        ev = jvsa.apply(variables, dict(jbd), training=False)
        tr, _ = jvsa.apply(variables, dict(jbd), training=True, mutable=["batch_stats"])
        return variables, {k: ev[k] for k in keys}, {k: tr[k] for k in keys}

    variables, want_ev, want_tr = jax.tree_util.tree_map(np.asarray, run(jax.random.PRNGKey(2)))
    port = VoxelSetAbstraction(cfg, meta.voxel_size, meta.point_cloud_range, 256, 4)
    port.load_state_dict(from_flax_variables(variables), strict=True)
    bd = {"points": t(cases.points()["points"]),
          "points_mask": t(cases.points()["points_mask"]),
          "spatial_features": t(out["spatial_features"]), "spatial_features_stride": 8,
          "multi_scale_3d_features": {s: _port_sparse(out, s) for s in GRIDS},
          "multi_scale_3d_strides": {s: GRIDS[s][1] for s in GRIDS}}
    for mode, want in (("eval", want_ev), ("train", want_tr)):
        with torch.no_grad():
            got = port.train(mode == "train")(dict(bd))
        np.testing.assert_array_equal(got["point_coords"].numpy(), want["point_coords"])
        np.testing.assert_array_equal(got["point_valid"].numpy(), want["point_valid"])
        for k in ("point_features_before_fusion", "point_features"):
            assert np.abs(want[k]).max() > 0, (mode, k)
            golden_close(got[k], want[k], f"{mode} {k}")


def _train_batch():
    return dict({k: t(v) for k, v in cases.train_batch(WHICH).items()}, batch_size=2)


@pytest.fixture(scope="module")
def train_case(jcase):
    want = jcase.train()
    model = cases.port_model(WHICH, train=True)
    margin = cases.relu_input_margin(cases.port_model(WHICH, train=True), _train_batch())
    out = model(_train_batch())
    out["loss"].backward()
    return dict(want, model=model, out=out, margin=margin)


def test_train_loss_and_tb_terms(train_case):
    """The step's loss and tb terms (1e-4); every ReLU input of the step
    lies at least 1e-5 from 0 (tiny.TWO_STAGE_TRAIN_BN_LIFT); the training
    RoIs are PV-RCNN's (tiny.SHARED_DRAWS), so its gt boxes give foreground."""
    assert train_case["margin"] > 1e-5
    out = train_case["out"]
    cases.close_scalar(out["loss"].detach(), train_case["loss"], "loss")
    assert set(out["tb_dict"]) == set(train_case["tb"]) == {
        "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss", "point_loss",
        "rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss"}
    for k, v in train_case["tb"].items():
        cases.close_scalar(out["tb_dict"][k].detach(), v, k)
    sampled = out["roi_targets"]["sampled"]
    assert sampled.sum(1).tolist() == [16, 16]
    assert (out["roi_targets"]["fg"] & sampled).sum(1).tolist() == [2, 1]


def test_train_gradients(train_case):
    """Every gradient, VectorPool's post_mlp and agg layers' included."""
    cases.check_gradients(train_case["model"], train_case["grads"])
    names = set(train_case["grads"])
    assert {"module_list.3.sa_rawpoints.scale1.post_mlp.fc0.weight",
            "module_list.3.sa_x_conv3.agg.fc0.weight"} <= names


def test_train_batch_stats(train_case):
    cases.check_batch_stats(train_case["model"], train_case["stats"])


def test_full_width_flax_tree_loads_strictly():
    variables, model, meta = cases.full_width_state(
        infer.ROOT / "tools/cfgs/kitti_models/pv_rcnn_plusplus.yaml")
    state = from_flax_variables(variables)
    assert len(state) == len(jax.tree_util.tree_leaves(variables))
    model.load_state_dict(state, strict=True)
    pfe = model.module_list[3]
    assert (pfe.num_sectors, pfe.num_point_features_before_fusion) == (6, 256 + 32 + 128 + 128)
    assert state["module_list.3.vsa_point_feature_fusion.weight"].shape == (90, 544)
    assert state["module_list.3.sa_rawpoints.scale0.post_mlp.fc0.weight"].shape == (32, 8 * 4)
    assert state["module_list.3.sa_rawpoints.scale1.post_mlp.fc0.weight"].shape == (32, 27 * 4)
    assert state["module_list.3.sa_x_conv3.scale0.post_mlp.fc0.weight"].shape == (64, 27 * 67)
    assert state["module_list.3.sa_x_conv4.agg.fc0.weight"].shape == (128, 128)
    assert state["module_list.6.cls_fc.fc0.weight"].shape == (256, 544)
    assert state["module_list.7.pool_mlp0.fc0.weight"].shape == (64, 93)
