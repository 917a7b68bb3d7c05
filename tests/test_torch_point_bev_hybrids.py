"""The port's BEV / point hybrids PointFromVoxel, VoxelPointCross and
BEVPoint and its VoxelPointCross neck against the JAX package on the CPU.

Modules, each on the synthetic pyramid of tests/test_experimental_variants.py
at that file's widths (`torch_hybrid_cases.ModuleCase`: one jit a module),
on a redrawn state: the eval forward (selected points exact, outputs at the
golden tolerance), the training forward (its selection through d-fps, the
same), the BN statistics and class statistics after it, and every
gradient of a fixed random projection of the outputs, both sides in f64 (a
parameter the port leaves without one has a zero JAX gradient; in f32 the
JAX package's own gradients keep ~2 digits). The neck through both of its
point branches: the window pooling over the pyramid at the raw points, and
the point features a backbone wrote at its own points. Whole: the tiny
DSASNet on each of the three hybrids (to its point head:
`tiny.dsasnet_model_cfg`) and the tiny PVSSDA on the neck
(`torch_hybrid_cases.DetectorCase`: one jit a model): eval outputs and
post-processed predictions, a training step (loss and tb terms, every
gradient, zero where the JAX package's is zero, the statistics after it).
BEVPoint's strided `scale{i}_deconv` converts as a ConvTranspose (flipped)
onto its own leaf, its 1 x 1 one as a ConvBlock.

Tolerances: outputs atol 1e-3 * max(1, max|want|), rtol 1e-3; picks, labels
and counts exact; loss and tb terms 1e-4; gradients rtol 1e-3, atol 1e-4 *
max(max|want| of the tensor, 1e-2 * the largest of all); statistics rtol
1e-4, atol 1e-5 * max(1, max|want|).
"""
import numpy as np
import pytest
import torch

from tests.torch_hybrid_cases import (
    PCR, POOL, PYRAMID, SOURCE_CHANNELS, VOXEL, DetectorCase, ModuleCase, check_grads,
    check_stats, close, port_batch,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_two_stage_cases import close_scalar
from tsm_det_pointcloud_tpu.models.backbones_2d import point_bev_hybrids as jh
from tsm_det_pointcloud_tpu.models.neck.voxel_point_cross import VoxelPointCross as JNeck
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.models.backbones_2d import point_bev_hybrids as ph
from tsm_det_pointcloud_tpu_torch.models.neck.voxel_point_cross import VoxelPointCross

PFV_CFG = {"Z_GROUPS": 4, "LOCAL_CH": 8, "GLOBAL_CH": 8, "FG_CORNER_POINTS": [[64, 32], [16, 8]],
           "SAMPLE_FPS": True, "STAT_START_ITER": 0}
VPC_CFG = {"Z_GROUPS": 4, "TRUNK_CH": 32, "N_BLOCK": [1, 1],
           "FG_CORNER_POINTS": [[32, 32], [24, 8]], "SAMPLE_FPS": True,
           "SA_CONFIG": {"RADIUS": [1.6], "NSAMPLE": [8], "MLPS": [[16, 16]]}}
BEV_CFG = {"N_BLOCK": [1, 2, 2], "NUM_FILTERS": 16, "NUM_RAW_KEYPOINTS": 32}
# the neck's second branch: points a backbone wrote (a third of them
# invalid), their features and a 2D backbone's map at stride 2
_RNG = np.random.RandomState(5)
NECK_POINTS = {
    "point_coords": np.concatenate([_RNG.uniform(0.5, 15.5, (2, 64, 1)),
                                    _RNG.uniform(-7.5, 7.5, (2, 64, 1)),
                                    _RNG.uniform(-2.5, 0.5, (2, 64, 1))], -1).astype(np.float32),
    "point_features": _RNG.randn(2, 64, 12).astype(np.float32),
    "point_valid": np.arange(64)[None].repeat(2, 0) % 3 != 2,
    "spatial_features_2d": _RNG.randn(2, 8, 8, 24).astype(np.float32),
}
# (JAX module, port module, outputs compared, outputs the gradient check sums,
# exact outputs, extra inputs)
MODULES = {
    "pfv": (lambda: jh.PointFromVoxel(model_cfg=PFV_CFG, input_channels=32, voxel_size=VOXEL,
                                      point_cloud_range=PCR),
            lambda: ph.PointFromVoxel(PFV_CFG, 32, VOXEL, PCR, raw_channels=1),
            ("point_coords", "point_valid", "point_features", "fg_preds", "candidate_coords",
             "candidate_features", "point_center_preds", "point_candidate_preds",
             "spatial_features_2d"),
            ("point_features", "fg_preds", "point_center_preds", "point_candidate_preds",
             "candidate_features", "spatial_features_2d"),
            ("point_coords", "point_valid"), None),
    "vpc": (lambda: jh.VoxelPointCross(model_cfg=VPC_CFG, input_channels=32, voxel_size=VOXEL,
                                       point_cloud_range=PCR),
            lambda: ph.VoxelPointCross(VPC_CFG, 32, VOXEL, PCR, raw_channels=1),
            ("point_coords", "point_valid", "point_features", "fg_preds", "point_corner_preds",
             "candidate_coords", "candidate_valid", "candidate_features", "candidate_score",
             "spatial_features_2d"),
            ("point_features", "fg_preds", "point_corner_preds", "candidate_features",
             "spatial_features_2d"),
            ("point_coords", "point_valid", "candidate_coords", "candidate_valid"), None),
    "bevpoint": (lambda: jh.BEVPoint(model_cfg=BEV_CFG, input_channels=32, voxel_size=VOXEL,
                                     point_cloud_range=PCR),
                 lambda: ph.BEVPoint(BEV_CFG, VOXEL, PCR, PYRAMID),
                 ("point_coords", "point_valid", "point_features", "raw_fg_preds",
                  "spatial_features_2d"),
                 ("point_features", "raw_fg_preds", "spatial_features_2d"),
                 ("point_valid",), None),
    "neck_pool": (lambda: JNeck(model_cfg={"NUM_FILTERS": 16, "POINT_GRID_POOL": POOL},
                                voxel_size=VOXEL, point_cloud_range=PCR),
                  lambda: VoxelPointCross({"NUM_FILTERS": 16, "POINT_GRID_POOL": POOL}, VOXEL,
                                          PCR, 32, None, SOURCE_CHANNELS),
                  ("point_coords", "point_features", "spatial_features_2d"),
                  ("point_features", "spatial_features_2d"), ("point_coords",), None),
    "neck_points": (lambda: JNeck(model_cfg={"NUM_FILTERS": 16}, voxel_size=VOXEL,
                                  point_cloud_range=PCR),
                    lambda: VoxelPointCross({"NUM_FILTERS": 16}, VOXEL, PCR, 24, 12),
                    ("point_coords", "point_valid", "point_features", "spatial_features_2d"),
                    ("point_features", "spatial_features_2d"), ("point_coords", "point_valid"),
                    NECK_POINTS),
}
_CACHE = {}


def _module_case(name):
    if name not in _CACHE:
        jmod, pmod, keys, loss_keys, _, extra = MODULES[name]
        case = ModuleCase(jmod(), pmod(), keys, loss_keys, extra=extra)
        _CACHE[name] = (case, case.run())
    return _CACHE[name]


def _detector_case(which):
    key = f"det_{which}"
    if key not in _CACHE:
        case = DetectorCase(which)
        _CACHE[key] = (case, case.run())
    return _CACHE[key]


@pytest.fixture(scope="module", params=list(MODULES))
def module_case(request):
    return request.param, *_module_case(request.param)


@pytest.fixture(scope="module", params=["pfv", "vpc", "bevpoint", "neck"])
def detector_case(request):
    return request.param, *_detector_case(request.param)


def _hold(got, want, name, exact):
    for k, w in want.items():
        if k in exact and k != "point_coords":
            np.testing.assert_array_equal(got[k].detach().numpy(), w, err_msg=f"{name} {k}")
        elif k in exact:   # voxel centres: one ulp apart at most
            np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0, atol=1e-6,
                                       err_msg=f"{name} {k}")
        else:
            close(got[k], w, f"{name} {k}")


def test_module_eval_and_training(module_case):
    name, case, want = module_case
    exact = MODULES[name][4]
    ev, tr = case.port_run()
    _hold(ev, want["eval"], f"{name} eval", exact)
    _hold(tr, want["train"], f"{name} train", exact)
    check_stats(case.port.state_dict(), want["stats"], name)


def test_module_gradients(module_case):
    """Every gradient of the projection, f64 on both sides; a parameter the
    port's backward does not reach has a zero JAX gradient."""
    name, case, want = module_case
    port = case.port_grads()
    idle = check_grads(port.named_parameters(), want["grads"], name)
    assert not idle, idle        # the projection reads every branch


def test_pfv_statistics_moved():
    """PointFromVoxel's class statistics (mean, momentum 0.7) move in
    training from STAT_START_ITER 0 on: the first iteration replaces them,
    as in the JAX package."""
    case, want = _module_case("pfv")
    key = "object_statistics.object_statistic_features"
    assert not np.allclose(want["stats"][key].numpy(), case.state[key].numpy())
    case.port_run()
    np.testing.assert_allclose(case.port.state_dict()[key].numpy(), want["stats"][key].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_detector_eval(detector_case):
    which, case, want = detector_case
    model = case.port()
    out = model(port_batch())
    pred, _ = model.post_processing(out)
    for k, w in want["out"].items():
        if k in ("point_valid", "roi_labels"):
            np.testing.assert_array_equal(out[k].numpy(), w, err_msg=k)
        elif k == "point_coords":
            np.testing.assert_allclose(out[k].detach().numpy(), w, rtol=0, atol=1e-6, err_msg=k)
        else:
            close(out[k], w, f"{which} {k}")
    for k in ("pred_labels", "count"):
        np.testing.assert_array_equal(pred[k].numpy(), want["pred"][k], err_msg=k)
    for k in ("pred_boxes", "pred_scores"):
        close(pred[k], want["pred"][k], f"{which} {k}")
    assert want["pred"]["count"].min() > 0


def test_detector_training_step(detector_case):
    which, case, want = detector_case
    model = case.port(train=True)
    out = model(port_batch(train=True))
    close_scalar(out["loss"].detach(), want["loss"], f"{which} loss")
    assert set(out["tb_dict"]) == set(want["tb"])
    for k, v in out["tb_dict"].items():
        close_scalar(torch.as_tensor(v).detach(), want["tb"][k], f"{which} {k}")
    out["loss"].backward()
    idle = check_grads(model.named_parameters(), want["grads"], which)
    check_stats(model.state_dict(), want["stats"], which)
    tops = {n.split(".")[2] for n in idle if n.startswith("module_list.3.")}
    if which == "pfv":        # fg scoring selects; the candidates feed no head
        assert {"fg_pred_out", "center_out", "candidate_out"} <= tops
    elif which == "vpc":      # the candidates and corners feed no head
        assert {"corner_out", "candidate_out", "candidate_features"} <= tops
    elif which == "bevpoint":
        assert tops == {"raw_fg_pred"}
    else:                     # the anchor head reads the neck's map, not its points
        assert any(n.startswith("module_list.1.") for n in idle)
        assert {n.split(".")[2] for n in idle if n.startswith("module_list.4.")} >= {
            "point_features", "p5_out", "v2p_5"}
    assert bool(idle) and model.unused_parameters


def test_bevpoint_deconv_conversion():
    """BEVPoint's strided scale{i}_deconv (a ConvTranspose in flax) converts
    flipped onto its own leaf and back; its 1 x 1 scale1_deconv is a
    ConvBlock, converted as a conv."""
    port = ph.BEVPoint(BEV_CFG, VOXEL, PCR, PYRAMID)
    state = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in tiny.redraw_state(port.state_dict(), 3).items()}
    tree = to_flax_variables(state)["params"]
    k2 = tree["scale2_deconv"]["kernel"]                   # (2, 2, Cin, Cout)
    np.testing.assert_array_equal(
        k2, state["scale2_deconv.weight"].numpy().transpose(2, 3, 0, 1)[::-1, ::-1])
    assert k2.shape == (2, 2, 16, 16) and tree["scale3_deconv"]["kernel"].shape == (4, 4, 16, 16)
    assert tree["scale1_deconv"]["conv0"]["kernel"].shape == (1, 1, 16, 16)
    back = from_flax_variables(to_flax_variables(state))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
