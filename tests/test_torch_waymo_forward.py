"""The Waymo-flavoured tiny TSM config (5 point features, a range symmetric
about 0, NMS_THRESH 0.5, SCORE_THRESH 0.01 x3) through the JAX package and
the port: the JAX model is built from the same dict, its weights are carried
across by convert.from_flax_variables, and the same numpy scans go through
both. Tolerance: the golden one of tests/test_torch_tsm_forward.py (atol
1e-3 * max(1, max|want|), rtol 1e-3) — MLP sums run in another order on the
two sides; FPS picks and neighbour sets are exact. Also: `dataset_meta`
follows the config's dataset.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_tsm_forward import _assert_golden_close, _random_variables
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu.utils.edict import EDict as JEDict
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network

B = 2


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


@functools.lru_cache(maxsize=None)
def _jax_model():
    meta = JDatasetMeta(**{f: getattr(tiny.WAYMO_META, f) for f in (
        "class_names", "point_cloud_range", "voxel_size", "grid_size", "max_voxels",
        "max_points_per_voxel", "num_point_features", "max_points")})
    return jbuild(JEDict(_plain(tiny.tiny_waymo_model_cfg())), num_class=3, dataset=meta)


@pytest.fixture(scope="module")
def jax_shapes():
    """The flax variables of a training init (teacher layers included), as
    shapes only."""
    model = _jax_model()
    batch = {"points": tiny.synth_waymo_points(B),
             "points_mask": np.ones((B, tiny.WAYMO_POINTS), bool),
             "gt_boxes": tiny.synth_gt(B)[0], "gt_boxes_mask": tiny.synth_gt(B)[1]}
    return jax.eval_shape(
        lambda b: model.init(jax.random.PRNGKey(0), dict(b, batch_size=B), training=True),
        batch)


@jax.jit
def _jax_forward(variables, points, mask):
    model = _jax_model()
    out = model.apply(variables, {"points": points, "points_mask": mask,
                                  "batch_size": B}, training=False)
    pred, _ = model.apply(variables, out, method=lambda m, bd: m.post_processing(bd))
    return out["batch_cls_preds"], out["batch_box_preds"], out["s_point_coords"], pred


def test_first_layer_takes_five_point_features(jax_shapes):
    """The converter maps every leaf of the 5-feature model, and the first
    point MLPs read 3 + 2 input channels on both sides."""
    sd = from_flax_variables(_random_variables(jax_shapes, 0))
    model = build_network(tiny.tiny_waymo_model_cfg(), 3, tiny.WAYMO_META, device="cpu")
    model.load_state_dict(sd, strict=True)
    firsts = [k for k, v in sd.items() if "sa0" in k and "point_mlp0" in k
              and v.dim() == 2 and 5 in v.shape]
    assert firsts, "no 5-channel first-layer weight found"


@pytest.mark.parametrize("seed", [0, 1])
def test_waymo_tiny_forward_and_post_processing(jax_shapes, seed):
    v = _random_variables(jax_shapes, seed)
    pts = tiny.synth_waymo_points(B, seed=seed + 3)
    jcls, jbox, jcoords, jpred = jax.tree_util.tree_map(
        np.asarray, _jax_forward(v, pts, np.ones(pts.shape[:2], bool)))
    model = build_network(tiny.tiny_waymo_model_cfg(), 3, tiny.WAYMO_META, device="cpu")
    model.load_state_dict(from_flax_variables(v), strict=True)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    out, pred = infer.detect(model, torch.from_numpy(pts), mask)

    assert out["batch_box_preds"].shape == (B, 24, 7)
    np.testing.assert_array_equal(out["s_point_coords"].numpy(), jcoords)
    _assert_golden_close(out["batch_cls_preds"].numpy(), jcls, "cls")
    _assert_golden_close(out["batch_box_preds"].numpy(), jbox, "box")
    np.testing.assert_array_equal(pred["count"].numpy(), jpred["count"])
    assert jpred["count"].sum() > 0, "the case must reach NMS"
    np.testing.assert_array_equal(pred["pred_labels"].numpy(), jpred["pred_labels"])
    _assert_golden_close(pred["pred_scores"].numpy(), jpred["pred_scores"], "scores")
    _assert_golden_close(pred["pred_boxes"].numpy(), jpred["pred_boxes"], "boxes")


def test_masked_points_forward(jax_shapes):
    """A third of the scan masked out (padding, as real Waymo scans are
    padded to a fixed size): the same picks and predictions on both sides."""
    v = _random_variables(jax_shapes, 2)
    pts = tiny.synth_waymo_points(B, seed=9)
    mask = np.ones(pts.shape[:2], bool)
    mask[:, 256:] = False
    jcls, jbox, jcoords, _ = jax.tree_util.tree_map(
        np.asarray, _jax_forward(v, pts, mask))
    model = build_network(tiny.tiny_waymo_model_cfg(), 3, tiny.WAYMO_META, device="cpu")
    model.load_state_dict(from_flax_variables(v), strict=True)
    out, _ = infer.detect(model, torch.from_numpy(pts), torch.from_numpy(mask))
    np.testing.assert_array_equal(out["s_point_coords"].numpy(), jcoords)
    _assert_golden_close(out["batch_cls_preds"].numpy(), jcls, "cls")
    _assert_golden_close(out["batch_box_preds"].numpy(), jbox, "box")


@pytest.mark.parametrize("cfg_file,features,pcr,grid,n_box", [
    ("tools/cfgs/waymo_models/waymo_fast_cpc.yaml", 5,
     (-75.2, -75.2, -2, 75.2, 75.2, 4), (1504, 1504, 40), 16),
    ("tools/cfgs/kitti_models/fast_cpc.yaml", 4,
     (0, -40, -3, 70.4, 40, 1), (1408, 1600, 40), 8),
])
def test_dataset_meta_follows_the_config(cfg_file, features, pcr, grid, n_box):
    from tsm_det_pointcloud_tpu_torch.train import synth_train_batch

    cfg = infer.load_cfg(infer.ROOT / cfg_file)
    meta = infer.dataset_meta(cfg, 1000)
    assert meta.num_point_features == features
    assert tuple(meta.point_cloud_range) == pcr
    assert tuple(meta.grid_size) == grid
    assert meta.class_names == tuple(cfg.CLASS_NAMES)
    # the grid is the range over the voxel size
    span = np.subtract(pcr[3:], pcr[:3]) / np.asarray(meta.voxel_size)
    np.testing.assert_allclose(span, grid, rtol=1e-6)
    scans = infer.synth_scans(meta, 2, 4000, seed=1)
    assert scans.shape == (2, 4000, features)
    lo, hi = np.asarray(pcr[:3]), np.asarray(pcr[3:])
    assert (scans[..., :3] >= lo).all() and (scans[..., :3] <= hi).all()
    batch = synth_train_batch(2, 4000, seed=1, point_cloud_range=meta.point_cloud_range,
                              n_features=meta.num_point_features)
    assert batch["points"].shape == (2, 4000, features)
    assert batch["gt_boxes"].shape == (2, n_box, 8)
    # every box holds its cluster's 200 points
    gt = batch["gt_boxes"][0, 0].numpy()
    inside = np.abs(batch["points"][0, :200, :3].numpy() - gt[:3]) <= gt[3:6] / 2
    assert inside.all()


def test_linearize_keys_fit_int32_or_raise():
    """The Waymo grid's keys fit int32 (keys are per scan); a grid whose
    sentinel does not fit raises and never wraps."""
    from tsm_det_pointcloud_tpu_torch.ops import spconv

    grid = (40, 1504, 1504)
    corner = torch.tensor([[[39, 1503, 1503], [0, 0, 0], [40, 0, 0]]])
    keys = spconv.linearize(corner, grid)
    assert keys.dtype == torch.int32
    assert keys.tolist() == [[40 * 1504 * 1504 - 1, 0, 40 * 1504 * 1504]]
    with pytest.raises(ValueError, match="int32"):
        spconv.linearize(corner, (1024, 1504, 1504))
