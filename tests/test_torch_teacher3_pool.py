"""Two module options of the port against the JAX package on the CPU: the
distillation backbone with a three-layer teacher (the `teacher3` variant of
fast_cpc.yaml at tiny widths) and PointRCNN's RoI head without a group-all
layer and without an SA_CONFIG (the `pointrcnn_pool_last` variant's branch
and the other one).

  * VoxelPointNet2FSMSGDistillation on tiny.tiny_model_cfg() with a third
    teacher SA layer (s-fps 16 of layer 1's 16 points at layer 1's widths,
    `infer._third_teacher_layer`'s rule) on random flax weights carried by
    `convert.from_flax_variables`: the eval outputs (teacher layers 0 and 1,
    then s_sa1 on layer 0's) and the training-mode outputs (all three
    teacher layers; the heads read the last) with the BN statistics after
    them;
  * PointRCNNHead on the tiny PointRCNN's RoI settings, fed synthetic point
    features, scores and first-stage boxes (some RoIs far from every point,
    so empty): with SA_CONFIG NPOINTS [16, 8] (the last SA level pooled) and
    with no SA_CONFIG (the RoI's points pooled), its RoIs, labels and
    refined boxes and scores in eval mode.

Tolerances: sampled indices, coordinates of sampled points, masks and RoI
labels exact; features the golden tolerance (atol 1e-3 * max(1, max|want|),
rtol 1e-3: MLP sums in another order); BN statistics 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.models.backbones_3d.voxel_pointnet2_backbone import (
    VoxelPointNet2FSMSGDistillation as JBackbone,
)
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
from tsm_det_pointcloud_tpu.models.roi_heads.pointrcnn_head import PointRCNNHead as JHead
from tsm_det_pointcloud_tpu_torch import infer, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models.backbones_3d.voxel_pointnet2_backbone import (
    VoxelPointNet2FSMSGDistillation,
)
from tsm_det_pointcloud_tpu_torch.models.roi_heads.pointrcnn_head import PointRCNNHead
from tsm_det_pointcloud_tpu_torch.utils.edict import EDict
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-3 * scale, rtol=1e-3,
                               err_msg=what)


def _fill(shapes, seed):
    """Random flax variables: kernels N(0, 1 / fan-in), BN scales and
    variances U(0.5, 1.5), other vectors N(0, 0.2^2)."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if len(s.shape) >= 2:
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.2).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _teacher3_cfg():
    """The tiny TSM backbone's config with a third teacher layer; its NPOINT
    entry is layer 1's 16, as the variant's is layer 1's 512."""
    cfg = EDict(tiny.tiny_model_cfg().BACKBONE_3D)
    sa = cfg.SA_CONFIG
    for key in ("QUERY_RANGE", "STRIDE", "RADIUS", "NSAMPLE", "MLPS", "SPCONV_MLPS_PRE",
                "AGGREGATION_MLPS", "CONFIDENCE_MLPS"):
        sa[key] = list(sa[key]) + [sa[key][1]]
    sa.NPOINT_LIST = list(sa.NPOINT_LIST) + [[16]]
    sa.SAMPLE_RANGE_LIST = list(sa.SAMPLE_RANGE_LIST) + [[[0, 16]]]
    sa.SAMPLE_METHOD_LIST = list(sa.SAMPLE_METHOD_LIST) + [["s-fps"]]
    return cfg


def test_variant_rule_matches_the_tiny_one():
    """`infer.variant_cfg("teacher3")` adds layer 1's settings the same way,
    at 512 points over [0, 512]."""
    sa = infer.variant_cfg("teacher3").MODEL.BACKBONE_3D.SA_CONFIG
    assert sa.NPOINT_LIST[2] == [512] and sa.SAMPLE_RANGE_LIST[2] == [[0, 512]]
    assert sa.SAMPLE_METHOD_LIST[2] == ["s-fps"]
    for key in ("QUERY_RANGE", "RADIUS", "NSAMPLE", "MLPS", "AGGREGATION_MLPS"):
        assert sa[key][2] == sa[key][1], key


_JMETA = JDatasetMeta(**dataclasses.asdict(tiny.META))
_JBACKBONE = JBackbone(model_cfg=dict(_teacher3_cfg()), input_channels=4, meta=_JMETA)
EVAL_KEYS = ("s_point_features", "s_point_coords", "s_point_valid", "s_point_scores",
             "s_last_centroid_xyz", "s_last_point_slot", "s_statistic_feature")
TRAIN_KEYS = EVAL_KEYS + ("point_features", "point_coords", "point_valid", "point_scores",
                          "last_centroid_xyz", "last_point_slot", "statistic_feature")


def _pts():
    p = tiny.synth_points(2)
    return {"points": jnp.asarray(p), "points_mask": jnp.ones(p.shape[:2], bool)}


@jax.jit
def _jax_backbone(variables, b):
    ev = _JBACKBONE.apply(variables, dict(b), training=False)
    tr, mut = _JBACKBONE.apply(variables, dict(b), training=True, mutable=["batch_stats"])
    lists = ("point_coords_list", "point_scores_list", "point_valid_list")
    return ({k: ev[k] for k in EVAL_KEYS + lists}, {k: tr[k] for k in TRAIN_KEYS + lists},
            mut["batch_stats"])


@pytest.fixture(scope="module")
def backbone_case():
    shapes = jax.eval_shape(
        lambda b: _JBACKBONE.init(jax.random.PRNGKey(0), b, training=True), _pts())
    v = _fill(shapes, 3)
    ev, tr, stats = jax.tree_util.tree_map(np.asarray, _jax_backbone(v, _pts()))
    return v, ev, tr, stats


@pytest.mark.parametrize("training", [False, True])
def test_three_layer_teacher_backbone(backbone_case, training):
    v, ev, tr, stats = backbone_case
    want = tr if training else ev
    port = VoxelPointNet2FSMSGDistillation(_teacher3_cfg(), 4, tiny.META)
    assert port.teacher_point_features == 48
    port.load_state_dict(from_flax_variables(v), strict=True)
    port.train(training)
    p = tiny.synth_points(2)
    with torch.no_grad():
        out = port({"points": torch.from_numpy(p),
                    "points_mask": torch.ones(p.shape[:2], dtype=torch.bool)})
    # eval: teacher layers 0 and 1, then s_sa1; training: layers 0-2, s_sa1
    assert len(out["point_coords_list"]) == (4 if training else 3)
    for k in want:
        if k.endswith("_list"):
            for i, (g, w) in enumerate(zip(out[k], want[k])):
                _close(g.numpy(), w, f"{k}[{i}]")
        elif k.endswith(("valid", "slot")):
            np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=k)
        else:
            _close(out[k].numpy(), want[k], k)
    if training:
        got = port.state_dict()
        for key, w in from_flax_variables({"batch_stats": stats}).items():
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def _roi_cfg(branch):
    cfg = EDict(tiny.pointrcnn_model_cfg().ROI_HEAD)
    if branch == "pool_last":
        cfg.SA_CONFIG = {"NPOINTS": [16, 8], "RADIUS": [0.4, 0.8], "NSAMPLE": [8, 8],
                         "MLPS": [[16, 16], [16, 32]]}
    else:
        del cfg["SA_CONFIG"]
    return cfg


def _roi_batch():
    """Two scans of 256 points in 8 clusters with 16 features and scores,
    and 256 first-stage boxes: 4 far from every point scoring highest, 8
    around the clusters next, the rest low (the proposal NMS keeps 8)."""
    rng = np.random.RandomState(21)
    B, N = 2, 256
    centres = rng.uniform([2, -6, -1], [14, 6, 0], (B, 8, 3))
    pts = (centres[:, rng.randint(0, 8, N)] + rng.normal(0, 0.6, (B, N, 3))).astype(np.float32)
    boxes = np.zeros((B, N, 7), np.float32)
    boxes[..., 0:3] = pts + rng.normal(0, 0.2, pts.shape)
    boxes[..., 3:6] = [3.9, 1.6, 1.56]
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (B, N))
    boxes[:, :8, 0:3] = centres
    boxes[:, 8:12, 0:2] = [[40.0, 30.0], [40.0, -30.0], [-30.0, 30.0], [-30.0, -30.0]]
    logits = rng.normal(-2, 0.5, (B, N, 1)).astype(np.float32)
    logits[:, :8] = 3.0 + np.arange(8)[:, None] * 0.1
    logits[:, 8:12] = 5.0
    valid = rng.uniform(size=(B, N)) > 0.05
    return {"point_coords": pts, "point_features": rng.randn(B, N, 16).astype(np.float32),
            "point_valid": valid,
            "point_cls_scores": rng.uniform(0, 1, (B, N)).astype(np.float32),
            "batch_cls_preds": logits, "batch_box_preds": boxes, "batch_size": 2}


@pytest.mark.parametrize("branch", ["pool_last", "no_sa"])
def test_pointrcnn_head_pooling_branches(branch):
    """RoIs, labels, refined boxes and scores of the JAX head; four of the
    eight RoIs of a scan hold no point (their pooled feature is 0)."""
    cfg = _roi_cfg(branch)
    jm = JHead(model_cfg=dict(cfg), input_channels=16, num_class=1)
    b = _roi_batch()
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), dict(x, batch_size=2),
                                              training=False),
                            {k: v for k, v in jb.items() if k != "batch_size"})
    v = _fill(shapes, 5)
    keys = ("rois", "roi_labels", "batch_cls_preds", "batch_box_preds")
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, x: {k: jm.apply(v, dict(x, batch_size=2), training=False)[k] for k in keys})(
        v, {k: v_ for k, v_ in jb.items() if k != "batch_size"}))
    port = PointRCNNHead(cfg, 16, 1).eval()
    port.load_state_dict(from_flax_variables(v), strict=True)
    assert hasattr(port, "roi_sa1") == (branch == "pool_last")
    assert not hasattr(port, "roi_sa2")
    with torch.no_grad():
        got = port({k: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                    for k, x in b.items()})
    np.testing.assert_array_equal(got["roi_labels"].numpy(), want["roi_labels"])
    far = (np.abs(want["rois"][..., 0]) >= 30).sum(1)
    assert (far == 4).all(), "four RoIs of each scan hold no point"
    for k in ("rois", "batch_cls_preds", "batch_box_preds"):
        _close(got[k].numpy(), want[k], k)


def test_a_shorter_last_teacher_layer_fails_alike():
    """A third teacher layer of fewer points than the student's (16 -> 8):
    the distillation loss pairs the teacher's last layer point for point
    with the student's, so the JAX training init fails on the shapes
    (TypeError) and the port's training forward alike (RuntimeError); ROADMAP
    §C."""
    import __graft_entry__ as ge
    from tsm_det_pointcloud_tpu.models import build_network as jbuild
    from tsm_det_pointcloud_tpu_torch.models import build_network

    cfg = tiny.tiny_model_cfg()
    cfg.BACKBONE_3D = _teacher3_cfg()
    cfg.BACKBONE_3D.SA_CONFIG.NPOINT_LIST[2] = [8]
    jm = jbuild(cfg, num_class=3, dataset=_JMETA)
    batch = ge._synth_batch(2, with_gt=True, seed=0)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b, training=True), batch)
    port = build_network(cfg, 3, tiny.META, device="cpu").train()
    gt, gmask = tiny.synth_gt(2, "wide")
    with pytest.raises(RuntimeError, match="size of tensor"):
        port({"points": torch.from_numpy(tiny.synth_points(2)), "batch_size": 2,
              "points_mask": torch.ones(2, 256, dtype=torch.bool),
              "gt_boxes": torch.from_numpy(gt), "gt_boxes_mask": torch.from_numpy(gmask)})
