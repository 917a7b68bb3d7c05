"""The port's whole tiny-TSM eval forward plus post-processing against the
JAX package, with the JAX model's weights carried across by
convert.from_flax_variables. Tolerance: the golden one of
tests/test_golden_forwards.py (atol 1e-3 * max(1, max|want|), rtol 1e-3) —
MLP sums run in another order on the two sides; FPS picks and neighbour
sets are exact, so nothing larger may differ.

The golden case runs on the committed converted weights of the JAX
model's PRNGKey(0) init, tsm_det_pointcloud_tpu_torch/data/tsm_tiny_state.npz
(the card's check reproduces the golden with them too); regenerate with
    python -c "from tests.test_torch_tsm_forward import write_tiny_state; write_tiny_state()"
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.models import build_network

GOLDEN = "tests/goldens/tsm_forward.npz"


def _assert_golden_close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=1e-3, err_msg=what)


@pytest.fixture(scope="module")
def jax_shapes():
    """The flax variables of the tiny model, as shapes only: a training
    init, which creates the teacher's layers too, as the port holds them."""
    batch = {k: v for k, v in ge._synth_batch(2, with_gt=True, seed=0).items()
             if k != "batch_size"}
    return jax.eval_shape(
        lambda b: _JMODEL.init(jax.random.PRNGKey(0), dict(b, batch_size=2),
                               training=True), batch)


def _port_model(variables, cfg):
    model = build_network(cfg, 3, tiny.META, device="cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    return model


def _port_forward(model, pts):
    with torch.no_grad():
        out = model({"points": torch.from_numpy(pts),
                     "points_mask": torch.ones(pts.shape[:2], dtype=torch.bool),
                     "batch_size": pts.shape[0]})
        pred, _ = model.post_processing(out)
    return out, pred


def write_tiny_state(path=tiny.STATE_PATH):
    """Write the converted PRNGKey(0) tiny-TSM weights."""
    model = ge._tsm_model()
    batch = ge._synth_batch(2, with_gt=True, seed=0)
    v = jax.jit(lambda r, b: model.init(r, b, training=True))(
        jax.random.PRNGKey(0), dict(batch))
    sd = from_flax_variables(jax.tree_util.tree_map(np.asarray, v))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **{k: t.numpy() for k, t in sd.items()})


def test_committed_state_is_the_converted_init():
    """The committed state is a fresh conversion of the JAX tiny model's
    PRNGKey(0) training init, leaf for leaf (rtol 1e-6, atol 1e-7: the
    init's float32 arithmetic may round differently on another CPU)."""
    model = ge._tsm_model()
    v = jax.jit(lambda r, b: model.init(r, b, training=True))(
        jax.random.PRNGKey(0), dict(ge._synth_batch(2, with_gt=True, seed=0)))
    want = from_flax_variables(jax.tree_util.tree_map(np.asarray, v))
    got = tiny.load_state()
    assert set(got) == set(want)
    for k, t in want.items():
        np.testing.assert_allclose(got[k].numpy(), t.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_reproduces_committed_golden():
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    model.load_state_dict(tiny.load_state(), strict=True)
    out, pred = _port_forward(model, tiny.synth_points(2))
    golden = np.load(GOLDEN)
    for key in golden.files:
        _assert_golden_close(out[key].numpy(), golden[key], key)
    assert (pred["count"] <= 8).all()


def _random_variables(shapes, seed):
    """Random flax variables from numpy: weights scaled by fan-in, BN
    scales and shifts, non-trivial running stats and statistics buffers,
    and cls biases lifted so that boxes pass the score gates."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "bias" and "_out" in path[-2].key and path[-2].key.startswith("cls"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        scale = 2.0 if path[0].key == "statistics" else 0.2
        return (rng.randn(*s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


_SCORE_THRESH = [0.05, 0.05, 0.05]


def _jax_model():
    jcfg = ge._tsm_model_cfg()
    jcfg["POST_PROCESSING"]["SCORE_THRESH"] = _SCORE_THRESH
    return jbuild(jcfg, num_class=3, dataset=ge._tsm_model().dataset_meta)


_JMODEL = _jax_model()


@jax.jit
def _jax_forward(variables, points, mask):
    out = _JMODEL.apply(variables, {"points": points, "points_mask": mask,
                                    "batch_size": 2}, training=False)
    pred, _ = _JMODEL.apply(variables, out,
                            method=lambda m, bd: m.post_processing(bd))
    return (out["batch_cls_preds"], out["batch_box_preds"],
            out["s_point_coords"], pred)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_weights_forward_and_post_processing(jax_shapes, seed):
    v = _random_variables(jax_shapes, seed)
    cfg = tiny.tiny_model_cfg()
    cfg["POST_PROCESSING"]["SCORE_THRESH"] = _SCORE_THRESH
    pts = tiny.synth_points(2, seed=seed + 7)
    jcls, jbox, jcoords, jpred = jax.tree_util.tree_map(
        np.asarray, _jax_forward(v, pts, np.ones(pts.shape[:2], bool)))
    out, pred = _port_forward(_port_model(v, cfg), pts)

    np.testing.assert_array_equal(out["s_point_coords"].numpy(), jcoords)
    _assert_golden_close(out["batch_cls_preds"].numpy(), jcls, "cls")
    _assert_golden_close(out["batch_box_preds"].numpy(), jbox, "box")
    np.testing.assert_array_equal(pred["count"].numpy(), jpred["count"])
    assert jpred["count"].sum() > 0, "the case must reach NMS"
    np.testing.assert_array_equal(pred["pred_labels"].numpy(), jpred["pred_labels"])
    _assert_golden_close(pred["pred_scores"].numpy(), jpred["pred_scores"], "scores")
    _assert_golden_close(pred["pred_boxes"].numpy(), jpred["pred_boxes"], "boxes")
