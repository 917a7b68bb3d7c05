"""Point-axis sharding in the port (parallel/point_sharding.py, the TSM
backbone's sharded layer 0) on two gloo processes against the JAX
package's `shard_map` versions on a (data 1, points 2) mesh of 2 of the 8
virtual CPU devices.

* The four primitives (tests/torch_dist_cases.point_primitives_case), on a
  cloud of 2 scans x 512 points on a 2**-5 m grid (where every product of
  the JAX d², whose cross term is a matmul, is exact, so both packages rank
  candidates alike): `segment_local_fps` index-equal to the JAX one and to
  `segment_local_fps_plain`, with and without a valid mask;
  `gather_from_sharded` rows equal; `sharded_ball_group_multi` counts equal
  and gathered rows equal (their nearest-k equal to the unsharded
  `grouping.query_group`'s too); `sharded_voxel_centroids` voxels, counts
  and valid equal, centroids to 1e-6.
* The tiny TSM's eval forward under point axis 2 (every rank the whole
  batch, its segment of the points) against the JAX forward traced under
  `pa.activate(mesh)`: box and class predictions rtol 1e-3 (the goldens'
  tolerance), the post-processed count equal (0: the init scores no box
  over SCORE_THRESH); the two ranks' outputs bit-equal.
* The sharded training step (DDP over the two ranks of the one points
  group) against `jax.grad` under `pa.activate(mesh)`: loss, tb terms and
  gradients at test_torch_dist_train.py's tolerances; the ranks bit-equal.
  No parameter lies before the sharded primitives (layer 0's inputs are the
  points), so their gradients never cross a collective in either package.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import __graft_entry__ as ge
from tests.torch_dist_cases import (dist_steps_case, point_forward_case,
                                    point_primitives_case, run_ranks, tsm_batch, tsm_state)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.parallel import point_sharding as jps
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.runtime.train_state import is_student

NPOINT = 96
SCALES = [(0.0, 0.25, 8), (0.25, 0.5, 16)]
GRID = (4, 8, 8)
CAPACITY = 64


def _mesh():
    return Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "points"))


def _clouds():
    rng = np.random.RandomState(3)
    B, N = 2, 512
    xyz = (rng.randint(0, 64, (B, N, 3)) / 32.0).astype(np.float32)
    feats = rng.uniform(0, 1, (B, N, 2)).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.2
    valid[1, 300:] = False      # a segment with a masked tail
    coords = rng.randint(0, 4, (1, N, 3)).astype(np.int32)
    vfeat = rng.uniform(-1, 1, (1, N, 4)).astype(np.float32)
    vvalid = rng.uniform(size=(1, N)) > 0.3
    return xyz, feats, valid, (coords, vfeat, vvalid, CAPACITY, GRID)


@pytest.fixture(scope="module")
def primitives(tmp_path_factory):
    xyz, feats, valid, vox = _clouds()
    ranks = run_ranks(point_primitives_case, (xyz, feats, valid, NPOINT, SCALES, vox),
                      tmp_path_factory.mktemp("prims"))
    mesh = _mesh()
    want = {
        "fps": jax.jit(lambda x, v: jps.segment_local_fps(x, NPOINT, mesh, v))(xyz, valid),
        "fps_nomask": jax.jit(lambda x: jps.segment_local_fps(x, NPOINT, mesh))(xyz)}
    payload = np.concatenate([xyz, feats], -1)
    want["rows"] = jax.jit(lambda p, i: jps.gather_from_sharded(p, i, mesh))(
        payload, ranks[0]["fps"])
    q = np.asarray(want["rows"])[..., :3]
    want["groups"] = jax.jit(lambda x, f, v, q: jps.sharded_ball_group_multi(
        tuple((lo, hi) for lo, hi, _ in SCALES), tuple(ns for *_, ns in SCALES), x, f, v,
        q, mesh))(xyz, feats, valid, q)
    coords, vfeat, vvalid, cap, grid = vox
    want["vox"] = jax.jit(lambda c, f, v: jps.sharded_voxel_centroids(
        c, f, v, cap, grid, mesh))(coords[0], vfeat[0], vvalid[0])
    return ranks, jax.tree_util.tree_map(np.asarray, want)


def test_segment_local_fps_index_equal(primitives):
    ranks, want = primitives
    for r in ranks:
        np.testing.assert_array_equal(r["fps"], want["fps"])
        np.testing.assert_array_equal(r["fps_plain"], want["fps"])
        np.testing.assert_array_equal(r["fps_nomask"], want["fps_nomask"])
        np.testing.assert_array_equal(r["fps_plain_nomask"], want["fps_nomask"])
    assert not np.array_equal(want["fps"], want["fps_nomask"])


def test_gather_from_sharded(primitives):
    ranks, want = primitives
    for r in ranks:
        np.testing.assert_array_equal(r["rows"], want["rows"])


def test_sharded_ball_group_multi(primitives):
    ranks, want = primitives
    assert len(want["groups"]) == len(SCALES)
    for r in ranks:
        for (cnt, rows), (j_xyz, j_feat, j_cnt), (f_cnt, f_rows) in zip(
                r["groups"], want["groups"], r["full"]):
            np.testing.assert_array_equal(cnt, j_cnt)
            np.testing.assert_array_equal(rows, np.concatenate([j_xyz, j_feat], -1))
            ns = rows.shape[2]
            filled = np.arange(ns) < f_cnt[..., None]
            np.testing.assert_array_equal(cnt, f_cnt)
            np.testing.assert_array_equal(rows, np.where(filled[..., None], f_rows, 0))
        assert (r["groups"][1][0] > SCALES[1][2]).any(), "some query must overflow ns"


def test_sharded_voxel_centroids(primitives):
    ranks, prims = primitives
    want = prims["vox"]
    for r in ranks:
        got = r["centroids"]
        for k in ("coordinates", "counts", "valid"):
            np.testing.assert_array_equal(got[k][0], want[k], err_msg=k)
        np.testing.assert_array_equal(got["num_voxels"][0], want["num_voxels"])
        np.testing.assert_allclose(got["centroids"][0], want["centroids"], rtol=1e-6,
                                   atol=1e-6)
        assert got["valid"].sum() > 10


@functools.lru_cache(maxsize=None)
def _jax_fns():
    model = ge._tsm_model()
    mesh = _mesh()

    @jax.jit
    def forward(v, b):
        out = model.apply(v, b, training=False)
        pred, _ = model.apply(v, out, method=lambda m, bd: m.post_processing(bd))
        return out, pred

    @jax.jit
    def loss_grad(v, b):
        def loss_fn(p):
            out, _ = model.apply(dict(v, params=p), b, training=True,
                                 mutable=["batch_stats", "statistics"])
            return out["loss"], out["tb_dict"]

        return jax.value_and_grad(loss_fn, has_aux=True)(v["params"])

    return mesh, forward, loss_grad


def _jax_batch(batch):
    return {k: v for k, v in batch.items()}


@pytest.fixture(scope="module")
def sharded_forward(tmp_path_factory):
    batch = tsm_batch(2, "sparse")
    del batch["gt_boxes"], batch["gt_boxes_mask"]
    ranks = run_ranks(point_forward_case, (batch,), tmp_path_factory.mktemp("fwd"))
    mesh, forward, _ = _jax_fns()
    with jps.activate(mesh, "points"):
        out, pred = forward(to_flax_variables(tsm_state()), _jax_batch(batch))
    return ranks, jax.tree_util.tree_map(np.asarray, (out, pred))


def test_sharded_forward_matches_jax(sharded_forward):
    ranks, (out, pred) = sharded_forward
    for r in ranks:
        for k in ("batch_cls_preds", "batch_box_preds"):
            want = out[k]
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(r["out"][k], want, rtol=1e-3, atol=1e-3 * scale,
                                       err_msg=k)
        np.testing.assert_array_equal(r["pred"]["count"], pred["count"])


def test_sharded_forward_ranks_bit_equal(sharded_forward):
    ranks, _ = sharded_forward
    for k, v in ranks[0]["out"].items():
        assert np.array_equal(v, ranks[1]["out"][k]), k
    for k, v in ranks[0]["pred"].items():
        assert np.array_equal(v, ranks[1]["pred"][k]), k


@pytest.fixture(scope="module")
def sharded_step(tmp_path_factory):
    batch = tsm_batch(2, "wide")
    ranks = run_ranks(dist_steps_case, ([("tsm", batch)], 2),
                      tmp_path_factory.mktemp("step"))
    mesh, _, loss_grad = _jax_fns()
    with jps.activate(mesh, "points"):
        (loss, tb), grads = loss_grad(to_flax_variables(tsm_state()), _jax_batch(batch))
    return [r[0] for r in ranks], jax.tree_util.tree_map(np.asarray, (loss, tb, grads))


def test_sharded_step_matches_jax(sharded_step):
    ranks, (loss, tb, grads) = sharded_step
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-4, atol=1e-4 * max(1, abs(loss)))
        for k, v in tb.items():
            np.testing.assert_allclose(r["tb"][k], v, rtol=1e-4,
                                       atol=1e-4 * max(1, abs(float(v))), err_msg=k)
    want = from_flax_variables({"params": grads})
    trained = [k for k in want if is_student(k)]
    scale = max(float(want[k].abs().max()) for k in trained)
    assert float(tb["s_n_pos"]) > 0
    for k in trained:
        w = want[k].numpy()
        atol = 1e-4 * max(float(np.abs(w).max()), 1e-2 * scale)
        np.testing.assert_allclose(ranks[0]["grads"][k], w, rtol=1e-3, atol=atol, err_msg=k)


def test_sharded_step_ranks_bit_equal(sharded_step):
    ranks, _ = sharded_step
    assert ranks[0]["mismatches"] == [] and ranks[1]["mismatches"] == []
    for key in ("grads", "buffers", "params"):
        for k, v in ranks[0][key].items():
            assert np.array_equal(v.view(np.uint8), ranks[1][key][k].view(np.uint8)), (key, k)
