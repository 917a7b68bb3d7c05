"""Port neighbour queries (ops/grouping.py, ops/voxel.py) against the JAX
package's nearest-k XLA references. `cnt` and `idx` must be equal: both
sides form d2 = max((|q|^2 + |x|^2) - 2 q.x, 0) in f32 and break d2 ties by
the lower index. N stays <= 8192, where the JAX top-k is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.ops import grouping as jgrp
from tsm_det_pointcloud_tpu.ops import voxel as jvox
from tsm_det_pointcloud_tpu_torch.ops import grouping as tgrp
from tsm_det_pointcloud_tpu_torch.ops import voxel as tvox


def _points(seed, B=2, N=1500, M=200, masked=True):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(0, 6, (B, N, 3)).astype(np.float32)
    xyz[:, -200:] = xyz[:, :200]          # duplicated points: equal d2
    xyz[:, 200:260] = np.round(xyz[:, 200:260] * 4) / 4  # lattice ties
    valid = (rng.uniform(size=(B, N)) > 0.2) if masked else np.ones((B, N), bool)
    q = xyz[:, rng.choice(N, M, replace=False)] + rng.normal(
        0, 0.05, (B, M, 3)).astype(np.float32)
    return xyz, valid, q.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_multi_dilated(masked):
    xyz, valid, q = _points(0, masked=masked)
    pairs = ((0.0, 0.2), (0.2, 0.4), (0.4, 0.8))
    ns = (16, 32, 32)
    want = jgrp.ball_query_multi(pairs, ns, jnp.asarray(xyz), jnp.asarray(q),
                                 jnp.asarray(valid))
    got = tgrp.ball_query_multi(pairs, ns, torch.from_numpy(xyz),
                                torch.from_numpy(q), torch.from_numpy(valid))
    for (wi, wc), (gi, gc) in zip(want, got):
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        assert np.asarray(wc).max() > 0
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_group_points_and_fused_payload():
    xyz, valid, q = _points(1)
    rng = np.random.RandomState(2)
    feats = rng.randn(*xyz.shape[:2], 5).astype(np.float32)
    pairs, ns = ((0.0, 0.3), (0.3, 0.6)), (8, 16)
    (idx, _), _ = jgrp.ball_query_multi(pairs, ns, jnp.asarray(xyz),
                                        jnp.asarray(q), jnp.asarray(valid))
    want = np.asarray(jgrp.group_points(jnp.asarray(feats), idx))
    got = tgrp.group_points(torch.from_numpy(feats),
                            torch.tensor(np.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the fused query+gather returns the same rows (exact f32 gather)
    payload = np.concatenate([xyz, feats], -1)
    out = tgrp.query_group(torch.from_numpy(xyz), torch.from_numpy(valid),
                           torch.from_numpy(q),
                           [(mn, mx, n) for (mn, mx), n in zip(pairs, ns)],
                           payload=torch.from_numpy(payload))
    np.testing.assert_array_equal(out[0][2][..., 3:].numpy(), want)
    np.testing.assert_array_equal(
        out[0][2][..., :3].numpy(),
        np.asarray(jgrp.group_points(jnp.asarray(xyz), idx)))


def _centroid_case(seed, B=2, V=300, M=120):
    rng = np.random.RandomState(seed)
    grid = (8, 40, 40)
    coords = np.stack([rng.randint(0, g, (B, V)) for g in grid], -1).astype(np.int32)
    cxyz = ((coords[..., ::-1] + rng.uniform(0, 1, (B, V, 3))) * 0.2).astype(np.float32)
    cvalid = rng.uniform(size=(B, V)) > 0.15
    qxyz = (cxyz[:, :M] + rng.normal(0, 0.1, (B, M, 3))).astype(np.float32)
    qcoords = np.floor(qxyz / 0.2).astype(np.int32)[..., ::-1].copy()
    return cxyz, coords, cvalid, qxyz, qcoords


@pytest.mark.parametrize("radius,nsample,qr,min_r", [
    (0.8, 16, (2, 2, 2), 0.0),
    (1.6, 32, (4, 4, 4), 0.0),
    (1.6, 8, (1, 3, 3), 0.4),
])
def test_voxel_query_window(radius, nsample, qr, min_r):
    cxyz, coords, cvalid, qxyz, qcoords = _centroid_case(3)
    got_i, got_c = tvox.voxel_query(
        torch.from_numpy(qxyz), torch.from_numpy(qcoords),
        torch.from_numpy(cxyz), torch.from_numpy(coords),
        torch.from_numpy(cvalid), radius, nsample, qr, min_radius=min_r)
    for b in range(cxyz.shape[0]):
        wi, wc = jvox.voxel_query(
            jnp.asarray(qxyz[b]), jnp.asarray(qcoords[b]), jnp.asarray(cxyz[b]),
            jnp.asarray(coords[b]), jnp.asarray(cvalid[b]), radius=radius,
            nsample=nsample, query_range=qr, min_radius=min_r)
        np.testing.assert_array_equal(got_c[b].numpy(), np.asarray(wc))
        np.testing.assert_array_equal(got_i[b].numpy(), np.asarray(wi))
    assert got_c.numpy().max() > 0


def test_voxel_centroids():
    rng = np.random.RandomState(4)
    B, N, V = 2, 400, 128
    grid = (4, 20, 20)
    coords = np.stack([rng.randint(0, g, (B, N)) for g in grid], -1).astype(np.int32)
    feats = rng.randn(B, N, 7).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.1
    got = tvox.voxel_centroids(torch.from_numpy(coords), torch.from_numpy(feats),
                               torch.from_numpy(valid), V, grid)
    for b in range(B):
        want = jvox.voxel_centroids(jnp.asarray(coords[b]), jnp.asarray(feats[b]),
                                    jnp.asarray(valid[b]), num_voxels=V,
                                    grid_dims=grid)
        want = jax.tree_util.tree_map(np.asarray, want)
        for k in ("coordinates", "counts", "point_slot", "valid"):
            np.testing.assert_array_equal(got[k][b].numpy(), want[k], err_msg=k)
        assert int(got["num_voxels"][b]) == int(want["num_voxels"])
        # segment sums in another order: f32 rounding only
        np.testing.assert_allclose(got["centroids"][b].numpy(), want["centroids"],
                                   rtol=1e-5, atol=1e-6)
