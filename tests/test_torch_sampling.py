"""Port FPS (tsm_det_pointcloud_tpu_torch.ops.sampling) against the JAX
package's XLA loops. Picks must be index-equal: both sides compute the same
f32 distances in the same order, and ties go to the first maximum."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.ops import sampling as jsamp
from tsm_det_pointcloud_tpu_torch.ops import _kernels
from tsm_det_pointcloud_tpu_torch.ops import sampling as tsamp


def _cloud(seed, B=2, N=300, dup=False, masked=False, dead_row=False):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-5, 5, (B, N, 3)).astype(np.float32)
    if dup:
        # exact duplicates and a regular lattice give equal distances: ties
        xyz[:, N // 2:] = xyz[:, :N - N // 2]
        xyz[:, :40] = np.stack(np.meshgrid(np.arange(4), np.arange(5),
                                           np.arange(2), indexing="ij"),
                               -1).reshape(-1, 3)
    valid = np.ones((B, N), bool)
    if masked:
        valid = rng.uniform(size=(B, N)) > 0.3
    if dead_row:
        valid[-1] = False
    return xyz, valid


CASES = {
    "plain": dict(),
    "masked": dict(masked=True),
    "duplicates": dict(dup=True),
    "dup_masked": dict(dup=True, masked=True),
    "dead_row": dict(masked=True, dead_row=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dfps_index_equal(case):
    xyz, valid = _cloud(0, **CASES[case])
    want = np.asarray(jsamp._furthest_point_sample_xla(
        jnp.asarray(xyz), 64, jnp.asarray(valid)))
    got = tsamp.furthest_point_sample(torch.from_numpy(xyz), 64,
                                      torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dfps_no_mask_index_equal():
    xyz, _ = _cloud(1, dup=True)
    want = np.asarray(jsamp._furthest_point_sample_xla(jnp.asarray(xyz), 50))
    got = tsamp.furthest_point_sample(torch.from_numpy(xyz), 50).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sfps_index_equal(case):
    xyz, valid = _cloud(2, **CASES[case])
    rng = np.random.RandomState(3)
    logits = rng.randn(*valid.shape).astype(np.float32) * 3
    logits[:, ::7] = -1e9  # zero weights: many equal keys
    w = (0.5 * (1.0 + np.tanh(0.5 * logits.astype(np.float64)))).astype(np.float32)
    want = np.asarray(jsamp._furthest_point_sample_weights_xla(
        jnp.asarray(xyz), jnp.asarray(w), 48, jnp.asarray(valid)))
    got = tsamp.furthest_point_sample_weights(
        torch.from_numpy(xyz), torch.from_numpy(w), 48,
        torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_takes_plain_version():
    """A CPU tensor runs the plain version: no kernel launch is counted."""
    xyz, valid = _cloud(4)
    before = dict(_kernels.LAUNCHES)
    tsamp.furthest_point_sample(torch.from_numpy(xyz), 8, torch.from_numpy(valid))
    assert _kernels.LAUNCHES == before


def test_gather_points():
    rng = np.random.RandomState(5)
    pts = rng.randn(2, 50, 6).astype(np.float32)
    idx = rng.randint(0, 50, (2, 17)).astype(np.int32)
    want = np.asarray(jsamp.gather_points(jnp.asarray(pts), jnp.asarray(idx)))
    got = tsamp.gather_points(torch.from_numpy(pts), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
