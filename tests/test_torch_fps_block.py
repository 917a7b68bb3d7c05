"""The port's block-pruned exact d-fps (prep + plain pruned update, the CPU
twin of kernel K6) against the JAX package: the XLA oracle
`_furthest_point_sample_xla` and the Pallas block-pruned kernel in interpret
mode with 1, 2 and 4 rows a program. Inputs come from numpy seeds.
Tolerance: none — the picks are indices and must be equal.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.ops.fps_pallas import (
    furthest_point_sample_block_pruned as jax_block_pruned,
)
from tsm_det_pointcloud_tpu.ops.sampling import _furthest_point_sample_xla
from tsm_det_pointcloud_tpu_torch.ops import sampling
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _clustered(rng, B, N):
    xyz = np.zeros((B, N, 3), np.float32)
    per = N // 8
    for b in range(B):
        for k in range(8):
            c = rng.uniform(-50, 50, 3) * [1, 1, 0.02]
            xyz[b, k * per:(k + 1) * per] = c + rng.uniform(-2, 2, (per, 3))
    return xyz


def _case(name):
    """(xyz (B, N, 3) f32, npoint, mask (B, N) bool or None)."""
    if name == "random_mask":
        rng = np.random.RandomState(7)
        xyz = rng.uniform(-40, 40, (2, 2500, 3)).astype(np.float32)
        mask = rng.rand(2, 2500) > 0.1
        mask[:, 0] = True
        return xyz, 256, mask
    if name == "four_blocks":
        rng = np.random.RandomState(8)
        return rng.uniform(-40, 40, (1, 4096, 3)).astype(np.float32), 1024, None
    if name == "clustered_masked_tail":
        xyz = _clustered(np.random.RandomState(11), 3, 4096)
        mask = np.ones((3, 4096), bool)
        mask[:, 4096 - 700:] = False
        return xyz, 256, mask
    if name == "duplicate_points_ties":
        rng = np.random.RandomState(11)
        base = rng.uniform(-10, 10, (1, 300, 3)).astype(np.float32)
        return np.concatenate([base, base[:, ::2], base[:, :100]], axis=1), 128, None
    if name == "ragged_last_block":
        rng = np.random.RandomState(12)
        return rng.uniform(-30, 30, (2, 3000, 3)).astype(np.float32), 200, None
    if name == "mask_empties_blocks":
        # the masked points are one corner of space: whole Morton blocks of
        # the sort's tail hold no valid point
        xyz = _clustered(np.random.RandomState(13), 2, 4096)
        mask = np.ones((2, 4096), bool)
        mask[:, 1024:3584] = False
        return xyz, 300, mask
    if name == "more_picks_than_valid":
        rng = np.random.RandomState(14)
        xyz = rng.uniform(-20, 20, (2, 1500, 3)).astype(np.float32)
        mask = np.zeros((2, 1500), bool)
        mask[:, :40] = True
        return xyz, 96, mask
    if name == "negative_coordinates":
        rng = np.random.RandomState(15)
        xyz = rng.uniform(-75, -5, (2, 2048, 3)).astype(np.float32)
        mask = rng.rand(2, 2048) > 0.3
        mask[:, 0] = True
        return xyz, 256, mask
    raise KeyError(name)


CASES = ["random_mask", "four_blocks", "clustered_masked_tail", "duplicate_points_ties",
         "ragged_last_block", "mask_empties_blocks", "more_picks_than_valid",
         "negative_coordinates"]


@functools.lru_cache(maxsize=None)
def _port_picks(name):
    xyz, npoint, mask = _case(name)
    got, visits = sampling._block_pruned_plain(
        torch.from_numpy(xyz), npoint, None if mask is None else torch.from_numpy(mask))
    return got.numpy(), visits.numpy()


@pytest.mark.parametrize("name", CASES)
def test_plain_block_pruned_equals_xla_oracle(name):
    xyz, npoint, mask = _case(name)
    want = np.asarray(_furthest_point_sample_xla(
        jnp.asarray(xyz), npoint, None if mask is None else jnp.asarray(mask)))
    got, visits = _port_picks(name)
    np.testing.assert_array_equal(got, want)
    nb = -(-xyz.shape[1] // sampling.FPS_BLOCK)
    assert (visits <= (npoint - 1) * nb).all()
    if name in ("clustered_masked_tail", "mask_empties_blocks", "more_picks_than_valid"):
        # the pruning is real: clustered or mostly-masked scans skip most
        # (step, block) updates
        assert (visits < (npoint - 1) * nb // 2).all()


@pytest.mark.parametrize("rows", [0, 2, 4])
@pytest.mark.parametrize("name", CASES)
def test_plain_block_pruned_equals_jax_block_pruned_kernel(name, rows):
    xyz, npoint, mask = _case(name)
    want = np.asarray(jax_block_pruned(
        jnp.asarray(xyz), npoint, None if mask is None else jnp.asarray(mask),
        interpret=True, rows=rows))
    np.testing.assert_array_equal(_port_picks(name)[0], want)


@pytest.mark.parametrize("name", CASES)
def test_plain_block_pruned_equals_port_plain_fps(name):
    xyz, npoint, mask = _case(name)
    want = sampling.furthest_point_sample_plain(
        torch.from_numpy(xyz), npoint, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(_port_picks(name)[0], want.numpy())


def test_empty_row_follows_the_oracle():
    """A scan with no valid point picks index 0 at every step, as the
    oracle's argmax over all -1 does; its neighbour in the batch is
    unaffected."""
    rng = np.random.RandomState(16)
    xyz = rng.uniform(-20, 20, (2, 2100, 3)).astype(np.float32)
    mask = np.ones((2, 2100), bool)
    mask[0] = False
    want = np.asarray(_furthest_point_sample_xla(jnp.asarray(xyz), 64, jnp.asarray(mask)))
    got = sampling.furthest_point_sample_block_pruned_plain(
        torch.from_numpy(xyz), 64, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all()


def test_invalid_seed_point():
    """Pick 0 is index 0 even when that point is invalid, and its
    coordinates still drive the first update, as in the oracle."""
    rng = np.random.RandomState(17)
    xyz = rng.uniform(-20, 20, (1, 2048, 3)).astype(np.float32)
    mask = np.ones((1, 2048), bool)
    mask[:, :5] = False
    want = np.asarray(_furthest_point_sample_xla(jnp.asarray(xyz), 100, jnp.asarray(mask)))
    got = sampling.furthest_point_sample_block_pruned_plain(
        torch.from_numpy(xyz), 100, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_prep_layout():
    """Blocks of FPS_BLOCK in Morton order with invalid rows last; pad lanes
    and invalid rows never widen a box; the block arg is the least original
    index among the block's valid points."""
    xyz, _, mask = _case("random_mask")
    st = sampling.block_prep(torch.from_numpy(xyz), torch.from_numpy(mask))
    B, N = mask.shape
    w = sampling.FPS_BLOCK
    nb = -(-N // w)
    assert st.xs.shape == (B, nb * w) and st.bbox.shape == (B, 6, nb)
    ois = st.ois.numpy()
    for b in range(B):
        real = ois[b] < N
        assert sorted(ois[b][real]) == list(range(N))
        v = mask[b][ois[b][real]]
        n_valid = int(mask[b].sum())
        assert v[:n_valid].all() and not v[n_valid:].any()
        np.testing.assert_array_equal(st.xs.numpy()[b][real], xyz[b, ois[b][real], 0])
        for g in range(nb):
            sl = slice(g * w, (g + 1) * w)
            vg = st.mind.numpy()[b, sl] > 0
            if vg.any():
                assert st.bbox[b, 0, g] == st.xs.numpy()[b, sl][vg].min()
                assert st.bbox[b, 1, g] == st.xs.numpy()[b, sl][vg].max()
                assert st.barg[b, g] == ois[b, sl][vg].min()
                assert st.bmax[b, g] == 1e10


def test_dispatch_on_cpu():
    """A CPU tensor goes to the plain lockstep version from
    furthest_point_sample at any N (also above K1's 16384), and the public
    block-pruned entry is callable at any N."""
    rng = np.random.RandomState(18)
    xyz = torch.from_numpy(rng.uniform(-40, 40, (1, 16500, 3)).astype(np.float32))
    want = sampling.furthest_point_sample_plain(xyz, 24)
    assert torch.equal(sampling.furthest_point_sample(xyz, 24), want)
    assert torch.equal(sampling.furthest_point_sample_block_pruned(xyz, 24), want)
    small = xyz[:, :50]
    assert torch.equal(sampling.furthest_point_sample_block_pruned(small, 10),
                       sampling.furthest_point_sample_plain(small, 10))


def test_sfps_above_k1_limit_raises_on_the_kernel_path():
    """K1's wrapper refuses rows past its 16384 points (s-fps over longer
    rows goes to K6's weighted instantiation); on a CPU tensor s-fps takes
    any N through the plain version."""
    xyz = torch.zeros((1, sampling.FPS_MAX_POINTS + 1, 3))
    w = torch.ones(xyz.shape[:2])
    with pytest.raises(ValueError, match="K6"):
        sampling._fps_kernel(xyz, 4, None, w)
    assert torch.equal(sampling.furthest_point_sample_weights(xyz, w, 4),
                       sampling.furthest_point_sample_plain(xyz, 4, None, w))


def test_morton_code_matches_jax():
    from tsm_det_pointcloud_tpu.ops.group_pallas import morton_code as jax_morton

    rng = np.random.RandomState(19)
    xyz = rng.uniform(-80, 80, (2, 500, 3)).astype(np.float32)
    origin = xyz.min(axis=1, keepdims=True)
    want = np.asarray(jax_morton(jnp.asarray(xyz), jnp.asarray(origin), cell=1.0))
    got = sampling.morton_code(torch.from_numpy(xyz), torch.from_numpy(origin)).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_block_pruned_at_waymo_test_points_equals_jax():
    """waymo_fast_cpc.yaml's test scans hold 163840 points a row, past the
    8-CTA layout of K6 (sampling.FPS_BLOCK_SMALL_POINTS): a few picks of the
    port's plain block-pruned d-fps there equal the JAX package's
    `sampling.furthest_point_sample` (the XLA oracle on the CPU), masked
    tail included."""
    from tsm_det_pointcloud_tpu.ops.sampling import furthest_point_sample as jax_fps

    n = 163840
    assert sampling.FPS_BLOCK_SMALL_POINTS < n <= sampling.FPS_BLOCK_MAX_POINTS
    xyz = _clustered(np.random.RandomState(16), 1, n)
    mask = np.ones((1, n), bool)
    mask[:, n - 5000:] = xyz[:, n - 5000:, 0] > 0
    want = np.asarray(jax_fps(jnp.asarray(xyz), 24, jnp.asarray(mask)))
    got = sampling.furthest_point_sample_block_pruned(torch.from_numpy(xyz), 24,
                                                      torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
