"""Port sparse conv (ops/spconv.py) against the JAX package: the rulebook
probe is exact; conv outputs agree to f32 summation order (stated below)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.ops import searchsorted_pallas
from tsm_det_pointcloud_tpu.ops import spconv as jsp
from tsm_det_pointcloud_tpu.ops import spconv_pallas
from tsm_det_pointcloud_tpu_torch.ops import spconv as tsp

# f32 sums over up to 27 taps x C channels in another order than XLA's
RTOL, ATOL = 1e-5, 1e-5


def _case(seed=0, B=2, V=300, C=16, Co=24, grid=(8, 20, 20)):
    rng = np.random.RandomState(seed)
    sent = int(np.prod(grid))
    coords = np.full((B, V, 3), -1, np.int32)
    valid = np.zeros((B, V), bool)
    gz, gy, gx = grid
    for b in range(B):
        n = V - 70 + b * 17
        cells = rng.choice(sent, n, replace=False)
        cc = np.stack([cells // (gy * gx), (cells // gx) % gy, cells % gx],
                      -1).astype(np.int32)
        key = (cc[:, 0] * gy + cc[:, 1]) * gx + cc[:, 2]
        coords[b, :n] = cc[np.argsort(key)]
        valid[b, :n] = True
    feats = rng.randn(B, V, C).astype(np.float32)
    w = (rng.randn(27, C, Co) * 0.1).astype(np.float32)
    return coords, valid, feats, w, grid


def _probe_inputs():
    coords, valid, _, _, grid = _case()
    keys = jsp.linearize(jnp.asarray(coords), grid, jnp.asarray(valid))
    offs = jnp.asarray(jsp.kernel_offsets(3))
    qk = jsp.linearize(jnp.asarray(coords)[:, None] + offs[None, :, None],
                       grid, jnp.asarray(valid)[:, None, :])
    return np.array(keys), np.array(qk), int(np.prod(grid))


def test_linearize_and_offsets():
    coords, valid, _, _, grid = _case(1)
    coords[0, 3] = (grid[0], 0, 0)  # out of grid: sentinel
    want = np.asarray(jsp.linearize(jnp.asarray(coords), grid, jnp.asarray(valid)))
    got = tsp.linearize(torch.from_numpy(coords), grid, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (1, 3, (3, 1, 3), 2):
        np.testing.assert_array_equal(tsp.kernel_offsets(k), jsp.kernel_offsets(k))


def test_lookup_matches_jax():
    keys, qk, sent = _probe_inputs()
    wi, wf = jsp._lookup_batched(jnp.asarray(keys), jnp.asarray(qk), sent)
    gi, gf = tsp._lookup_batched(torch.from_numpy(keys), torch.from_numpy(qk), sent)
    wf = np.asarray(wf)
    np.testing.assert_array_equal(gf.numpy(), wf)
    assert wf.any()
    np.testing.assert_array_equal(gi.numpy()[wf], np.asarray(wi)[wf])


def test_lookup_matches_pallas_interpret():
    """The probe K3 replaces: rank - 1 clamped and membership, bitwise for
    every care query (< sentinel)."""
    keys, qk, sent = _probe_inputs()
    B, K, Q = qk.shape
    pi, pf = searchsorted_pallas.searchsorted_rulebook(
        jnp.asarray(keys), jnp.asarray(qk.reshape(B, 1, K * Q)), sent,
        interpret=True)
    pi = np.asarray(pi).reshape(B, K, Q)
    pf = np.asarray(pf).reshape(B, K, Q) & (qk < sent)
    gi, gf = tsp._lookup_batched(torch.from_numpy(keys), torch.from_numpy(qk), sent)
    care = qk < sent
    np.testing.assert_array_equal(gf.numpy(), pf)
    np.testing.assert_array_equal(gi.numpy()[care], pi[care])


def test_bykey_plain_matches_pallas_interpret():
    """K4's plain version against the Pallas by-key kernel it replaces."""
    coords, valid, feats, w, grid = _case(2, V=200, C=8, Co=12)
    sent = int(np.prod(grid))
    keys = jsp.linearize(jnp.asarray(coords), grid, jnp.asarray(valid))
    offs = jnp.asarray(jsp.kernel_offsets(3))
    qk = jsp.linearize(jnp.asarray(coords)[:, None] + offs[None, :, None],
                       grid, jnp.asarray(valid)[:, None, :])
    want = spconv_pallas.gather_matmul_bykey(
        jnp.asarray(feats), keys, qk, jnp.asarray(w), sent, interpret=True)
    got = tsp.gather_matmul_bykey(torch.from_numpy(feats),
                                  torch.tensor(np.asarray(keys)),
                                  torch.tensor(np.asarray(qk)),
                                  torch.from_numpy(w), sent)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("k", [1, 3])
def test_subm_conv(k):
    coords, valid, feats, w, grid = _case(3)
    w = w[:k ** 3]
    want = np.asarray(jsp.subm_conv3d(jnp.asarray(feats), jnp.asarray(coords),
                                      jnp.asarray(valid), jnp.asarray(w), grid))
    got = tsp.subm_conv3d(torch.from_numpy(feats), torch.from_numpy(coords),
                          torch.from_numpy(valid), torch.from_numpy(w), grid)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("capacity", [64, 1000])
def test_strided_and_inverse_conv(capacity):
    """Capacity 64 truncates the output set, 1000 pads it."""
    coords, valid, feats, w, grid = _case(4)
    og = (4, 10, 10)
    strided = jax.jit(functools.partial(
        jsp.sparse_conv3d, grid=grid, out_grid=og, kernel_size=3, stride=2,
        padding=1, out_capacity=capacity))
    wf, woc, wov = strided(jnp.asarray(feats), jnp.asarray(coords),
                           jnp.asarray(valid), jnp.asarray(w))
    gf, goc, gov = tsp.sparse_conv3d(torch.from_numpy(feats),
                                     torch.from_numpy(coords),
                                     torch.from_numpy(valid),
                                     torch.from_numpy(w), grid, og, 3, 2, 1,
                                     capacity)
    np.testing.assert_array_equal(goc.numpy(), np.asarray(woc))
    np.testing.assert_array_equal(gov.numpy(), np.asarray(wov))
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=RTOL, atol=ATOL)

    w_inv = np.ascontiguousarray(np.swapaxes(w, 1, 2))   # coarse Co -> fine C
    coarse = np.asarray(wf)
    inverse = jax.jit(functools.partial(
        jsp.inverse_conv3d, coarse_grid=og, kernel_size=3, stride=2, padding=1))
    want = np.asarray(inverse(jnp.asarray(coarse), woc, wov, jnp.asarray(w_inv),
                              jnp.asarray(coords), jnp.asarray(valid)))
    got = tsp.inverse_conv3d(torch.from_numpy(coarse.copy()), goc, gov,
                             torch.from_numpy(w_inv), torch.from_numpy(coords),
                             torch.from_numpy(valid), og, 3, 2, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))
