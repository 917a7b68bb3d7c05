"""The port's materialised sparse-conv route against the JAX package on the
CPU: K7's plain version (`gather_matmul_plain`) against the Pallas index
gather-GEMM it replaces (ops/spconv_pallas.py `_kernel`, in interpret mode)
and against its XLA formulation; the materialised rulebooks of the three
builders against the JAX builders', element for element; the convs through
the materialised route against the same convs by key; K7's gradient
(`_GatherConv`, whose backward is `gather_matmul_bwd_plain`) against
`jax.vjp` of the XLA formulation, as the JAX custom VJP's `_bwd` takes it.

Tolerance for sums: rtol 1e-5, atol 1e-5 * max|want| — f32 sums over taps
and channels run in another order on the two sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.ops import spconv as jsp
from tsm_det_pointcloud_tpu.ops import spconv_pallas
from tsm_det_pointcloud_tpu_torch.ops import spconv as tsp
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("c,co,k", [(4, 16, 27), (16, 32, 27), (64, 128, 3)])
def test_gather_matmul_plain_matches_pallas_and_xla(c, co, k):
    """Ragged Q (300: not a multiple of the Pallas 256-row block), unsorted
    indices, 15% misses and a whole 256-row tile of -1 in one tap."""
    rng = np.random.RandomState(c + co + k)
    B, V, Q = 2, 384, 300
    f = rng.randn(B, V, c).astype(np.float32)
    idx = rng.randint(0, V, (B, k, Q)).astype(np.int32)
    idx[rng.rand(B, k, Q) < 0.15] = -1
    idx[:, 1, :256] = -1
    w = (rng.randn(k, c, co) * 0.1).astype(np.float32)
    got = tsp.gather_matmul(torch.from_numpy(f), torch.from_numpy(idx),
                            torch.from_numpy(w))
    assert got.shape == (B, Q, co)
    want = spconv_pallas._gather_matmul_fwd(jnp.asarray(f), jnp.asarray(idx),
                                            jnp.asarray(w), interpret=True)
    _close(got.numpy(), want)
    _close(got.numpy(), spconv_pallas._xla_reference(jnp.asarray(f), jnp.asarray(idx),
                                                     jnp.asarray(w)))
    assert np.abs(got.numpy()).max() > 0


def test_gather_matmul_all_misses_is_zero():
    f = torch.randn(1, 50, 8)
    idx = torch.full((1, 27, 70), -1, dtype=torch.int32)
    out = tsp.gather_matmul(f, idx, torch.randn(27, 8, 16))
    assert out.shape == (1, 70, 16) and not out.any()


def _voxels(seed, B=2, V=300, grid=(9, 20, 20)):
    """Key-sorted voxel sets with a padded tail (as tests/test_torch_spconv)."""
    rng = np.random.RandomState(seed)
    gz, gy, gx = grid
    coords = np.full((B, V, 3), -1, np.int32)
    valid = np.zeros((B, V), bool)
    for b in range(B):
        n = V - 70 + b * 17
        cells = np.sort(rng.choice(gz * gy * gx, n, replace=False))
        coords[b, :n] = np.stack([cells // (gy * gx), cells // gx % gy, cells % gx], -1)
        valid[b, :n] = True
    return coords, valid, grid


def _og(grid, ks, st, pd):
    return tuple(int(g) for g in (np.asarray(grid) + 2 * np.asarray(pd) - np.asarray(ks))
                 // np.asarray(st) + 1)


# (kernel, stride, padding) of VoxelBackBone8x's strided convs: the plain
# down conv, conv4_down (padding (0, 1, 1)) and conv_out ((3, 1, 1), 3 taps)
PLANS = {"down": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
         "conv4_down": ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
         "conv_out": ((3, 1, 1), (2, 1, 1), (0, 0, 0))}


def _assert_same_rulebook(got, want):
    """where(found, idx, -1) element for element. The JAX CPU builders probe a
    dense voxel->slot table whose idx is 0 where not found, so idx is
    compared through found."""
    gi, gf = (t.numpy() for t in got)
    wi, wf = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_array_equal(np.where(gf, gi, -1), np.where(wf, wi, -1))
    assert wf.any() and not wf.all()


def test_subm_rulebook_materialised():
    coords, valid, grid = _voxels(0)
    want = jsp.build_subm_rulebook(jnp.asarray(coords), jnp.asarray(valid), grid)
    got = tsp.build_subm_rulebook(torch.from_numpy(coords), torch.from_numpy(valid), grid,
                                  lazy=False)
    _assert_same_rulebook(got, want)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_conv_plan_materialised(plan):
    ks, st, pd = PLANS[plan]
    coords, valid, grid = _voxels(1)
    og = _og(grid, ks, st, pd)
    woc, wov, want = jsp.build_conv_plan(jnp.asarray(coords), jnp.asarray(valid), grid, og,
                                         ks, st, pd, 250)
    goc, gov, got = tsp.build_conv_plan(torch.from_numpy(coords), torch.from_numpy(valid),
                                        grid, og, ks, st, pd, 250, lazy=False)
    np.testing.assert_array_equal(goc.numpy(), np.asarray(woc))
    np.testing.assert_array_equal(gov.numpy(), np.asarray(wov))
    assert got[0].shape[1] == int(np.prod(ks))
    _assert_same_rulebook(got, want)


def test_inverse_rulebook_materialised():
    coords, valid, grid = _voxels(2)
    og = _og(grid, 3, 2, 1)
    tc, tv = torch.from_numpy(coords), torch.from_numpy(valid)
    oc, ov, _ = tsp.build_conv_plan(tc, tv, grid, og, 3, 2, 1, 250)
    want = jsp.build_inverse_rulebook(jnp.asarray(oc.numpy()), jnp.asarray(ov.numpy()),
                                      jnp.asarray(coords), jnp.asarray(valid), og, 3, 2, 1)
    got = tsp.build_inverse_rulebook(oc, ov, tc, tv, og, 3, 2, 1, lazy=False)
    _assert_same_rulebook(got, want)


@pytest.mark.parametrize("kind", ["subm", "down", "conv4_down", "conv_out", "inverse"])
def test_materialised_conv_equals_bykey(kind):
    """The same conv, same inputs and weights, through both routes."""
    coords, valid, grid = _voxels(3)
    rng = np.random.RandomState(4)
    tc, tv = torch.from_numpy(coords), torch.from_numpy(valid)
    c, co = 16, 24
    if kind == "subm":
        feats = torch.from_numpy(rng.randn(2, 300, c).astype(np.float32))
        w = torch.from_numpy((rng.randn(27, c, co) * 0.1).astype(np.float32))
        routes = [tsp.subm_conv3d(feats, tc, tv, w, grid,
                                  rulebook=tsp.build_subm_rulebook(tc, tv, grid, lazy=lazy))
                  for lazy in (False, True)]
    elif kind == "inverse":
        og = _og(grid, 3, 2, 1)
        oc, ov, _ = tsp.build_conv_plan(tc, tv, grid, og, 3, 2, 1, 250)
        feats = torch.from_numpy(rng.randn(2, 250, c).astype(np.float32))
        w = torch.from_numpy((rng.randn(27, c, co) * 0.1).astype(np.float32))
        routes = [tsp.inverse_conv3d(feats, oc, ov, w, tc, tv, og, 3, 2, 1,
                                     rulebook=tsp.build_inverse_rulebook(
                                         oc, ov, tc, tv, og, 3, 2, 1, lazy=lazy))
                  for lazy in (False, True)]
    else:
        ks, st, pd = PLANS[kind]
        og = _og(grid, ks, st, pd)
        feats = torch.from_numpy(rng.randn(2, 300, c).astype(np.float32))
        w = torch.from_numpy((rng.randn(int(np.prod(ks)), c, co) * 0.1).astype(np.float32))
        routes = []
        for lazy in (False, True):
            plan = tsp.build_conv_plan(tc, tv, grid, og, ks, st, pd, 250, lazy=lazy)
            routes.append(tsp.sparse_conv3d(feats, tc, tv, w, grid, og, ks, st, pd, 250,
                                            plan=plan)[0])
    mat, bykey = (r.numpy() for r in routes)
    assert np.abs(bykey).max() > 0
    _close(mat, bykey)


def test_sparse_to_dense_matches_jax():
    coords, valid, grid = _voxels(5, V=120)
    feats = np.random.RandomState(6).randn(2, 120, 5).astype(np.float32)
    feats[~valid] = 7.0                                    # invalid rows are dropped
    want = jsp.sparse_to_dense(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                               grid)
    got = tsp.sparse_to_dense(torch.from_numpy(feats), torch.from_numpy(coords),
                              torch.from_numpy(valid), grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _vjp_case(kind):
    """(features, idx, weight, g) numpy: a random map with -1 entries and
    repeats, a strided conv's materialised plan, and conv_out's 3-tap one."""
    rng = np.random.RandomState({"random": 7, "down": 8, "conv_out": 9}[kind])
    if kind == "random":
        B, V, Q, K, c, co = 2, 200, 150, 27, 16, 32
        idx = rng.randint(0, V - 30, (B, K, Q)).astype(np.int32)   # rows >= V - 30 unnamed
        idx[rng.rand(B, K, Q) < 0.4] = -1
        idx[:, 2] = -1
    else:
        ks, st, pd = PLANS[kind]
        coords, valid, grid = _voxels(10)
        _, _, (i, found) = tsp.build_conv_plan(
            torch.from_numpy(coords), torch.from_numpy(valid), grid,
            _og(grid, ks, st, pd), ks, st, pd, 250, lazy=False)
        idx = torch.where(found, i, torch.full_like(i, -1)).numpy()
        B, K, Q = idx.shape
        V, c, co = coords.shape[1], 64, 128 if kind == "conv_out" else 64
    assert (idx >= 0).any() and (idx < 0).any()
    f = rng.randn(B, V, c).astype(np.float32)
    w = (rng.randn(K, c, co) / np.sqrt(K * c)).astype(np.float32)
    g = rng.randn(B, Q, co).astype(np.float32)
    return f, idx, w, g


@pytest.mark.parametrize("kind", ["random", "down", "conv_out"])
def test_gather_conv_gradient_matches_jax_vjp(kind):
    """df and dW of the materialised conv's product (`_GatherConv`) against
    jax.vjp of `_xla_reference` at the same cotangent; rows no index names
    get a zero df on both sides."""
    f, idx, w, g = _vjp_case(kind)
    _, vjp = jax.vjp(lambda a, b: spconv_pallas._xla_reference(a, jnp.asarray(idx), b),
                     jnp.asarray(f), jnp.asarray(w))
    want_df, want_dw = vjp(jnp.asarray(g))
    tf = torch.from_numpy(f).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tsp._GatherConv.apply(tf, tw, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g))
    _close(tf.grad.numpy(), want_df)
    _close(tw.grad.numpy(), want_dw)
    named = np.zeros(f.shape[:2], bool)
    for b in range(f.shape[0]):
        named[b, idx[b][idx[b] >= 0]] = True
    assert not named.all() and not tf.grad.numpy()[~named].any()


def test_materialised_conv_backward_reaches_features_and_weight():
    """A subm conv on a materialised rulebook, masked output, under
    autograd: its gradients equal the by-key route's (K5's plain version)."""
    coords, valid, grid = _voxels(11)
    rng = np.random.RandomState(12)
    tc, tv = torch.from_numpy(coords), torch.from_numpy(valid)
    f0 = rng.randn(2, 300, 16).astype(np.float32)
    w0 = (rng.randn(27, 16, 16) * 0.1).astype(np.float32)
    g = torch.from_numpy(rng.randn(2, 300, 16).astype(np.float32))
    grads = []
    for lazy in (False, True):
        f = torch.from_numpy(f0).requires_grad_(True)
        w = torch.from_numpy(w0).requires_grad_(True)
        out = tsp.subm_conv3d(f, tc, tv, w, grid,
                              rulebook=tsp.build_subm_rulebook(tc, tv, grid, lazy=lazy))
        out.backward(g)
        grads.append((f.grad.numpy(), w.grad.numpy()))
    (mf, mw), (bf, bw) = grads
    assert np.abs(mw).max() > 0
    _close(mf, bf)
    _close(mw, bw)
