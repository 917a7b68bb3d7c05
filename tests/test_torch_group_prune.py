"""K2's pruned route on the CPU: `group_prep` (Morton tiles and boxes), the
visit rule with its rounding margin, and the nearest k by (d2, original
index) over the visited pairs (`query_group_pruned_plain`). Held exactly
equal to `query_group_plain` (idx, cnt, gathered rows) and to the JAX
package's `ball_query_multi` / `voxel_query` (the tolerance of
tests/test_torch_grouping.py: equal), and every hit pair of the plain
version must lie in a visited tile. N stays <= 8192, where the JAX top-k is
exact. Coordinates lie on a 2**-5 m grid: with |x|, |y| <= 75 m and
|z| <= 4 m every product and partial sum of the cross term q.x is exact in
f32, so the JAX reference's matmul cross term gives the port's d2 bits (off
the grid the two round differently in the last bit and can order nearly
equal d2 differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.ops import grouping as jgrp
from tsm_det_pointcloud_tpu.ops import voxel as jvox
from tsm_det_pointcloud_tpu_torch.ops import grouping as tgrp
from torch_group_cases import ADV_R, ADV_R2, adversarial, on_grid
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

DILATED = ((0.0, 0.8), (0.8, 1.6), (1.6, 2.4))
NS = (16, 32, 8)


def _scene(name):
    """(xyz (B, N, 3), valid (B, N), queries (B, M, 3)) f32 / bool, numpy."""
    rng = np.random.RandomState(sum(map(ord, name)))
    B, N, M = 2, 3000, 300
    if name == "uniform":
        xyz = rng.uniform((-20, -20, -2), (20, 20, 1), (B, N, 3))
        valid = rng.uniform(size=(B, N)) > 0.1
    elif name == "clustered":
        xyz = rng.uniform((-35, -35, -2), (35, 35, 1), (B, N, 3))
        for k in range(8):
            c = rng.uniform((-30, -30, -1), (30, 30, 0), (B, 1, 3))
            xyz[:, 600 + 300 * k:900 + 300 * k] = c + rng.normal(0, 0.8, (B, 300, 3))
        valid = np.ones((B, N), bool)
    elif name == "empty_rows":
        B = 3
        xyz = rng.uniform((-20, -20, -2), (20, 20, 1), (B, N, 3))
        valid = rng.uniform(size=(B, N)) > 0.3
        valid[1] = False            # a scan with no valid source
        valid[2, :2200] = False     # most tiles of this scan are all-invalid
    else:
        raise KeyError(name)
    xyz = on_grid(xyz)
    xyz[:, -150:] = xyz[:, :150]                           # duplicated points
    q = xyz[:, rng.choice(N, M, replace=False)] + rng.normal(0, 0.3, (B, M, 3))
    return xyz, valid, on_grid(q)



def _hits(xyz, valid, q, scales, coords=None, qc=None):
    """(B, M, N) bool: pairs that hit some scale, by the plain version's
    arithmetic."""
    x = torch.from_numpy(xyz)
    qq = torch.from_numpy(q)
    cross = (qq[..., None, 0] * x[:, None, :, 0] + qq[..., None, 1] * x[:, None, :, 1]) \
        + qq[..., None, 2] * x[:, None, :, 2]
    d2 = (tgrp._sq_norm(qq)[..., None] + tgrp._sq_norm(x)[:, None]) - 2.0 * cross
    d2 = torch.where(d2 > 0, d2, torch.zeros_like(d2))
    any_hit = torch.zeros(d2.shape, dtype=torch.bool)
    for mn, mx, _, qr in tgrp._norm_scales(scales):
        h = torch.from_numpy(valid)[:, None] & (d2 < tgrp._r2(mx))
        if mn > 0:
            h &= d2 >= tgrp._r2(mn)
        if qr is not None:
            dc = (torch.from_numpy(qc)[:, :, None].long()
                  - torch.from_numpy(coords)[:, None].long()).abs()
            h &= (dc <= torch.tensor(qr)).all(-1)
        any_hit |= h
    return any_hit


def _check_route(xyz, valid, q, scales, payload=None, coords=None, qc=None):
    """The pruned route equals the plain version; every plain hit pair lies
    in a visited tile. Returns the route's (idx, cnt) split per scale."""
    t = (lambda a: None if a is None else torch.from_numpy(a))
    args = (t(xyz), t(valid), t(q), scales, t(payload), t(coords), t(qc))
    want = tgrp.query_group_plain(*args)
    got_i, got_c, got_g, visits = tgrp.query_group_pruned_plain(*args)
    np.testing.assert_array_equal(got_c.numpy(), want[1].numpy())
    np.testing.assert_array_equal(got_i.numpy(), want[0].numpy())
    if payload is not None:
        np.testing.assert_array_equal(got_g.numpy(), want[2].numpy())

    norm = tgrp._norm_scales(scales)
    window = any(s[3] is not None for s in norm)
    prep = tgrp.group_prep(t(xyz), t(valid), t(q), t(coords) if window else None)
    visited, visits2 = tgrp._visit_rule(prep, t(q), t(qc), norm)
    assert torch.equal(visits, visits2)
    B, N = xyz.shape[:2]
    M = q.shape[1]
    nt = prep.tbox.shape[1]
    assert visited.shape == (B, M, nt)
    # every hit pair (b, m, n) of the plain version lies in a visited tile
    tile_of = torch.full((B, N), -1, dtype=torch.long)
    rows = prep.oi.long()
    for b in range(B):
        keep = rows[b] >= 0
        tile_of[b, rows[b][keep]] = torch.nonzero(keep)[:, 0] // tgrp.GROUP_TILE
    qpos = torch.argsort(prep.qperm.long(), dim=1)
    hb, hm, hn = torch.nonzero(_hits(xyz, valid, q, scales, coords, qc), as_tuple=True)
    assert hb.numel() > 0
    assert bool((tile_of[hb, hn] >= 0).all())
    assert bool(visited[hb, qpos[hb, hm], tile_of[hb, hn]].all())
    # the visit counts: no more than every (query, tile) pair
    assert int(visits.sum()) <= B * M * nt
    out, off = [], 0
    for s in norm:
        out.append((got_i[..., off:off + s[2]].numpy(), got_c[..., len(out)].numpy()))
        off += s[2]
    return out, visits


def _against_jax_ball(xyz, valid, q, pairs, ns, route):
    want = jgrp.ball_query_multi(pairs, ns, jnp.asarray(xyz), jnp.asarray(q),
                                 jnp.asarray(valid))
    for (wi, wc), (gi, gc) in zip(want, route):
        np.testing.assert_array_equal(gc, np.asarray(wc))
        np.testing.assert_array_equal(gi, np.asarray(wi))


@pytest.mark.parametrize("name", ["uniform", "clustered", "empty_rows"])
def test_pruned_route_ball_query(name):
    xyz, valid, q = _scene(name)
    rng = np.random.RandomState(3)
    payload = np.concatenate([xyz, rng.randn(*xyz.shape[:2], 4).astype(np.float32)], -1)
    scales = [(mn, mx, n) for (mn, mx), n in zip(DILATED, NS)]
    route, visits = _check_route(xyz, valid, q, scales, payload)
    _against_jax_ball(xyz, valid, q, DILATED, NS, route)
    assert max(int(c.max()) for _, c in route) > 0
    # the rule prunes: far fewer (query, tile) pairs than all of them
    nt = -(-xyz.shape[1] // tgrp.GROUP_TILE)
    assert int(visits.sum()) < 0.6 * q.shape[0] * q.shape[1] * nt
    if name == "empty_rows":
        assert int(route[0][1][1].max()) == 0       # the scan with no valid source
        assert (route[0][0][1] == 0).all()
        assert int(visits[1].sum()) == 0             # and no tile of it visited


def test_pruned_route_adversarial_boundary():
    xyz, valid, q = adversarial()
    pairs, ns = ((0.0, ADV_R),), (32,)
    route, visits = _check_route(xyz, valid, q, [(0.0, ADV_R, 32)])
    _against_jax_ball(xyz, valid, q, pairs, ns, route)
    # the case is adversarial: some sources truly outside r test as hits,
    # beside true hits and true misses
    d_true = ((xyz[0, ::256].astype(np.float64) - q[0].astype(np.float64)) ** 2).sum(-1)
    cnt = route[0][1][0]
    r2 = np.float64(tgrp._r2(ADV_R))
    assert r2 == ADV_R2
    assert ((d_true > r2) & (cnt == 256)).any()
    assert ((d_true < r2) & (cnt == 256)).any() and ((d_true > r2) & (cnt == 0)).any()
    # each hit tile holds 256 equal d2: ties go to the lower original index
    hit = cnt > 0
    first = np.arange(len(cnt))[hit] * 256
    np.testing.assert_array_equal(route[0][0][0][hit], first[:, None] + np.arange(32))


def test_pruned_route_margin_is_needed():
    """Without the margin the adversarial case loses hits: the rule's
    margin, not luck, keeps the route exact there."""
    xyz, valid, q = adversarial()
    t = torch.from_numpy
    prep = tgrp.group_prep(t(xyz), t(valid), t(q))
    group_tile = torch.argsort(prep.oi[0, ::tgrp.GROUP_TILE].long() // 256)  # group -> tile
    box = prep.tbox[0, group_tile]
    assert torch.equal(box[:, :3], box[:, 3:6])            # each tile is one point
    g = box[:, :3] - t(q)[0]
    gap2 = (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + g[:, 2] * g[:, 2]
    _, cnt, _ = tgrp.query_group_plain(t(xyz), t(valid), t(q), [(0.0, ADV_R, 32)])
    hit = cnt[0, :, 0] > 0
    assert (hit & (gap2 > ADV_R2)).any()           # a margin-free rule skips these
    visited, _ = tgrp._visit_rule(prep, t(q), None, [(0.0, ADV_R, 32, None)])
    qpos = torch.argsort(prep.qperm.long(), dim=1)[0]
    assert bool(visited[0, qpos, group_tile][hit].all())


def _window_case(seed, B=2, V=2500, M=300):
    rng = np.random.RandomState(seed)
    grid = (20, 200, 200)
    coords = np.stack([rng.randint(0, g, (B, V)) for g in grid], -1).astype(np.int32)
    coords[:, -100:] = coords[:, :100]                     # duplicated voxels
    cxyz = on_grid((coords[..., ::-1] + rng.uniform(0.05, 0.95, (B, V, 3))) * 0.2)
    cxyz[:, -100:] = cxyz[:, :100]
    cvalid = rng.uniform(size=(B, V)) > 0.15
    qxyz = on_grid(cxyz[:, :M] + rng.normal(0, 0.3, (B, M, 3)))
    qcoords = np.floor(qxyz / 0.2).astype(np.int32)[..., ::-1].copy()
    return cxyz, coords, cvalid, qxyz, qcoords


@pytest.mark.parametrize("radius,nsample,qr,min_r", [
    (0.8, 16, (2, 2, 2), 0.0),
    (1.6, 32, (4, 4, 4), 0.0),
    (1.6, 8, (1, 3, 3), 0.4),
])
def test_pruned_route_window_query(radius, nsample, qr, min_r):
    cxyz, coords, cvalid, qxyz, qcoords = _window_case(11)
    payload = np.concatenate([cxyz, np.random.RandomState(4).randn(
        *cxyz.shape[:2], 3).astype(np.float32)], -1)
    route, _ = _check_route(cxyz, cvalid, qxyz, [(min_r, radius, nsample, qr)], payload,
                            coords, qcoords)
    (gi, gc), = route
    assert gc.max() > 0
    for b in range(cxyz.shape[0]):
        wi, wc = jvox.voxel_query(
            jnp.asarray(qxyz[b]), jnp.asarray(qcoords[b]), jnp.asarray(cxyz[b]),
            jnp.asarray(coords[b]), jnp.asarray(cvalid[b]), radius=radius,
            nsample=nsample, query_range=qr, min_radius=min_r)
        np.testing.assert_array_equal(gc[b], np.asarray(wc))
        np.testing.assert_array_equal(gi[b], np.asarray(wi))


def test_pruned_route_mixed_window_scales():
    """Two window scales with different ranges in one call, as the VSA
    layers make them: the rule takes the largest range per axis."""
    cxyz, coords, cvalid, qxyz, qcoords = _window_case(12)
    scales = [(0.0, 0.8, 16, (1, 1, 2)), (0.4, 1.6, 32, (3, 4, 4))]
    _check_route(cxyz, cvalid, qxyz, scales, None, coords, qcoords)


def test_group_prep_layout():
    """Morton tiles: invalid rows last with index -1, whole tiles of
    GROUP_TILE rows, empty boxes for all-invalid tiles, a query
    permutation."""
    xyz, valid, q = _scene("empty_rows")
    prep = tgrp.group_prep(torch.from_numpy(xyz), torch.from_numpy(valid),
                           torch.from_numpy(q))
    B, N = valid.shape
    nt = -(-N // tgrp.GROUP_TILE)
    assert prep.pts.shape == (B, nt * tgrp.GROUP_TILE, 4)
    for b in range(B):
        oi = prep.oi[b].numpy()
        n_valid = int(valid[b].sum())
        assert (oi[:n_valid] >= 0).all() and (oi[n_valid:] == -1).all()
        assert sorted(oi[:n_valid]) == sorted(np.nonzero(valid[b])[0])
        np.testing.assert_array_equal(prep.pts[b, :n_valid, :3].numpy(), xyz[b, oi[:n_valid]])
        empty = np.arange(nt) * tgrp.GROUP_TILE >= n_valid
        assert (prep.tbox[b, empty, :3].numpy() == 1e30).all()
        assert (prep.tbox[b, ~empty, :3] <= prep.tbox[b, ~empty, 3:6]).all()
        assert sorted(prep.qperm[b].tolist()) == list(range(q.shape[1]))


def test_tile_cache_reuses_and_renews():
    """A TileCache hands back the same tiles for the same source tensors,
    and tiles anew for other tensors or after an in-place write; on the CPU
    query_group takes no tiles from it."""
    xyz, valid, q = _scene("uniform")
    x, v = torch.from_numpy(xyz), torch.from_numpy(valid)
    cache = tgrp.TileCache()
    first = cache.get(x, v)
    assert cache.get(x, v) is first
    for got, want in zip(first, tgrp.tile_sources(x, v)):
        assert (got is None and want is None) or torch.equal(got, want)
    assert cache.get(x.clone(), v) is not first
    again = cache.get(x, v)
    assert again is not first and torch.equal(again.tbox, first.tbox)
    x[0, 0, 0] += 5.0
    moved = cache.get(x, v)
    assert moved is not again and torch.equal(moved.tbox, tgrp.tile_sources(x, v).tbox)

    fresh = tgrp.TileCache()
    tgrp.query_group(x, v, torch.from_numpy(q), [(0.0, 0.8, 8)], cache=fresh)
    assert fresh._tiles is None
