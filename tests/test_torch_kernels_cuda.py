"""Each hand-written kernel against its plain PyTorch version on the card
(skipped on hosts without one). Run there with
    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
K1 / K2 / K3 / K6 are exact; K4, K5 and K7 multiply in split precision
(3xTF32) and sum in another f32 order, fixed from launch to launch (all
bit-equal on repeat; rtol 1e-4, atol 1e-4 * max|out|)."""
import numpy as np
import pytest
import torch

from torch_group_cases import ADV_R, adversarial, on_grid
from tsm_det_pointcloud_tpu_torch.ops import _kernels, grouping, sampling, spconv

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _counted(name, fn):
    before = _kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("weighted", [False, True])
def test_fps_kernel(dev, weighted):
    rng = np.random.RandomState(0)
    xyz = torch.from_numpy(rng.uniform(-5, 5, (3, 3000, 3)).astype(np.float32)).to(dev)
    xyz[:, 1500:] = xyz[:, :1500]
    valid = torch.from_numpy(rng.uniform(size=(3, 3000)) > 0.2).to(dev)
    w = torch.rand(3, 3000, device=dev) if weighted else None
    got = _counted("fps", lambda: sampling._fps_kernel(xyz, 256, valid, w))
    want = sampling.furthest_point_sample_plain(xyz, 256, valid, w)
    assert torch.equal(got, want)


def _lattice(shape, rng):
    """The integer points of a box of `shape` around the origin, shuffled:
    every d2 is exact, so nearly every step ties."""
    g = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32) - np.asarray(shape, np.float32) // 2
    return g[rng.permutation(len(g))]


@pytest.mark.parametrize("weighted", [False, True])
def test_fps_kernel_ties_across_ctas(dev, weighted):
    """A lattice row of 16384 integer points around a seed at its centre, a
    quarter of them duplicated elsewhere in the row: the steps tie between
    points that different warps and CTAs of the cluster own, and the least
    index must win. The weights are powers of two, so w * mindist ties too."""
    rng = np.random.RandomState(23)
    xyz = np.stack([_lattice((32, 32, 16), rng) for _ in range(2)])
    xyz[:, 0] = 0.0                                   # the seed: the lattice centre
    xyz[:, -4096:] = xyz[:, 1:4097]                   # duplicates, far apart in the row
    xyz = torch.from_numpy(xyz).to(dev)
    w = (torch.from_numpy(2.0 ** rng.randint(-1, 2, (2, 16384))).float().to(dev)
         if weighted else None)
    got = _counted("fps", lambda: sampling._fps_kernel(xyz, 2048, None, w))
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, 2048, None, w))


@pytest.mark.parametrize("batch,npoint,weighted", [(16, 4096, False), (8, 3072, True)])
def test_fps_kernel_full_batch_one_wave(dev, batch, npoint, weighted):
    """K1 at the TSM paths' widest calls (KITTI d-fps b16 x 16384 -> 4096,
    Waymo s-fps b8 x 16384 -> 3072), every row's cluster resident at once,
    with a row whose mask is empty and one of 100 valid points."""
    from tsm_det_pointcloud_tpu_torch.infer import synth_points

    plan = sampling.fps_plan(16384, weighted)
    assert plan["cluster_size"] in (4, 8) and plan["active_clusters"] >= batch
    xyz = torch.from_numpy(np.ascontiguousarray(
        synth_points(batch, 16384, seed=batch)[..., :3])).to(dev)
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    valid[3] = False
    valid[5, 100:] = False
    w = torch.rand(xyz.shape[:2], device=dev) if weighted else None
    got = _counted("fps", lambda: sampling._fps_kernel(xyz, npoint, valid, w))
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, npoint, valid, w))


def _fps_block_case(name):
    """(xyz (B, N, 3), npoint, valid or None) on the CPU, from numpy seeds."""
    rng = np.random.RandomState(20)
    if name == "clustered":
        xyz = rng.uniform(-60, 60, (3, 5000, 3)).astype(np.float32)
        for k in range(6):
            c = rng.uniform(-50, 50, 3).astype(np.float32)
            xyz[:, k * 500:(k + 1) * 500] = c + rng.uniform(-2, 2, (3, 500, 3))
        return xyz, 700, rng.uniform(size=(3, 5000)) > 0.2
    if name == "ties":
        base = rng.uniform(-10, 10, (2, 1500, 3)).astype(np.float32)
        return np.concatenate([base, base[:, ::2], base[:, :300]], 1), 400, None
    if name == "empty_row":
        xyz = rng.uniform(-20, 20, (2, 2100, 3)).astype(np.float32)
        valid = np.ones((2, 2100), bool)
        valid[0] = False
        return xyz, 64, valid
    if name == "empty_blocks_and_short":
        xyz = rng.uniform(-20, 20, (2, 4096, 3)).astype(np.float32)
        valid = np.zeros((2, 4096), bool)
        valid[:, 5:90] = True
        return xyz, 128, valid
    raise KeyError(name)


@pytest.mark.parametrize("name", ["clustered", "ties", "empty_row",
                                  "empty_blocks_and_short"])
def test_fps_block_kernel(dev, name):
    xyz, npoint, valid = _fps_block_case(name)
    xyz = torch.from_numpy(xyz).to(dev)
    valid = None if valid is None else torch.from_numpy(valid).to(dev)
    got = _counted("fps_block", lambda: sampling.furthest_point_sample_block_pruned(
        xyz, npoint, valid))
    want = sampling.furthest_point_sample_plain(xyz, npoint, valid)
    assert torch.equal(got, want)
    # the plain block-pruned version visits the same (step, block) pairs
    _, visits = sampling._fps_block_kernel(xyz, npoint, valid)
    _, want_visits = sampling._block_pruned_plain(xyz, npoint, valid)
    assert torch.equal(visits, want_visits)


def _waymo_xyz(batch, seed=0):
    from tsm_det_pointcloud_tpu_torch.infer import synth_waymo
    return torch.from_numpy(np.ascontiguousarray(synth_waymo(batch, 122880, seed)[..., :3]))


@pytest.mark.parametrize("batch", [1, 8, 16])
def test_fps_block_kernel_waymo_shapes(dev, batch):
    """122880 -> 16384 picks index for index; b16 is more scans than one
    wave of clusters holds on an H100 at cluster size 16 or 8."""
    xyz = _waymo_xyz(batch, seed=batch).to(dev)
    plan = sampling.fps_block_plan(122880 // sampling.FPS_BLOCK)
    assert plan["active_clusters"] > 0
    got = _counted("fps_block", lambda: sampling.furthest_point_sample_block_pruned(
        xyz, 16384))
    want = sampling.furthest_point_sample_plain(xyz, 16384)
    assert torch.equal(got, want)


def test_fps_block_kernel_ties_across_ctas(dev):
    """A lattice of integer points (exact distances) around a seed at its
    centre, a sixth of them duplicated elsewhere in the row: nearly every
    step ties between blocks that different CTAs own, and the least
    original index must win."""
    rng = np.random.RandomState(22)
    g = np.stack(np.meshgrid(np.arange(64), np.arange(48), np.arange(40), indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32) - [32, 24, 20]
    xyz = np.stack([g[rng.permutation(len(g))] for _ in range(2)])
    xyz[:, 0] = 0.0                                   # the seed: the lattice centre
    xyz[:, -20480:] = xyz[:, 1:20481]                 # duplicates, far apart in the row
    xyz = torch.from_numpy(xyz).to(dev)
    got = _counted("fps_block", lambda: sampling.furthest_point_sample_block_pruned(
        xyz, 4096))
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, 4096))


def test_fps_block_kernel_masked_waymo(dev):
    """The masked input of chip_smoke.py's phase 10: whole Morton blocks
    empty (x <= 0 past the first 40000 points), an empty scan, a scan of
    100 points."""
    xyz = _waymo_xyz(4).to(dev)
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    valid[:, 40000:] = xyz[:, 40000:, 0] > 0
    valid[1] = False
    valid[2, 100:] = False
    got = _counted("fps_block", lambda: sampling.furthest_point_sample_block_pruned(
        xyz, 16384, valid))
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, 16384, valid))


@pytest.mark.parametrize("n, cluster", [(131072, 8), (131073, 16), (163840, 16),
                                        (sampling.FPS_BLOCK_MAX_POINTS, 16)])
def test_fps_block_kernel_long_rows(dev, n, cluster):
    """Rows up to FPS_BLOCK_SMALL_POINTS keep the cluster of 8 CTAs; longer
    ones, up to the cap (waymo_fast_cpc.yaml's test scans hold 163840), run
    on a cluster of 16. Index-equal to the plain FPS, on the clustered scans
    and with whole Morton blocks masked out."""
    from tsm_det_pointcloud_tpu_torch.infer import synth_waymo
    batch = 2 if n < sampling.FPS_BLOCK_MAX_POINTS else 1
    xyz = torch.from_numpy(np.ascontiguousarray(synth_waymo(batch, n, seed=n)[..., :3])).to(dev)
    assert sampling.fps_block_plan(-(-n // sampling.FPS_BLOCK))["cluster_size"] == cluster
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    valid[:, 40000:] = xyz[:, 40000:, 0] > 0
    for mask in (None, valid):
        got = _counted("fps_block", lambda: sampling.furthest_point_sample_block_pruned(
            xyz, 2048, mask))
        assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, 2048, mask))


def test_fps_block_kernel_above_cap_raises(dev):
    xyz = torch.zeros((1, sampling.FPS_BLOCK_MAX_POINTS + 1, 3), device=dev)
    before = _kernels.LAUNCHES["fps_block"]
    with pytest.raises(ValueError, match="FPS_BLOCK_MAX_POINTS"):
        sampling.furthest_point_sample(xyz, 16)
    assert _kernels.LAUNCHES["fps_block"] == before


@pytest.mark.parametrize("n,num_sectors", [(20000, 6), (3000, 4)])
def test_sector_fps_rows(dev, n, num_sectors):
    """PV-RCNN++'s sector d-fps: one launch over the B * S sector rows (K6
    above 16384 points a row, K1 below), index-equal to the plain d-fps, on
    rows whose valid set excludes index 0 (every sector but point 0's), a
    scan with no valid point (every row empty), a scan with its first
    sector under-filled (3 valid points, fewer than its share) and KITTI's
    field of view (x > 0: sectors 0 and 5 of 6 empty)."""
    from tsm_det_pointcloud_tpu_torch.models.backbones_3d.pfe import vector_pool

    rng = np.random.RandomState(24)
    xyz = rng.uniform(-40, 40, (3, n, 3)).astype(np.float32)
    xyz[2, :, 0] = np.abs(xyz[2, :, 0]) + 0.1
    valid = np.ones((3, n), bool)
    valid[1] = False
    sector = vector_pool.sector_ids(torch.from_numpy(xyz), num_sectors).numpy()
    first = np.flatnonzero(sector[0] == 0)
    valid[0, first[3:]] = False
    xyz, valid = torch.from_numpy(xyz).to(dev), torch.from_numpy(valid).to(dev)
    npoint = 4096 if n > sampling.FPS_MAX_POINTS else 200
    shares = vector_pool.sector_shares(npoint, num_sectors)
    kernel = "fps_block" if n > sampling.FPS_MAX_POINTS else "fps"
    got = _counted(kernel, lambda: vector_pool.sectorized_fps(xyz, valid, npoint, num_sectors))
    rows, masks = vector_pool.sector_rows(xyz, valid, num_sectors)
    assert not masks[:, 0].all() and (~masks).all(1).any()
    want = sampling.furthest_point_sample_plain(rows, shares[0], masks).reshape(
        3, num_sectors, shares[0])
    want = torch.cat([want[:, s, :k] for s, k in enumerate(shares)], 1)
    assert torch.equal(got, want)
    assert (got[1] == 0).all() and (got[0, 4:shares[0]] == int(first[0])).all()


def test_fps_dispatch_above_k1_limit(dev):
    """d-fps over more than 16384 points a row launches K6, not K1."""
    rng = np.random.RandomState(21)
    xyz = torch.from_numpy(rng.uniform(-40, 40, (2, 20000, 3)).astype(np.float32)).to(dev)
    before = _kernels.LAUNCHES["fps"]
    got = _counted("fps_block", lambda: sampling.furthest_point_sample(xyz, 300))
    assert _kernels.LAUNCHES["fps"] == before
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, 300))


def _weighted_case(name):
    """(xyz (B, N, 3), npoint, valid or None, weights (B, N)) on the CPU for
    K6's weighted instantiation, from numpy seeds: rows past K1's 16384."""
    rng = np.random.RandomState(30)
    if name == "clustered":
        xyz = rng.uniform(-60, 60, (2, 20000, 3)).astype(np.float32)
        for k in range(6):
            c = rng.uniform(-50, 50, 3).astype(np.float32)
            xyz[:, k * 2000:(k + 1) * 2000] = c + rng.uniform(-2, 2, (2, 2000, 3))
        valid = rng.uniform(size=(2, 20000)) > 0.2
        return xyz, 1024, valid, rng.uniform(size=(2, 20000)).astype(np.float32)
    if name == "ties":   # a lattice, powers-of-two weights: keys tie across CTAs
        g = np.stack(np.meshgrid(np.arange(40), np.arange(32), np.arange(16), indexing="ij"),
                     -1).reshape(-1, 3).astype(np.float32) - [20, 16, 8]
        xyz = np.stack([g[rng.permutation(len(g))] for _ in range(2)])
        xyz[:, 0] = 0.0
        xyz[:, -4096:] = xyz[:, 1:4097]
        w = (2.0 ** rng.randint(-1, 2, xyz.shape[:2])).astype(np.float32)
        return xyz, 1024, None, w
    if name == "dim":   # a block's largest key far below its largest min-distance
        xyz = rng.uniform(-60, 60, (2, 20000, 3)).astype(np.float32)
        return xyz, 512, None, rng.uniform(0.01, 0.2, (2, 20000)).astype(np.float32)
    if name == "empty_and_short":
        xyz = rng.uniform(-20, 20, (3, 17000, 3)).astype(np.float32)
        valid = np.ones((3, 17000), bool)
        valid[0] = False
        valid[1, 100:] = False
        w = rng.uniform(size=(3, 17000)).astype(np.float32)
        w[2, ::7] = 0.0                      # zero weights: keys 0 beside valid ones
        return xyz, 256, valid, w
    raise KeyError(name)


@pytest.mark.parametrize("name", ["clustered", "ties", "dim", "empty_and_short"])
def test_fps_block_weighted_kernel(dev, name):
    """K6's weighted instantiation (s-fps past K1's rows) index-equal to the
    plain lockstep s-fps, visiting the (step, block) pairs of the plain
    block-pruned s-fps."""
    xyz, npoint, valid, w = _weighted_case(name)
    xyz, w = torch.from_numpy(xyz).to(dev), torch.from_numpy(w).to(dev)
    valid = None if valid is None else torch.from_numpy(valid).to(dev)
    got = _counted("fps_block_weighted", lambda: sampling.furthest_point_sample_weights(
        xyz, w, npoint, valid))
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, npoint, valid, w))
    _, visits = sampling._fps_block_kernel(xyz, npoint, valid, w)
    _, want_visits = sampling._block_pruned_plain(xyz, npoint, valid, w)
    assert torch.equal(visits, want_visits)


@pytest.mark.parametrize("batch, n", [(4, 65536), (2, 131073), (1, sampling.FPS_BLOCK_MAX_POINTS)])
def test_fps_block_weighted_long_rows(dev, batch, n):
    """Weighted rows on both cluster layouts, up to K6's cap, with random
    weights and whole Morton blocks masked out; d-fps launches on the same
    rows are not counted as weighted ones."""
    from tsm_det_pointcloud_tpu_torch.infer import synth_waymo
    xyz = torch.from_numpy(np.ascontiguousarray(synth_waymo(batch, n, seed=n)[..., :3])).to(dev)
    plan = sampling.fps_block_plan(-(-n // sampling.FPS_BLOCK), True)
    assert plan["active_clusters"] > 0
    valid = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    valid[:, 40000:] = xyz[:, 40000:, 0] > 0
    w = torch.rand(xyz.shape[:2], generator=torch.Generator().manual_seed(n)).to(dev)
    before = _kernels.LAUNCHES["fps_block"]
    got = _counted("fps_block_weighted", lambda: sampling.furthest_point_sample_weights(
        xyz, w, 2048, valid))
    assert _kernels.LAUNCHES["fps_block"] == before
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, 2048, valid, w))


@pytest.mark.parametrize("window", [False, True])
def test_query_group_kernel(dev, window):
    rng = np.random.RandomState(1)
    B, N, M = 2, 2000, 300
    xyz = torch.from_numpy(rng.uniform(0, 4, (B, N, 3)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(B, N)) > 0.1).to(dev)
    q = xyz[:, :M] + 0.05
    payload = torch.cat([xyz, torch.randn(B, N, 5, device=dev)], -1)
    coords = qc = None
    scales = [(0.0, 0.3, 16), (0.3, 0.6, 32)]
    if window:
        coords = torch.floor(xyz / 0.2).int().flip(-1).contiguous()
        qc = torch.floor(q / 0.2).int().flip(-1).contiguous()
        scales = [(0.0, 0.5, 16, (1, 2, 2)), (0.0, 0.9, 8, (3, 3, 3))]
    args = (xyz, valid, q, scales, payload, coords, qc)
    got = _counted("query_group", lambda: grouping._query_group_kernel(*args))
    want = grouping.query_group_plain(*args)
    for g, w in zip(got, want):   # idx, cnt, grouped
        assert torch.equal(g, w)


def test_query_group_payload_gradient_teacher_scales(dev):
    """K2's payload gradient (`_GroupPayload`: K2's forward, the cotangent
    of the filled slots scattered back by `index_add_`) at the teacher's
    layer-1 window scales (radii 0.4 / 0.8 / 1.6 / 3.2 m dilated, 32 samples,
    query ranges 2 / 4 / 8 / 16 voxels of 0.2 x 0.2 x 0.4 m) on a layer-0
    sized centroid set: the card's against the CPU's plain route, rtol 1e-5,
    atol 1e-5 * max|grad| (index_add_ sums in no fixed order on the card)."""
    rng = np.random.RandomState(11)
    B, N, M, D = 2, 4096, 512, 64
    xyz = on_grid(rng.uniform((0, -12, -2.5), (24, 12, 0.5), (B, N, 3)))
    valid = rng.uniform(size=(B, N)) > 0.05
    q = on_grid(xyz[:, :M] + rng.normal(0, 0.3, (B, M, 3)))
    vs = np.array([0.2, 0.2, 0.4])
    coords = np.floor((xyz - (0, -40, -3)) / vs).astype(np.int32)[..., ::-1].copy()
    qc = np.floor((q - (0, -40, -3)) / vs).astype(np.int32)[..., ::-1].copy()
    scales = [(0.0, 0.4, 32, (2, 2, 2)), (0.4, 0.8, 32, (4, 4, 4)),
              (0.8, 1.6, 32, (8, 8, 8)), (1.6, 3.2, 32, (16, 16, 16))]
    payload = np.concatenate([xyz, rng.randn(B, N, D).astype(np.float32)], -1)
    cot = torch.from_numpy(rng.randn(B, M, 32, 3 + D).astype(np.float32))

    def grad(d):
        src, v, qq, cc, qqc, pl = (torch.from_numpy(a).to(d)
                                   for a in (xyz, valid, q, coords, qc, payload))
        pl.requires_grad_(True)
        groups = grouping.query_group(src, v, qq, scales, pl, cc, qqc)
        total = 0.0
        for (_, cnt, g), (_, _, ns, _) in zip(groups, scales):
            filled = torch.arange(ns, device=d) < cnt[..., None]
            total = total + (torch.where(filled[..., None], g, 0.0) * cot.to(d)).sum()
        total.backward()
        return pl.grad.cpu(), [int(c.sum()) for _, c, _ in groups]

    want, want_cnt = grad(torch.device("cpu"))
    got, cnt = _counted("query_group", lambda: grad(dev))
    assert cnt == want_cnt and min(cnt) > 0
    scale = float(want.abs().max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * scale)


def _pruned_case(name):
    """K2 inputs on the CPU: more sources than one tile and more queries
    than one thread block."""
    if name == "adversarial":     # sources at r^2 +- a few ulp at |q| ~ 80 m
        xyz, valid, q = adversarial()
        return xyz, valid, q, [(0.0, ADV_R, 32)], None, None
    rng = np.random.RandomState(5)
    B, N, M = 2, 5000, 600
    xyz = on_grid(rng.uniform((-25, -25, -2), (25, 25, 1), (B, N, 3)))
    xyz[:, 2500:] = xyz[:, :2500]                  # every point twice: d2 ties
    valid = rng.uniform(size=(B, N)) > 0.1
    q = on_grid(xyz[:, rng.choice(N, M, replace=False)] + rng.normal(0, 0.2, (B, M, 3)))
    if name == "duplicates":
        return xyz, valid, q, [(0.0, 0.8, 16), (0.8, 1.6, 32), (1.6, 2.4, 8)], None, None
    coords = np.floor(xyz / 0.2).astype(np.int32)[..., ::-1].copy()
    qc = np.floor(q / 0.2).astype(np.int32)[..., ::-1].copy()
    return xyz, valid, q, [(0.0, 0.8, 16, (2, 3, 3)), (0.4, 1.6, 32, (4, 6, 6))], coords, qc


@pytest.mark.parametrize("scales", [
    [(0.0, 0.2, 32), (0.2, 0.4, 32), (0.4, 0.8, 64)],     # 3DSSD's layer 0, dilated
    [(0.0, 1.6, 64)],
    [(0.0, 0.8, 40), (0.8, 1.6, 33), (0.0, 2.4, 64), (0.4, 1.2, 8)],
])
def test_query_group_kernel_wide(dev, scales):
    """K2 with a scale of 33-64 samples (its two-entry kernel) equals the
    plain version exactly (idx, cnt, gathered rows) on every point twice
    (d2 ties), and tests the (query, tile) pairs of the plain visit rule."""
    rng = np.random.RandomState(31)
    B, N, M = 2, 6000, 700
    xyz = on_grid(rng.uniform((-3, -3, -0.5), (3, 3, 0.5), (B, N, 3)))
    xyz[:, 3000:] = xyz[:, :3000]
    valid = rng.uniform(size=(B, N)) > 0.1
    q = on_grid(xyz[:, rng.choice(N, M, replace=False)] + rng.normal(0, 0.1, (B, M, 3)))
    payload = np.concatenate([xyz, rng.randn(B, N, 7).astype(np.float32)], -1)
    cpu = [torch.from_numpy(a) for a in (xyz, valid, q, payload)]
    args = tuple(a.to(dev) for a in cpu[:3]) + (scales, cpu[3].to(dev), None, None)
    before = _kernels.LAUNCHES["query_group"]
    got = _counted("query_group_wide", lambda: grouping._query_group_kernel(*args))
    assert _kernels.LAUNCHES["query_group"] == before
    want = grouping.query_group_plain(*args)
    for g, w in zip(got, want):   # idx, cnt, grouped
        assert torch.equal(g, w)
    cnt = want[1]        # every scale finds hits; a wide one more than its samples
    assert all(int(cnt[..., s].max()) > (ns if ns > 32 else 0)
               for s, (_, _, ns) in enumerate(scales))
    scales_n, sx, sv, qx, pl, scc, qcc = grouping._kernel_inputs(*args)
    visits = grouping._query_group_launch(grouping.group_prep(sx, sv, qx), qx, scales_n, pl,
                                          qcc)[3]
    want_visits = grouping.query_group_pruned_plain(cpu[0], cpu[1], cpu[2], scales)[3]
    assert torch.equal(visits.cpu(), want_visits)


def test_query_group_above_cap_raises(dev):
    xyz = torch.zeros((1, 100, 3), device=dev)
    valid = torch.ones((1, 100), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="nsample in"):
        grouping._query_group_kernel(xyz, valid, xyz[:, :4], [(0.0, 1.0, 65)], None, None, None)


@pytest.mark.parametrize("name", ["adversarial", "duplicates", "window"])
def test_query_group_kernel_pruned(dev, name):
    """The pruned K2 equals the plain version exactly (idx, cnt, gathered
    rows), and tests the (query, tile) pairs of the plain visit rule."""
    xyz, valid, q, scales, coords, qc = _pruned_case(name)
    payload = np.concatenate([xyz, np.random.RandomState(6).randn(
        *xyz.shape[:2], 5).astype(np.float32)], -1)
    cpu = [None if a is None else torch.from_numpy(a) for a in (xyz, valid, q, payload,
                                                                coords, qc)]
    on = [None if a is None else a.to(dev) for a in cpu]
    args = (on[0], on[1], on[2], scales, on[3], on[4], on[5])
    got = _counted("query_group", lambda: grouping._query_group_kernel(*args))
    want = grouping.query_group_plain(*args)
    for g, w in zip(got, want):   # idx, cnt, grouped
        assert torch.equal(g, w)
    assert int(want[1].max()) > 0
    scales_n, sx, sv, qx, pl, scc, qcc = grouping._kernel_inputs(*args)
    visits = grouping._query_group_launch(grouping.group_prep(sx, sv, qx, scc), qx,
                                          scales_n, pl, qcc)[3]
    want_visits = grouping.query_group_pruned_plain(cpu[0], cpu[1], cpu[2], scales, None,
                                                    cpu[4], cpu[5])[3]
    assert torch.equal(visits.cpu(), want_visits)


def test_query_group_shared_tiles(dev):
    """Two window queries on the same sources through one TileCache: the
    sources are tiled once, and both results equal the plain version's."""
    xyz, valid, q, scales, coords, qc = _pruned_case("window")
    src = [torch.from_numpy(a).to(dev) for a in (xyz, valid, coords)]
    payload = src[0] * 2.0
    cache = grouping.TileCache()
    tiles = []
    for qq, qqc in ((q, qc), (q[:, ::-1], qc[:, ::-1])):
        qq, qqc = (torch.from_numpy(a.copy()).to(dev) for a in (qq, qqc))
        got = _counted("query_group", lambda: grouping.query_group(
            src[0], src[1], qq, scales, payload, src[2], qqc, cache=cache))
        want = grouping.query_group(src[0].cpu(), src[1].cpu(), qq.cpu(), scales,
                                    payload.cpu(), src[2].cpu(), qqc.cpu())
        for g, w in zip(got, want):   # per scale: idx, cnt, grouped
            for gt, wt in zip(g, w):
                assert torch.equal(gt.cpu(), wt)
        tiles.append(cache.get(src[0], src[1], src[2]))
    assert tiles[0] is tiles[1]


def _probe_case(name):
    """(skeys (B, V), queries (B, Q), sentinel) int32 on the CPU."""
    rng = np.random.RandomState(12)
    sent = 2_000_000

    def rows(lengths, V):
        out = np.full((len(lengths), V), sent, np.int64)
        for b, n in enumerate(lengths):
            out[b, :n] = np.sort(rng.choice(sent, n, replace=False))
        return out

    if name == "window_overflow":     # queries spread over a 40000-key row
        sk = rows([40000, 39000], 40000)
        q = rng.randint(0, sent + 1, (2, 9000))
        q[:, ::3] = sk[:, rng.randint(0, 39000, 3000)]
    elif name == "all_sentinel_blocks":   # tap rows: a key offset, whole blocks out of grid
        sk = rows([4000, 3500], 4096)
        q = np.concatenate([sk, sk + 1, sk - 3], 1)
        q[:, 512:1536] = sent
        q[:, 3000:3100] = sent + 5    # above the sentinel: a whole-row search
    elif name == "fps_order":             # the s_sa1 point keys: unsorted
        sk = rows([4096, 3000], 4096)
        q = np.stack([rng.permutation(np.concatenate([sk[b, :2000], rng.randint(0, sent, 1000)]))
                      for b in range(2)])
    elif name == "ragged_rows":           # valid lengths 0, 1, 1000, 4096
        sk = rows([0, 1, 1000, 4096], 4096)
        q = np.concatenate([sk, rng.randint(0, sent, (4, 700))], 1)
    else:
        raise KeyError(name)
    return (torch.from_numpy(sk.astype(np.int32)), torch.from_numpy(q.astype(np.int32)), sent)


@pytest.mark.parametrize("name", ["window_overflow", "all_sentinel_blocks", "fps_order",
                                  "ragged_rows"])
def test_probe_kernel_windows(dev, name):
    sk, q, sent = _probe_case(name)
    sk, q = sk.to(dev), q.to(dev)
    gi, gf = _counted("probe", lambda: spconv.probe(sk, q, sent))
    wi, wf = spconv.probe_plain(sk, q, sent)
    assert torch.equal(gi, wi) and torch.equal(gf, wf)
    assert bool(wf.any())


def test_probe_one_launch_bool_found(dev):
    """`found` comes back as torch.bool from the kernel's one launch: no
    second kernel converts it."""
    from torch.profiler import ProfilerActivity, profile

    sk, q, sent = _probe_case("all_sentinel_blocks")
    sk, q = sk.to(dev), q.to(dev)
    spconv.probe(sk, q, sent)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, found = spconv.probe(sk, q, sent)
        torch.cuda.synchronize()
    assert found.dtype == torch.bool
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "probe" in kernels[0], kernels


def test_probe_kernel(dev):
    rng = np.random.RandomState(2)
    keys = np.sort(rng.choice(100000, (2, 500), replace=False), axis=1)
    sk = torch.from_numpy(np.concatenate([keys, np.full((2, 100), 100000)], 1)
                          .astype(np.int32)).to(dev)
    q = torch.from_numpy(rng.randint(0, 100010, (2, 4000)).astype(np.int32)).to(dev)
    q[:, :200] = sk[:, :200]
    gi, gf = _counted("probe", lambda: spconv.probe(sk, q, 100000))
    wi, wf = spconv.probe_plain(sk, q, 100000)
    assert torch.equal(gi, wi) and torch.equal(gf, wf)


@pytest.mark.parametrize("c,co", [(16, 24), (64, 128), (130, 70)])
def test_bykey_kernel(dev, c, co):
    rng = np.random.RandomState(3)
    B, V, grid = 2, 600, (8, 30, 30)
    coords = np.stack([np.sort(rng.choice(np.prod(grid), V, replace=False))
                       for _ in range(B)])
    cz = torch.from_numpy(np.stack([coords // 900, coords // 30 % 30, coords % 30],
                                   -1).astype(np.int32)).to(dev)
    valid = torch.ones(B, V, dtype=torch.bool, device=dev)
    rb = spconv.build_subm_rulebook(cz, valid, grid)
    f = torch.randn(B, V, c, device=dev)
    w = torch.randn(27, c, co, device=dev) * 0.1
    sent = int(np.prod(grid))
    got = _counted("spconv_bykey",
                   lambda: spconv.gather_matmul_bykey(f, rb.skeys, rb.qkeys, w, sent))
    want = spconv.gather_matmul_bykey_plain(f, rb.skeys, rb.qkeys, w, sent)
    scale = float(want.abs().max())
    assert ((got - want).abs() <= 1e-4 * want.abs() + 1e-4 * scale).all()


def _bykey_case(c, co, dev, scale_range=0.0, seed=5):
    """Keys and features made so that: row block 1 (rows 64-127) misses at
    every tap, tap 5 has exactly one hit in row block 0, tap 7 misses
    everywhere, and Q = 333 is not a multiple of 64. With `scale_range` r,
    the features and weights span 10**-r .. 10**r in magnitude."""
    rng = np.random.RandomState(seed)
    B, V, K, Q, sent = 2, 700, 27, 333, 100000
    keys = np.sort(np.stack([rng.choice(sent, V - 20, replace=False) for _ in range(B)]), 1)
    sk = np.concatenate([keys, np.full((B, 20), sent)], 1).astype(np.int32)
    absent = np.stack([np.setdiff1d(np.arange(sent), k)[:5000] for k in keys])
    qk = np.empty((B, K, Q), np.int32)
    for b in range(B):
        hit = rng.uniform(size=(K, Q)) < 0.3
        qk[b] = np.where(hit, rng.choice(keys[b], (K, Q)), rng.choice(absent[b], (K, Q)))
        qk[b, :, 64:128] = rng.choice(absent[b], (K, 64))
        qk[b, 5, :64] = rng.choice(absent[b], 64)
        qk[b, 5, 17] = keys[b, 3]
        qk[b, 7] = sent
    qk[:, 3, ::7] = sent + 5                      # beyond the sentinel: a miss too

    def spread(shape):
        x = rng.randn(*shape)
        return (x * 10.0 ** rng.uniform(-scale_range, scale_range, shape)).astype(np.float32)

    f = spread((B, V, c))
    w = (spread((K, c, co)) / np.sqrt(c)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (f, sk, qk, w)) + (sent,)


def _bykey_close(got, want):
    scale = float(want.abs().max())
    return bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-4 * scale).all())


@pytest.mark.parametrize("c,co", [(40, 64), (64, 64), (64, 128), (128, 128), (128, 256)])
def test_bykey_kernel_edges(dev, c, co):
    """All-miss row block, a one-hit tap, an all-miss tap, ragged Q and C;
    two launches bit-equal."""
    f, sk, qk, w, sent = _bykey_case(c, co, dev)
    got = _counted("spconv_bykey", lambda: spconv.gather_matmul_bykey(f, sk, qk, w, sent))
    want = spconv.gather_matmul_bykey_plain(f, sk, qk, w, sent)
    assert _bykey_close(got, want)
    assert not got[:, 64:128].any()               # the all-miss row block
    assert torch.equal(got, spconv.gather_matmul_bykey(f, sk, qk, w, sent))


def test_bykey_kernel_split_precision(dev):
    """Inputs spanning 1e3 in magnitude: the 3xTF32 product holds the f32
    tolerance, where a TF32 product does not."""
    f, sk, qk, w, sent = _bykey_case(64, 128, dev, scale_range=1.5)
    got = _counted("spconv_bykey", lambda: spconv.gather_matmul_bykey(f, sk, qk, w, sent))
    want = spconv.gather_matmul_bykey_plain(f, sk, qk, w, sent)
    assert _bykey_close(got, want)
    idx, found = spconv._lookup_plain(sk, qk, sent)
    g = torch.gather(f[:, None].expand(-1, qk.shape[1], -1, -1), 2,
                     idx.long()[..., None].expand(-1, -1, -1, f.shape[-1]))
    g = torch.where(found[..., None], g, torch.zeros_like(g))
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.einsum("bkqc,kco->bqo", g, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert not _bykey_close(tf32, want)


def _rulebooks(dev, rng, B=2, V=600, grid=(8, 30, 30)):
    """Subm, strided and inverse by-key rulebooks on random voxel sets."""
    coords = np.stack([np.sort(rng.choice(np.prod(grid), V, replace=False))
                       for _ in range(B)])
    cz = torch.from_numpy(np.stack([coords // 900, coords // 30 % 30, coords % 30],
                                   -1).astype(np.int32)).to(dev)
    valid = torch.ones(B, V, dtype=torch.bool, device=dev)
    valid[:, -50:] = False
    subm = spconv.build_subm_rulebook(cz, valid, grid)
    g2 = tuple((np.asarray(grid) + 2 - 3) // 2 + 1)
    oc, ov, down = spconv.build_conv_plan(cz, valid, grid, g2, 3, 2, 1, V)
    inv = spconv.build_inverse_rulebook(oc, ov, cz, valid, g2, 3, 2, 1)
    return {"subm": (subm, V, int(np.prod(grid))),
            "strided": (down, V, int(np.prod(grid))),
            "inverse": (inv, V, int(np.prod(g2)))}


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
@pytest.mark.parametrize("c,co", [(64, 64), (64, 128), (130, 70)])
def test_bykey_bwd_kernel(dev, kind, c, co):
    rng = np.random.RandomState(4)
    rb, V, sent = _rulebooks(dev, rng)[kind]
    B, K, Q = rb.qkeys.shape
    f = torch.randn(B, rb.skeys.shape[1], c, device=dev)
    w = torch.randn(K, c, co, device=dev) * 0.1
    g = torch.randn(B, Q, co, device=dev)
    got = _counted("spconv_bykey_bwd", lambda: spconv.gather_matmul_bykey_bwd(
        f, rb.skeys, rb.qkeys, w, g, sent))
    want = spconv.gather_matmul_bykey_bwd_plain(f, rb.skeys, rb.qkeys, w, g, sent)
    for gt, wt in zip(got, want):
        scale = float(wt.abs().max())
        assert scale > 0
        assert ((gt - wt).abs() <= 1e-4 * wt.abs() + 1e-4 * scale).all()


def _to_tf32(x):
    """x rounded to TF32 (10 mantissa bits; to nearest, ties away from 0)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
@pytest.mark.parametrize("c,co", [(64, 128), (130, 70)])
def test_bykey_bwd_kernel_split_precision(dev, kind, c, co):
    """f, W and g spanning 1e3 in magnitude: both 3xTF32 products (dW in
    its own kernel, df through K4's) hold the f32 tolerance, where TF32
    products do not: the plain version on operands rounded to TF32's 10-bit
    mantissa, as a tensor core takes them (their products are exact in f32,
    so this is TF32 at any width, where cuBLAS may not take TF32 for a
    ragged one)."""
    rng = np.random.RandomState(10)
    rb, V, sent = _rulebooks(dev, rng)[kind]
    B, K, Q = rb.qkeys.shape

    def spread(*shape):
        x = rng.randn(*shape) * 10.0 ** rng.uniform(-1.5, 1.5, shape)
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    f = spread(B, rb.skeys.shape[1], c)
    w = spread(K, c, co) / np.sqrt(c)
    g = spread(B, Q, co)
    got = _counted("spconv_bykey_bwd", lambda: spconv.gather_matmul_bykey_bwd(
        f, rb.skeys, rb.qkeys, w, g, sent))
    want = spconv.gather_matmul_bykey_bwd_plain(f, rb.skeys, rb.qkeys, w, g, sent)
    tf32 = spconv.gather_matmul_bykey_bwd_plain(_to_tf32(f), rb.skeys, rb.qkeys,
                                                _to_tf32(w), _to_tf32(g), sent)
    for gt, t, wt in zip(got, tf32, want):
        assert _bykey_close(gt, wt)
        assert not _bykey_close(t, wt)


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
@pytest.mark.parametrize("c,co", [(64, 64), (64, 128), (130, 70)])
def test_bykey_bwd_kernel_repeat_bit_equal(dev, kind, c, co):
    """No float atomics: two launches give the same df and dW bit for bit."""
    rng = np.random.RandomState(8)
    rb, V, sent = _rulebooks(dev, rng, V=1500)[kind]
    B, K, Q = rb.qkeys.shape
    f = torch.randn(B, rb.skeys.shape[1], c, device=dev)
    w = torch.randn(K, c, co, device=dev) * 0.1
    g = torch.randn(B, Q, co, device=dev)
    df, dw = spconv.gather_matmul_bykey_bwd(f, rb.skeys, rb.qkeys, w, g, sent)
    df2, dw2 = spconv.gather_matmul_bykey_bwd(f, rb.skeys, rb.qkeys, w, g, sent)
    assert torch.equal(df, df2) and torch.equal(dw, dw2)
    assert df.abs().max() > 0 and dw.abs().max() > 0


def _one_tap_rulebook(dev, rng, B=2, V=1500, grid=(8, 30, 30)):
    """The 1x1x1 subm rulebook of a random voxel set (spconv4x, spconv_out,
    sp_update)."""
    coords = np.stack([np.sort(rng.choice(np.prod(grid), V, replace=False))
                       for _ in range(B)])
    cz = torch.from_numpy(np.stack([coords // 900, coords // 30 % 30, coords % 30],
                                   -1).astype(np.int32)).to(dev)
    valid = torch.ones(B, V, dtype=torch.bool, device=dev)
    valid[:, -50:] = False
    return spconv.build_subm_rulebook(cz, valid, grid, kernel_size=1), int(np.prod(grid))


# the teacher U-Net's (kind, Cin, Cout): layer 1 of fast_cpc_teacher.yaml has
# n_en 128 and 2 n_en 256 (inv8x_a/b, inv4x_a/b, inv16x_a/b; spconv8x,
# spconv16x; inv8x, inv4x) and 1x1x1 convs 256 -> 128 (spconv4x), 128 -> 256
# (spconv_out) and 64 -> 256 (sp_update)
TEACHER_CONVS = [("subm", 128, 128), ("subm", 256, 256), ("strided", 128, 128),
                 ("strided", 128, 256), ("inverse", 256, 128), ("inverse", 128, 128),
                 ("one_tap", 256, 128), ("one_tap", 128, 256), ("one_tap", 64, 256)]


@pytest.mark.parametrize("kind,c,co", TEACHER_CONVS)
def test_bykey_bwd_kernel_teacher_widths(dev, kind, c, co):
    """K5 at the teacher U-Net's widths: df and dW within K5's tolerance of
    the plain version, and bit-equal between two launches."""
    rng = np.random.RandomState(12)
    if kind == "one_tap":
        rb, sent = _one_tap_rulebook(dev, rng)
    else:
        rb, _, sent = _rulebooks(dev, rng, V=1500)[kind]
    B, K, Q = rb.qkeys.shape
    assert K == (1 if kind == "one_tap" else 27)
    f = torch.randn(B, rb.skeys.shape[1], c, device=dev)
    w = torch.randn(K, c, co, device=dev) / np.sqrt(K * c)
    g = torch.randn(B, Q, co, device=dev)
    got = _counted("spconv_bykey_bwd", lambda: spconv.gather_matmul_bykey_bwd(
        f, rb.skeys, rb.qkeys, w, g, sent))
    again = spconv.gather_matmul_bykey_bwd(f, rb.skeys, rb.qkeys, w, g, sent)
    want = spconv.gather_matmul_bykey_bwd_plain(f, rb.skeys, rb.qkeys, w, g, sent)
    for gt, g2, wt in zip(got, again, want):
        assert torch.equal(gt, g2)
        assert float(wt.abs().max()) > 0
        assert _bykey_close(gt, wt)


def test_teacher_train_step_on_card(dev):
    """The tiny teacher's training step on the card (K1-K5, K2's payload
    gradient) against the committed JAX golden, at the CPU test's
    tolerances (tests/test_torch_teacher.py): loss and tb terms rtol 1e-4,
    every gradient rtol 1e-3 with atol 1e-4 * max(max|want|, 1e-2 * the
    largest), the statistics after the step rtol 1e-5."""
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.models import build_network

    model = build_network(tiny.tiny_teacher_model_cfg(), 3, tiny.META, device=dev)
    model.load_state_dict(tiny.load_state(tiny.TEACHER_STATE_PATH), strict=True)
    state = model.state_dict()
    for k, v in tiny.teacher_overrides().items():
        state[k].copy_(torch.from_numpy(v).to(dev))
    gt, gmask = tiny.synth_gt(2, "wide")
    pts = torch.from_numpy(tiny.synth_points(2)).to(dev)
    before = dict(_kernels.LAUNCHES)
    out = model.train()({"points": pts, "batch_size": 2,
                         "points_mask": torch.ones(2, 256, dtype=torch.bool, device=dev),
                         "gt_boxes": torch.from_numpy(gt).to(dev),
                         "gt_boxes_mask": torch.from_numpy(gmask).to(dev)})
    out["loss"].backward()
    torch.cuda.synchronize()
    for k in ("fps", "query_group", "probe", "spconv_bykey", "spconv_bykey_bwd"):
        assert _kernels.LAUNCHES[k] > before[k], k
    params = dict(model.named_parameters())
    with np.load(tiny.TEACHER_TRAIN_GOLDEN_PATH) as golden:
        gold = {k: golden[k] for k in golden.files}
    scale = max(float(np.abs(v).max()) for k, v in gold.items() if k.startswith("grad/"))
    for k, want in gold.items():
        if k.startswith("grad/"):
            np.testing.assert_allclose(
                params[k[5:]].grad.cpu().numpy(), want, rtol=1e-3,
                atol=1e-4 * max(float(np.abs(want).max()), 1e-2 * scale), err_msg=k)
        elif k.startswith("stat/"):
            np.testing.assert_allclose(state[k[5:]].cpu().numpy(), want, rtol=1e-5,
                                       atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                       err_msg=k)
        else:
            got = out["loss"] if k == "loss" else out["tb_dict"][k[3:]]
            np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4,
                                       atol=1e-4 * max(1.0, abs(float(want))), err_msg=k)


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
def test_bykey_bwd_df_matches_inverse_plain(dev, kind):
    """K5's df against its route's CPU twin (the per-tap inverse table, the
    gather in tap order) run on the card."""
    rng = np.random.RandomState(9)
    rb, V, sent = _rulebooks(dev, rng)[kind]
    B, K, Q = rb.qkeys.shape
    f = torch.randn(B, rb.skeys.shape[1], 64, device=dev)
    w = torch.randn(K, 64, 128, device=dev) * 0.1
    g = torch.randn(B, Q, 128, device=dev)
    df, _ = _counted("spconv_bykey_bwd", lambda: spconv.gather_matmul_bykey_bwd(
        f, rb.skeys, rb.qkeys, w, g, sent))
    want = spconv.gather_matmul_bykey_df_plain(rb.skeys, rb.qkeys, w, g, sent)
    scale = float(want.abs().max())
    assert scale > 0
    assert ((df - want).abs() <= 1e-4 * want.abs() + 1e-4 * scale).all()


@pytest.mark.parametrize("c,co,k,q", [(4, 16, 27, 300), (16, 32, 27, 1000),
                                      (64, 128, 3, 777), (130, 70, 27, 257)])
def test_gather_kernel(dev, c, co, k, q):
    """Ragged widths and Q, K = 3, unsorted indices with misses, and a whole
    tap of -1."""
    rng = np.random.RandomState(c + k)
    B, V = 2, 900
    idx = rng.randint(0, V, (B, k, q)).astype(np.int32)
    idx[rng.rand(B, k, q) < 0.3] = -1
    idx[:, 1] = -1
    idx = torch.from_numpy(idx).to(dev)
    f = torch.randn(B, V, c, device=dev)
    w = torch.randn(k, c, co, device=dev) * 0.1
    got = _counted("spconv_gather", lambda: spconv.gather_matmul(f, idx, w))
    want = spconv.gather_matmul_plain(f, idx, w)
    scale = float(want.abs().max())
    assert scale > 0
    assert ((got - want).abs() <= 1e-4 * want.abs() + 1e-4 * scale).all()


def test_gather_kernel_all_misses(dev):
    idx = torch.full((1, 27, 500), -1, dtype=torch.int32, device=dev)
    got = _counted("spconv_gather", lambda: spconv.gather_matmul(
        torch.randn(1, 40, 4, device=dev), idx, torch.randn(27, 4, 16, device=dev)))
    assert not got.any()


def test_materialised_convs_launch_probe_and_gather(dev):
    """A materialised subm rulebook probes once (K3) and serves two convs (K7)."""
    rng = np.random.RandomState(9)
    B, V, grid = 2, 600, (8, 30, 30)
    cells = np.stack([np.sort(rng.choice(np.prod(grid), V, replace=False)) for _ in range(B)])
    cz = torch.from_numpy(np.stack([cells // 900, cells // 30 % 30, cells % 30],
                                   -1).astype(np.int32)).to(dev)
    valid = torch.ones(B, V, dtype=torch.bool, device=dev)
    rb = _counted("probe", lambda: spconv.build_subm_rulebook(cz, valid, grid, lazy=False))
    f = torch.randn(B, V, 16, device=dev)
    w = torch.randn(27, 16, 16, device=dev) * 0.1
    for _ in range(2):
        got = _counted("spconv_gather", lambda: spconv.subm_conv3d(f, cz, valid, w, grid,
                                                                   rulebook=rb))
    lazy = spconv.build_subm_rulebook(cz, valid, grid)
    want = spconv.gather_matmul_bykey_plain(f, lazy.skeys, lazy.qkeys, w, int(np.prod(grid)))
    scale = float(want.abs().max())
    assert ((got - want).abs() <= 1e-4 * want.abs() + 1e-4 * scale).all()


def _gather_case(c, co, k, dev, scale_range=0.0, seed=6):
    """An index map made so that: row block 1 (rows 64-127) misses at every
    tap, tap 1 has exactly one hit in row block 0, the last tap misses
    everywhere, some entries are >= V (a miss too), indices repeat within a
    tap, and Q = 333 is not a multiple of 64. With `scale_range` r, the
    features and weights span 10**-r .. 10**r in magnitude."""
    rng = np.random.RandomState(seed)
    B, V, Q = 2, 700, 333
    idx = rng.randint(0, V, (B, k, Q)).astype(np.int32)
    idx[rng.uniform(size=(B, k, Q)) < 0.6] = -1
    idx[:, :, 64:128] = -1
    idx[:, 1, :64] = -1
    idx[:, 1, 17] = 3
    idx[:, k - 1] = -1
    idx[:, 0, ::7] = V + 5

    def spread(shape):
        x = rng.randn(*shape)
        return (x * 10.0 ** rng.uniform(-scale_range, scale_range, shape)).astype(np.float32)

    f = spread((B, V, c))
    w = (spread((k, c, co)) / np.sqrt(c)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (f, idx, w))


@pytest.mark.parametrize("k", [3, 27])
@pytest.mark.parametrize("co", [16, 32, 128])
@pytest.mark.parametrize("c", [4, 16, 40])
def test_gather_kernel_edges(dev, c, co, k):
    """SECOND's widths and taps: an all-miss row block, a one-hit tap, an
    all-miss tap, indices >= V, ragged Q; two launches bit-equal."""
    f, idx, w = _gather_case(c, co, k, dev)
    got = _counted("spconv_gather", lambda: spconv.gather_matmul(f, idx, w))
    want = spconv.gather_matmul_plain(f, torch.where(idx < f.shape[1], idx, -1), w)
    assert _bykey_close(got, want)
    assert not got[:, 64:128].any()               # the all-miss row block
    assert torch.equal(got, spconv.gather_matmul(f, idx, w))


@pytest.mark.parametrize("c,co", [(16, 32), (64, 128)])
def test_gather_kernel_split_precision(dev, c, co):
    """Inputs spanning 1e3 in magnitude: K7 holds the f32 tolerance, where
    the plain product on operands rounded to TF32 does not."""
    f, idx, w = _gather_case(c, co, 27, dev, scale_range=1.5)
    idx = torch.where(idx < f.shape[1], idx, -1)
    got = _counted("spconv_gather", lambda: spconv.gather_matmul(f, idx, w))
    want = spconv.gather_matmul_plain(f, idx, w)
    assert _bykey_close(got, want)
    assert not _bykey_close(spconv.gather_matmul_plain(_to_tf32(f), idx, _to_tf32(w)), want)


def test_second_train_step_on_card(dev):
    """The tiny SECOND's training step on the card (K3 and K7 forward, K7's
    plain backward) against the same step on the CPU: loss and tb terms
    rtol 1e-4, every parameter's gradient rtol 1e-3 with atol 1e-4 * the
    largest |grad| of its tensor (the card's index_add_ sums in no fixed
    order), BN running stats 1e-5; 12 K7 and 8 K3 launches."""
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.runtime.optimization import build_optimizer
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step

    gt, gmask = tiny.second_gt(2)
    state = tiny.load_state(tiny.SECOND_STATE_PATH)
    runs = {}
    for d in (torch.device("cpu"), dev):
        model = build_network(tiny.second_model_cfg(), 1, tiny.SECOND_META, device=d)
        model.load_state_dict(state, strict=True)
        opt = build_optimizer({"OPTIMIZER": "adam_onecycle", "LR": 0.003,
                               "WEIGHT_DECAY": 0.01, "GRAD_NORM_CLIP": 10},
                              list(model.parameters()), 10)
        batch = {"points": torch.from_numpy(tiny.second_points(2)).to(d),
                 "points_mask": torch.ones(2, 512, dtype=torch.bool, device=d),
                 "batch_size": 2, "gt_boxes": torch.from_numpy(gt).to(d),
                 "gt_boxes_mask": torch.from_numpy(gmask).to(d)}
        before = dict(_kernels.LAUNCHES)
        model.train()
        opt.zero_grad(set_to_none=True)
        out = model(dict(batch))
        out["loss"].backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        opt.step()
        torch.cuda.synchronize()
        launched = {k: _kernels.LAUNCHES[k] - before[k] for k in ("probe", "spconv_gather")}
        runs[d.type] = (out, grads,
                        {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                        launched)
        loss, _ = train_step(model, opt, batch)
        assert torch.isfinite(loss)
    (cpu_out, cpu_g, cpu_sd, _), (out, g, sd, launched) = runs["cpu"], runs["cuda"]
    assert launched == {"probe": 8, "spconv_gather": 12}
    for key in ["loss"] + [f"tb/{k}" for k in cpu_out["tb_dict"]]:
        got = out["loss"] if key == "loss" else out["tb_dict"][key[3:]]
        want = cpu_out["loss"] if key == "loss" else cpu_out["tb_dict"][key[3:]]
        np.testing.assert_allclose(float(got.detach()), float(want.detach()), rtol=1e-4,
                                   atol=1e-4 * max(1.0, abs(float(want.detach()))),
                                   err_msg=key)
    assert float(cpu_out["tb_dict"]["rpn_loss_loc"]) > 0
    for n, want in cpu_g.items():
        np.testing.assert_allclose(g[n].numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-4 * float(want.abs().max()), err_msg=n)
    for k, want in cpu_sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
