"""Each hand-written kernel against its plain PyTorch version on the card
(skipped on hosts without one). Run there with
    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
K1 / K2 / K3 / K6 are exact; K4 and K5 multiply in split precision
(3xTF32) and sum in another f32 order, fixed from launch to launch (both
bit-equal on repeat), K7 sums in another order (all rtol 1e-4,
atol 1e-4 * max|out|)."""
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


def test_fps_dispatch_above_k1_limit(dev):
    """d-fps over more than 16384 points a row launches K6, not K1."""
    rng = np.random.RandomState(21)
    xyz = torch.from_numpy(rng.uniform(-40, 40, (2, 20000, 3)).astype(np.float32)).to(dev)
    before = _kernels.LAUNCHES["fps"]
    got = _counted("fps_block", lambda: sampling.furthest_point_sample(xyz, 300))
    assert _kernels.LAUNCHES["fps"] == before
    assert torch.equal(got, sampling.furthest_point_sample_plain(xyz, 300))


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
