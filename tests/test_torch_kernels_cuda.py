"""Each hand-written kernel against its plain PyTorch version on the card
(skipped on hosts without one). Run there with
    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
K1 / K2 / K3 / K6 are exact; K4 and K7 sum in another f32 order and K5 with
float atomics in a varying one (all rtol 1e-4, atol 1e-4 * max|out|)."""
import numpy as np
import pytest
import torch

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
