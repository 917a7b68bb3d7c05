"""Each hand-written kernel against its plain PyTorch version on the card
(skipped on hosts without one). Run there with
    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
K1 / K2 / K3 are exact; K4 sums in another f32 order (rtol 1e-4,
atol 1e-4 * max|out|)."""
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
    for (gi, gc, gg), (wi, wc, wg) in zip(got, want):
        assert torch.equal(gc, wc)
        assert torch.equal(gi, wi)
        assert torch.equal(gg, wg)


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
