"""K5's df route on the CPU: the per-tap inverse of a by-key map and df as
the gather over it in tap order (`spconv.bykey_inverse_plain`,
`spconv.gather_matmul_bykey_df_plain`), the CPU twin of the kernel's route.

  * against the Pallas backward K5 replaces
    (`spconv_pallas.gather_matmul_bykey_bwd`, interpret mode on the CPU) on
    the subm, strided and inverse rulebooks the port's builders make: f32
    sums in another order, rtol 1e-5, atol 1e-5 * max|want|;
  * every per-tap map of the tiny TSM's student U-Net, as its training step
    hands them to the backward, is injective (the kernel's domain);
  * a map that names a row twice in one tap makes the helper raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.ops import spconv_pallas
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.models import build_network
from tsm_det_pointcloud_tpu_torch.ops import spconv as tsp

GRID, OUT_GRID, CAP = (8, 20, 20), (4, 10, 10), 200


def _coords(seed, B=2, V=300):
    """Sorted unique voxels, a ragged number a scan, -1 padding."""
    rng = np.random.RandomState(seed)
    gz, gy, gx = GRID
    coords = np.full((B, V, 3), -1, np.int32)
    valid = np.zeros((B, V), bool)
    for b in range(B):
        n = V - 70 + b * 17
        cells = np.sort(rng.choice(gz * gy * gx, n, replace=False))
        coords[b, :n] = np.stack([cells // (gy * gx), (cells // gx) % gy, cells % gx], -1)
        valid[b, :n] = True
    return rng, torch.from_numpy(coords), torch.from_numpy(valid)


def _rulebook(kind, seed):
    """(the numpy generator, a port LazyRulebook of `kind`, its sentinel)."""
    rng, coords, valid = _coords(seed)
    if kind == "subm":
        rb = tsp.build_subm_rulebook(coords, valid, GRID)
        return rng, rb, int(np.prod(GRID))
    oc, ov, down = tsp.build_conv_plan(coords, valid, GRID, OUT_GRID, 3, 2, 1, CAP)
    if kind == "strided":
        return rng, down, int(np.prod(GRID))
    inv = tsp.build_inverse_rulebook(oc, ov, coords, valid, OUT_GRID, 3, 2, 1)
    return rng, inv, int(np.prod(OUT_GRID))


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
@pytest.mark.parametrize("c,co", [(8, 16), (16, 8)])
def test_df_through_inverse_matches_pallas_interpret(kind, c, co):
    rng, rb, sent = _rulebook(kind, seed=len(kind) + c)
    B, V = rb.skeys.shape
    K, Q = rb.qkeys.shape[1:]
    feats = rng.randn(B, V, c).astype(np.float32)
    w = (rng.randn(K, c, co) * 0.1).astype(np.float32)
    g = rng.randn(B, Q, co).astype(np.float32)
    want_df, want_dw = spconv_pallas.gather_matmul_bykey_bwd(
        jnp.asarray(feats), jnp.asarray(rb.skeys.numpy()), jnp.asarray(rb.qkeys.numpy()),
        jnp.asarray(w), jnp.asarray(g), sent, interpret=True)
    want_df = np.asarray(want_df)
    assert float(np.abs(want_df).max()) > 0
    got = tsp.gather_matmul_bykey_df_plain(rb.skeys, rb.qkeys, torch.from_numpy(w),
                                           torch.from_numpy(g), sent)
    np.testing.assert_allclose(got.numpy(), want_df, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_df).max()))
    # and the same df as the plain backward's scatter
    df, _ = tsp.gather_matmul_bykey_bwd_plain(torch.from_numpy(feats), rb.skeys, rb.qkeys,
                                              torch.from_numpy(w), torch.from_numpy(g), sent)
    np.testing.assert_allclose(got.numpy(), df.numpy(), rtol=1e-5,
                               atol=1e-5 * float(df.abs().max()))


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
def test_inverse_table_names_each_hit_once(kind):
    """inv[b, k, row] = q exactly for the found (b, k, q), -1 elsewhere."""
    _, rb, sent = _rulebook(kind, seed=7)
    inv = tsp.bykey_inverse_plain(rb.skeys, rb.qkeys, sent)
    idx, found = tsp._lookup_plain(rb.skeys, rb.qkeys, sent)
    assert int((inv >= 0).sum()) == int(found.sum()) > 0
    b, k, q = found.nonzero(as_tuple=True)
    assert torch.equal(inv[b, k, idx[b, k, q].long()], q)


def test_tiny_student_unet_maps_are_injective(monkeypatch):
    """Every map the tiny TSM's training step hands K5 (the student U-Net's
    ten by-key convs) names each source row at most once a tap."""
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    model.load_state_dict(tiny.load_state(), strict=True)
    for k, v in tiny.train_statistics().items():
        getattr(model.module_list[1], k).copy_(torch.from_numpy(v))
    maps = []
    bwd = tsp.gather_matmul_bykey_bwd

    def recording(features, skeys, qkeys, weight, g, sentinel):
        maps.append((skeys, qkeys, sentinel))
        return bwd(features, skeys, qkeys, weight, g, sentinel)

    monkeypatch.setattr(tsp, "gather_matmul_bykey_bwd", recording)
    pts = torch.from_numpy(tiny.synth_points(2))
    gt, gt_mask = tiny.synth_gt(2, "wide")
    out = model.train()({"points": pts, "batch_size": 2,
                         "points_mask": torch.ones(pts.shape[:2], dtype=torch.bool),
                         "gt_boxes": torch.from_numpy(gt),
                         "gt_boxes_mask": torch.from_numpy(gt_mask)})
    out["loss"].backward()
    assert len(maps) == 10
    for skeys, qkeys, sentinel in maps:
        idx, found = tsp._lookup_plain(skeys, qkeys, sentinel)
        assert int(found.sum()) > 0
        for k in range(qkeys.shape[1]):
            for b in range(qkeys.shape[0]):
                rows = idx[b, k][found[b, k]]
                assert torch.unique(rows).numel() == rows.numel()
        tsp.bykey_inverse_plain(skeys, qkeys, sentinel)   # does not raise


def test_inverse_raises_on_a_row_named_twice():
    _, rb, sent = _rulebook("subm", seed=3)
    qkeys = rb.qkeys.clone()
    qkeys[1, 13, 10] = qkeys[1, 13, 11]      # two targets of the centre tap name one row
    assert bool(torch.isin(qkeys[1, 13, 11], rb.skeys[1][rb.skeys[1] < sent]))
    with pytest.raises(ValueError, match="injective"):
        tsp.bykey_inverse_plain(rb.skeys, qkeys, sent)
    with pytest.raises(ValueError, match="injective"):
        tsp.gather_matmul_bykey_df_plain(rb.skeys, qkeys, torch.zeros(27, 4, 4),
                                         torch.zeros(2, qkeys.shape[2], 4), sent)
