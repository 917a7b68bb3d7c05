"""Gradients of the port's ops against `jax.grad` / `jax.vjp` of the JAX
package on the CPU, and the masked train-mode BatchNorm against flax.

  * the by-key sparse-conv backward: the plain version of K5
    (`gather_matmul_bykey_bwd_plain`) and autograd through the port's convs
    (`_ByKeyConv`) against the VJP of the JAX convs, on subm, strided and
    inverse rulebooks; the plain version against the Pallas kernel K5
    replaces, run in interpret mode; the autograd Function against torch
    autograd of the plain forward. f32 sums in another order: rtol 1e-5,
    atol 1e-5 * max|want|.
  * the query_group payload gradient (the scatter back onto the chosen
    source rows) against jax.grad of the JAX query + gather: the same
    cotangent entries summed in another order, rtol 1e-6, atol 1e-6.
  * voxel_centroids' feature gradient: rtol 1e-5, atol 1e-6.
  * train-mode BatchNorm (masked stats, fast variance, running-stat update)
    against flax: output and running stats rtol 1e-5, atol 1e-5; input
    gradient rtol 1e-4, atol 1e-5 * max|want|.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsm_det_pointcloud_tpu.models.backbones_3d import pointnet2_modules as jpn2
from tsm_det_pointcloud_tpu.ops import grouping as jgrp
from tsm_det_pointcloud_tpu.ops import spconv as jsp
from tsm_det_pointcloud_tpu.ops import spconv_pallas
from tsm_det_pointcloud_tpu.ops import voxel as jvox
from tsm_det_pointcloud_tpu_torch.models.backbones_3d import pointnet2_modules as tpn2
from tsm_det_pointcloud_tpu_torch.ops import grouping as tgrp
from tsm_det_pointcloud_tpu_torch.ops import spconv as tsp
from tsm_det_pointcloud_tpu_torch.ops import voxel as tvox
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _close(got, want, rtol, atol_scale, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()), err_msg=what)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# by-key sparse-conv backward
# ---------------------------------------------------------------------------

GRID, OUT_GRID, CAP = (8, 20, 20), (4, 10, 10), 200


def _sparse_case(seed=0, B=2, V=300, C=16, Co=24):
    rng = np.random.RandomState(seed)
    sent = int(np.prod(GRID))
    gz, gy, gx = GRID
    coords = np.full((B, V, 3), -1, np.int32)
    valid = np.zeros((B, V), bool)
    for b in range(B):
        n = V - 70 + b * 17
        cells = rng.choice(sent, n, replace=False)
        cc = np.stack([cells // (gy * gx), (cells // gx) % gy, cells % gx],
                      -1).astype(np.int32)
        coords[b, :n] = cc[np.argsort((cc[:, 0] * gy + cc[:, 1]) * gx + cc[:, 2])]
        valid[b, :n] = True
    feats = rng.randn(B, V, C).astype(np.float32)
    w = (rng.randn(27, C, Co) * 0.1).astype(np.float32)
    return rng, coords, valid, feats, w


def _conv_case(kind, seed=0):
    """(port conv fn of (f, w), JAX conv fn of (f, w), f, w, the port's
    rulebook, its sentinel, the output mask, the cotangent)."""
    rng, coords, valid, feats, w = _sparse_case(seed)
    tc, tv = _t(coords), _t(valid)
    if kind == "subm":
        rb = tsp.build_subm_rulebook(tc, tv, GRID)
        out_valid, sent = valid, int(np.prod(GRID))

        def port(f, ww):
            return tsp.subm_conv3d(f, tc, tv, ww, GRID, rulebook=rb)

        def ref(f, ww):
            return jsp.subm_conv3d(f, coords, valid, ww, GRID)
    elif kind == "strided":
        oc, ov, rb = tsp.build_conv_plan(tc, tv, GRID, OUT_GRID, 3, 2, 1, CAP)
        out_valid, sent = ov.numpy(), int(np.prod(GRID))

        def port(f, ww):
            return tsp.sparse_conv3d(f, tc, tv, ww, GRID, OUT_GRID, 3, 2, 1, CAP,
                                     plan=(oc, ov, rb))[0]

        def ref(f, ww):
            return jsp.sparse_conv3d(f, coords, valid, ww, GRID, OUT_GRID,
                                     kernel_size=3, stride=2, padding=1,
                                     out_capacity=CAP)[0]
    else:
        oc, ov, _ = tsp.build_conv_plan(tc, tv, GRID, OUT_GRID, 3, 2, 1, CAP)
        rb = tsp.build_inverse_rulebook(oc, ov, tc, tv, OUT_GRID, 3, 2, 1)
        out_valid, sent = valid, int(np.prod(OUT_GRID))
        w = np.ascontiguousarray(np.swapaxes(w, 1, 2))    # coarse Co -> fine C
        feats = rng.randn(coords.shape[0], CAP, w.shape[1]).astype(np.float32)
        ocn, ovn = oc.numpy(), ov.numpy()

        def port(f, ww):
            return tsp.inverse_conv3d(f, oc, ov, ww, tc, tv, OUT_GRID, 3, 2, 1,
                                      rulebook=rb)

        def ref(f, ww):
            return jsp.inverse_conv3d(f, ocn, ovn, ww, coords, valid,
                                      OUT_GRID, kernel_size=3, stride=2, padding=1)
    g = rng.randn(out_valid.shape[0], out_valid.shape[1], w.shape[-1]).astype(np.float32)
    return port, ref, feats, w, rb, sent, out_valid, g


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
def test_bykey_backward_matches_jax_vjp(kind):
    port, ref, feats, w, rb, sent, out_valid, g = _conv_case(kind)
    _, vjp = jax.vjp(jax.jit(ref), jnp.asarray(feats), jnp.asarray(w))
    want_df, want_dw = vjp(jnp.asarray(g))
    assert float(jnp.abs(want_df).max()) > 0 and float(jnp.abs(want_dw).max()) > 0
    # the plain version of K5, given the cotangent of the unmasked output
    g_in = np.where(out_valid[..., None], g, 0.0).astype(np.float32)
    df, dw = tsp.gather_matmul_bykey_bwd_plain(_t(feats), rb.skeys, rb.qkeys,
                                               _t(w), _t(g_in), sent)
    _close(df, want_df, 1e-5, 1e-5, "plain df")
    _close(dw, want_dw, 1e-5, 1e-5, "plain dW")
    # autograd through the port's conv (the _ByKeyConv Function)
    f_t, w_t = _t(feats).requires_grad_(True), _t(w).requires_grad_(True)
    out = port(f_t, w_t)
    assert out.grad_fn is not None
    (out * _t(g)).sum().backward()
    _close(f_t.grad, want_df, 1e-5, 1e-5, "autograd df")
    _close(w_t.grad, want_dw, 1e-5, 1e-5, "autograd dW")


def test_bykey_backward_plain_matches_pallas_interpret():
    """K5's plain version against the Pallas backward K5 replaces (padding,
    sentinel rows and keys that never match contribute nothing)."""
    rng = np.random.RandomState(3)
    B, V, C, Co, K, Q = 2, 300, 8, 16, 5, 200
    feats = rng.randn(B, V, C).astype(np.float32)
    w = (rng.randn(K, C, Co) * 0.1).astype(np.float32)
    sent = 10 ** 6
    sk = np.sort(rng.choice(sent, (B, V), replace=False).astype(np.int32), 1)
    qk = rng.choice(sent, (B, K, Q)).astype(np.int32)
    qk[:, :, : Q // 2] = sk[:, rng.randint(0, V, (K, Q // 2))]   # hits
    qk[:, :, ::7] = sent + 5                                      # sentinel rows
    g = rng.randn(B, Q, Co).astype(np.float32)
    want_df, want_dw = spconv_pallas.gather_matmul_bykey_bwd(
        jnp.asarray(feats), jnp.asarray(sk), jnp.asarray(qk), jnp.asarray(w),
        jnp.asarray(g), sent, interpret=True)
    df, dw = tsp.gather_matmul_bykey_bwd_plain(_t(feats), _t(sk), _t(qk), _t(w),
                                               _t(g), sent)
    _close(df, want_df, 1e-5, 1e-5, "df")
    _close(dw, want_dw, 1e-5, 1e-5, "dW")
    assert float(np.abs(np.asarray(want_df)).max()) > 0


@pytest.mark.parametrize("kind", ["subm", "strided", "inverse"])
def test_bykey_function_matches_plain_autograd(kind):
    _, _, feats, w, rb, sent, _, g = _conv_case(kind, seed=1)
    grads = []
    for use_function in (True, False):
        f_t, w_t = _t(feats).requires_grad_(True), _t(w).requires_grad_(True)
        if use_function:
            out = tsp._ByKeyConv.apply(f_t, w_t, rb.skeys, rb.qkeys, sent)
        else:
            out = tsp.gather_matmul_bykey_plain(f_t, rb.skeys, rb.qkeys, w_t, sent)
        (out * _t(g)).sum().backward()
        grads.append((f_t.grad, w_t.grad))
    (df, dw), (want_df, want_dw) = grads
    _close(df, want_df.numpy(), 1e-5, 1e-5, "df")
    _close(dw, want_dw.numpy(), 1e-5, 1e-5, "dW")


# ---------------------------------------------------------------------------
# query_group payload gradient, voxel_centroids gradient
# ---------------------------------------------------------------------------

def _centroid_case(seed, B=2, V=300, M=120, D=5):
    rng = np.random.RandomState(seed)
    grid = (8, 40, 40)
    coords = np.stack([rng.randint(0, g, (B, V)) for g in grid], -1).astype(np.int32)
    cxyz = ((coords[..., ::-1] + rng.uniform(0, 1, (B, V, 3))) * 0.2).astype(np.float32)
    cvalid = rng.uniform(size=(B, V)) > 0.15
    qxyz = (cxyz[:, :M] + rng.normal(0, 0.1, (B, M, 3))).astype(np.float32)
    qcoords = np.floor(qxyz / 0.2).astype(np.int32)[..., ::-1].copy()
    feats = rng.randn(B, V, D).astype(np.float32)
    return rng, cxyz, coords, cvalid, qxyz, qcoords, feats


@pytest.mark.parametrize("window", [True, False])
def test_query_group_payload_grad_matches_jax(window):
    rng, cxyz, coords, cvalid, qxyz, qcoords, feats = _centroid_case(5)
    radius, ns, qr, min_r = 1.2, 16, (3, 3, 3), 0.2
    if window:
        idx = np.stack([np.asarray(jvox.voxel_query(
            qxyz[b], qcoords[b], cxyz[b], coords[b], cvalid[b], radius=radius,
            nsample=ns, query_range=qr, min_radius=min_r)[0])
            for b in range(cxyz.shape[0])])
        scales = [(min_r, radius, ns, qr)]
    else:
        idx = np.asarray(jgrp.ball_query_multi(((min_r, radius),), (ns,),
                                               jnp.asarray(cxyz), jnp.asarray(qxyz),
                                               jnp.asarray(cvalid))[0][0])
        scales = [(min_r, radius, ns)]
    g = rng.randn(*qxyz.shape[:2], ns, feats.shape[-1]).astype(np.float32)
    want = jax.grad(lambda f: (jgrp.group_points(f, jnp.asarray(idx))
                               * jnp.asarray(g)).sum())(jnp.asarray(feats))
    payload = _t(feats).requires_grad_(True)
    src_xyz = _t(cxyz).requires_grad_(True)
    (got_idx, _, grouped), = tgrp.query_group(
        src_xyz, _t(cvalid), _t(qxyz), scales, payload=payload,
        src_coords=_t(coords) if window else None,
        q_coords=_t(qcoords) if window else None)
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    (grouped * _t(g)).sum().backward()
    _close(payload.grad, want, 1e-6, 1e-6, "payload grad")
    assert float(np.abs(np.asarray(want)).max()) > 0
    assert src_xyz.grad is None, "xyz and the selection get no gradient"


def test_voxel_centroids_feature_grad():
    rng = np.random.RandomState(4)
    B, N, V, grid = 2, 400, 128, (4, 20, 20)
    coords = np.stack([rng.randint(0, gd, (B, N)) for gd in grid], -1).astype(np.int32)
    feats = rng.randn(B, N, 7).astype(np.float32)
    valid = rng.uniform(size=(B, N)) > 0.1
    g = rng.randn(B, V, 7).astype(np.float32)

    def ref(f):
        out = jax.vmap(lambda c, ff, v: jvox.voxel_centroids(
            c, ff, v, num_voxels=V, grid_dims=grid)["centroids"])(
            jnp.asarray(coords), f, jnp.asarray(valid))
        return (out * jnp.asarray(g)).sum()

    want = jax.grad(ref)(jnp.asarray(feats))
    f_t = _t(feats).requires_grad_(True)
    out = tvox.voxel_centroids(_t(coords), f_t, _t(valid), V, grid)["centroids"]
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert float(np.abs(np.asarray(want)).max()) > 0


# ---------------------------------------------------------------------------
# masked train-mode BatchNorm
# ---------------------------------------------------------------------------

def _bn_case(seed, mask_kind, shape=(2, 30, 8, 6)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    mask = {"partial": rng.uniform(size=shape[:-1]) > 0.4,
            "empty": np.zeros(shape[:-1], bool), "none": None}[mask_kind]
    if mask is not None:
        x = np.where(mask[..., None], x, 0.0).astype(np.float32)
    C = shape[-1]
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": rng.randn(C).astype(np.float32)}
    stats = {"mean": rng.randn(C).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    g = rng.randn(*shape).astype(np.float32)
    return x, mask, params, stats, g


@pytest.mark.parametrize("mask_kind", ["partial", "none"])
@pytest.mark.parametrize("eps,momentum", [(1e-3, 0.99), (1e-5, 0.9)])
def test_masked_batchnorm_train(mask_kind, eps, momentum):
    x, mask, params, stats, g = _bn_case(6, mask_kind)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=eps)
    jmask = None if mask is None else jnp.asarray(mask[..., None])

    def ref(xx):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, xx, mask=jmask,
                          mutable=["batch_stats"])
        return (y * g).sum(), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), want_dx = jax.value_and_grad(ref, has_aux=True)(
        jnp.asarray(x))
    m = tpn2.BatchNorm(x.shape[-1], eps=eps, momentum=momentum).train()
    with torch.no_grad():
        m.weight.copy_(_t(params["scale"]))
        m.bias.copy_(_t(params["bias"]))
        m.running_mean.copy_(_t(stats["mean"]))
        m.running_var.copy_(_t(stats["var"]))
    x_t = _t(x).requires_grad_(True)
    y = m(x_t, None if mask is None else _t(mask))
    (y * _t(g)).sum().backward()
    _close(y, want_y, 1e-5, 1e-5, "y")
    _close(m.running_mean, want_stats["mean"], 1e-5, 1e-5, "running mean")
    _close(m.running_var, want_stats["var"], 1e-5, 1e-5, "running var")
    _close(x_t.grad, want_dx, 1e-4, 1e-5, "dx")


def test_shared_mlp_empty_mask_falls_back_to_all():
    """An all-empty mask: the MLP's BNs take every element (safe_bn_mask)."""
    x, mask, _, _, _ = _bn_case(7, "empty")
    jm = jpn2.SharedMLP([5, 4])
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    want, upd = jm.apply(v, jnp.asarray(x), True, mask=jnp.asarray(mask[..., None]),
                         mutable=["batch_stats"])
    tm = tpn2.SharedMLP(x.shape[-1], [5, 4]).train()
    with torch.no_grad():
        for i in range(2):
            getattr(tm, f"fc{i}").weight.copy_(_t(np.asarray(v["params"][f"fc{i}"]["kernel"]).T))
    got = tm(_t(x), _t(mask))
    _close(got, want, 1e-5, 1e-5, "y")
    for i in range(2):
        bn = getattr(tm, f"bn{i}")
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            w = upd["batch_stats"][f"bn{i}"][key]
            assert np.isfinite(np.asarray(w)).all()
            _close(getattr(bn, name), w, 1e-5, 1e-5, f"bn{i} {name}")


def test_grouped_max_splits_ties_like_jax():
    """The masked max-pool keeps amax: ties share the gradient, as jnp.max."""
    h = np.array([[[[1.0, 2.0], [3.0, 2.0], [3.0, 0.5]]]], np.float32)
    slot_ok = np.array([[[True, True, True]]])
    want = jax.grad(lambda a: jnp.where(jnp.asarray(slot_ok)[..., None], a, -1e9
                                        ).max(axis=2).sum())(jnp.asarray(h))
    from tsm_det_pointcloud_tpu_torch.models.backbones_3d import (
        voxel_pointnet2_backbone as tvb)
    h_t = _t(h).requires_grad_(True)
    tvb._masked_max(h_t, _t(slot_ok), torch.ones(1, 1, dtype=torch.bool)).sum().backward()
    np.testing.assert_array_equal(h_t.grad.numpy(), np.asarray(want))
    assert float(h_t.grad[0, 0, 0, 1]) == 0.5

