#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. card and build: prints the card's name and power limit and builds the
     hand-written kernels from tsm_det_pointcloud_tpu_torch/csrc;
  2. capture: one eval forward of the fast_cpc detector (b16 x 16384;
     weights, BN stats and statistics buffers seeded and random, as
     infer.build_detector makes them) records every kernel call's inputs;
  3. kernels: each recorded call runs through its kernel and its plain
     PyTorch version — K1 FPS index-equal, K2 query+group cnt / filled idx /
     gathered rows equal, K3 probe bitwise, K4 gather-GEMM allclose
     (rtol 1e-4, atol 1e-4 * max|out|: f32 sums in another order) — and
     both are timed with CUDA events, with the bound from the inputs;
  4. reference: the tiny TSM config with the JAX package's converted
     PRNGKey(0) weights reproduces tests/goldens/tsm_forward.npz on the card
     (golden tolerance: atol 1e-3 * max(1, max|want|), rtol 1e-3);
  5. main path: launch counts are zeroed, 3 batches of forward +
     multi-threshold NMS run, the counts are read; outputs must be finite,
     count <= NMS_POST_MAXSIZE, and every eval kernel must have launched;
  6. training capture: one full-width distillation training step of the
     same detector (b16 x 16384, synthetic scans with a car box around each
     cluster, adam_onecycle over the student) records every kernel call's
     inputs (K1-K4 at the training path's own shapes: the teacher's sa1 and
     its 128/256-wide U-Net, the teacher head's VSA) and checks that
     backward gave every s_* parameter a gradient (every sparse-conv weight
     a nonzero one) and the teacher none; each call runs through its kernel
     and its plain version at the tolerances of phase 3, K5 (df and dW) at
     K4's (float atomics sum in a varying order), and both are timed with
     the bound;
  7. training reference: the tiny config's training step on the card (the
     committed PRNGKey(0) state, tiny.train_statistics, the "wide" boxes)
     reproduces tsm_det_pointcloud_tpu_torch/data/tsm_tiny_train_golden.npz
     (loss and tb terms: atol 1e-4 * max(1, |want|), rtol 1e-4; s_*
     gradients: rtol 1e-3, atol 1e-4 * max(max|want|, 1e-2 * the largest
     |want|), the tolerances of tests/test_torch_tsm_train.py);
  8. training main path: launch counts are zeroed, 3 timed steps run, the
     counts are read; every loss must be finite, the teacher's parameters
     bit-identical, every s_* parameter changed and every kernel, K5
     included, launched. Prints train scans/s and the peak device memory.
The line before the last is the kernels JSON: each row's numbers are those
of the training path (per step of phase 6, `launches` from phase 8) and its
`eval` object those of the eval path (per forward of phase 3, `launches`
from phase 5; null for K5). The last line is the result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BYTES_PER_S = 3.35e12      # H100 SXM HBM3
MAIN_BATCH, MAIN_POINTS, MAIN_ITERS, TRAIN_ITERS = 16, 16384, 3, 3
EVAL_KERNELS = ("fps", "query_group", "probe", "spconv_bykey")
KERNELS = {
    "fps": ("tsm_det_pointcloud_tpu_torch/csrc/fps.cu",
            "tsm_det_pointcloud_tpu/ops/fps_pallas.py:28"),
    "query_group": ("tsm_det_pointcloud_tpu_torch/csrc/group.cu",
                    "tsm_det_pointcloud_tpu/ops/group_pallas.py:108"),
    "probe": ("tsm_det_pointcloud_tpu_torch/csrc/probe.cu",
              "tsm_det_pointcloud_tpu/ops/searchsorted_pallas.py:55"),
    "spconv_bykey": ("tsm_det_pointcloud_tpu_torch/csrc/spconv_bykey.cu",
                     "tsm_det_pointcloud_tpu/ops/spconv_pallas.py:132"),
    "spconv_bykey_bwd": ("tsm_det_pointcloud_tpu_torch/csrc/spconv_bykey_bwd.cu",
                         "tsm_det_pointcloud_tpu/ops/spconv_pallas.py:383"),
}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_time_ms(fn, reps):
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops, nbytes):
    t_ops = ops / F32_OPS_PER_S * 1e3
    t_bytes = nbytes / BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


class Recorder:
    """Wraps the kernel wrappers to keep a copy of every call's inputs."""

    def __init__(self, names):
        self.calls = {k: [] for k in names}
        self._undo = []

    def wrap(self, module, attr, name):
        orig = getattr(module, attr)

        def rec(*args):
            import torch

            self.calls[name].append(tuple(
                a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args))
            return orig(*args)

        setattr(module, attr, rec)
        self._undo.append((module, attr, orig))

    def restore(self):
        for module, attr, orig in self._undo:
            setattr(module, attr, orig)


def compare_fps(args):
    from tsm_det_pointcloud_tpu_torch.ops import sampling

    xyz, npoint, valid, weights = args
    got = sampling._fps_kernel(xyz, npoint, valid, weights)
    want = sampling.furthest_point_sample_plain(xyz, npoint, valid, weights)
    check(bool((got == want).all()), f"K1 fps differs from its plain version at {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    ops = (npoint - 1) * B * N * (10 if weights is not None else 9)
    nbytes = B * N * 12 + B * npoint * 4 + (B * N if valid is not None else 0) \
        + (B * N * 4 if weights is not None else 0)
    return (0.0, lambda: sampling._fps_kernel(xyz, npoint, valid, weights),
            lambda: sampling.furthest_point_sample_plain(xyz, npoint, valid, weights),
            None, ops, nbytes, 5, 1)


def compare_query_group(args):
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import grouping

    src_xyz, src_valid, q_xyz, scales, payload, src_coords, q_coords = args
    gi, gc, gg = grouping._query_group_kernel(*args)
    wi, wc, wg = grouping.query_group_plain(*args)
    check(bool((gc == wc).all()), "K2 cnt differs from its plain version")
    # slot j of scale s is filled when j < min(cnt_s, ns_s)
    filled = torch.cat([torch.arange(int(sc[2]), device=gc.device)
                        < torch.clamp(gc[..., s], max=int(sc[2]))[..., None]
                        for s, sc in enumerate(scales)], -1)
    check(bool((gi[filled] == wi[filled]).all()), "K2 idx differs on filled slots")
    err = 0.0
    if gg is not None:
        d = (gg[filled] - wg[filled]).abs()
        err = float(d.max()) if d.numel() else 0.0
        check(err == 0.0, "K2 gathered rows differ from the plain gather")
    B, N, _ = src_xyz.shape
    M = q_xyz.shape[1]
    S = len(scales)
    T = sum(int(s[2]) for s in scales)
    D = 0 if payload is None else payload.shape[-1]
    window = src_coords is not None
    ops = B * M * N * (8 + 2 * S + (6 if window else 0))
    nbytes = (B * N * (12 + 1 + (12 if window else 0) + 4 * D)
              + B * M * (12 + (12 if window else 0))
              + B * M * (4 * T + 4 * S + 4 * T * D))
    return (err, lambda: grouping._query_group_kernel(*args),
            lambda: grouping.query_group_plain(*args), None, ops, nbytes, 5, 1)


def compare_probe(args):
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import spconv

    skeys, queries, sentinel = args
    gi, gf = spconv.probe(skeys, queries, sentinel)
    wi, wf = spconv.probe_plain(skeys, queries, sentinel)
    check(bool((gi == wi).all()) and bool((gf == wf).all()),
          "K3 probe differs bitwise from its plain version")
    B, V = skeys.shape
    Q = queries.shape[1]
    sk = skeys.contiguous()
    q = queries.contiguous()
    ops = B * Q * int(np.ceil(np.log2(max(V, 2))) + 1)
    nbytes = 4 * B * V + 4 * B * Q + 5 * B * Q
    return (0.0, lambda: spconv.probe(skeys, queries, sentinel),
            lambda: spconv.probe_plain(skeys, queries, sentinel),
            lambda: torch.searchsorted(sk, q, right=True), ops, nbytes, 20, 5)


def compare_bykey(args):
    from tsm_det_pointcloud_tpu_torch.ops import spconv

    f, skeys, qkeys, w, sentinel = args
    got = spconv.gather_matmul_bykey(f, skeys, qkeys, w, sentinel)
    want = spconv.gather_matmul_bykey_plain(f, skeys, qkeys, w, sentinel)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-4 * scale).all()),
          f"K4 differs from its plain version: max abs err {err} (scale {scale})")
    B, V, C = f.shape
    _, K, Q = qkeys.shape
    Co = w.shape[-1]
    _, found = spconv._lookup_plain(skeys, qkeys, sentinel)
    hits = int(found.sum())
    ops = 2 * C * Co * hits
    nbytes = 4 * (B * V * C + B * V + B * K * Q + K * C * Co + B * Q * Co)
    return (err, lambda: spconv.gather_matmul_bykey(f, skeys, qkeys, w, sentinel),
            lambda: spconv.gather_matmul_bykey_plain(f, skeys, qkeys, w, sentinel),
            None, ops, nbytes, 5, 2)


def compare_bykey_bwd(args):
    from tsm_det_pointcloud_tpu_torch.ops import spconv

    f, skeys, qkeys, w, g, sentinel = args
    got = spconv.gather_matmul_bykey_bwd(f, skeys, qkeys, w, g, sentinel)
    want = spconv.gather_matmul_bykey_bwd_plain(f, skeys, qkeys, w, g, sentinel)
    err = 0.0
    for what, gt, wt in zip(("df", "dW"), got, want):
        scale = float(wt.abs().max())
        e = float((gt - wt).abs().max())
        check(bool(((gt - wt).abs() <= 1e-4 * wt.abs() + 1e-4 * scale).all()),
              f"K5 {what} differs from its plain version: max abs err {e} (scale {scale})")
        err = max(err, e)
    B, V, C = f.shape
    _, K, Q = qkeys.shape
    Co = w.shape[-1]
    _, found = spconv._lookup_plain(skeys, qkeys, sentinel)
    hits = int(found.sum())
    ops = 4 * C * Co * hits
    nbytes = 4 * (2 * B * V * C + B * Q * Co + 2 * K * C * Co + B * V + B * K * Q)
    return (err, lambda: spconv.gather_matmul_bykey_bwd(f, skeys, qkeys, w, g, sentinel),
            lambda: spconv.gather_matmul_bykey_bwd_plain(f, skeys, qkeys, w, g, sentinel),
            None, ops, nbytes, 5, 2)


COMPARE = {"fps": compare_fps, "query_group": compare_query_group,
           "probe": compare_probe, "spconv_bykey": compare_bykey,
           "spconv_bykey_bwd": compare_bykey_bwd}


def compare_recorded(calls, label):
    """Each recorded call through its kernel and its plain version, timed;
    returns the per-kernel sums over the recorded pass."""
    import torch

    report = {}
    for name, args_list in calls.items():
        agg = dict(err=0.0, ms=0.0, plain_ms=0.0, lib_ms=None, ops=0, nbytes=0,
                   bound=0.0)
        for i, args in enumerate(args_list):
            err, kfn, pfn, lfn, ops, nbytes, reps, preps = COMPARE[name](args)
            k_ms = cuda_time_ms(kfn, reps)
            p_ms = cuda_time_ms(pfn, preps)
            l_ms = cuda_time_ms(lfn, reps) if lfn is not None else None
            b_ms, b_by = bound_ms(ops, nbytes)
            shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
            print(f"  {label} {name} call {i}: {shapes} kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
                  + (f", library {l_ms:.4f} ms" if l_ms is not None else ""))
            agg["err"] = max(agg["err"], err)
            agg["ms"] += k_ms
            agg["plain_ms"] += p_ms
            agg["ops"] += ops
            agg["nbytes"] += nbytes
            if l_ms is not None:
                agg["lib_ms"] = (agg["lib_ms"] or 0.0) + l_ms
        agg["bound"], agg["bound_by"] = bound_ms(agg["ops"], agg["nbytes"])
        report[name] = agg
        print(f"{label} {name}: {len(args_list)} calls per pass, kernel {agg['ms']:.4f} ms, "
              f"plain {agg['plain_ms']:.4f} ms, bound {agg['bound']:.4f} ms "
              f"({agg['bound_by']}), max abs err {agg['err']:g}")
    return report


def record_kernels(names):
    """A Recorder over the wrappers of the named kernels."""
    from tsm_det_pointcloud_tpu_torch.ops import grouping, sampling, spconv

    where = {"fps": (sampling, "_fps_kernel"),
             "query_group": (grouping, "_query_group_kernel"),
             "probe": (spconv, "probe"),
             "spconv_bykey": (spconv, "gather_matmul_bykey"),
             "spconv_bykey_bwd": (spconv, "gather_matmul_bykey_bwd")}
    rec = Recorder(names)
    for name in names:
        rec.wrap(*where[name], name)
    return rec


def close_scalar(got, want):
    return abs(got - want) <= 1e-4 * max(1.0, abs(want)) + 1e-4 * abs(want)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the card")
    sys.path.insert(0, str(ROOT))
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import build_detector, detect, synth_points
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import is_student, train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    # ---- 1. card and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(card)
    build_s = _kernels.build_all()
    for name in KERNELS:
        _kernels.func(name)
    print(f"kernels built in {build_s:.1f} s")
    for name, log in _kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 2. capture the main path's kernel calls ----
    cfg_file = ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"
    cfg, model = build_detector(cfg_file, dev, seed=0, n_points=MAIN_POINTS)
    post_max = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    lo, hi = cfg.MODEL.POINT_HEAD.SAMPLE_RANGE
    batches = [torch.from_numpy(synth_points(MAIN_BATCH, MAIN_POINTS, seed=s)).to(dev)
               for s in range(MAIN_ITERS)]
    mask = torch.ones((MAIN_BATCH, MAIN_POINTS), dtype=torch.bool, device=dev)
    rec = record_kernels(EVAL_KERNELS)
    detect(model, batches[0], mask)
    torch.cuda.synchronize()
    rec.restore()
    for name, calls in rec.calls.items():
        check(len(calls) > 0, f"the capture forward made no {name} call")

    # ---- 3. each kernel against its plain version, timed ----
    report_eval = compare_recorded(rec.calls, "eval")
    del rec

    # ---- 4. reference: the tiny config reproduces the JAX golden ----
    tmodel = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device=dev)
    tmodel.load_state_dict(tiny.load_state(), strict=True)
    tpts = torch.from_numpy(tiny.synth_points(2)).to(dev)
    tout, tpred = detect(tmodel, tpts, torch.ones(tpts.shape[:2], dtype=torch.bool,
                                                   device=dev))
    golden = np.load(ROOT / "tests/goldens/tsm_forward.npz")
    for key in golden.files:
        want = golden[key]
        got = tout[key].cpu().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        diff = float(np.abs(got - want).max())
        check(got.shape == want.shape and np.allclose(got, want, atol=1e-3 * scale, rtol=1e-3),
              f"tiny {key} differs from the golden: max abs diff {diff}")
        print(f"reference: tiny {key} {got.shape} max abs diff vs golden {diff:.3g}")

    # ---- 5. the main path, counted ----
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    preds = []
    for pts in batches:
        out, pred = detect(model, pts, mask)
        preds.append((out, pred))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_eval = dict(_kernels.LAUNCHES)
    for out, pred in preds:
        for key in ("batch_cls_preds", "batch_box_preds"):
            check(bool(torch.isfinite(out[key]).all()), f"non-finite {key}")
        check(tuple(out["batch_box_preds"].shape) == (MAIN_BATCH, hi - lo, 7),
              f"box preds shape {tuple(out['batch_box_preds'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"non-finite {key}")
        check(bool((pred["count"] <= post_max).all()), "count > NMS_POST_MAXSIZE")
    counts = [int(c) for c in preds[-1][1]["count"]]
    for name in EVAL_KERNELS:
        check(launches_eval[name] > 0, f"kernel {name} was not launched on the eval path")
    print(f"main path: {MAIN_ITERS} batches x {MAIN_BATCH} scans x {MAIN_POINTS} "
          f"points in {dt:.3f} s = {MAIN_ITERS * MAIN_BATCH / dt:.3f} scans/s; "
          f"detections per scan (last batch) {counts}; launches {launches_eval}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, preds, batches, out, pred

    # ---- 6. capture one full-width training step's kernel calls ----
    _, tr_model, opt = build_trainer(cfg_file, dev, seed=0, n_points=MAIN_POINTS,
                                     total_steps=TRAIN_ITERS + 1)
    tbatches = [synth_train_batch(MAIN_BATCH, MAIN_POINTS, seed=s, device=dev)
                for s in range(TRAIN_ITERS + 1)]
    rec = record_kernels(list(KERNELS))
    # train_step's work, with the gradients read between backward and the
    # update: every s_* parameter gets one from backward (the kernels'
    # outputs are wired into autograd), every sparse-conv weight a nonzero one
    opt.zero_grad(set_to_none=True)
    out = tr_model(dict(tbatches[0]))
    out["loss"].backward()
    torch.cuda.synchronize()
    rec.restore()
    for n, p in tr_model.named_parameters():
        if is_student(n):
            check(p.grad is not None, f"student parameter {n} got no gradient")
            if p.dim() == 3:
                check(bool(p.grad.abs().sum() > 0), f"sparse-conv weight {n} got a zero gradient")
        else:
            check(p.grad is None, f"teacher parameter {n} got a gradient")
    opt.step()
    for name, calls in rec.calls.items():
        check(len(calls) > 0, f"the training capture step made no {name} call")
    print(f"training capture: loss {float(out['loss'].detach()):.4f}, "
          + ", ".join(f"{k} {float(torch.as_tensor(v).detach()):.4f}"
                      for k, v in out["tb_dict"].items()))
    del out
    report = compare_recorded(rec.calls, "train")
    del rec

    # ---- 7. training reference: the tiny step reproduces the JAX golden ----
    tmodel = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device=dev)
    tmodel.load_state_dict(tiny.load_state(), strict=True)
    for k, v in tiny.train_statistics().items():
        getattr(tmodel.module_list[1], k).copy_(torch.from_numpy(v).to(dev))
    gt, gt_mask = tiny.synth_gt(2, "wide")
    tout = tmodel.train()({"points": tpts, "batch_size": 2,
                           "points_mask": torch.ones(tpts.shape[:2], dtype=torch.bool,
                                                     device=dev),
                           "gt_boxes": torch.from_numpy(gt).to(dev),
                           "gt_boxes_mask": torch.from_numpy(gt_mask).to(dev)})
    tout["loss"].backward()
    params = dict(tmodel.named_parameters())
    with np.load(ROOT / "tsm_det_pointcloud_tpu_torch/data/tsm_tiny_train_golden.npz") as g:
        gold = {k: g[k] for k in g.files}
    gscale = max(float(np.abs(v).max()) for k, v in gold.items() if k.startswith("grad/"))
    worst = 0.0
    for key, want in gold.items():
        if key.startswith("grad/"):
            got = params[key[5:]].grad.cpu().numpy()
            atol = 1e-4 * max(float(np.abs(want).max()), 1e-2 * gscale)
            diff = float(np.abs(got - want).max())
            check(np.allclose(got, want, rtol=1e-3, atol=atol),
                  f"tiny training {key} differs from the golden: max abs diff {diff}")
            worst = max(worst, diff)
        else:
            got = float((tout["loss"] if key == "loss" else tout["tb_dict"][key[3:]]).detach())
            check(close_scalar(got, float(want)),
                  f"tiny training {key} {got} differs from the golden {float(want)}")
    print(f"training reference: tiny loss {float(tout['loss'].detach()):.6f} (golden "
          f"{float(gold['loss']):.6f}), {sum(k.startswith('grad/') for k in gold)} "
          f"s_* gradients, max abs diff {worst:.3g}")
    del tmodel, tout, params

    # ---- 8. the training main path, counted ----
    before = {n: p.detach().clone() for n, p in tr_model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [train_step(tr_model, opt, b)[0] for b in tbatches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, l in enumerate(losses):
        check(bool(torch.isfinite(l)), f"training step {i} loss is not finite")
    n_student = 0
    for n, p in tr_model.named_parameters():
        if is_student(n):
            n_student += 1
            check(not torch.equal(p, before[n]), f"student parameter {n} did not change")
        else:
            check(torch.equal(p, before[n]), f"teacher parameter {n} changed")
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the training path")
    print(f"training main path: {TRAIN_ITERS} steps x {MAIN_BATCH} scans x {MAIN_POINTS} "
          f"points in {dt:.3f} s = {TRAIN_ITERS * MAIN_BATCH / dt:.3f} train scans/s "
          f"({1e3 * dt / TRAIN_ITERS:.1f} ms/step); losses "
          f"{[round(float(l), 4) for l in losses]}; {n_student} student tensors changed, "
          f"teacher unchanged; launches {launches}; peak memory {peak:.2f} GiB")

    def numbers(a, n):
        return {"launches": n, "max_abs_err": a["err"], "ms": a["ms"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound"],
                "bound_by": a["bound_by"], "library_ms": a["lib_ms"]}

    rows = []
    for name, (src, replaces) in KERNELS.items():
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            **numbers(report[name], launches[name]),
            "eval": (numbers(report_eval[name], launches_eval[name])
                     if name in report_eval else None),
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
