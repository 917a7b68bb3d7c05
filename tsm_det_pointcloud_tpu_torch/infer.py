"""Eval entry point: build the detector on the card and detect on synthetic
scans.

    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/fast_cpc.yaml [--batch 16] \
        [--points 16384] [--iters 3] [--seed 0] [--device cuda] [--profile]

Prints the detections per scan of the last batch and the scans/s over the
timed batches (host clock around work that ends in a synchronize). Weights,
BN running stats and the head's statistics buffers are random, made from
--seed, with the cls priors lifted so that NMS has boxes to work on.
--profile then traces one more batch with
torch.profiler and prints the device's busy share of that batch's wall time
and the kernels with the most device time.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .config import cfg_from_yaml_file
from .models import build_network
from .models.detectors import DatasetMeta
from .utils.common_utils import resolve_device
from .utils.edict import EDict

ROOT = Path(__file__).resolve().parent.parent


def synth_scene(batch, n, seed=0):
    """Synthetic KITTI-range scans (B, n, 4) with eight car-like clusters
    each (x within 2 m, y within 1 m of its centre, z in [-1.6, -0.2]), and
    the clusters' (x, y) centres (B, 8, 2)."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch, n, 4), np.float32)
    pts[..., 0] = rng.uniform(0.0, 69.0, (batch, n))
    pts[..., 1] = rng.uniform(-39.0, 39.0, (batch, n))
    pts[..., 2] = rng.uniform(-2.0, 0.5, (batch, n))
    pts[..., 3] = rng.uniform(0, 1, (batch, n))
    centres = np.zeros((batch, 8, 2), np.float32)
    for b in range(batch):
        for k in range(8):
            cx, cy = rng.uniform(5, 60), rng.uniform(-30, 30)
            centres[b, k] = cx, cy
            pts[b, k * 200:(k + 1) * 200, 0] = rng.uniform(cx - 2, cx + 2, 200)
            pts[b, k * 200:(k + 1) * 200, 1] = rng.uniform(cy - 1, cy + 1, 200)
            pts[b, k * 200:(k + 1) * 200, 2] = rng.uniform(-1.6, -0.2, 200)
    return pts, centres


def synth_points(batch, n, seed=0):
    """Synthetic KITTI-range scans (B, n, 4) with eight car-like clusters
    each, so NMS has real work (the same recipe as the JAX bench)."""
    return synth_scene(batch, n, seed)[0]


def load_cfg(cfg_file):
    return cfg_from_yaml_file(str(cfg_file), EDict({"ROOT_DIR": ROOT, "LOCAL_RANK": 0}))


def kitti_meta(cfg, n_points):
    return DatasetMeta(
        class_names=tuple(cfg.CLASS_NAMES),
        point_cloud_range=(0, -40, -3, 70.4, 40, 1),
        voxel_size=(0.05, 0.05, 0.1), grid_size=(1408, 1600, 40),
        max_voxels=16000, max_points_per_voxel=5, num_point_features=4,
        max_points=n_points,
    )


@torch.no_grad()
def randomize_eval_state(model, seed):
    """Seeded non-trivial BN running stats and statistics buffers (a real
    deployment loads them from a checkpoint), and cls output biases at 1.0
    instead of the -log(99) prior, so that boxes reach NMS."""
    from .models.backbones_3d.pointnet2_modules import BatchNorm

    g = torch.Generator().manual_seed(int(seed))
    dev = next(model.parameters()).device
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            n = m.running_mean.shape[0]
            m.running_mean.copy_((torch.randn(n, generator=g) * 0.2).to(dev))
            m.running_var.copy_((0.5 + torch.rand(n, generator=g)).to(dev))
        if name.rsplit(".", 1)[-1] in ("cls0_out", "cls1_out", "cls2_out"):
            m.bias.fill_(1.0)
    seed_statistics(model, g)


@torch.no_grad()
def seed_statistics(model, g):
    """The head's class-statistics buffers N(0, 0.25) from generator g (a
    real run transfers them from the teacher checkpoint)."""
    head = model.module_list[1]
    for buf in ("object_statistic_features", "object_momentum", "object_mean"):
        t = getattr(head, buf)
        t.copy_((torch.randn(t.shape, generator=g) * 0.5).to(t.device))


def build_detector(cfg_file, device="cuda", seed=0, n_points=16384):
    """The detector of `cfg_file` with seeded random weights and eval state."""
    cfg = load_cfg(cfg_file)
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                          dataset=kitti_meta(cfg, n_points), device=device,
                          seed=seed)
    randomize_eval_state(model, seed + 1)
    return cfg, model


@torch.no_grad()
def detect(model, points, mask):
    """points (B, N, 4), mask (B, N) on the model's device -> (batch_dict,
    pred) with fixed-size detections."""
    out = model({"points": points, "points_mask": mask,
                 "batch_size": points.shape[0]})
    pred, _ = model.post_processing(out)
    return out, pred


def _self_device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_batch(model, points, mask, top=20):
    """Trace one batch on the card; print the device busy share and the
    kernels with the most device time."""
    profile_call(lambda: detect(model, points, mask), top)


def profile_call(fn, top=20):
    """Trace one call of `fn` on the card; print the device busy share of
    its wall time and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side kernel events only: an aten op's device time is also its
    # kernels' time, and a user annotation's (Optimizer.step) spans its
    # kernels' too, so counting either would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in events)
    print(f"profile: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%), idle {100 - 100 * busy_us / wall_us:.1f}%")
    events.sort(key=_self_device_us, reverse=True)
    for e in events[:top]:
        print(f"  {_self_device_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg_file", default=str(ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    _, model = build_detector(args.cfg_file, dev, args.seed, args.points)
    pts = torch.from_numpy(synth_points(args.batch, args.points, args.seed)).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    detect(model, pts, mask)  # warm-up: builds the kernels
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        _, pred = detect(model, pts, mask)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    for b, c in enumerate(pred["count"].tolist()):
        print(f"scan {b}: {c} detections")
    print(f"{args.batch * args.iters / dt:.3f} scans/s on {dev} "
          f"(batch {args.batch} x {args.points} points, {args.iters} batches)")
    if args.profile:
        if dev.type != "cuda":
            raise RuntimeError("--profile measures the card: run with --device cuda")
        profile_batch(model, pts, mask)


if __name__ == "__main__":
    main()
