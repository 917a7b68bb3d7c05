"""Eval entry point: build the detector on the card and detect on synthetic
scans.

    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/fast_cpc.yaml [--batch 16] \
        [--points 16384] [--iters 3] [--seed 0] [--device cuda] [--profile]
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/waymo_models/waymo_fast_cpc.yaml --batch 8 \
        --points 122880
    python -m tsm_det_pointcloud_tpu_torch.infer \
        --cfg_file tools/cfgs/kitti_models/second.yaml --batch 4 --points 20000

The dataset's geometry is read from the config's DATA_CONFIG (voxel limits
of the test mode) and the synthetic scans follow it: KITTI (4 point
features) or Waymo (5 point features, a +-75.2 m range). Prints the
detections per scan of the last batch and the scans/s over the timed
batches (host clock around work that ends in a synchronize). Weights, BN
running stats and the TSM head's statistics buffers are random, made from
--seed, with the cls priors lifted so that NMS has boxes to work on.
--profile then traces one more batch with
torch.profiler and prints the device's busy share of that batch's wall time
and the kernels with the most device time, and the same for the batch's
post-processing alone.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .config import cfg_from_yaml_file
from .models import build_network
from .models.detectors import DatasetMeta
from .utils.common_utils import resolve_device
from .utils.edict import EDict

ROOT = Path(__file__).resolve().parent.parent


class ScanRecipe(NamedTuple):
    """The constants of one synthetic-scan recipe: background points uniform
    in the box `lo`..`hi`, `n_clusters` object-like clusters of 200 points
    each (x within 2 m, y within 1 m of a centre drawn in `centre_lo`..
    `centre_hi`, z in `cluster_z`), and the box that holds such a cluster
    (z centre, dx, dy, dz)."""
    lo: tuple
    hi: tuple
    n_clusters: int
    centre_lo: tuple
    centre_hi: tuple
    cluster_z: tuple
    box: tuple


# keyed by the dataset's POINT_CLOUD_RANGE: the recipes of the JAX package's
# bench.py (KITTI range, eight car-like clusters) and tools/bench_waymo.py
# (Waymo range, sixteen vehicle-like clusters)
SCAN_RECIPES = {
    (0, -40, -3, 70.4, 40, 1): ScanRecipe(
        (0.0, -39.0, -2.0), (69.0, 39.0, 0.5), 8, (5, -30), (60, 30), (-1.6, -0.2),
        (-0.9, 4.2, 2.2, 1.6)),
    (-75.2, -75.2, -2, 75.2, 75.2, 4): ScanRecipe(
        (-74, -74, -1.9), (74, 74, 3.9), 16, (-60, -60), (60, 60), (0.0, 1.8),
        (0.9, 4.2, 2.2, 2.0)),
}
KITTI_RANGE, WAYMO_RANGE = SCAN_RECIPES


def scan_recipe(point_cloud_range):
    """The synthetic-scan recipe for a dataset's range."""
    key = tuple(point_cloud_range)
    if key not in SCAN_RECIPES:
        raise ValueError(f"no synthetic-scan recipe for POINT_CLOUD_RANGE {key}: "
                         f"add one to infer.SCAN_RECIPES")
    return SCAN_RECIPES[key]


def synth_scene(batch, n, seed=0, point_cloud_range=KITTI_RANGE, n_features=4):
    """Synthetic scans (B, n, n_features: x, y, z, then features in [0, 1))
    in the given range by its `ScanRecipe`, and the clusters' (x, y) centres
    (B, n_clusters, 2)."""
    r = scan_recipe(point_cloud_range)
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch, n, n_features), np.float32)
    for a in range(3):
        pts[..., a] = rng.uniform(r.lo[a], r.hi[a], (batch, n))
    for a in range(3, n_features):
        pts[..., a] = rng.uniform(0, 1, (batch, n))
    centres = np.zeros((batch, r.n_clusters, 2), np.float32)
    for b in range(batch):
        for k in range(r.n_clusters):
            cx = rng.uniform(r.centre_lo[0], r.centre_hi[0])
            cy = rng.uniform(r.centre_lo[1], r.centre_hi[1])
            centres[b, k] = cx, cy
            s = slice(k * 200, (k + 1) * 200)
            pts[b, s, 0] = rng.uniform(cx - 2, cx + 2, 200)
            pts[b, s, 1] = rng.uniform(cy - 1, cy + 1, 200)
            pts[b, s, 2] = rng.uniform(*r.cluster_z, 200)
    return pts, centres


def synth_points(batch, n, seed=0):
    """Synthetic KITTI-range scans (B, n, 4) with eight car-like clusters
    each, so NMS has real work (the same recipe as the JAX bench)."""
    return synth_scene(batch, n, seed)[0]


def synth_waymo(batch, n, seed=0):
    """Synthetic Waymo-range scans (B, n, 5: x, y, z, intensity, elongation)
    with sixteen vehicle-like clusters each."""
    return synth_scene(batch, n, seed, WAYMO_RANGE, 5)[0]


def synth_scans(meta, batch, n, seed=0):
    """Synthetic scans of the dataset `meta` describes (`dataset_meta`)."""
    return synth_scene(batch, n, seed, meta.point_cloud_range, meta.num_point_features)[0]


def load_cfg(cfg_file):
    return cfg_from_yaml_file(str(cfg_file), EDict({"ROOT_DIR": ROOT, "LOCAL_RANK": 0}))


# SECOND's conv_cls bias in place of the -log(99) prior: with the seeded
# weights and eval state a few thousand of a scan's 211,200 anchors then
# score above the config's SCORE_THRESH 0.1 (calibrated on the synthetic
# KITTI scans at 20000 points; infer prints the count)
SECOND_CLS_BIAS = -2.575


@torch.no_grad()
def randomize_eval_state(model, seed):
    """Seeded non-trivial BN running stats and, for TSM, statistics buffers
    (a real deployment loads them from a checkpoint), and cls output biases
    lifted from the -log(99) prior so that boxes reach NMS: TSM's cls heads
    at 1.0, SECOND's conv_cls at SECOND_CLS_BIAS."""
    from .models.backbones_3d.pointnet2_modules import BatchNorm

    g = torch.Generator().manual_seed(int(seed))
    dev = next(model.parameters()).device
    for name, m in model.named_modules():
        if isinstance(m, (BatchNorm, torch.nn.BatchNorm2d)):
            n = m.running_mean.shape[0]
            m.running_mean.copy_((torch.randn(n, generator=g) * 0.2).to(dev))
            m.running_var.copy_((0.5 + torch.rand(n, generator=g)).to(dev))
        tail = name.rsplit(".", 1)[-1]
        if tail in ("cls0_out", "cls1_out", "cls2_out"):
            m.bias.fill_(1.0)
        elif tail == "conv_cls":
            m.bias.fill_(SECOND_CLS_BIAS)
    if hasattr(model.module_list[-1], "object_statistic_features"):
        seed_statistics(model, g)


@torch.no_grad()
def seed_statistics(model, g):
    """The head's class-statistics buffers N(0, 0.25) from generator g (a
    real run transfers them from the teacher checkpoint)."""
    head = model.module_list[1]
    for buf in ("object_statistic_features", "object_momentum", "object_mean"):
        t = getattr(head, buf)
        t.copy_((torch.randn(t.shape, generator=g) * 0.5).to(t.device))


def dataset_meta(cfg, n_points, mode="test"):
    """The static geometry of the config's dataset, read from its
    DATA_CONFIG: the range, the point features, the voxel size of the first
    DATA_PROCESSOR entry that states one (and its voxel limits, where it has
    them: MAX_NUMBER_OF_VOXELS of `mode`, "test" for eval and "train" for
    training, as the JAX data processor picks them), and the grid they
    give."""
    data = cfg.DATA_CONFIG
    pcr = tuple(data.POINT_CLOUD_RANGE)
    voxel = next(p for p in data.DATA_PROCESSOR if "VOXEL_SIZE" in p)
    size = tuple(voxel.VOXEL_SIZE)
    grid = np.round(np.subtract(pcr[3:], pcr[:3]) / np.asarray(size)).astype(int)
    limits = {}
    if "MAX_NUMBER_OF_VOXELS" in voxel:
        limits["max_voxels"] = int(voxel.MAX_NUMBER_OF_VOXELS[mode])
    if "MAX_POINTS_PER_VOXEL" in voxel:
        limits["max_points_per_voxel"] = int(voxel.MAX_POINTS_PER_VOXEL)
    return DatasetMeta(
        class_names=tuple(cfg.CLASS_NAMES), point_cloud_range=pcr, voxel_size=size,
        grid_size=tuple(int(g) for g in grid),
        num_point_features=len(data.POINT_FEATURE_ENCODING.used_feature_list),
        max_points=n_points, **limits)


def build_detector(cfg_file, device="cuda", seed=0, n_points=16384):
    """The detector of `cfg_file` with seeded random weights and eval state;
    its dataset's geometry is `model.dataset_meta`."""
    cfg = load_cfg(cfg_file)
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                          dataset=dataset_meta(cfg, n_points), device=device,
                          seed=seed)
    randomize_eval_state(model, seed + 1)
    return cfg, model


@torch.no_grad()
def detect(model, points, mask):
    """points (B, N, C), mask (B, N) on the model's device -> (batch_dict,
    pred) with fixed-size detections."""
    out = model({"points": points, "points_mask": mask,
                 "batch_size": points.shape[0]})
    pred, _ = model.post_processing(out)
    return out, pred


def voxel_anchor_counts(model, out):
    """Per scan, the voxels a voxel-based detector kept and the anchors
    (predictions) whose best class score reaches a scalar SCORE_THRESH; None
    where the model or the config has neither."""
    post = model.model_cfg["POST_PROCESSING"]
    voxels = out["voxel_mask"].sum(1).tolist() if "voxel_mask" in out else None
    thresh = post.get("SCORE_THRESH", 0.1)
    over = None
    if not isinstance(thresh, (list, tuple)):
        scores = torch.sigmoid(out["batch_cls_preds"]).amax(-1)
        over = (scores >= float(thresh)).sum(1).tolist()
    return voxels, over


def self_device_us(evt):
    """A torch.profiler event's own device time, µs (the attribute's name
    differs between PyTorch versions; 0 when it has none)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_batch(model, points, mask, top=20):
    """Trace one batch on the card; print the device busy share and the
    kernels with the most device time. Then trace the batch's
    post-processing (NMS) alone, to show its share of the batch."""
    profile_call(lambda: detect(model, points, mask), top)
    out, _ = detect(model, points, mask)
    print("post-processing alone:")
    profile_call(lambda: model.post_processing(out), top=5)


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
              and self_device_us(e) > 0]
    busy_us = sum(self_device_us(e) for e in events)
    print(f"profile: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%), idle {100 - 100 * busy_us / wall_us:.1f}%")
    # each iteration of an NMS keep fixpoint (nms_bev's or the suppression
    # matrix route's) ends in one torch.equal, which the host waits for
    n_equal = sum(e.count for e in prof.key_averages() if e.key == "aten::equal")
    if n_equal:
        print(f"profile: {n_equal} aten::equal calls (NMS keep-fixpoint iterations, one "
              f"host sync each)")
    events.sort(key=self_device_us, reverse=True)
    for e in events[:top]:
        print(f"  {self_device_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")


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
    cfg, model = build_detector(args.cfg_file, dev, args.seed, args.points)
    pts = torch.from_numpy(synth_scans(model.dataset_meta, args.batch, args.points, args.seed)).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    detect(model, pts, mask)  # warm-up: builds the kernels
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out, pred = detect(model, pts, mask)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    voxels, over = voxel_anchor_counts(model, out)
    for b, c in enumerate(pred["count"].tolist()):
        extra = "" if voxels is None else f", {voxels[b]} voxels"
        extra += "" if over is None else f", {over[b]} predictions over SCORE_THRESH"
        print(f"scan {b}: {c} detections{extra}")
    print(f"{args.batch * args.iters / dt:.3f} scans/s on {dev} "
          f"(batch {args.batch} x {args.points} points, {args.iters} batches)")
    if args.profile:
        if dev.type != "cuda":
            raise RuntimeError("--profile measures the card: run with --device cuda")
        profile_batch(model, pts, mask)


if __name__ == "__main__":
    main()
