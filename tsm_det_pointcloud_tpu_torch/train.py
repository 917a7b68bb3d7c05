"""Training entry point: the fast_cpc distillation step, the TSM teacher's
step or SECOND's step, on synthetic scans.

    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/fast_cpc.yaml [--batch 16] \\
        [--points 16384] [--steps 3] [--seed 0] [--device cuda] \\
        [--ckpt_dir DIR] [--pretrained_model CKPT] [--profile]
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/fast_cpc_teacher.yaml --ckpt_dir DIR
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/waymo_models/waymo_fast_cpc.yaml --batch 8 \\
        --points 122880 --steps 3
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/second.yaml --batch 4 --points 20000

Builds the detector with seeded random weights. With --pretrained_model (a
checkpoint this entry point wrote, e.g. the teacher's) the weights it holds
are loaded by key and shape (`runtime.checkpoint.partial_load`) and its
class statistics by name (`transfer_statistics`), the two phases of the TSM
recipe; without it a distillation config
(`runtime.train_state.is_distillation`) seeds the class-statistics buffers
instead. A distillation config then freezes the teacher and trains the
student; any other config (the TSM teacher, whose statistics start at
zeros and accumulate in training, and SECOND) trains every parameter. The optimizer is the config's adam_onecycle, over one warm-up
step (which builds the kernels) plus --steps timed steps
(`runtime.train_loop.train_one_epoch`, which reads the loss on the host at
the first and the last of them), each on its own synthetic scan batch with
one class-1 box (a car) around each of the scan's eight point clusters
(KITTI-range configs) or one vehicle box around each of its sixteen (Waymo
configs). Prints the losses, the train scans/s over the timed steps (host
clock around work that ends in a synchronize) and the peak device memory;
with --ckpt_dir it then writes a checkpoint. --profile then traces one more
step with torch.profiler and prints the device's busy share and the top
kernels.
The KITTI dataloader and its augmentors are not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .infer import (KITTI_RANGE, ROOT, dataset_meta, load_cfg, profile_call, scan_recipe,
                    seed_statistics, synth_scene)
from .models import build_network
from .runtime.checkpoint import (load_model_state, partial_load, save_checkpoint,
                                 transfer_statistics)
from .runtime.optimization import build_optimizer
from .runtime.train_loop import train_one_epoch
from .runtime.train_state import freeze_teacher, is_distillation, train_step
from .utils.common_utils import resolve_device


def synth_train_batch(batch, n, seed=0, device="cpu", point_cloud_range=KITTI_RANGE,
                      n_features=4):
    """Synthetic scans (infer.synth_scene: by default the KITTI range's
    (B, n, 4) with 8 clusters; the Waymo range's have 16) plus gt_boxes with
    the recipe's box of class 1, heading 0, around each cluster, and masks,
    as device tensors."""
    pts, centres = synth_scene(batch, n, seed, point_cloud_range, n_features)
    n_box = centres.shape[1]
    gt = np.zeros((batch, n_box, 8), np.float32)
    gt[..., 0:2] = centres
    gt[..., 2:6] = scan_recipe(point_cloud_range).box
    gt[..., 7] = 1
    dev = torch.device(device)
    return {"points": torch.from_numpy(pts).to(dev),
            "points_mask": torch.ones((batch, n), dtype=torch.bool, device=dev),
            "batch_size": batch,
            "gt_boxes": torch.from_numpy(gt).to(dev),
            "gt_boxes_mask": torch.ones((batch, n_box), dtype=torch.bool, device=dev)}


def build_trainer(cfg_file, device="cuda", seed=0, n_points=16384, total_steps=1,
                  pretrained_model=None):
    """(cfg, model in train mode, optimizer over the parameters that train:
    the student's for a distillation config, else all of them).
    pretrained_model: a checkpoint file whose weights and class statistics
    are loaded first (as the JAX tools/train.py:161-171 does)."""
    cfg = load_cfg(cfg_file)
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                          dataset=dataset_meta(cfg, n_points, "train"), device=device,
                          seed=seed)
    if pretrained_model is not None:
        state = load_model_state(pretrained_model)
        missed = partial_load(model, state)
        moved = transfer_statistics(model, state)
        print(f"pretrained model {pretrained_model}: {len(model.state_dict()) - len(missed)} "
              f"entries loaded, {len(missed)} not in it; statistics {moved}")
    elif is_distillation(cfg.MODEL):
        seed_statistics(model, torch.Generator().manual_seed(seed + 1))
    if is_distillation(cfg.MODEL):
        params = freeze_teacher(model)
    else:
        params = list(model.parameters())
    opt = build_optimizer(cfg.OPTIMIZATION, params, total_steps)
    return cfg, model.train(), opt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg_file", default=str(ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--pretrained_model", default=None,
                    help="a checkpoint of this entry point (the teacher's, for a "
                         "distillation config) to start from")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    total = args.steps + 1 + int(args.profile)
    cfg, model, opt = build_trainer(args.cfg_file, dev, args.seed, args.points, total,
                                    args.pretrained_model)
    meta = model.dataset_meta
    batches = [synth_train_batch(args.batch, args.points, args.seed + i, dev,
                                 meta.point_cloud_range, meta.num_point_features)
               for i in range(total)]
    loss, _ = train_step(model, opt, batches[0])  # warm-up: builds the kernels
    print(f"warm-up step: loss {float(loss):.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mean_loss = train_one_epoch(model, opt, batches[1:args.steps + 1], 0, 1,
                                log_every=max(args.steps - 1, 1))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"mean loss over the timed steps {mean_loss:.4f}")
    peak = (f", peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "")
    print(f"{args.batch * args.steps / dt:.3f} train scans/s on {dev} "
          f"(batch {args.batch} x {args.points} points, {args.steps} steps, "
          f"{1e3 * dt / max(args.steps, 1):.1f} ms/step{peak})")
    if args.ckpt_dir:
        print(f"checkpoint: {save_checkpoint(model, opt, args.ckpt_dir, 1, opt.state['count'])}")
    if args.profile:
        if dev.type != "cuda":
            raise RuntimeError("--profile measures the card: run with --device cuda")
        profile_call(lambda: train_step(model, opt, batches[-1]))


if __name__ == "__main__":
    main()
