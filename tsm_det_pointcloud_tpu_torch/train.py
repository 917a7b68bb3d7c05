"""Training entry point: the fast_cpc distillation step, the TSM teacher's
step or SECOND's step, on synthetic scans or on a dataset (KITTI or Waymo).

Synthetic-scan mode:
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
Dataset mode (`--data_root DIR`, or `--dataset` for the config's DATA_PATH;
the counterpart of the JAX tools/train.py):
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/fast_cpc.yaml --data_root DIR \\
        [--batch 16] [--epochs N] [--workers 4] [--ckpt_save_interval 1] \\
        [--max_ckpt_save_num 30] [--num_epochs_to_eval 0] [--extra_tag default] \\
        [--output_dir DIR] [--ckpt CKPT] [--pretrained_model CKPT] \\
        [--seed 0 | --fix_random_seed] [--device cuda]
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/waymo_models/waymo_fast_cpc.yaml --data_root DIR \\
        [--set DATA_CONFIG.SAMPLED_INTERVAL.train 1]
The two modes are chosen by these flags; neither falls back to the other.
`--set KEY VALUE ...` overrides config keys in both (`config.cfg_from_list`,
as the JAX tools/train.py's --set).

Both build the detector with seeded random weights. With --pretrained_model
(a checkpoint this entry point wrote, e.g. the teacher's) the weights it
holds are loaded by key and shape (`runtime.checkpoint.partial_load`) and
its class statistics by name (`transfer_statistics`), the two phases of the
TSM recipe; without it a distillation config
(`runtime.train_state.is_distillation`) seeds the class-statistics buffers
instead. A distillation config then freezes the teacher and trains the
student; any other config (the TSM teacher, whose statistics start at zeros
and accumulate in training, and SECOND) trains every parameter. The
optimizer is the config's adam_onecycle.

Synthetic-scan mode runs one warm-up step (which builds the kernels) plus
--steps timed steps (`runtime.train_loop.train_one_epoch`, which reads the
loss on the host at the first and the last of them), each on its own
synthetic scan batch with one class-1 box (a car) around each of the scan's
eight point clusters (KITTI-range configs) or one vehicle box around each of
its sixteen (Waymo configs). Prints the losses, the train scans/s over the
timed steps (host clock around work that ends in a synchronize) and the peak
device memory; with --ckpt_dir it then writes a checkpoint. --profile then
traces one more step with torch.profiler and prints the device's busy share
and the top kernels.

Dataset mode trains --epochs epochs (else the config's NUM_EPOCHS) over the
dataset's train split with the config's augmentors, `--workers` loader
processes and batches of --batch (else BATCH_SIZE_PER_GPU), resuming from
--ckpt, else from the newest checkpoint under <output_dir>/ckpt (on the card
the kernels are built first, while the loader's workers start). Its output
directory is the JAX tools/train.py's, output/<EXP_GROUP_PATH>/<TAG>/
<extra_tag> under the repository (`default_output_dir`: EXP_GROUP_PATH is
the --cfg_file string's folders after the first, TAG its file name's stem),
unless --output_dir names another; the config goes to its log file
(`config.log_config_to_file`). It checkpoints every --ckpt_save_interval
epochs, keeps the --max_ckpt_save_num newest, streams the losses to
<output_dir>/metrics.jsonl and prints each epoch's train scans/s (host
clock, loader included, ending in a synchronize), the loop's wait on the
loader a step and the peak device memory. --fix_random_seed seeds the
loader and numpy's global state with FIX_RANDOM_SEED (666, the JAX tool's)
in place of --seed. --num_epochs_to_eval N then evaluates the last N
checkpoints on the val split (`runtime.eval_utils.repeat_eval_ckpts`). A
dataset cached in shared memory (`USE_SHARED_MEMORY`) is cleaned at the
end.
"""
from __future__ import annotations

import argparse
import time
from contextlib import closing
from pathlib import Path

import numpy as np
import torch

from .config import log_config_to_file
from .infer import (KITTI_RANGE, ROOT, dataset_meta, load_cfg, profile_call, scan_recipe,
                    seed_statistics, synth_scene)
from .models import build_network
from .ops import _kernels
from .runtime.checkpoint import (latest_checkpoint, load_model_state, partial_load,
                                 restore_checkpoint, save_checkpoint, transfer_statistics)
from .runtime.optimization import build_optimizer
from .runtime.train_loop import train_model, train_one_epoch
from .runtime.train_state import freeze_teacher, is_distillation, train_step
from .utils.common_utils import create_logger, resolve_device


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
                  pretrained_model=None, dataset=None, set_cfgs=None):
    """(cfg, model in train mode, optimizer over the parameters that train:
    the student's for a distillation config, else all of them).
    pretrained_model: a checkpoint file whose weights and class statistics
    are loaded first (as the JAX tools/train.py:161-171 does). dataset: the
    training dataset whose geometry the model takes, else the config's
    (`infer.dataset_meta` at n_points). set_cfgs: `--set` overrides."""
    cfg = load_cfg(cfg_file, set_cfgs)
    if dataset is None:
        dataset = dataset_meta(cfg, n_points, "train")
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset=dataset,
                          device=device, seed=seed)
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


# the loader's seed and numpy's under --fix_random_seed (the JAX tools/train.py's)
FIX_RANDOM_SEED = 666


def default_output_dir(cfg_file, extra_tag="default"):
    """The JAX tools' output directory for the --cfg_file string:
    output/<EXP_GROUP_PATH>/<TAG>/<extra_tag> under the repository, where
    EXP_GROUP_PATH is the string's folders after the first and TAG its file
    name's stem (config.cfg_from_yaml_file sets both alike)."""
    cfg_file = str(cfg_file)
    return (ROOT / "output" / "/".join(cfg_file.split("/")[1:-1]) / Path(cfg_file).stem
            / extra_tag)


def peak_memory(dev):
    return (f", peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "")


def train_on_dataset(args, dev):
    """Dataset mode (see the module docstring). Returns (the checkpoint
    directory, a dict per epoch trained: `train_one_epoch`'s timings,
    mean_loss, scans_per_s, peak_gib)."""
    from .datasets import build_dataloader
    from .runtime.eval_utils import repeat_eval_ckpts
    from .runtime.metrics import MetricsWriter

    cfg = load_cfg(args.cfg_file, args.set_cfgs)
    batch = args.batch or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)
    output_dir = Path(args.output_dir or default_output_dir(args.cfg_file, args.extra_tag))
    ckpt_dir = output_dir / "ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(output_dir / f"log_train_{time.strftime('%Y%m%d-%H%M%S')}.txt")
    logger.info("training %s on %s, output %s", args.cfg_file, dev, output_dir)
    log_config_to_file(cfg, logger=logger)
    seed = args.seed
    if args.fix_random_seed:
        seed = FIX_RANDOM_SEED
        np.random.seed(FIX_RANDOM_SEED)
    train_set, train_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch, root_path=args.data_root,
        workers=args.workers, seed=seed, logger=logger, training=True,
        pin_memory=dev.type == "cuda")
    train_loader.start()   # the workers start while the kernels and the model are built
    if dev.type == "cuda":
        logger.info("kernels built in %.1f s", _kernels.build_all())
    steps = len(train_loader)
    if steps == 0:
        raise ValueError(f"the train split holds {len(train_set)} samples: no full "
                         f"batch of {batch}")
    _, model, opt = build_trainer(args.cfg_file, dev, args.seed, total_steps=steps * epochs,
                                  pretrained_model=args.pretrained_model, dataset=train_set,
                                  set_cfgs=args.set_cfgs)
    start_epoch = 0
    resume_from = args.ckpt or latest_checkpoint(ckpt_dir)
    if resume_from is not None:
        start_epoch, it = restore_checkpoint(resume_from, model, opt)
        logger.info("resumed from %s (epoch %d, step %d)", resume_from, start_epoch, it)
    timings, epochs_done = {}, []

    def report(epoch, mean_loss):
        n, rate = timings["steps"], timings["steps"] * batch / timings["seconds"]
        epochs_done.append(dict(
            timings, mean_loss=mean_loss, scans_per_s=rate,
            peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                      if dev.type == "cuda" else None)))
        print(f"epoch {epoch + 1}/{epochs}: mean loss {mean_loss:.4f}; "
              f"{rate:.3f} train scans/s on {dev} (batch {batch}, "
              f"{n} steps in {timings['seconds']:.3f} s, loader included; loader wait "
              f"{timings['loader_first_wait_s']:.4f} s for the first step, "
              f"{timings['loader_wait_s'] / max(n - 1, 1):.4f} s for each later one"
              f"{peak_memory(dev)})")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    with MetricsWriter(output_dir) as writer:
        with closing(train_loader):   # its workers stop before the eval's start
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            train_model(model, opt, train_loader, ckpt_dir, epochs, start_epoch=start_epoch,
                        log=logger.info, max_ckpt_save_num=args.max_ckpt_save_num,
                        ckpt_save_interval=args.ckpt_save_interval,
                        device=dev, metrics_writer=writer, timings=timings,
                        on_epoch_end=report)
        if args.num_epochs_to_eval > 0:
            test_set, test_loader, _ = build_dataloader(
                cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch, root_path=args.data_root,
                workers=args.workers, logger=logger, training=False,
                pin_memory=dev.type == "cuda")
            eval_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), test_set, device=dev,
                                       seed=args.seed)
            with closing(test_loader):
                repeat_eval_ckpts(eval_model, test_loader, test_set, cfg, ckpt_dir,
                                  output_dir / "eval" / "eval_with_train", logger,
                                  args.num_epochs_to_eval, metrics_writer=writer)
    train_set.clean_shared_memory()
    return ckpt_dir, epochs_done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg_file", default=str(ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"))
    ap.add_argument("--batch", "--batch_size", dest="batch", type=int, default=None,
                    help="synthetic mode: 16; dataset mode: the config's BATCH_SIZE_PER_GPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pretrained_model", default=None,
                    help="a checkpoint of this entry point (the teacher's, for a "
                         "distillation config) to start from")
    ap.add_argument("--set", dest="set_cfgs", nargs="+", default=None, metavar="KEY VALUE",
                    help="config overrides, key value pairs")
    synth = ap.add_argument_group("synthetic-scan mode")
    synth.add_argument("--points", type=int, default=None, help="default 16384")
    synth.add_argument("--steps", type=int, default=None, help="default 3")
    synth.add_argument("--ckpt_dir", default=None)
    synth.add_argument("--profile", action="store_true")
    data = ap.add_argument_group("dataset mode")
    data.add_argument("--dataset", action="store_true",
                      help="train on the config's DATA_PATH")
    data.add_argument("--data_root", default=None,
                      help="train on this dataset root (the config's dataset)")
    data.add_argument("--epochs", type=int, default=None)
    data.add_argument("--workers", type=int, default=4)
    data.add_argument("--ckpt_save_interval", type=int, default=1)
    data.add_argument("--max_ckpt_save_num", type=int, default=30)
    data.add_argument("--num_epochs_to_eval", type=int, default=0)
    data.add_argument("--ckpt", default=None,
                      help="resume from this checkpoint, else from the newest one")
    data.add_argument("--extra_tag", default="default")
    data.add_argument("--fix_random_seed", action="store_true",
                      help=f"seed {FIX_RANDOM_SEED} in place of --seed")
    data.add_argument("--output_dir", default=None,
                      help="default output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>")
    args = ap.parse_args(argv)

    if args.dataset or args.data_root is not None:
        for flag in ("points", "steps", "ckpt_dir"):
            if getattr(args, flag) is not None:
                ap.error(f"--{flag} belongs to the synthetic-scan mode")
        if args.profile:
            ap.error("--profile belongs to the synthetic-scan mode")
        return train_on_dataset(args, resolve_device(args.device))
    args.batch = args.batch or 16
    args.points = args.points or 16384
    args.steps = 3 if args.steps is None else args.steps
    dev = resolve_device(args.device)
    total = args.steps + 1 + int(args.profile)
    cfg, model, opt = build_trainer(args.cfg_file, dev, args.seed, args.points, total,
                                    args.pretrained_model, set_cfgs=args.set_cfgs)
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
    print(f"{args.batch * args.steps / dt:.3f} train scans/s on {dev} "
          f"(batch {args.batch} x {args.points} points, {args.steps} steps, "
          f"{1e3 * dt / max(args.steps, 1):.1f} ms/step{peak_memory(dev)})")
    if args.ckpt_dir:
        print(f"checkpoint: {save_checkpoint(model, opt, args.ckpt_dir, 1, opt.state['count'])}")
    if args.profile:
        if dev.type != "cuda":
            raise RuntimeError("--profile measures the card: run with --device cuda")
        profile_call(lambda: train_step(model, opt, batches[-1]))


if __name__ == "__main__":
    main()
