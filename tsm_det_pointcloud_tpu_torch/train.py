"""Training entry point: the fast_cpc distillation step, the TSM teacher's
step or the step of another detector of the KITTI zoo (SECOND, PointPillars,
CenterPoint, Part-A2, PV-RCNN, PV-RCNN++, PointRCNN, Voxel R-CNN,
SECONDNetIoU, CaDDN, PVSSDA, DSASNet) or of the CenterPoints of nuScenes, Lyft and PandaSet,
on synthetic scans or on a dataset (KITTI, Waymo, nuScenes, Lyft or
PandaSet; CaDDN, a camera detector, on synthetic camera batches alone).

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
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/PartA2.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/pvrcnn.yaml --batch 2 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/kitti_models/pv_rcnn_plusplus.yaml --batch 2 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.train \
        --cfg_file tools/cfgs/kitti_models/voxel_rcnn_car.yaml --batch 2 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.train \
        --cfg_file tools/cfgs/kitti_models/second_iou.yaml --batch 4 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.train \
        --cfg_file tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml \
        --batch 4 --points 300000
    python -m tsm_det_pointcloud_tpu_torch.train \
        --cfg_file tools/cfgs/kitti_models/CaDDN.yaml --batch 2
    python -m tsm_det_pointcloud_tpu_torch.train \
        --cfg_file tools/cfgs/kitti_models/dsasnet.yaml --batch 2 --points 20000
    python -m tsm_det_pointcloud_tpu_torch.train \
        --cfg_file tools/cfgs/nuscenes_models/cbgs_pp_multihead.yaml --batch 4 \
        --points 300000
    python -m tsm_det_pointcloud_tpu_torch.train --variant pillar_options --batch 4 \
        --points 20000 [--set OPTIMIZATION.OPTIMIZER sgd]
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
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/lyft_models/centerpoint_voxel01_res3d.yaml --data_root DIR
    python -m tsm_det_pointcloud_tpu_torch.train \\
        --cfg_file tools/cfgs/pandaset_models/centerpoint.yaml --data_root DIR
Multi-process (dataset mode only; the synthetic-scan mode runs in one
process), as the JAX tools/train.py --launcher:
    torchrun --nproc_per_node N -m tsm_det_pointcloud_tpu_torch.train \
        --launcher pytorch --cfg_file CFG --data_root DIR [--point_axis P]
    srun ... python -m tsm_det_pointcloud_tpu_torch.train --launcher slurm ...
The two modes are chosen by these flags; neither falls back to the other.
--variant NAME (both modes) takes a variant of a shipped config
(`infer.variant_cfg`: pillar_options, teacher3, pointrcnn_pool_last, neck, or
a DSASNet hybrid) in place of --cfg_file.
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
optimizer is the config's: adam_onecycle, or adam / sgd, whose step-decay
epochs count the loader's steps in dataset mode (1000 steps an epoch in the
synthetic mode, the JAX build_optimizer's default).

Synthetic-scan mode runs one warm-up step (which builds the kernels) plus
--steps timed steps (`runtime.train_loop.train_one_epoch`, which reads the
loss on the host at the first and the last of them), each on its own
synthetic scan batch with one class-1 box (a car) around each of the scan's
eight point clusters (KITTI-range configs) or one vehicle box around each of
its sixteen (Waymo and nuScenes configs; a nuScenes box also has a
velocity, and its classes cycle through the config's ten, so that every
head group has targets). A camera config's batches also carry
`infer.synth_camera`'s images and projection and the boxes' 2D extents in
the image (`infer.boxes_to_image`) as gt_boxes2d. Prints the losses, the train scans/s over the
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

With --launcher pytorch (or jax, its synonym) or slurm each process joins
the process group (`parallel.comm.init_distributed`: cuda:LOCAL_RANK and
NCCL on the card, gloo with --device cpu), loads its rank-strided shard of
the train split and steps DDP (`parallel.train_state.wrap_data_parallel`);
--batch is one process's batch, so a step takes world x --batch scans. The
BN statistics, the class statistics and the losses' normalizers are the
global batch's (parallel/comm.py), so the step is the JAX data mesh's. Rank
0 alone logs, writes metrics and checkpoints. --point_axis P (or the
config's PARALLEL.POINT_AXIS) groups P consecutive ranks on each sample and
splits each scan's points over them (`parallel.point_sharding`; the world
size must be a multiple of P, and the scans' points of P; a TSM config's
only, whose backbone's layer 0 is what it splits).
"""
from __future__ import annotations

import argparse
import os
import time
from contextlib import closing, nullcontext
from pathlib import Path

import numpy as np
import torch

from .config import log_config_to_file
from .config import cfg_from_list
from .infer import (HYBRID_VARIANTS, KITTI_RANGE, OPTION_VARIANTS, ROOT, boxes_to_image,
                    dataset_meta, load_cfg, profile_call, refuse_camera_data, scan_recipe,
                    seed_statistics, synth_camera, synth_scene, uses_images, variant_cfg)
from .models import build_network
from .ops import _kernels
from .parallel import comm, point_sharding
from .parallel.train_state import wrap_data_parallel
from .runtime.checkpoint import (latest_checkpoint, load_model_state, partial_load,
                                 restore_checkpoint, save_checkpoint, transfer_statistics)
from .runtime.optimization import build_optimizer
from .runtime.train_loop import train_model, train_one_epoch
from .runtime.train_state import freeze_teacher, is_distillation, train_step
from .utils.common_utils import create_logger, resolve_device


def synth_train_batch(batch, n, seed=0, device="cpu", point_cloud_range=KITTI_RANGE,
                      n_features=4, velocity=False, n_classes=1):
    """Synthetic scans (infer.synth_scene: by default the KITTI range's
    (B, n, 4) with 8 clusters; the Waymo and nuScenes ranges' have 16) plus
    gt_boxes with the recipe's box, heading 0, around each cluster, and
    masks, as device tensors. The boxes' classes cycle through 1..n_classes
    (by default all class 1). With `velocity` the boxes carry a velocity
    (vx, vy), each component uniform in [-5, 5) m/s from the seed, before the
    class: (B, n_box, 10)."""
    pts, centres = synth_scene(batch, n, seed, point_cloud_range, n_features)
    n_box = centres.shape[1]
    gt = np.zeros((batch, n_box, 10 if velocity else 8), np.float32)
    gt[..., 0:2] = centres
    gt[..., 2:6] = scan_recipe(point_cloud_range).box
    if velocity:
        gt[..., 7:9] = np.random.RandomState(seed).uniform(-5, 5, (batch, n_box, 2))
    gt[..., -1] = 1 + np.arange(n_box) % n_classes
    dev = torch.device(device)
    return {"points": torch.from_numpy(pts).to(dev),
            "points_mask": torch.ones((batch, n), dtype=torch.bool, device=dev),
            "batch_size": batch,
            "gt_boxes": torch.from_numpy(gt).to(dev),
            "gt_boxes_mask": torch.ones((batch, n_box), dtype=torch.bool, device=dev)}


def add_camera(batch, seed=0):
    """A synthetic training batch (`synth_train_batch`) with camera inputs:
    `infer.synth_camera`'s images and projection and gt_boxes2d, the image
    extents of its gt boxes, on the batch's device."""
    gt = batch["gt_boxes"].cpu().numpy()
    cam = synth_camera(gt.shape[0], seed)
    cam["gt_boxes2d"] = boxes_to_image(gt, cam["trans_lidar_to_cam_img"])
    dev = batch["gt_boxes"].device
    return {**batch, **{k: torch.from_numpy(v).to(dev) for k, v in cam.items()}}


def build_trainer(cfg_file, device="cuda", seed=0, n_points=16384, total_steps=1,
                  pretrained_model=None, dataset=None, set_cfgs=None, steps_per_epoch=1000):
    """(cfg, model in train mode, optimizer over the parameters that train:
    the student's for a distillation config, else all of them); `cfg_file`
    may be a loaded config.
    pretrained_model: a checkpoint file whose weights and class statistics
    are loaded first (as the JAX tools/train.py:161-171 does). dataset: the
    training dataset whose geometry the model takes, else the config's
    (`infer.dataset_meta` at n_points). set_cfgs: `--set` overrides of the
    config file (a loaded config takes none: it is not copied).
    steps_per_epoch: the epoch length adam / sgd count DECAY_STEP_LIST in
    (the loader's in dataset mode; the JAX build_optimizer's default,
    1000, else)."""
    if isinstance(cfg_file, dict):
        if set_cfgs:
            raise ValueError("set_cfgs apply to a config file, not to a loaded config")
        cfg = cfg_file
    else:
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
    opt = build_optimizer(cfg.OPTIMIZATION, params, total_steps, steps_per_epoch)
    return cfg, model.train(), opt


def predicts_velocity(model):
    """Whether the model's CenterHead has a velocity branch (its training
    batches then need 10-column gt boxes)."""
    return any(getattr(m, "code_size", 8) > 8 for m in model.modules())


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

    cfg = run_cfg(args)
    refuse_camera_data(cfg, "train --data_root")
    batch = args.batch or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)
    # a variant's runs go to output/cfgs/variants/<name>/<extra_tag>
    cfg_name = f"tools/cfgs/variants/{args.variant}.yaml" if args.variant else args.cfg_file
    output_dir = Path(args.output_dir or default_output_dir(cfg_name, args.extra_tag))
    ckpt_dir = output_dir / "ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    rank, main_rank = comm.get_rank(), comm.is_main()
    logger = create_logger(
        output_dir / f"log_train_{time.strftime('%Y%m%d-%H%M%S')}.txt" if main_rank else None,
        rank=rank)
    logger.info("training %s on %s, output %s",
                f"the variant {args.variant}" if args.variant else args.cfg_file, dev, output_dir)
    psh, num_shards, shard_id = shard_plan(args, cfg, dev)
    logger.info("%d process(es), %d data shard(s)%s; batch %d a process", comm.get_world_size(),
                num_shards, f", points over {psh.size}" if psh else "", batch)
    log_config_to_file(cfg, logger=logger)
    seed = args.seed
    if args.fix_random_seed:
        seed = FIX_RANDOM_SEED
        np.random.seed(FIX_RANDOM_SEED)
    train_set, train_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch, root_path=args.data_root,
        workers=args.workers, seed=seed, logger=logger, training=True,
        pin_memory=dev.type == "cuda", num_shards=num_shards, shard_id=shard_id)
    train_loader.start()   # the workers start while the kernels and the model are built
    if dev.type == "cuda":
        logger.info("kernels built in %.1f s", _kernels.build_all())
    steps = len(train_loader)
    if steps == 0:
        raise ValueError(f"the train split holds {len(train_set)} samples: no full "
                         f"batch of {batch}")
    _, model, opt = build_trainer(cfg, dev, args.seed, total_steps=steps * epochs,
                                  pretrained_model=args.pretrained_model, dataset=train_set,
                                  steps_per_epoch=steps)
    stepper = wrap_data_parallel(model, dev)
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
        if main_rank:
            print(f"epoch {epoch + 1}/{epochs}: mean loss {mean_loss:.4f}; "
                  f"{rate:.3f} train scans/s on {dev} (batch {batch}, "
                  f"{n} steps in {timings['seconds']:.3f} s, loader included; loader "
                  f"wait {timings['loader_first_wait_s']:.4f} s for the first step, "
                  f"{timings['loader_wait_s'] / max(n - 1, 1):.4f} s for each later one"
                  f"{peak_memory(dev)})")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    pax_ctx = point_sharding.activate(psh) if psh is not None else nullcontext()
    with (MetricsWriter(output_dir) if main_rank else nullcontext()) as writer, pax_ctx:
        with closing(train_loader):   # its workers stop before the eval's start
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            train_model(stepper, opt, train_loader, ckpt_dir, epochs, start_epoch=start_epoch,
                        log=logger.info if main_rank else None,
                        max_ckpt_save_num=args.max_ckpt_save_num,
                        ckpt_save_interval=args.ckpt_save_interval,
                        device=dev, metrics_writer=writer, timings=timings,
                        on_epoch_end=report)
        if args.num_epochs_to_eval > 0:
            test_set, test_loader, _ = build_dataloader(
                cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch, root_path=args.data_root,
                workers=args.workers, logger=logger, training=False,
                pin_memory=dev.type == "cuda", num_shards=num_shards, shard_id=shard_id)
            eval_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), test_set, device=dev,
                                       seed=args.seed)
            with closing(test_loader):
                repeat_eval_ckpts(eval_model, test_loader, test_set, cfg, ckpt_dir,
                                  output_dir / "eval" / "eval_with_train", logger,
                                  args.num_epochs_to_eval, metrics_writer=writer)
    comm.barrier()   # no rank reads the shared frames any more
    train_set.clean_shared_memory()
    return ckpt_dir, epochs_done


def run_cfg(args):
    """The config of the run: --variant's (`infer.variant_cfg`), else
    --cfg_file's, then the --set overrides."""
    if args.variant is None:
        return load_cfg(args.cfg_file, args.set_cfgs)
    cfg = variant_cfg(args.variant)
    if args.set_cfgs:
        cfg_from_list(list(args.set_cfgs), cfg)
    return cfg


def shard_plan(args, cfg, dev):
    """(the point-axis context or None, the loader's shard count, this
    rank's shard): the ranks, or under --point_axis P (else the config's
    PARALLEL.POINT_AXIS) the groups of P consecutive ranks, each load one
    shard. The ranks of a points group repeat everything after layer 0, where
    the JAX jit computes it once: on the card they run deterministic
    algorithms (`index_add_`'s sorted route: its float atomics would sum in
    another order on each rank), so that their BN statistics and outputs
    stay bit-equal. The split belongs to the TSM backbone's layer 0: a
    config without it (a voxel or pillar detector) raises."""
    pax = args.point_axis or int(cfg.get("PARALLEL", {}).get("POINT_AXIS", 0) or 0)
    if pax > 1 and cfg.MODEL.get("NAME") not in ("3DSSD", "Point3DSSD"):
        raise ValueError(f"--point_axis splits the points of the TSM backbone's layer 0; "
                         f"{cfg.MODEL.NAME} has no such layer: run it without --point_axis")
    if pax > 1:
        psh = point_sharding.make_point_mesh(pax, dev.type)
        if dev.type == "cuda":
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            torch.use_deterministic_algorithms(True)
        return psh, psh.n_data, psh.data_index
    return None, comm.get_world_size(), comm.get_rank()


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
    ap.add_argument("--variant", default=None,
                    choices=OPTION_VARIANTS + ("neck",) + tuple(HYBRID_VARIANTS),
                    help="a variant of a shipped config (`infer.variant_cfg`) in place of "
                         "--cfg_file")
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
    data.add_argument("--launcher", choices=comm.LAUNCHERS, default="none",
                      help="pytorch (or jax): torchrun's environment; slurm: srun's")
    data.add_argument("--point_axis", type=int, default=0,
                      help="split each scan's points over this many ranks (0: the "
                           "config's PARALLEL.POINT_AXIS, else off)")
    args = ap.parse_args(argv)

    if args.dataset or args.data_root is not None:
        for flag in ("points", "steps", "ckpt_dir"):
            if getattr(args, flag) is not None:
                ap.error(f"--{flag} belongs to the synthetic-scan mode")
        if args.profile:
            ap.error("--profile belongs to the synthetic-scan mode")
        dev = comm.init_distributed(args.launcher, args.device)
        try:
            return train_on_dataset(args, dev)
        finally:
            comm.shutdown()
    if args.launcher != "none" or args.point_axis:
        ap.error("--launcher and --point_axis belong to the dataset mode")
    args.batch = args.batch or 16
    args.points = args.points or 16384
    args.steps = 3 if args.steps is None else args.steps
    dev = resolve_device(args.device)
    total = args.steps + 1 + int(args.profile)
    cfg, model, opt = build_trainer(run_cfg(args), dev, args.seed, args.points, total,
                                    args.pretrained_model)
    meta = model.dataset_meta
    velocity = predicts_velocity(model)
    batches = [synth_train_batch(args.batch, args.points, args.seed + i, dev,
                                 meta.point_cloud_range, meta.num_point_features, velocity,
                                 len(cfg.CLASS_NAMES) if velocity else 1)
               for i in range(total)]
    if uses_images(cfg.MODEL):
        batches = [add_camera(b, args.seed + i) for i, b in enumerate(batches)]
    t0 = time.perf_counter()
    loss, _ = train_step(model, opt, batches[0])  # warm-up: builds the kernels
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"warm-up step: loss {float(loss):.4f}, {time.perf_counter() - t0:.3f} s (the "
          f"kernels' and cuDNN's first calls)")
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
