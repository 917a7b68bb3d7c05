"""Dataset eval entry point (counterpart of the JAX tools/test.py):

    python -m tsm_det_pointcloud_tpu_torch.evaluate \\
        --cfg_file tools/cfgs/kitti_models/fast_cpc.yaml [--ckpt CKPT] \\
        [--data_root DIR] [--batch_size 16] [--workers 4] [--save_to_file] \\
        [--eval_all [--max_waiting_mins 30]] [--extra_tag default] \\
        [--eval_tag default] [--output_dir DIR] [--device cuda] [--set KEY VALUE ...]
    python -m tsm_det_pointcloud_tpu_torch.evaluate \\
        --cfg_file tools/cfgs/waymo_models/waymo_fast_cpc.yaml --data_root DIR
    python -m tsm_det_pointcloud_tpu_torch.evaluate \\
        --cfg_file tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml \\
        --data_root DIR
    python -m tsm_det_pointcloud_tpu_torch.evaluate \\
        --cfg_file tools/cfgs/lyft_models/centerpoint_voxel01_res3d.yaml --data_root DIR
    python -m tsm_det_pointcloud_tpu_torch.evaluate \\
        --cfg_file tools/cfgs/pandaset_models/centerpoint.yaml --data_root DIR

Builds the config's test-split loader (the dataset at --data_root, else the
config's DATA_PATH: a KITTI, a Waymo, a nuScenes, a Lyft or a PandaSet root) and the
detector on it, loads
--ckpt (else the newest checkpoint under <output_dir>/ckpt; with none, the
seeded random init, with a warning), builds the kernels on the card while
the loader's workers start, and runs `runtime.eval_utils.eval_one_ckpt`: the
eval forward and post-processing per batch, the prediction dicts (KITTI:
written as label files with --save_to_file), result.pkl and the dataset's
eval (the official KITTI eval, the Waymo metric, nuScenes' NDS or the Lyft
mAP; PandaSet has no official one and returns an empty result), all under
<output_dir>/eval/<eval_tag>, whose metrics.jsonl gets the result dict and
whose log file the config and the eval's table. <output_dir> is the JAX
tools/test.py's, output/<EXP_GROUP_PATH>/<TAG>/<extra_tag> under the
repository (`train.default_output_dir`), unless --output_dir names
another. Prints the APs (KITTI: 3D R40; Waymo: AP and APH at
L1 and L2; nuScenes: NDS, mAP and the five TP errors; Lyft: the mAP and
each class's AP), sec_per_example, the loop's scans/s (loader included) and its
wait on the loader a batch. `--set` overrides config keys
(`config.cfg_from_list`). --eval_all instead watches <output_dir>/ckpt and
evaluates each new checkpoint, until none has come for --max_waiting_mins.
The device is the card unless --device cpu is given.

Multi-process, as the JAX tools/test.py --launcher:
    torchrun --nproc_per_node N -m tsm_det_pointcloud_tpu_torch.evaluate \
        --launcher pytorch --cfg_file CFG --data_root DIR [--point_axis P]
Each rank evaluates its rank-strided shard of the test split (--batch_size a
process); rank 0 merges the predictions and the recall counters, writes
result.pkl and runs the dataset's eval (`runtime.eval_utils`), and with
--eval_all picks the checkpoints for every rank. --point_axis P (or the
config's PARALLEL.POINT_AXIS) splits each scan's points over P consecutive
ranks, which share a shard (`parallel.point_sharding`).
"""
from __future__ import annotations

import argparse
import re
import time
from contextlib import closing, nullcontext
from pathlib import Path

from .config import log_config_to_file
from .datasets import build_dataloader
from .infer import ROOT, load_cfg, refuse_camera_data
from .models import build_network
from .ops import _kernels
from .parallel import comm, point_sharding
from .runtime.checkpoint import latest_checkpoint, restore_checkpoint
from .runtime.eval_utils import eval_one_ckpt
from .runtime.metrics import MetricsWriter
from .train import default_output_dir, shard_plan
from .utils.common_utils import create_logger


def ap_line(res, class_names):
    """The result dict's headline APs: KITTI's 3D R40 easy / moderate /
    hard a class, nuScenes' NDS, mAP and mean TP errors, Lyft's mAP and
    its AP a class, else (Waymo) every AP and APH entry; PandaSet's
    evaluation has no metric to give."""
    if "NDS" in res:
        return "; ".join(f"{k} {float(res[k]):.4f}" for k in (
            "NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE"))
    if "mAP" in res and all(c in res for c in class_names):
        return f"Lyft mAP {float(res['mAP']):.4f}; AP over the IoUs: " + "; ".join(
            f"{c} {float(res[c]):.4f}" for c in class_names)
    if not any("/AP" in k or "_R40" in k for k in res):
        return "no detection metric: the dataset has no official one (PandaSet)"
    if all(f"{c}_3d/moderate_R40" in res for c in class_names):
        return "AP (3d, R40) easy / moderate / hard: " + "; ".join(
            f"{c} " + " / ".join(f"{float(res[f'{c}_3d/{d}_R40']):.4f}"
                                 for d in ("easy", "moderate", "hard"))
            for c in class_names)
    return "AP: " + "; ".join(f"{k} {float(v):.4f}" for k, v in sorted(res.items())
                              if "/AP" in k)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg_file", default=str(ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"))
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--batch_size", type=int, default=None,
                    help="default: the config's BATCH_SIZE_PER_GPU")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--save_to_file", action="store_true")
    ap.add_argument("--eval_all", action="store_true")
    ap.add_argument("--max_waiting_mins", type=float, default=30)
    ap.add_argument("--extra_tag", default="default")
    ap.add_argument("--eval_tag", default="default")
    ap.add_argument("--output_dir", default=None,
                    help="default output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", dest="set_cfgs", nargs="+", default=None, metavar="KEY VALUE",
                    help="config overrides, key value pairs")
    ap.add_argument("--launcher", choices=comm.LAUNCHERS, default="none",
                    help="pytorch (or jax): torchrun's environment; slurm: srun's")
    ap.add_argument("--point_axis", type=int, default=0,
                    help="split each scan's points over this many ranks (0: the "
                         "config's PARALLEL.POINT_AXIS, else off)")
    args = ap.parse_args(argv)
    dev = comm.init_distributed(args.launcher, args.device)
    try:
        return evaluate(args, dev)
    finally:
        comm.shutdown()


def evaluate(args, dev):
    """`main`'s evaluation on `dev`, in this process's part of the group."""
    main_rank = comm.is_main()
    cfg = load_cfg(args.cfg_file, args.set_cfgs)
    refuse_camera_data(cfg, "evaluate")
    batch = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    output_dir = Path(args.output_dir or default_output_dir(args.cfg_file, args.extra_tag))
    eval_dir = output_dir / "eval" / args.eval_tag
    eval_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(
        eval_dir / f"log_eval_{time.strftime('%Y%m%d-%H%M%S')}.txt" if main_rank else None,
        rank=comm.get_rank())
    log_config_to_file(cfg, logger=logger)
    psh, num_shards, shard_id = shard_plan(args, cfg, dev)
    test_set, test_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch, root_path=args.data_root,
        workers=args.workers, logger=logger, training=False, pin_memory=dev.type == "cuda",
        num_shards=num_shards, shard_id=shard_id)
    test_loader.start()   # the workers start while the kernels and the model are built
    if dev.type == "cuda":
        logger.info("kernels built in %.1f s", _kernels.build_all())
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), test_set, device=dev)

    def load_and_eval(ckpt, epoch_id=0):
        if ckpt is not None:
            restore_checkpoint(ckpt, model)
            logger.info("loaded checkpoint %s", ckpt)
        else:
            logger.warning("no checkpoint found or given: evaluating the seeded random init")
        res = eval_one_ckpt(model, test_loader, test_set, cfg, logger, eval_dir,
                            save_to_file=args.save_to_file, metrics_writer=writer,
                            epoch_id=epoch_id)
        if not main_rank:
            return res
        print(ap_line(res, cfg.CLASS_NAMES))
        print(f"{res['scans_per_s']:.3f} scans/s on {dev} (batch {batch}, {len(test_set)} "
              f"scans, loader included); sec_per_example {res['sec_per_example']:.4f}; "
              f"loader wait {res['loader_first_wait_s']:.4f} s for the first batch, "
              f"{res['loader_wait_s']:.4f} s for each later one")
        return res

    pax_ctx = point_sharding.activate(psh) if psh is not None else nullcontext()
    with (MetricsWriter(eval_dir) if main_rank else nullcontext()) as writer, \
            closing(test_loader), pax_ctx:
        if not args.eval_all:
            return load_and_eval(args.ckpt or latest_checkpoint(output_dir / "ckpt"))
        # watch the checkpoint directory: evaluate each new epoch, give up
        # after max_waiting_mins without one
        eval_list = eval_dir / "eval_list_val.txt"
        evaluated = set(eval_list.read_text().split() if eval_list.exists() else [])
        waited = 0.0
        while waited < args.max_waiting_mins * 60:
            # rank 0's view of the directory decides for every rank
            latest = comm.all_gather_object(latest_checkpoint(output_dir / "ckpt"))[0]
            epoch = re.findall(r"checkpoint_epoch_(\d+)", latest.name)[0] if latest else None
            if latest is not None and epoch not in evaluated:
                load_and_eval(latest, epoch_id=int(epoch))
                evaluated.add(epoch)
                if main_rank:
                    with open(eval_list, "a") as f:
                        f.write(epoch + "\n")
                waited = 0.0
            else:
                time.sleep(30)
                waited += 30


if __name__ == "__main__":
    main()
