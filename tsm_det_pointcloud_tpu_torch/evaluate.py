"""Dataset eval entry point (counterpart of the JAX tools/test.py):

    python -m tsm_det_pointcloud_tpu_torch.evaluate \\
        --cfg_file tools/cfgs/kitti_models/fast_cpc.yaml [--ckpt CKPT] \\
        [--data_root DIR] [--batch_size 16] [--workers 4] [--save_to_file] \\
        [--eval_all [--max_waiting_mins 30]] [--extra_tag default] \\
        [--eval_tag default] [--output_dir DIR] [--device cuda] [--set KEY VALUE ...]
    python -m tsm_det_pointcloud_tpu_torch.evaluate \\
        --cfg_file tools/cfgs/waymo_models/waymo_fast_cpc.yaml --data_root DIR

Builds the config's test-split loader (the dataset at --data_root, else the
config's DATA_PATH: a KITTI or a Waymo root) and the detector on it, loads
--ckpt (else the newest checkpoint under <output_dir>/ckpt; with none, the
seeded random init, with a warning), builds the kernels on the card while
the loader's workers start, and runs `runtime.eval_utils.eval_one_ckpt`: the
eval forward and post-processing per batch, the prediction dicts (KITTI:
written as label files with --save_to_file), result.pkl and the dataset's
eval (the official KITTI eval, or the Waymo metric), all under
<output_dir>/eval/<eval_tag>, whose metrics.jsonl gets the result dict and
whose log file the config and the eval's table. <output_dir> is the JAX
tools/test.py's, output/<EXP_GROUP_PATH>/<TAG>/<extra_tag> under the
repository (`train.default_output_dir`), unless --output_dir names
another. Prints the APs (KITTI: 3D R40; Waymo: AP and APH at
L1 and L2), sec_per_example, the loop's scans/s (loader included) and its
wait on the loader a batch. `--set` overrides config keys
(`config.cfg_from_list`). --eval_all instead watches <output_dir>/ckpt and
evaluates each new checkpoint, until none has come for --max_waiting_mins.
The device is the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import re
import time
from contextlib import closing
from pathlib import Path

from .config import log_config_to_file
from .datasets import build_dataloader
from .infer import ROOT, load_cfg
from .models import build_network
from .ops import _kernels
from .runtime.checkpoint import latest_checkpoint, restore_checkpoint
from .runtime.eval_utils import eval_one_ckpt
from .runtime.metrics import MetricsWriter
from .train import default_output_dir
from .utils.common_utils import create_logger, resolve_device


def ap_line(res, class_names):
    """The result dict's headline APs: KITTI's 3D R40 easy / moderate /
    hard a class, else (Waymo) every AP and APH entry."""
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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_cfg(args.cfg_file, args.set_cfgs)
    batch = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    output_dir = Path(args.output_dir or default_output_dir(args.cfg_file, args.extra_tag))
    eval_dir = output_dir / "eval" / args.eval_tag
    eval_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(eval_dir / f"log_eval_{time.strftime('%Y%m%d-%H%M%S')}.txt")
    log_config_to_file(cfg, logger=logger)
    test_set, test_loader, _ = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch, root_path=args.data_root,
        workers=args.workers, logger=logger, training=False, pin_memory=dev.type == "cuda")
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
        print(ap_line(res, cfg.CLASS_NAMES))
        print(f"{res['scans_per_s']:.3f} scans/s on {dev} (batch {batch}, {len(test_set)} "
              f"scans, loader included); sec_per_example {res['sec_per_example']:.4f}; "
              f"loader wait {res['loader_first_wait_s']:.4f} s for the first batch, "
              f"{res['loader_wait_s']:.4f} s for each later one")
        return res

    with MetricsWriter(eval_dir) as writer, closing(test_loader):
        if not args.eval_all:
            return load_and_eval(args.ckpt or latest_checkpoint(output_dir / "ckpt"))
        # watch the checkpoint directory: evaluate each new epoch, give up
        # after max_waiting_mins without one
        eval_list = eval_dir / "eval_list_val.txt"
        evaluated = set(eval_list.read_text().split() if eval_list.exists() else [])
        waited = 0.0
        while waited < args.max_waiting_mins * 60:
            latest = latest_checkpoint(output_dir / "ckpt")
            epoch = re.findall(r"checkpoint_epoch_(\d+)", latest.name)[0] if latest else None
            if latest is not None and epoch not in evaluated:
                load_and_eval(latest, epoch_id=int(epoch))
                evaluated.add(epoch)
                with open(eval_list, "a") as f:
                    f.write(epoch + "\n")
                waited = 0.0
            else:
                time.sleep(30)
                waited += 30


if __name__ == "__main__":
    main()
