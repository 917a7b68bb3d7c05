"""Detect on raw scans (the counterpart of the JAX package's tools/demo.py):

    python -m tsm_det_pointcloud_tpu_torch.demo --cfg_file CFG --data_path PATH \\
        [--ckpt CKPT] [--ext .bin|.npy] [--device cuda]

PATH is a scan file or a directory of them (globbed by --ext and sorted):
`.bin` files of float32 (x, y, z, intensity), `.npy` arrays of the config's
point features. Each scan goes through the config's test-mode data
processing (`DatasetTemplate.prepare_data`: range mask, sample_points, ...;
no field-of-view crop, there is no calibration) and is collated alone. The
detector is built with `build_network` on that geometry, with seeded random
weights unless --ckpt names a checkpoint of this package (from `train`, or
from a reference checkpoint by `convert_torch_ckpt`). Each scan's eval
forward and post-processing run on the device, and the detections are
logged as text, a line a scan and a line a detection (open3d and mayavi
are not installed). The device is the card unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import glob
import time
from pathlib import Path

import numpy as np
import torch

from .datasets import load_data_to_device, to_torch_batch
from .datasets.dataset import DatasetTemplate
from .infer import ROOT, detect, load_cfg
from .models import build_network
from .ops import _kernels
from .runtime.checkpoint import restore_checkpoint
from .utils.common_utils import create_logger, resolve_device


class DemoDataset(DatasetTemplate):
    """Raw scan files in test mode; `collate(sample)` batches one scan."""

    def __init__(self, dataset_cfg, class_names, root_path, ext=".bin", logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=False,
                         root_path=Path(root_path), logger=logger)
        self.ext = ext
        if self.root_path.is_dir():
            self.sample_file_list = sorted(glob.glob(str(self.root_path / f"*{ext}")))
        else:
            self.sample_file_list = [str(root_path)]

    def __len__(self):
        return len(self.sample_file_list)

    def __getitem__(self, index):
        f = self.sample_file_list[index]
        if self.ext == ".bin":
            points = np.fromfile(f, dtype=np.float32).reshape(-1, 4)
        elif self.ext == ".npy":
            points = np.load(f)
        else:
            raise NotImplementedError(self.ext)
        return self.prepare_data(data_dict={"points": points, "frame_id": index})

    def collate(self, sample):
        return self.collate_batch([sample])


def run_demo(model, dataset, logger):
    """Each scan of `dataset` through the model and post-processing; logs
    its detections and returns, a scan each, {pred_boxes, pred_scores,
    pred_labels} as numpy arrays of its detections."""
    dev = next(model.parameters()).device
    preds = []
    for idx in range(len(dataset)):
        batch = load_data_to_device(to_torch_batch(dataset.collate(dataset[idx])), dev)
        _, pred = detect(model, batch["points"], batch["points_mask"])
        cnt = int(pred["count"][0])
        pred = {k: pred[k][0, :cnt].cpu().numpy()
                for k in ("pred_boxes", "pred_scores", "pred_labels")}
        logger.info("Sample %d: %d detections", idx, cnt)
        for box, score, label in zip(pred["pred_boxes"], pred["pred_scores"],
                                     pred["pred_labels"]):
            logger.info("  label=%d score=%.3f box=[% .2f % .2f % .2f % .2f % .2f % .2f % .2f]",
                        int(label), float(score), *[float(x) for x in box])
        preds.append(pred)
    return preds


def main(argv=None):
    """Returns (run_demo's detections, the scans/s of its loop)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg_file", default=str(ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"))
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ext", default=".bin")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_cfg(args.cfg_file)
    logger = create_logger()
    logger.info("-----------------Demo of tsm_det_pointcloud_tpu_torch-----------------")
    dataset = DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, args.data_path, args.ext, logger)
    logger.info("Total number of samples: \t%d", len(dataset))
    if dev.type == "cuda":
        logger.info("kernels built in %.1f s", _kernels.build_all())
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device=dev)
    # the JAX demo collates the first scan once more for its init: so does
    # this one, so that the dataset's generator (sample_points' draw) runs
    # the same stream
    first = dataset.collate(dataset[0])
    logger.info("Scan 0 collated to %s", first["points"].shape)
    if args.ckpt:
        restore_checkpoint(args.ckpt, model)
        logger.info("Loaded checkpoint %s", args.ckpt)
    else:
        logger.warning("No checkpoint given: detecting with the seeded random weights")
    t0 = time.perf_counter()
    preds = run_demo(model, dataset, logger)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    logger.info("Demo done: %d scans in %.3f s (%.3f scans/s, loading included)",
                len(dataset), dt, len(dataset) / dt)
    return preds, len(dataset) / dt


if __name__ == "__main__":
    main()
