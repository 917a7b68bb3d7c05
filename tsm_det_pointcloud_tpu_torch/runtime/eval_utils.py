"""Dataset evaluation (counterpart of tsm_det_pointcloud_tpu/runtime/eval_utils.py:
`eval_one_ckpt` :44, `repeat_eval_ckpts`).

Per batch: the host batch goes to the model's device, the eval forward and
post-processing run, and the batch's predictions and recall counters come
back to the host once for the whole batch (not frame by frame); the first
read waits for the card, before the batch's clock stops. The per-frame prediction dicts then go to the dataset's
`generate_prediction_dicts`; at the end `result.pkl` is written and the
dataset's official eval runs.

Clocks (host): `sec_per_example` is the batches' time from the loader's
hand-over to the predictions on the host, over the frames, as the JAX
package counts it; `loader_first_wait_s` is the loop's wait for its first
batch (the workers' start, unless `loader.start()` came earlier) and
`loader_wait_s` its mean wait for each later one; `scans_per_s` is the
frames over the whole loop, loader included, official eval excluded.

In a multi-process run each rank evaluates its shard of a rank-strided
loader (under point-axis sharding, each group of `--point_axis` ranks one
shard); rank 0 merges the prediction dicts into dataset order
(`comm.merge_results_dist`), sums the recall counters
(`comm.reduce_dict(average=False)`) and alone writes result.pkl and runs
the dataset's eval, as the JAX runtime/eval_utils.py:98-103 does; the other
ranks return {}. `sec_per_example` is rank 0's batch time over the merged
frames, `scans_per_s` the merged frames over rank 0's loop.
"""
from __future__ import annotations

import json
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..datasets import load_data_to_device
from ..parallel import comm, point_sharding


def eval_one_ckpt(model, loader, dataset, cfg, logger, result_dir, save_to_file=False,
                  metrics_writer=None, epoch_id=None):
    """Evaluate `model` (its weights as they are) over `loader`; returns the
    official eval's result dict with `sec_per_example`,
    `loader_first_wait_s`, `loader_wait_s` and `scans_per_s` added."""
    dev = next(model.parameters()).device
    model.eval()
    class_names = list(cfg.CLASS_NAMES)
    det_annos = []
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)

    total_time, n_frames, waits = 0.0, 0, []
    recall_acc = {}
    t_start = t_end = time.perf_counter()
    for batch in loader:
        t0 = time.perf_counter()
        waits.append(t0 - t_end)
        bsz = int(batch["batch_size"])
        psh = point_sharding.active()
        if psh is not None:
            batch = point_sharding.shard_batch(batch, psh)
        with torch.no_grad():
            out = model(load_data_to_device(batch, dev))
            pred, recall = model.post_processing(out)
        pred = {k: v.cpu().numpy() for k, v in pred.items()}
        keys = sorted(recall)
        recall = (dict(zip(keys, torch.stack([recall[k] for k in keys]).cpu().tolist()))
                  if keys else {})
        total_time += time.perf_counter() - t0
        n_frames += bsz
        for k, v in recall.items():
            recall_acc[k] = recall_acc.get(k, 0.0) + v

        pred_dicts = []
        for b in range(bsz):
            cnt = int(pred["count"][b])
            pred_dicts.append({
                "pred_boxes": pred["pred_boxes"][b][:cnt],
                "pred_scores": pred["pred_scores"][b][:cnt],
                "pred_labels": pred["pred_labels"][b][:cnt],
            })
        det_annos += dataset.generate_prediction_dicts(
            batch, pred_dicts, class_names,
            output_path=result_dir if save_to_file else None)
        t_end = time.perf_counter()
    loop_s = time.perf_counter() - t_start
    if comm.get_world_size() > 1:
        psh = point_sharding.active()
        pax = psh.size if psh is not None else 1
        det_annos = comm.merge_results_dist(det_annos, len(dataset), replicas=pax)
        recall_acc = {k: v / pax for k, v in
                      comm.reduce_dict(recall_acc, average=False).items()}
        n_frames = len(det_annos)
        if not comm.is_main():
            return {}

    sec_per_example = total_time / max(n_frames, 1)
    first_wait = waits[0] if waits else 0.0
    wait = sum(waits[1:]) / max(len(waits) - 1, 1)
    logger.info("Generate label finished(sec_per_example: %.4f second).", sec_per_example)
    logger.info("%d scans in %.3f s, loader included: %.3f scans/s; loader wait %.4f s for "
                "the first batch, %.4f s for each later one", n_frames, loop_s,
                n_frames / max(loop_s, 1e-9), first_wait, wait)
    gt_num = max(recall_acc.get("gt", 0.0), 1.0)
    for k in sorted(recall_acc):
        if k != "gt":
            logger.info("recall_%s: %f", k, recall_acc[k] / gt_num)

    with open(result_dir / "result.pkl", "wb") as f:
        pickle.dump(det_annos, f)

    result_str, result_dict = dataset.evaluation(det_annos, class_names)
    logger.info(result_str)
    result_dict["sec_per_example"] = sec_per_example
    result_dict["loader_first_wait_s"] = first_wait
    result_dict["loader_wait_s"] = wait
    result_dict["scans_per_s"] = n_frames / max(loop_s, 1e-9)
    if metrics_writer is not None and epoch_id is not None:
        metrics_writer.write(int(epoch_id), result_dict, prefix="eval/")
    return result_dict


def repeat_eval_ckpts(model, loader, dataset, cfg, ckpt_dir, eval_root, logger,
                      num_epochs_to_eval, metrics_writer=None):
    """Evaluate the last `num_epochs_to_eval` checkpoints of a run, each
    loaded into `model`; writes eval_root/epoch_<E>/val/eval_summary.json
    (rank 0).
    Returns {epoch: result dict}."""
    from .checkpoint import _checkpoints, _epoch_of, restore_checkpoint

    found = _checkpoints(ckpt_dir)
    found = found[-num_epochs_to_eval:] if num_epochs_to_eval > 0 else []
    results = {}
    for ckpt in found:
        epoch = _epoch_of(ckpt)
        restore_checkpoint(ckpt, model)
        edir = Path(eval_root) / ("epoch_%d" % epoch) / "val"
        logger.info("*** In-train eval: epoch %d (%s) ***", epoch, ckpt)
        res = eval_one_ckpt(model, loader, dataset, cfg, logger, edir,
                            metrics_writer=metrics_writer, epoch_id=epoch)
        if comm.is_main():
            with open(edir / "eval_summary.json", "w") as f:
                json.dump({k: float(v) for k, v in res.items()
                           if isinstance(v, (int, float, np.floating))}, f, indent=1)
        results[epoch] = res
    return results
