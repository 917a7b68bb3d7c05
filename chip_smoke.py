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
     (rtol 1e-4, atol 1e-4 * max|out|: f32 sums in another order, and
     K4's split-precision 3xTF32 products) — and both are timed with CUDA
     events around a host loop of launches, with the bound from the inputs.
     K4's log line also gives a second bound, its hits at the 3xTF32 rate
     (495 / 3 TFLOP/s, not in the kernels line), and its hit share of
     staged rows: the hits over the rows of the (64-row block, tap) pairs
     with at least one hit (`hits`, `staged_rows`). K2's `ms` is its launch
     alone on prepared sources, `prep_ms` beside it the PyTorch prep on the same host loop
     (grouping.tile_sources: Morton sort, gathers, tile boxes, which K2
     calls on the same sources share, so only a pass's first call on them
     pays it; and grouping.query_order) and `prep_device_ms` the prep's
     device time alone; its bound counts the pair tests of the (query, tile)
     pairs the pruning rule visited (`visits`). The phase's log line also
     gives the (query, tile) pairs there are and what every query against
     every source would take at the bound's rate: a derived figure, not a
     time, and not in the kernels line. K3 and torch.searchsorted are also
     traced with torch.profiler: `device_ms` and `library_device_ms` are
     their kernels' device time alone, without the host's dispatch gaps.
     Every such device time is taken at the end, after phase 16: a
     profiler window slows the host's later launches, and no path is timed
     after one. K1's log line gives its plan (cluster size,
     cudaOccupancyMaxActiveClusters, shared memory a CTA), its time a step
     and a latency floor: its steps times one exchange round of its cluster
     layout, timed alone by csrc/fps.cu's `fps_round_probe` (on the log
     line, not in the kernels line);
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
     K4's (3xTF32 products, sums in another fixed order) and bit-equal
     between two launches, and both are timed with the bound (K5's log line
     also gives its 3xTF32 bound, as K4's does);
  7. training reference: the tiny config's training step on the card (the
     committed PRNGKey(0) state, tiny.train_statistics, the "wide" boxes)
     reproduces tsm_det_pointcloud_tpu_torch/data/tsm_tiny_train_golden.npz
     (loss and tb terms: atol 1e-4 * max(1, |want|), rtol 1e-4; s_*
     gradients: rtol 1e-3, atol 1e-4 * max(max|want|, 1e-2 * the largest
     |want|), the tolerances of tests/test_torch_tsm_train.py);
  8. training main path: launch counts are zeroed, 3 timed steps run, the
     counts are read; every loss must be finite, the teacher's parameters
     bit-identical, every s_* parameter changed and every kernel, K5
     included, launched. Prints train scans/s and the peak device memory;
  9. Waymo capture: one eval forward of the waymo_fast_cpc detector
     (b8 x 122880 x 5 features, seeded weights and eval state) records every
     kernel call's inputs;
 10. kernels at Waymo shapes: K6 (block-pruned exact d-fps, 122880 ->
     16384) index-equal to the plain lockstep FPS over all 8 x 16384 picks,
     on the clustered scans and on an input whose mask empties whole Morton
     blocks, one scan and all but 100 points of another; K1 (s-fps 16384 ->
     3072; its plan and latency floor as in phase 3), K2, K3, K4 against
     their plain versions at the tolerances of phase 3 (K2's layer-0 call,
     16 G pair tests, is held against the plain version on every 15th
     query, all sources, and `plain_ms` is that subset's time;
     `plain_note` says so). Each is timed, with its
     bound; K6's counts the block visits the pruning rule required, and
     its plain version (seconds a call) is timed on one run without a
     warm-up. K6 also prints its plan (cluster size,
     cudaOccupancyMaxActiveClusters and the waves it implies at b8, shared
     memory a CTA), its time a step, and a latency floor (the waves times
     its steps times one exchange round of its clusters, timed alone by
     csrc/fps.cu's `fps_round_probe` on clusters of its size; on the log
     line, not in the kernels line). K6 again at waymo_fast_cpc.yaml's
     163840 test points a row, b8 (a cluster of 16 CTAs: rows of more than
     131072 points), on the clustered scans and with the mask above, each
     index-equal to the plain FPS over all 8 x 16384 picks, timed, with its
     plan, waves, time a step and latency floor (log lines only);
 11. Waymo main path: launch counts are zeroed, 3 batches of forward + NMS
     run, the counts are read; outputs finite, box preds (8, 3072, 7),
     count <= 512, and K6, K1, K2, K3, K4 all launched. Prints Waymo scans/s
     and the peak device memory;
 12. Waymo training step: a warm-up step (which records every kernel
     call's inputs) and 2 timed steps at b8 x 122880 with a vehicle box
     around each of the 16 clusters, counted; each recorded call (K6, K1-K4
     at the training path's own shapes: the teacher's sa1 window query with
     its VSA payload and its U-Net, and K5 at all ten convs) runs through
     its kernel and its plain version at the tolerances of phases 3 and 6,
     timed, with its bound (K2's layer-0 call on a stride of queries as in
     phase 10; K2's and K3's extra figures as in phase 3); losses finite,
     teacher bit-identical, every s_* parameter
     changed, all six kernels launched. Prints train scans/s and the peak
     device memory;
 13. SECOND capture: one eval forward + class-agnostic NMS of the second.yaml
     detector (b4 x 20000, 40000 voxels a level, 211,200 anchors a scan;
     seeded weights and eval state, as infer.build_detector makes them)
     records every K3 and K7 call's inputs (8 and 12 a forward); prints the
     voxels a scan and the anchors over SCORE_THRESH;
 14. kernels at SECOND shapes: every recorded K7 call against its plain
     version (rtol 1e-4, atol 1e-4 * max|out|, K4's tolerance) and
     bit-equal between two launches, every K3 call bitwise against
     probe_plain; each timed with its bound, K3 also beside
     torch.searchsorted, both also by device time alone. K7's log line
     gives each call's (C, Co, K), its hits, their share of the staged rows
     (as K4's) and its bound at the 3xTF32 rate beside the f32 one (not in
     the kernels line);
 15. SECOND reference: the tiny SECOND with
     tsm_det_pointcloud_tpu_torch/data/second_tiny_state.npz (the JAX
     package's converted PRNGKey(0) init) reproduces
     tests/goldens/second_forward.npz on the card at the golden tolerance;
 16. SECOND main path: launch counts are zeroed, 3 batches of forward +
     class-agnostic NMS run, the counts are read; outputs finite, box preds
     (4, 211200, 7), count <= 500, K3 and K7 launched 8 and 12 times a
     forward. Prints SECOND scans/s and the peak device memory;
 17. SECOND training capture: one training step of the second.yaml
     detector (b4 x 20000, 16000 voxels a level, seeded weights, a class-1
     box around each of the scan's 8 clusters, adam_onecycle over every
     parameter; the warm-up of phase 18) records every K3 and K7 call
     (8 and 12: the forward's, K7 under autograd) and checks that backward
     gave every parameter a gradient (every sparse-conv weight a nonzero
     one); each call runs through its kernel and its plain version at the
     tolerances of phase 14, timed, with its bound;
 18. SECOND training main path: launch counts are zeroed, 2 timed steps
     run, the counts are read; losses finite, every parameter changed, K3
     and K7 launched 8 and 12 times a step. Prints train scans/s and the
     peak device memory;
 19. teacher eval (fast_cpc_teacher.yaml, b16 x 16384, both SA layers, the
     256-wide U-Net, the gated head; seeded weights and eval state): the
     tiny teacher with tsm_det_pointcloud_tpu_torch/data/
     tsm_teacher_tiny_state.npz and tiny.teacher_overrides reproduces
     tsm_teacher_tiny_forward.npz at the golden tolerance; one recorded
     forward holds every K1-K4 call against its plain version (phase 3's
     tolerances), timed; launch counts are zeroed, 3 batches of forward +
     multi-threshold NMS run, the counts are read; outputs finite, box preds
     (16, 512, 7), count <= 512, K1-K4 launched. Prints scans/s and the peak
     device memory;
 20. teacher training (b16 x 16384, adam_onecycle LR 0.01 over every
     parameter): the tiny teacher's step reproduces
     tsm_teacher_tiny_train_golden.npz (loss and tb terms as phase 7, every
     gradient at phase 7's tolerance, the class statistics after the step
     rtol 1e-5); then a recorded warm-up step at full width (layer 1's
     confidence bias set to tiny.TEACHER_CONF_BIAS, so that the statistic
     update counts points from the first step) gives every parameter a
     gradient (every sparse-conv weight a nonzero one), prints the points
     the update counted a class and checks the statistics buffers changed;
     every K1-K5 call of it runs through its kernel and its plain version at
     phases 3 and 6's tolerances (K5 at the U-Net's 128 / 256 widths, df and
     dW bit-equal between two launches), timed; launch counts are zeroed, 2
     timed steps run, the counts are read: losses finite, every parameter
     changed but those with a zero gradient and value (`still_params`),
     K1-K5 launched. Prints train scans/s and the peak memory;
 21. handoff: the trained teacher's checkpoint (runtime.checkpoint.
     save_checkpoint) is loaded by a fast_cpc.yaml trainer through
     train.build_trainer's pretrained_model (partial_load, then
     transfer_statistics): its statistics equal the teacher's and every
     teacher parameter is bit-equal; after one distillation step they still
     are, and every student parameter moved (as phase 20, `still_params`);
 22. KITTI data: a synthetic KITTI root in a temporary directory
     (datasets/kitti/synthetic.py: 48 train and 48 val frames of 120000
     points over 360 degrees, ~25k of them in the camera's field of view;
     four cars, two pedestrians and two cyclists a frame with road planes),
     then `create_kitti_infos` (infos and gt database); the val gt echoed as
     detections must score 100.0 on every AP of the official eval;
 23. KITTI data eval: fast_cpc.yaml's test split through the loader (4
     forkserver workers, the FOV crop, 20000 points a scan) and
     `runtime.eval_utils.eval_one_ckpt` at b16 (3 batches; seeded weights and
     eval state as infer.build_detector makes them, the geometry from the
     dataset): the first batch, loaded in the process, records every K1-K4
     and K6 call (d-fps over 20000 points a scan, more than K1's 16384, runs
     on K6), held against its plain version at phases 3 and 10's tolerances,
     timed;
     launch counts are zeroed, the eval loop runs, the counts are read;
     predictions finite, 48 prediction dicts, an AP dict of 72 finite
     entries. Prints eval scans/s (host clock, loader included),
     sec_per_example, the loop's wait on the loader a batch, peak memory and
     the AP dict; the device idle share of one profiled batch of it comes at
     the end, after every timed path;
 24. KITTI data training: `train --data_root` for 2 epochs at b16 with 4
     workers and fast_cpc.yaml's augmentors (gt sampling with road planes,
     flip, box noise, rotation, scaling), launch counts zeroed before and
     read after; its first step records every K1-K5 call, held against its
     plain version at phases 3 and 6's tolerances (K5 bit-equal between two
     launches), timed; every kernel launched, losses finite. Prints each
     epoch's train scans/s (host clock, loader included; the first epoch
     holds the recorded step), the loader wait a step and the peak memory;
     then `evaluate --ckpt` on the checkpoint of its last epoch.
 25. Waymo data: a synthetic Waymo root of raw tfrecords in a temporary
     directory (datasets/waymo/synthetic.py: 4 train and 4 val sequences of
     4 frames, a frame's TOP laser 64 x 2650 with two returns and its
     per-pixel pose, four short-range lasers, ~195k points, vehicles,
     pedestrians and cyclists; written by 8 processes), then
     `create_waymo_infos` with a pool of 8 (npy frames, infos, gt database,
     pcdet_waymo_dbinfos_train_sampled_1.pkl), timed; the val gt echoed as
     detections must score 100.0 on every AP and APH, L1 and L2, of the
     three classes;
 26. Waymo data eval: waymo_fast_cpc.yaml's test split through the loader (4
     forkserver workers, 163840 of each scan's points) and
     `runtime.eval_utils.eval_one_ckpt` at b8 (2 batches; seeded weights and
     eval state, the geometry from the dataset): the first batch, loaded in
     the process, records every K6 (163840 -> 16384, a cluster of 16), K1,
     K2, K3 and K4 call, held against its plain version at phases 3 and 10's
     tolerances (K2's layer-0 call on a stride of queries, as phase 10),
     timed; launch counts are zeroed, the eval loop runs, the counts are
     read; predictions finite, an AP dict of 12 finite entries. Prints eval
     scans/s (host clock, loader included), sec_per_example, the loop's wait
     on the loader a batch and the peak memory; the idle share of one
     profiled batch comes at the end, after every timed path;
 27. Waymo data training: `train --data_root` for 2 epochs of 2 steps at b8
     (120000 points a scan: K6 in its 8-CTA layout) with 4 workers and the
     config's augmentors, SAMPLED_INTERVAL.train cut from 5 to 1 by
     `--set` (16 train frames), launch counts zeroed before and read after;
     its first step records every K6 and K1-K5 call, held against its plain
     version at phases 3, 6 and 10's tolerances (K5 bit-equal between two
     launches), timed; every kernel launched, losses finite. Prints each
     epoch's train scans/s, the loader wait a step and the peak memory; then
     `evaluate --ckpt` on the checkpoint of its last epoch.
 28. teacher data path and the two-phase recipe, on phase 22's root, each
     run through its entry point with 4 workers, launch counts zeroed before
     and read after, the first batch or step recorded (the detector's first
     forward, or runtime.train_loop.train_step's first call) and each
     recorded K1-K6 call held against its plain version at phases 3, 6 and
     10's tolerances (K5 bit-equal between two launches), timed:
     fast_cpc_teacher.yaml's `evaluate` at b16 x 20000 (3 batches, seeded
     weights; d-fps 20000 -> 4096 on K6), its `train --data_root` for 1
     epoch of 3 steps at b16, fast_cpc.yaml's `train --data_root
     --pretrained_model` on the teacher's checkpoint for 1 epoch of 3 steps,
     then `evaluate --ckpt` on the student's checkpoint; every teacher
     parameter and the class statistics bit-equal in the student's
     checkpoint, losses finite, AP dicts finite. Prints each run's scans/s
     or train scans/s, loader wait and peak memory;
 29. SECOND data path: second.yaml's `evaluate` at b4 (3 batches) and
     `train --data_root` for 1 epoch of 3 steps at b4, on the first
     SECOND_DATA_FRAMES val and train frames of the root (`--set
     DATA_CONFIG.INFO_PATH...` on info files of those frames), recorded and
     held as in phase 28 (K3 bitwise, K7 at K4's tolerance and bit-equal
     between two launches); 8 K3 and 12 K7 calls a forward. Prints the
     points a scan holds in the field of view and those the collate drops
     past MAX_POINTS, the voxels a scan of the first batch, scans/s, train
     scans/s and peak memory;
 30. reference checkpoint and demo: a synthetic OpenPCDet-layout checkpoint
     (convert_torch_ckpt.reference_state_dict) of a seeded full-width
     fast_cpc.yaml detector (infer.build_detector) through
     `convert_torch_ckpt`: every converted tensor placed, every one placed
     without a tie bit-equal to its source; prints the tensors placed among
     more than one candidate and those misplaced, and where none is
     misplaced checks that every converted entry equals its source and
     prints the two models' difference on one scan; then `demo --ckpt` on
     DEMO_SCANS raw .bin scans of the root's val split (360 degrees, no
     field-of-view crop, 20000 points sampled: d-fps on K6), its first
     forward recorded and held as in phase 28. Prints the detections a
     scan, scans/s and peak memory.
Before it prints its result the script stops the loaders' workers, their
fork server and multiprocessing's resource tracker, waits for each, and
fails if any process it started is still running; it prints its own time,
the kernels' build included.
The line before the last is the kernels JSON: each row's numbers are those
of the KITTI training path (per step of phase 6, `launches` from phase 8),
its `eval` object those of the KITTI eval path (per forward of phase 3,
`launches` from phase 5; null for K5), its `waymo` object those of the
Waymo eval path (per forward of phase 10, `launches` from phase 11; null
for K5) and `waymo_train` those of the Waymo training path (per step of
phase 12, `launches` from its 2 timed steps), its `second` object those of
the SECOND eval path (per forward of phase 14, `launches` from phase 16;
null but for K3 and K7) and `second_train` those of SECOND's training path
(per step of phase 17, `launches` from phase 18), its `teacher` object those
of the teacher's eval path (per forward of phase 19, `launches` from its 3
counted batches; null for K5, K6, K7) and `teacher_train` those of the
teacher's training path (per step of phase 20, `launches` from its 2 counted
steps), its `kitti_data` object those of the KITTI data eval path (per
batch of phase 23, `launches` from its eval loop; null for K5, K7) and
`kitti_data_train` those of the KITTI data training path (per step of phase
24's recorded step, `launches` from its 2 epochs; null for K6, K7), its
`waymo_data` and `waymo_data_train` objects those of the Waymo data eval and
training paths (per batch of phase 26 and per step of phase 27's recorded
step, `launches` from its eval loop and its 2 epochs; null for K7, and K5 at
eval), its `teacher_data` and `teacher_data_train` objects those of phase
28's teacher evaluate and train (per batch and per step recorded, `launches`
from the run), `second_data` and `second_data_train` those of phase 29 (null
but for K3 and K7) and `demo` that of phase 30's demo (per scan recorded,
`launches` from its 4 scans; null for K5, K7). K6 is on no KITTI path of
synthetic scans (only on those of 20000-point test scans: the data evals and
the demo): its row's own numbers are the Waymo eval path's; K7 is on
SECOND's paths alone, and its row's own numbers are SECOND's eval path's
(`path` says which path a row's own numbers are from).
K6's and K2's `ms` is their launch alone; `prep_ms` beside it is the
PyTorch prep (Morton sort, gathers, boxes) that precedes each launch (K2's
tiles counted once a pass for the calls that share them).
The last line is the result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32X3_OPS_PER_S = 495e12 / 3   # H100 SXM TF32 tensor cores, three products (3xTF32)
BYTES_PER_S = 3.35e12      # H100 SXM HBM3
MAIN_BATCH, MAIN_POINTS, MAIN_ITERS, TRAIN_ITERS = 16, 16384, 3, 3
WAYMO_BATCH, WAYMO_POINTS, WAYMO_ITERS, WAYMO_TRAIN_ITERS = 8, 122880, 3, 2
SECOND_BATCH, SECOND_POINTS, SECOND_ITERS, SECOND_TRAIN_ITERS = 4, 20000, 3, 2
TEACHER_TRAIN_ITERS = 2
# the synthetic KITTI root of phases 22-24: frames a split, points a scan,
# loader workers, training epochs
KITTI_TRAIN, KITTI_VAL, KITTI_SCAN_POINTS, KITTI_WORKERS, KITTI_EPOCHS = 48, 48, 120000, 4, 2
KITTI_BATCH = 16             # fast_cpc.yaml's BATCH_SIZE_PER_GPU
# waymo_fast_cpc.yaml's test scans (sample_points' NUM_POINTS), past K6's 8-CTA layout
WAYMO_TEST_POINTS = 163840
# the synthetic Waymo root of phases 25-27: train and val sequences, frames a
# sequence (16 + 16 frames: 2 eval batches, 2 training steps an epoch at the
# train SAMPLED_INTERVAL cut from 5 to 1), loader and preprocessing workers,
# training epochs
WAYMO_TRAIN_SEQ, WAYMO_VAL_SEQ, WAYMO_SEQ_FRAMES = 4, 4, 4
WAYMO_WORKERS, WAYMO_PREP_WORKERS, WAYMO_EPOCHS = 4, 8, 2
WAYMO_DATA_CLASSES = ("Vehicle", "Pedestrian", "Cyclist")
# phase 29: SECOND's eval and training on the first frames of each split of
# phase 22's root (3 batches, 3 steps at b4); phase 30: the demo's raw scans
SECOND_DATA_FRAMES = 12
DEMO_SCANS = 4
EVAL_KERNELS = ("fps", "query_group", "probe", "spconv_bykey")
KITTI_KERNELS = EVAL_KERNELS + ("spconv_bykey_bwd",)
WAYMO_EVAL_KERNELS = ("fps_block",) + EVAL_KERNELS
TSM_KERNELS = ("fps_block",) + KITTI_KERNELS
# at fast_cpc.yaml's 20000 test points a scan, over K1's 16384, d-fps runs on K6
KITTI_DATA_EVAL_KERNELS = ("fps_block",) + EVAL_KERNELS
SECOND_KERNELS = ("probe", "spconv_gather")
SECOND_CALLS = {"probe": 8, "spconv_gather": 12}   # a forward: 4 rulebooks + 4 plans, 12 convs
BYKEY_ROWS = 64              # K4's row block (csrc/spconv_bykey.cu kRows)
PAIR_TESTS_PLAIN = 1 << 30   # K2's plain version is run on at most this many pairs
PLAIN_NOTES = {}             # kernel -> what its plain version ran on, when not everything
EXTRAS = {}                  # kernel -> figures of its last compared call that a pass sums
EXTRA_KEYS = ("prep_ms", "prep_device_ms", "visits", "device_ms", "library_device_ms",
              "hits", "staged_rows")
TILED = []                   # K2 tiles whose making a compared call of the pass has timed


class Deferred(NamedTuple):
    """A device-time measurement of fn(*args, **kwargs) (`device_ms`),
    taken after every timed path: one torch.profiler window slows the
    host's later launches for the rest of the process, so no path may be
    timed after one. The tensor arguments wait in host memory, so that they
    hold no device memory while the paths run."""
    fn: object
    args: tuple
    reps: int
    kernels: object = None
    kwargs: object = None


def deferred(fn, args, reps, kernels=None, **kwargs):
    import torch

    return Deferred(fn, tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args),
                    reps, kernels, kwargs)
KERNELS = {
    "fps": ("tsm_det_pointcloud_tpu_torch/csrc/fps.cu",
            "tsm_det_pointcloud_tpu/ops/fps_pallas.py:28"),
    "fps_block": ("tsm_det_pointcloud_tpu_torch/csrc/fps_block.cu",
                  "tsm_det_pointcloud_tpu/ops/fps_pallas.py:197 (and :490, :633)"),
    "query_group": ("tsm_det_pointcloud_tpu_torch/csrc/group.cu",
                    "tsm_det_pointcloud_tpu/ops/group_pallas.py:108"),
    "probe": ("tsm_det_pointcloud_tpu_torch/csrc/probe.cu",
              "tsm_det_pointcloud_tpu/ops/searchsorted_pallas.py:55"),
    "spconv_bykey": ("tsm_det_pointcloud_tpu_torch/csrc/spconv_bykey.cu",
                     "tsm_det_pointcloud_tpu/ops/spconv_pallas.py:132"),
    "spconv_bykey_bwd": ("tsm_det_pointcloud_tpu_torch/csrc/spconv_bykey_bwd.cu",
                         "tsm_det_pointcloud_tpu/ops/spconv_pallas.py:383"),
    "spconv_gather": ("tsm_det_pointcloud_tpu_torch/csrc/spconv_gather.cu",
                      "tsm_det_pointcloud_tpu/ops/spconv_pallas.py:45"),
}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def descendants():
    """The pids of every process this one started, and theirs."""
    children = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except OSError:   # it ended meanwhile
            continue
        children.setdefault(ppid, []).append(int(pid))
    found, todo = [], [os.getpid()]
    while todo:
        kids = children.get(todo.pop(), [])
        found += kids
        todo += kids
    return found


def running(pids):
    """Those of `pids` that still run (neither gone nor a zombie)."""
    alive = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    alive.append(pid)
        except OSError:
            pass
    return alive


def cuda_time_ms(fn, reps):
    """ms a call over `reps` calls between two CUDA events, after a warm-up
    call; reps 0: one call and no warm-up, for what takes seconds."""
    import torch

    if reps:
        fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(max(reps, 1)):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / max(reps, 1)


def device_ms(fn, reps, kernels=None):
    """Device time of `fn`'s kernels alone, per call, from a torch.profiler
    window of `reps` calls: for each kernel, its mean time times the
    launches it makes a call. Unlike cuda_time_ms it leaves out the host's
    dispatch gaps between launches. The profiler at times hands back a
    window short of a kernel record or two, which the means ride out; a
    window with no device time, or (given `kernels`) another number of
    launches a call, is taken again, up to five times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsm_det_pointcloud_tpu_torch.infer import self_device_us

    fn()  # warm-up
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False) and e.count > 0]
        per_call = [round(e.count / reps) for e in events]
        us = sum(self_device_us(e) / e.count * k for e, k in zip(events, per_call))
        if us > 0 and (kernels is None or sum(per_call) == kernels):
            return us / 1e3
    fail(f"torch.profiler recorded {[e.count for e in events]} launches for {reps} calls, "
         f"five times")


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
    # beside the bound, a latency floor: the steps times one exchange round
    # of this call's cluster layout, timed alone by a probe kernel
    plan = sampling.fps_plan(N, weights is not None)
    round_us = exchange_round_us(min(B, plan["active_clusters"]), plan["cluster_size"])
    floor_ms = (npoint - 1) * round_us / 1e3
    EXTRAS["fps"] = {"floor_ms": floor_ms, "steps": npoint - 1}
    print(f"  K1 plan at b{B} x {N} ({'s-fps' if weights is not None else 'd-fps'}): "
          f"cluster size {plan['cluster_size']}, cudaOccupancyMaxActiveClusters "
          f"{plan['active_clusters']}, {plan['smem_bytes']} B shared memory a CTA; one "
          f"exchange round {round_us:.4f} us, so a latency floor of {floor_ms:.4f} ms for "
          f"{npoint - 1} steps")
    return (0.0, lambda: sampling._fps_kernel(xyz, npoint, valid, weights),
            lambda: sampling.furthest_point_sample_plain(xyz, npoint, valid, weights),
            None, ops, nbytes, 5, 1)


def compare_fps_block(args):
    from tsm_det_pointcloud_tpu_torch.ops import sampling

    xyz, npoint, valid = args
    got, visits = sampling._fps_block_kernel(xyz, npoint, valid)
    want = sampling.furthest_point_sample_plain(xyz, npoint, valid)
    n_diff = int((got != want).sum())
    check(n_diff == 0, f"K6 fps_block differs from the plain FPS at {tuple(xyz.shape)}: "
                       f"{n_diff} of {got.numel()} picks")
    B, N, _ = xyz.shape
    nb = -(-N // sampling.FPS_BLOCK)
    n_visits = int(visits.sum())
    ops = n_visits * sampling.FPS_BLOCK * 9
    nbytes = B * N * 12 + B * npoint * 4 + (B * N if valid is not None else 0)
    # beside the bound: the visited blocks' 24 bytes a point (x, y, z, index
    # and mind read, mind written; they come from L2, not device memory) and
    # the full sweep K1's formula would count
    visit_ms = n_visits * sampling.FPS_BLOCK * 24 / BYTES_PER_S * 1e3
    sweep_ms = (npoint - 1) * B * N * 9 / F32_OPS_PER_S * 1e3
    # `ms` is the launch alone; the PyTorch prep (Morton sort, gathers, boxes)
    # is timed apart as `prep_ms`. The launch only reads its prepared state.
    # Beside the operations bound, a latency floor: the steps times one
    # exchange round (every warp's candidate pushed to every CTA of its
    # cluster, awaited and reduced), timed alone by a probe kernel
    reps = 3
    xyz = xyz.detach().contiguous().float()
    prep_ms = cuda_time_ms(lambda: sampling.block_prep(xyz, valid), reps)
    state = sampling.block_prep(xyz, valid)
    plan = sampling.fps_block_plan(nb)
    round_us = exchange_round_us(min(B, plan["active_clusters"]), plan["cluster_size"])
    # a batch of more scans than clusters resident at once runs in waves,
    # each of them the steps long
    waves = -(-B // plan["active_clusters"])
    floor_ms = waves * (npoint - 1) * round_us / 1e3
    EXTRAS["fps_block"] = {"prep_ms": prep_ms, "floor_ms": floor_ms, "steps": npoint - 1}
    print(f"  K6 visited {n_visits} of {(npoint - 1) * nb * B} (step, block) pairs "
          f"({100 * n_visits / ((npoint - 1) * nb * B):.2f}%); their bytes at the memory "
          f"rate {visit_ms:.4f} ms; a full sweep's operations {sweep_ms:.4f} ms; the "
          f"prep alone {prep_ms:.4f} ms")
    print(f"  K6 plan at b{B} x {nb} blocks: cluster size {plan['cluster_size']}, "
          f"cudaOccupancyMaxActiveClusters {plan['active_clusters']} ({waves} wave"
          f"{'s' if waves > 1 else ''} at b{B}), {plan['smem_bytes']} B shared memory a "
          f"CTA; one exchange round {round_us:.4f} us, so a latency floor of "
          f"{floor_ms:.4f} ms for {waves} x {npoint - 1} steps")
    # the plain lockstep FPS takes seconds at Waymo shapes: timed on one
    # run, no warm-up
    return (0.0, lambda: sampling._fps_block_launch(xyz, state, npoint),
            lambda: sampling.furthest_point_sample_plain(xyz, npoint, valid),
            None, ops, nbytes, reps, 0)


def exchange_round_us(clusters, cluster_size, rounds=16384):
    """Time of one FPS exchange round (csrc/cluster_exchange.cuh
    `round_kernel`, launched by csrc/fps.cu's `fps_round_probe`: every
    warp's candidate pushed to every CTA of its cluster, awaited and reduced)
    with `clusters` clusters of `cluster_size` CTAs of 8 warps at once: K1's
    layouts (4 or 8 CTAs) and K6's (8, or 16 for rows of more than
    sampling.FPS_BLOCK_SMALL_POINTS points)."""
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    sink = torch.empty(clusters * cluster_size, device="cuda")
    fn = _kernels.func("fps_round_probe")

    def run():
        _kernels.check(fn(cluster_size, clusters, rounds, sink.data_ptr(),
                          _kernels.stream_ptr(sink.device)), "fps_round_probe")

    return cuda_time_ms(run, 3) * 1e3 / rounds


def compare_query_group(args):
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import grouping

    src_xyz, src_valid, q_xyz, scales, payload, src_coords, q_coords, tiles = args
    gi, gc, gg = grouping._query_group_kernel(*args)
    # the plain version materialises every (query, source) pair: above
    # PAIR_TESTS_PLAIN pairs it runs on every `stride`-th query (all sources)
    # and the kernel's full-shape result is held against it on those
    stride = -(-src_xyz.shape[0] * src_xyz.shape[1] * q_xyz.shape[1] // PAIR_TESTS_PLAIN)
    plain_args = args[:7]
    if stride > 1:
        PLAIN_NOTES["query_group"] = (f"plain version run and timed on every {stride}th "
                                      f"query of the {q_xyz.shape[1]}-query call")
        print(f"  K2 {PLAIN_NOTES['query_group']}")
        plain_args = (src_xyz, src_valid, q_xyz[:, ::stride].contiguous(), scales, payload,
                      src_coords,
                      None if q_coords is None else q_coords[:, ::stride].contiguous())
        gi, gc = gi[:, ::stride], gc[:, ::stride]
        gg = None if gg is None else gg[:, ::stride]
    wi, wc, wg = grouping.query_group_plain(*plain_args)
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
    # `ms` is the launch alone, on prepared sources; the PyTorch prep is
    # timed apart as `prep_ms`: the query sort, and the tiles where this
    # call made them (tiles shared with an earlier call of the pass were
    # made there). The bound counts the pair tests of the tiles the rule
    # visited (the launch's `visits`); `sweep_ms`, what every query against
    # every source would take at the same rate, is derived, for the log
    scales_n, sx, sv, qx, pl, scc, qcc = grouping._kernel_inputs(*args[:7])
    shared = any(t is tiles for t in TILED)
    if tiles is not None and not shared:
        TILED.append(tiles)
    prep = grouping.GroupPrep(*(tiles or grouping.tile_sources(sx, sv, scc)),
                              grouping.query_order(qx))
    visits = grouping._query_group_launch(prep, qx, scales_n, pl, qcc)[3]
    per_pair = 8 + 2 * S + (6 if window else 0)
    n_visits = int(visits.sum())
    nt = prep.tbox.shape[1]
    ops = n_visits * grouping.GROUP_TILE * per_pair
    sweep_ms = B * M * N * per_pair / F32_OPS_PER_S * 1e3
    prep_fn, prep_args = ((grouping.query_order, (qx,)) if shared
                          else (grouping.group_prep, (sx, sv, qx, scc)))
    prep_ms = cuda_time_ms(lambda: prep_fn(*prep_args), 5)
    EXTRAS["query_group"] = {"prep_ms": prep_ms,
                             "prep_device_ms": deferred(prep_fn, prep_args, 5),
                             "sweep_ms": sweep_ms, "visits": n_visits, "tile_pairs": B * M * nt}
    print(f"  K2 tested {n_visits} of {B * M * nt} (query, tile) pairs "
          f"({100 * n_visits / (B * M * nt):.2f}%); all pairs at the same rate "
          f"{sweep_ms:.4f} ms (derived, not timed); the prep alone {prep_ms:.4f} ms"
          + (" (the tiles were made by an earlier call, only the queries sorted here)"
             if shared else ""))
    nbytes = (B * N * (12 + 1 + (12 if window else 0) + 4 * D)
              + B * M * (12 + (12 if window else 0))
              + B * M * (4 * T + 4 * S + 4 * T * D))
    return (err, lambda: grouping._query_group_launch(prep, qx, scales_n, pl, qcc),
            lambda: grouping.query_group_plain(*plain_args), None, ops, nbytes, 5, 1)


def compare_probe(args):
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import spconv

    skeys, queries, sentinel = args
    # the kernel's and the library call's device time alone, beside the
    # host-loop figures, taken at the end
    EXTRAS["probe"] = {
        "device_ms": deferred(spconv.probe, (skeys, queries, sentinel), 20, 1),
        "library_device_ms": deferred(torch.searchsorted, (skeys.contiguous(),
                                                           queries.contiguous()), 20, 1,
                                      right=True)}
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


def staged_rows(found):
    """The rows (q < Q) of the (BYKEY_ROWS-row block, tap) pairs in which
    at least one row's key is found: what a kernel that stages whole row
    blocks for every tap with a hit stages. found (B, K, Q) bool."""
    import torch

    B, K, Q = found.shape
    pad = -Q % BYKEY_ROWS
    f = torch.cat([found, found.new_zeros((B, K, pad))], -1).reshape(B, K, -1, BYKEY_ROWS)
    rows = torch.clamp(Q - torch.arange(f.shape[2], device=found.device) * BYKEY_ROWS,
                       max=BYKEY_ROWS)
    return int((f.any(-1) * rows).sum())


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
    staged = staged_rows(found)
    EXTRAS["spconv_bykey"] = {"hits": hits, "staged_rows": staged,
                              "bound_tf32x3_ms": 2 * C * Co * hits / TF32X3_OPS_PER_S * 1e3}
    print(f"  K4 hit share of staged rows {hits / max(staged, 1):.4f} ({hits} hits, {staged} "
          f"rows in the ({BYKEY_ROWS}-row block, tap) pairs with a hit)")
    ops = 2 * C * Co * hits
    nbytes = 4 * (B * V * C + B * V + B * K * Q + K * C * Co + B * Q * Co)
    return (err, lambda: spconv.gather_matmul_bykey(f, skeys, qkeys, w, sentinel),
            lambda: spconv.gather_matmul_bykey_plain(f, skeys, qkeys, w, sentinel),
            None, ops, nbytes, 5, 2)


def compare_bykey_bwd(args):
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import spconv

    f, skeys, qkeys, w, g, sentinel = args
    got = spconv.gather_matmul_bykey_bwd(f, skeys, qkeys, w, g, sentinel)
    again = spconv.gather_matmul_bykey_bwd(f, skeys, qkeys, w, g, sentinel)
    want = spconv.gather_matmul_bykey_bwd_plain(f, skeys, qkeys, w, g, sentinel)
    err = 0.0
    for what, gt, g2, wt in zip(("df", "dW"), got, again, want):
        scale = float(wt.abs().max())
        e = float((gt - wt).abs().max())
        check(bool(((gt - wt).abs() <= 1e-4 * wt.abs() + 1e-4 * scale).all()),
              f"K5 {what} differs from its plain version: max abs err {e} (scale {scale})")
        check(torch.equal(gt, g2), f"K5 {what} differs between two launches")
        err = max(err, e)
    B, V, C = f.shape
    _, K, Q = qkeys.shape
    Co = w.shape[-1]
    _, found = spconv._lookup_plain(skeys, qkeys, sentinel)
    hits = int(found.sum())
    ops = 4 * C * Co * hits
    EXTRAS["spconv_bykey_bwd"] = {"bound_tf32x3_ms": ops / TF32X3_OPS_PER_S * 1e3}
    nbytes = 4 * (2 * B * V * C + B * Q * Co + 2 * K * C * Co + B * V + B * K * Q)
    return (err, lambda: spconv.gather_matmul_bykey_bwd(f, skeys, qkeys, w, g, sentinel),
            lambda: spconv.gather_matmul_bykey_bwd_plain(f, skeys, qkeys, w, g, sentinel),
            None, ops, nbytes, 5, 2)


def compare_gather(args):
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import spconv

    f, idx, w = args
    got = spconv.gather_matmul(f, idx, w)
    want = spconv.gather_matmul_plain(f, idx, w)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-4 * scale).all()),
          f"K7 differs from its plain version: max abs err {err} (scale {scale})")
    check(torch.equal(got, spconv.gather_matmul(f, idx, w)), "K7 differs between two launches")
    B, V, C = f.shape
    _, K, Q = idx.shape
    Co = w.shape[-1]
    hit = (idx >= 0) & (idx < V)
    hits = int(hit.sum())
    staged = staged_rows(hit)
    # bytes: the indices, each row that some index names read once, W, out
    rows = sum(int(torch.unique(idx[b][hit[b]]).numel()) for b in range(B))
    ops = 2 * C * Co * hits
    nbytes = 4 * (B * K * Q + rows * C + K * C * Co + B * Q * Co)
    b_ms, b_by = bound_ms(ops, nbytes)
    tf32x3_ms = max(ops / TF32X3_OPS_PER_S, nbytes / BYTES_PER_S) * 1e3
    EXTRAS["spconv_gather"] = {"hits": hits, "staged_rows": staged, "bound_tf32x3_ms": tf32x3_ms}
    print(f"  K7 (C, Co, K) = ({C}, {Co}, {K}): {hits} hits, hit share of staged rows "
          f"{hits / max(staged, 1):.4f} ({staged} rows in the ({BYKEY_ROWS}-row block, tap) "
          f"pairs with a hit); bound {b_ms:.4f} ms ({b_by}, f32), {tf32x3_ms:.4f} ms at "
          f"3xTF32")
    return (err, lambda: spconv.gather_matmul(f, idx, w),
            lambda: spconv.gather_matmul_plain(f, idx, w), None, ops, nbytes, 5, 2)


COMPARE = {"fps": compare_fps, "fps_block": compare_fps_block,
           "query_group": compare_query_group,
           "probe": compare_probe, "spconv_bykey": compare_bykey,
           "spconv_bykey_bwd": compare_bykey_bwd, "spconv_gather": compare_gather}


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
            for k, v in EXTRAS.pop(name, {}).items():
                if isinstance(v, Deferred):
                    agg.setdefault("deferred", []).append((k, v))
                else:
                    agg[k] = agg.get(k, 0) + v
        agg["bound"], agg["bound_by"] = bound_ms(agg["ops"], agg["nbytes"])
        report[name] = agg
        print(f"{label} {name}: {len(args_list)} calls per pass, kernel {agg['ms']:.4f} ms, "
              f"plain {agg['plain_ms']:.4f} ms, bound {agg['bound']:.4f} ms "
              f"({agg['bound_by']}), max abs err {agg['err']:g}"
              + (f", prep {agg['prep_ms']:.4f} ms" if "prep_ms" in agg else "")
              + (f", hit share of staged rows {agg['hits'] / max(agg['staged_rows'], 1):.4f}"
                 if "staged_rows" in agg else "")
              + (f", 3xTF32 bound {agg['bound_tf32x3_ms']:.4f} ms"
                 if "bound_tf32x3_ms" in agg else "")
              + (f", {1e3 * agg['ms'] / agg['steps']:.4f} us a step, latency floor "
                 f"{agg['floor_ms']:.4f} ms" if "steps" in agg else "")
              + (f", (query, tile) pairs tested {agg['visits']} of {agg['tile_pairs']}, "
                 f"all pairs at the bound's rate {agg['sweep_ms']:.4f} ms (derived)"
                 if "sweep_ms" in agg else ""))
    TILED.clear()
    return report


def take_device_times(reports):
    """The deferred device times (see Deferred), summed over each pass."""
    import torch

    for label, report in reports.items():
        for name, agg in report.items():
            for k, d in agg.pop("deferred", []):
                args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in d.args]
                agg[k] = agg.get(k, 0.0) + device_ms(lambda: d.fn(*args, **d.kwargs),
                                                     d.reps, d.kernels)
            got = {k: agg[k] for k in ("device_ms", "library_device_ms", "prep_device_ms")
                   if k in agg}
            if got:
                print(f"{label} {name}: device time alone, per pass: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in got.items()))


def record_kernels(names):
    """A Recorder over the wrappers of the named kernels."""
    from tsm_det_pointcloud_tpu_torch.ops import grouping, sampling, spconv

    where = {"fps": (sampling, "_fps_kernel"),
             "fps_block": (sampling, "_fps_block_kernel"),
             "query_group": (grouping, "_query_group_kernel"),
             "probe": (spconv, "probe"),
             "spconv_bykey": (spconv, "gather_matmul_bykey"),
             "spconv_bykey_bwd": (spconv, "gather_matmul_bykey_bwd"),
             "spconv_gather": (spconv, "gather_matmul")}
    rec = Recorder(names)
    for name in names:
        rec.wrap(*where[name], name)
    return rec


@contextmanager
def first_call_recorded(owner, attr, names):
    """Within the block, the first call of owner.attr (a training loop's
    first step, `runtime.train_loop.train_step`, or a detector class's first
    forward) runs with the named kernels' calls recorded; the yielded list
    then holds (its Recorder, its result)."""
    import torch

    orig = getattr(owner, attr)
    first = []

    def wrapped(*args, **kwargs):
        if first:
            return orig(*args, **kwargs)
        rec = record_kernels(names)
        try:
            result = orig(*args, **kwargs)
            torch.cuda.synchronize()
        finally:
            rec.restore()
        first.append((rec, result))
        return result

    setattr(owner, attr, wrapped)
    try:
        yield first
    finally:
        setattr(owner, attr, orig)


def close_scalar(got, want):
    return abs(got - want) <= 1e-4 * max(1.0, abs(want)) + 1e-4 * abs(want)


def second_phases(dev):
    """Phases 13-16: the SECOND eval path. Returns the per-kernel report of
    phase 14 and the launch counts of phase 16."""
    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, synth_scans,
                                                    voxel_anchor_counts)
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    # ---- 13. capture the SECOND eval forward's kernel calls ----
    scfg_file = ROOT / "tools/cfgs/kitti_models/second.yaml"
    scfg, smodel = build_detector(scfg_file, dev, seed=0, n_points=SECOND_POINTS)
    spost = scfg.MODEL.POST_PROCESSING
    spost_max = int(spost.NMS_CONFIG.NMS_POST_MAXSIZE)
    sbatches = [torch.from_numpy(synth_scans(smodel.dataset_meta, SECOND_BATCH, SECOND_POINTS,
                                             seed=s)).to(dev)
                for s in range(SECOND_ITERS)]
    smask = torch.ones((SECOND_BATCH, SECOND_POINTS), dtype=torch.bool, device=dev)
    rec = record_kernels(SECOND_KERNELS)
    sout, _ = detect(smodel, sbatches[0], smask)
    torch.cuda.synchronize()
    rec.restore()
    for name, n in SECOND_CALLS.items():
        check(len(rec.calls[name]) == n,
              f"the SECOND capture forward made {len(rec.calls[name])} {name} calls, not {n}")
    voxels, over = voxel_anchor_counts(smodel, sout)
    print(f"SECOND capture: voxel capacity {smodel.dataset_meta.max_voxels}; voxels a scan "
          f"{voxels}; anchors over SCORE_THRESH {spost.SCORE_THRESH} a scan {over} of "
          f"{sout['batch_cls_preds'].shape[1]}")
    del sout

    # ---- 14. each kernel against its plain version at SECOND shapes ----
    report_second = compare_recorded(rec.calls, "second")
    del rec

    # ---- 15. SECOND reference: the tiny SECOND reproduces its JAX golden ----
    stiny = build_network(tiny.second_model_cfg(), 1, tiny.SECOND_META, device=dev)
    stiny.load_state_dict(tiny.load_state(tiny.SECOND_STATE_PATH), strict=True)
    stpts = torch.from_numpy(tiny.second_points(2)).to(dev)
    stout, _ = detect(stiny, stpts, torch.ones(stpts.shape[:2], dtype=torch.bool, device=dev))
    golden = np.load(ROOT / "tests/goldens/second_forward.npz")
    for key in golden.files:
        want = golden[key]
        got = stout[key].cpu().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        diff = float(np.abs(got - want).max())
        check(got.shape == want.shape and np.allclose(got, want, atol=1e-3 * scale, rtol=1e-3),
              f"tiny SECOND {key} differs from the golden: max abs diff {diff}")
        print(f"SECOND reference: tiny {key} {got.shape} max abs diff vs golden {diff:.3g}")
    del stiny, stout

    # ---- 16. the SECOND main path, counted ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    preds = [detect(smodel, pts, smask) for pts in sbatches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_second = dict(_kernels.LAUNCHES)
    for out, pred in preds:
        for key in ("batch_cls_preds", "batch_box_preds"):
            check(bool(torch.isfinite(out[key]).all()), f"SECOND: non-finite {key}")
        check(tuple(out["batch_box_preds"].shape) == (SECOND_BATCH, 211200, 7),
              f"SECOND box preds shape {tuple(out['batch_box_preds'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"SECOND: non-finite {key}")
        check(bool((pred["count"] <= spost_max).all()), "SECOND: count > NMS_POST_MAXSIZE")
    counts = [int(c) for c in preds[-1][1]["count"]]
    for name, n in SECOND_CALLS.items():
        check(launches_second[name] == n * SECOND_ITERS,
              f"kernel {name} launched {launches_second[name]} times on the SECOND path, "
              f"not {n} a forward")
    print(f"SECOND main path: {SECOND_ITERS} batches x {SECOND_BATCH} scans x {SECOND_POINTS} "
          f"points (211200 anchors a scan) in {dt:.3f} s = "
          f"{SECOND_ITERS * SECOND_BATCH / dt:.3f} scans/s; detections per scan (last batch) "
          f"{counts}; launches {launches_second}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del smodel, preds, sbatches, out, pred
    return report_second, launches_second


def second_train_phases(dev):
    """Phases 17-18: SECOND's training step. Returns the per-kernel report
    of phase 17 and the launch counts of phase 18."""
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    # ---- 17. capture one training step's kernel calls (the warm-up) ----
    scfg_file = ROOT / "tools/cfgs/kitti_models/second.yaml"
    _, model, opt = build_trainer(scfg_file, dev, seed=0, n_points=SECOND_POINTS,
                                  total_steps=SECOND_TRAIN_ITERS + 1)
    meta = model.dataset_meta
    batches = [synth_train_batch(SECOND_BATCH, SECOND_POINTS, s, dev, meta.point_cloud_range,
                                 meta.num_point_features)
               for s in range(SECOND_TRAIN_ITERS + 1)]
    rec = record_kernels(SECOND_KERNELS)
    opt.zero_grad(set_to_none=True)
    out = model(dict(batches[0]))
    out["loss"].backward()
    torch.cuda.synchronize()
    rec.restore()
    for name, n in SECOND_CALLS.items():
        check(len(rec.calls[name]) == n,
              f"the SECOND training step made {len(rec.calls[name])} {name} calls, not {n}")
    for n, p in model.named_parameters():
        check(p.grad is not None, f"SECOND parameter {n} got no gradient")
        if p.dim() == 3:
            check(bool(p.grad.abs().sum() > 0), f"sparse-conv weight {n} got a zero gradient")
    opt.step()
    check(bool(torch.isfinite(out["loss"])), "SECOND warm-up step loss is not finite")
    print(f"SECOND training capture: voxel capacity {meta.max_voxels}; loss "
          f"{float(out['loss'].detach()):.4f}, "
          + ", ".join(f"{k} {float(v.detach()):.4f}" for k, v in out["tb_dict"].items()))
    del out
    report = compare_recorded(rec.calls, "second train")
    del rec

    # ---- 18. the SECOND training main path, counted ----
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [train_step(model, opt, b)[0] for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, loss in enumerate(losses):
        check(bool(torch.isfinite(loss)), f"SECOND training step {i} loss is not finite")
    for n, p in model.named_parameters():
        check(not torch.equal(p, before[n]), f"SECOND parameter {n} did not change")
    for name, n in SECOND_CALLS.items():
        check(launches[name] == n * SECOND_TRAIN_ITERS,
              f"kernel {name} launched {launches[name]} times on the SECOND training path, "
              f"not {n} a step")
    print(f"SECOND training main path: {SECOND_TRAIN_ITERS} steps x {SECOND_BATCH} scans x "
          f"{SECOND_POINTS} points in {dt:.3f} s = "
          f"{SECOND_TRAIN_ITERS * SECOND_BATCH / dt:.3f} train scans/s "
          f"({1e3 * dt / SECOND_TRAIN_ITERS:.1f} ms/step); losses "
          f"{[round(float(v), 4) for v in losses]}; {len(before)} parameters changed; "
          f"launches {launches}; peak memory {peak:.2f} GiB")
    del model, opt, batches, before, losses
    torch.cuda.empty_cache()
    return report, launches


def still_params(model, before, what):
    """The parameters among `before` (name -> value before the steps) that
    the steps left in place; fails unless each has a zero gradient in the
    last step and a zero value, the only ones AdamW's decay leaves where they
    are. On the synthetic scans layer 0's d-fps keeps its 4096 picks more
    than 1.15 m apart (the plain FPS, scan seed 1), one a voxel: the teacher's
    layer-1 first scale (0-0.4 m) finds only the query's own centroid, a
    zero position input, and its second (0.4-0.8 m) none, so their MLPs
    take no gradient; and no point scores class 2, whose statistics stay
    zero and whose cls block sees a constant (the JAX package's gradients
    are zero in such cases too, tests/test_torch_teacher.py)."""
    import torch

    still = []
    for n, p in model.named_parameters():
        if n in before and torch.equal(p, before[n]):
            check(p.grad is not None and not bool(p.grad.abs().max())
                  and not bool(p.abs().max()), f"{what} parameter {n} did not change")
            still.append(n)
    return still


def teacher_phases(dev):
    """Phases 19-21: the TSM teacher (fast_cpc_teacher.yaml) eval path, its
    training step and the handoff of its checkpoint to a fast_cpc.yaml
    distillation trainer. Returns the per-kernel reports of phases 19 and 20
    and the launch counts of their counted runs."""
    import tempfile

    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import build_detector, detect, synth_points
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.models.dense_heads.point_head_vote import (
        STATISTIC_BUFFERS as STATISTIC_NAMES,
    )
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import save_checkpoint
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import is_student, train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    tcfg_file = ROOT / "tools/cfgs/kitti_models/fast_cpc_teacher.yaml"

    # ---- 19. teacher eval: the tiny golden, one recorded forward, 3 counted ----
    tmodel = build_network(tiny.tiny_teacher_model_cfg(), 3, tiny.META, device=dev)
    tmodel.load_state_dict(tiny.load_state(tiny.TEACHER_STATE_PATH), strict=True)
    tstate = tmodel.state_dict()
    for k, v in tiny.teacher_overrides().items():
        tstate[k].copy_(torch.from_numpy(v).to(dev))
    tpts = torch.from_numpy(tiny.synth_points(2)).to(dev)
    tmask = torch.ones(tpts.shape[:2], dtype=torch.bool, device=dev)
    tout, _ = detect(tmodel, tpts, tmask)
    with np.load(tiny.TEACHER_FORWARD_PATH) as golden:
        for key in golden.files:
            want = golden[key]
            got = tout[key].cpu().numpy()
            scale = max(1.0, float(np.abs(want).max()))
            diff = float(np.abs(got - want).max())
            check(got.shape == want.shape
                  and np.allclose(got, want, atol=1e-3 * scale, rtol=1e-3),
                  f"tiny teacher {key} differs from the golden: max abs diff {diff}")
            print(f"teacher reference: tiny {key} {got.shape} max abs diff vs golden {diff:.3g}")

    cfg, model = build_detector(tcfg_file, dev, seed=0, n_points=MAIN_POINTS)
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
        check(len(calls) > 0, f"the teacher capture forward made no {name} call")
    report_eval = compare_recorded(rec.calls, "teacher eval")
    del rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    preds = [detect(model, pts, mask) for pts in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_eval = dict(_kernels.LAUNCHES)
    for out, pred in preds:
        for key in ("batch_cls_preds", "batch_box_preds"):
            check(bool(torch.isfinite(out[key]).all()), f"teacher: non-finite {key}")
        check(tuple(out["batch_box_preds"].shape) == (MAIN_BATCH, hi - lo, 7),
              f"teacher box preds shape {tuple(out['batch_box_preds'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"teacher: non-finite {key}")
        check(bool((pred["count"] <= post_max).all()), "teacher: count > NMS_POST_MAXSIZE")
    for name in EVAL_KERNELS:
        check(launches_eval[name] > 0, f"kernel {name} was not launched on the teacher eval path")
    print(f"teacher eval main path: {MAIN_ITERS} batches x {MAIN_BATCH} scans x {MAIN_POINTS} "
          f"points in {dt:.3f} s = {MAIN_ITERS * MAIN_BATCH / dt:.3f} scans/s; detections "
          f"per scan (last batch) {[int(c) for c in preds[-1][1]['count']]}; launches "
          f"{launches_eval}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, preds, batches, out, pred

    # ---- 20. teacher training: the tiny golden, a recorded warm-up step, 2 counted ----
    gt, gt_mask = tiny.synth_gt(2, "wide")
    tout = tmodel.train()({"points": tpts, "points_mask": tmask, "batch_size": 2,
                           "gt_boxes": torch.from_numpy(gt).to(dev),
                           "gt_boxes_mask": torch.from_numpy(gt_mask).to(dev)})
    tout["loss"].backward()
    params = dict(tmodel.named_parameters())
    tstate = tmodel.state_dict()
    with np.load(tiny.TEACHER_TRAIN_GOLDEN_PATH) as g:
        gold = {k: g[k] for k in g.files}
    gscale = max(float(np.abs(v).max()) for k, v in gold.items() if k.startswith("grad/"))
    check({k[5:] for k in gold if k.startswith("grad/")} == set(params),
          "the teacher train golden does not hold every parameter's gradient")
    worst = 0.0
    for key, want in gold.items():
        if key.startswith(("grad/", "stat/")):
            is_grad = key.startswith("grad/")
            got = (params[key[5:]].grad if is_grad else tstate[key[5:]]).cpu().numpy()
            diff = float(np.abs(got - want).max())
            ok = (np.allclose(got, want, rtol=1e-3,
                              atol=1e-4 * max(float(np.abs(want).max()), 1e-2 * gscale))
                  if is_grad else np.allclose(got, want, rtol=1e-5,
                                              atol=1e-5 * max(1.0, float(np.abs(want).max()))))
            check(ok, f"tiny teacher training {key} differs from the golden: max abs diff {diff}")
            worst = max(worst, diff) if is_grad else worst
        else:
            got = float((tout["loss"] if key == "loss" else tout["tb_dict"][key[3:]]).detach())
            check(close_scalar(got, float(want)),
                  f"tiny teacher training {key} {got} differs from the golden {float(want)}")
    print(f"teacher training reference: tiny loss {float(tout['loss'].detach()):.6f} (golden "
          f"{float(gold['loss']):.6f}), {len(params)} gradients, max abs diff {worst:.3g}; "
          f"statistics counted {tout['statistic_counts'].tolist()} points a class")
    del tmodel, tout, params, tstate

    _, model, opt = build_trainer(tcfg_file, dev, seed=0, n_points=MAIN_POINTS,
                                  total_steps=TEACHER_TRAIN_ITERS + 1)
    # the confidence prior -log 99 scores every point near 0.01, under the
    # statistic update's 0.3: layer 1's bias as the tiny checks set it, so
    # that the update counts points from the first step
    with torch.no_grad():
        model.module_list[0].sa1.confidence_out.bias.copy_(
            torch.tensor(tiny.TEACHER_CONF_BIAS, device=dev))
    tbatches = [synth_train_batch(MAIN_BATCH, MAIN_POINTS, seed=s, device=dev)
                for s in range(TEACHER_TRAIN_ITERS + 1)]
    head = model.module_list[1].head
    stats0 = [getattr(head, b).clone() for b in STATISTIC_NAMES]
    rec = record_kernels(KITTI_KERNELS)
    opt.zero_grad(set_to_none=True)
    out = model(dict(tbatches[0]))
    out["loss"].backward()
    torch.cuda.synchronize()
    rec.restore()
    for n, p in model.named_parameters():
        check(p.grad is not None, f"teacher parameter {n} got no gradient")
        if p.dim() == 3:
            check(bool(p.grad.abs().sum() > 0), f"sparse-conv weight {n} got a zero gradient")
    opt.step()
    check(bool(torch.isfinite(out["loss"])), "teacher warm-up step loss is not finite")
    counts = out["statistic_counts"].tolist()
    check(any(counts), f"the statistic update counted no point: {counts}")
    for b, before in zip(STATISTIC_NAMES, stats0):
        check(not torch.equal(getattr(head, b), before), f"teacher statistic {b} did not change")
    for name, calls in rec.calls.items():
        check(len(calls) > 0, f"the teacher training capture step made no {name} call")
    print(f"teacher training capture: loss {float(out['loss'].detach()):.4f}, "
          + ", ".join(f"{k} {float(torch.as_tensor(v).detach()):.4f}"
                      for k, v in out["tb_dict"].items())
          + f"; statistic update counted {counts} points (class 0, 1, 2)")
    k5 = sorted({(c[0].shape[-1], c[3].shape[-1], c[3].shape[0])
                 for c in rec.calls["spconv_bykey_bwd"]})
    print(f"teacher training capture: K5 (Cin, Cout, K) {k5}")
    del out
    report_train = compare_recorded(rec.calls, "teacher train")
    del rec
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    steps = [train_step(model, opt, b) for b in tbatches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_train = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [loss for loss, _ in steps]
    for i, loss in enumerate(losses):
        check(bool(torch.isfinite(loss)), f"teacher training step {i} loss is not finite")
    unmoved = still_params(model, before, "teacher")
    for name in KITTI_KERNELS:
        check(launches_train[name] > 0,
              f"kernel {name} was not launched on the teacher training path")
    print(f"teacher training main path: {TEACHER_TRAIN_ITERS} steps x {MAIN_BATCH} scans x "
          f"{MAIN_POINTS} points in {dt:.3f} s = {TEACHER_TRAIN_ITERS * MAIN_BATCH / dt:.3f} "
          f"train scans/s ({1e3 * dt / TEACHER_TRAIN_ITERS:.1f} ms/step); losses "
          f"{[round(float(v), 4) for v in losses]}; {len(before) - len(unmoved)} of "
          f"{len(before)} parameters changed, the rest {unmoved} with a zero gradient and "
          f"value; launches {launches_train}; peak memory {peak:.2f} GiB")
    del before, steps, losses, tbatches

    # ---- 21. the handoff: teacher checkpoint -> fast_cpc.yaml distillation ----
    with tempfile.TemporaryDirectory() as ckpt_dir:
        path = save_checkpoint(model, opt, ckpt_dir, 1, opt.state["count"])
        t_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model, opt
        torch.cuda.empty_cache()
        _, dmodel, dopt = build_trainer(ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml", dev,
                                        seed=0, n_points=MAIN_POINTS, total_steps=1,
                                        pretrained_model=path)
    dhead = dmodel.module_list[1]
    for b in STATISTIC_NAMES:
        check(torch.equal(getattr(dhead, b), t_state[f"module_list.1.head.{b}"]),
              f"the distillation head's {b} is not the teacher's")
    dparams = dict(dmodel.named_parameters())
    loaded = [n for n in dparams if not is_student(n)]
    for n in loaded:
        check(torch.equal(dparams[n], t_state[n]), f"teacher parameter {n} was not loaded")
    student0 = {n: p.detach().clone() for n, p in dparams.items() if is_student(n)}
    dbatch = synth_train_batch(MAIN_BATCH, MAIN_POINTS, seed=0, device=dev)
    loss, _ = train_step(dmodel, dopt, dbatch)
    check(bool(torch.isfinite(loss)), "the distillation step's loss is not finite")
    for n in loaded:
        check(torch.equal(dparams[n], t_state[n]), f"teacher parameter {n} changed")
    unmoved = still_params(dmodel, student0, "student")
    print(f"handoff: teacher checkpoint -> fast_cpc.yaml trainer: statistics equal, "
          f"{len(loaded)} teacher parameters bit-equal before and after one distillation "
          f"step (loss {float(loss):.4f}), {len(student0) - len(unmoved)} of "
          f"{len(student0)} student parameters moved, the rest {unmoved} with a zero "
          f"gradient and value")
    del dmodel, dopt, dparams, t_state, student0, dbatch
    torch.cuda.empty_cache()
    return report_eval, launches_eval, report_train, launches_train


def echo_gt_annos(infos):
    """The val infos' annos of the three classes as detections, at distinct
    scores (the 41-point sweep steps through the true positives' scores)."""
    rng = np.random.RandomState(0)
    dets = []
    for info in infos:
        a = info["annos"]
        keep = np.isin(a["name"], ["Car", "Pedestrian", "Cyclist"])
        dets.append({k: a[k][keep] for k in ("name", "truncated", "occluded", "alpha", "bbox",
                                              "dimensions", "location", "rotation_y")}
                    | {"score": rng.uniform(0.5, 1.0, int(keep.sum()))})
    return dets


def kitti_data_phases(dev):
    """Phases 22-24: the KITTI data path on a synthetic root. Returns the
    per-kernel reports of phases 23 and 24, the launch counts of their
    counted runs, a function that profiles one eval batch (to be called
    after every timed path: see Deferred) and removes the root, and the
    root (phases 28-30 run on it)."""
    import logging
    import pickle
    import tempfile

    import torch

    from tsm_det_pointcloud_tpu_torch import evaluate, train
    from tsm_det_pointcloud_tpu_torch.datasets import (build_dataloader, load_batch,
                                                       load_data_to_device, to_torch_batch)
    from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
    from tsm_det_pointcloud_tpu_torch.datasets.kitti.synthetic import write_synthetic_kitti
    from tsm_det_pointcloud_tpu_torch.eval.kitti_eval import get_official_eval_result
    from tsm_det_pointcloud_tpu_torch.infer import (detect, load_cfg, profile_call,
                                                    randomize_eval_state)
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime import eval_utils, train_loop

    cfg_file = ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"
    cfg = load_cfg(cfg_file)
    classes = list(cfg.CLASS_NAMES)
    batch = KITTI_BATCH
    logger = logging.getLogger("chip_smoke.kitti")
    logger.setLevel(logging.WARNING)
    tmp = tempfile.TemporaryDirectory()
    root, out = Path(tmp.name) / "kitti", Path(tmp.name) / "out"

    # ---- 22. a synthetic KITTI root, then its infos and gt database ----
    t0 = time.perf_counter()
    write_synthetic_kitti(root, KITTI_TRAIN, KITTI_VAL, KITTI_SCAN_POINTS)
    t1 = time.perf_counter()
    create_kitti_infos(cfg.DATA_CONFIG, classes, root, root, workers=8)
    t2 = time.perf_counter()
    with open(root / "kitti_infos_val.pkl", "rb") as f:
        val_infos = pickle.load(f)
    with open(root / "kitti_dbinfos_train.pkl", "rb") as f:
        db = pickle.load(f)
    check(len(val_infos) == KITTI_VAL, f"{len(val_infos)} val infos")
    check(all(len(db.get(c, [])) > 0 for c in classes), f"gt database {sorted(db)}")
    _, echo = get_official_eval_result([i["annos"] for i in val_infos],
                                       echo_gt_annos(val_infos), classes)
    check(len(echo) == 72 and all(abs(v - 100.0) < 1e-6 for v in echo.values()),
          f"echoed gt does not score 100: {echo}")
    print(f"kitti data: {KITTI_TRAIN} + {KITTI_VAL} frames of {KITTI_SCAN_POINTS} points "
          f"written in {t1 - t0:.3f} s, infos and gt database in {t2 - t1:.3f} s "
          f"({ {c: len(v) for c, v in db.items()} } gt objects); echoed val gt scores 100.0 "
          f"on all {len(echo)} APs")

    # ---- 23. fast_cpc.yaml eval over the val split through eval_one_ckpt ----
    test_set, test_loader, sampler = build_dataloader(
        cfg.DATA_CONFIG, classes, batch, root_path=root, workers=KITTI_WORKERS,
        training=False, pin_memory=True)
    test_loader.start()   # the workers start during the comparisons below
    model = build_network(cfg.MODEL, len(classes), test_set, device=dev, seed=0)
    randomize_eval_state(model, 1)
    first = load_data_to_device(
        to_torch_batch(load_batch(test_set, sampler.batches()[0], 0, 0)), dev)
    n_pts = first["points"].shape[1]
    rec = record_kernels(KITTI_DATA_EVAL_KERNELS)
    detect(model, first["points"], first["points_mask"])
    torch.cuda.synchronize()
    rec.restore()
    for name, calls in rec.calls.items():
        check(len(calls) > 0, f"the KITTI data eval batch made no {name} call")
    print(f"kitti data eval: one batch {tuple(first['points'].shape)}, d-fps {n_pts} -> "
          f"{cfg.MODEL.BACKBONE_3D.S_SA_CONFIG.NPOINT_LIST[0][0]} on K6 (over K1's 16384)")
    report_eval = compare_recorded(rec.calls, "kitti data eval")
    del rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    res = eval_utils.eval_one_ckpt(model, test_loader, test_set, cfg, logger, out / "eval")
    launches_eval = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in KITTI_DATA_EVAL_KERNELS:
        check(launches_eval[name] > 0,
              f"kernel {name} was not launched on the KITTI data eval path")
    with open(out / "eval" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    check(len(annos) == KITTI_VAL, f"{len(annos)} prediction dicts for {KITTI_VAL} frames")
    for a in annos:
        check(np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all(),
              f"frame {a['frame_id']}: non-finite predictions")
    aps = {k: float(v) for k, v in res.items() if "/" in k}
    check(len(aps) == 72 and all(np.isfinite(v) for v in aps.values()), f"AP dict {aps}")
    print(f"kitti data eval main path: {KITTI_VAL} scans ({len(test_loader)} batches, the "
          f"last of {KITTI_VAL % batch or batch}) x {n_pts} points: {res['scans_per_s']:.3f} "
          f"scans/s (host clock, loader included, {KITTI_WORKERS} workers), sec_per_example "
          f"{res['sec_per_example']:.4f}, loader wait {res['loader_first_wait_s']:.4f} s for "
          f"the first batch, {res['loader_wait_s']:.4f} s for each later one; "
          f"detections per scan {[len(a['name']) for a in annos[:batch]]}; launches "
          f"{launches_eval}; peak memory {peak:.2f} GiB")
    print(f"kitti data eval AP dict: {json.dumps(aps)}")
    del test_loader

    # ---- 24. train --data_root, 2 epochs, the first step recorded; evaluate --ckpt ----
    torch.cuda.synchronize()
    _kernels.reset_launches()
    with first_call_recorded(train_loop, "train_step", KITTI_KERNELS) as step0:
        ckpt_dir, epochs = train.main([
            "--cfg_file", str(cfg_file), "--data_root", str(root), "--epochs",
            str(KITTI_EPOCHS), "--workers", str(KITTI_WORKERS), "--batch", str(batch),
            "--output_dir", str(out / "train"), "--device", str(dev)])
    launches_train = dict(_kernels.LAUNCHES)
    for name in KITTI_KERNELS:
        check(launches_train[name] > 0,
              f"kernel {name} was not launched on the KITTI data training path")
    for i, e in enumerate(epochs):
        check(np.isfinite(e["mean_loss"]), f"epoch {i + 1}: mean loss {e['mean_loss']}")
    rec = step0[0][0]
    for name, calls in rec.calls.items():
        check(len(calls) > 0, f"the KITTI data training step made no {name} call")
    last = epochs[-1]
    print(f"kitti data training main path: {KITTI_EPOCHS} epochs of {last['steps']} steps x "
          f"{batch} scans, {KITTI_WORKERS} workers, the config's augmentors: epoch 1 (its "
          f"first step recorded) {epochs[0]['scans_per_s']:.3f}, epoch {KITTI_EPOCHS} "
          f"{last['scans_per_s']:.3f} train scans/s (host clock, loader included); loader "
          f"wait {epochs[0]['loader_first_wait_s']:.4f} s for the first step, "
          f"{last['loader_wait_s'] / max(last['steps'] - 1, 1):.4f} s for each later one of "
          f"epoch {KITTI_EPOCHS}; mean losses "
          f"{[round(e['mean_loss'], 4) for e in epochs]}; launches {launches_train}; peak "
          f"memory {max(e["peak_gib"] or 0.0 for e in epochs):.2f} GiB")
    report_train = compare_recorded(rec.calls, "kitti data train")
    del rec, step0[:]
    ckpt = ckpt_dir / f"checkpoint_epoch_{KITTI_EPOCHS}.pth"
    check(ckpt.exists(), f"no checkpoint {ckpt}")
    eres = evaluate.main(["--cfg_file", str(cfg_file), "--data_root", str(root), "--ckpt",
                          str(ckpt), "--workers", str(KITTI_WORKERS), "--batch_size",
                          str(batch), "--output_dir", str(out / "train"), "--device", str(dev)])
    check(all(f"{c}_3d/{d}_R40" in eres for c in classes for d in ("easy", "moderate", "hard")),
          f"evaluate --ckpt gave no AP dict: {sorted(eres)}")
    print(f"kitti data evaluate --ckpt {ckpt.name}: {eres['scans_per_s']:.3f} scans/s, "
          f"Car_3d/moderate_R40 {float(eres['Car_3d/moderate_R40']):.4f}")

    def profile_eval_batch():
        print("kitti data eval: one profiled batch (forward + NMS)")
        wall, busy = profile_call(lambda: detect(model, first["points"], first["points_mask"]),
                                  top=10)
        print(f"kitti data eval: device idle share of a profiled batch "
              f"{100 - 100 * busy / wall:.1f}% ({busy:.3f} of {wall:.3f} ms busy)")
        tmp.cleanup()

    return report_eval, launches_eval, report_train, launches_train, profile_eval_batch, root


def echo_waymo_dets(infos):
    """The val infos' gt of the three classes as detections, at distinct
    scores."""
    rng = np.random.RandomState(0)
    dets = []
    for info in infos:
        a = info["annos"]
        keep = np.isin(a["name"], WAYMO_DATA_CLASSES)
        dets.append({"name": a["name"][keep].astype(object),
                     "boxes_lidar": a["gt_boxes_lidar"][keep],
                     "score": rng.uniform(0.5, 1.0, int(keep.sum()))})
    return dets


def waymo_data_phases(dev):
    """Phases 25-27: the Waymo data path on a synthetic root. Returns the
    per-kernel reports of phases 26 and 27, the launch counts of their
    counted runs, the plain-version notes of each, and a function that
    profiles one eval batch (to be called after every timed path: see
    Deferred)."""
    import logging
    import pickle
    import tempfile

    import torch

    from tsm_det_pointcloud_tpu_torch import evaluate, train
    from tsm_det_pointcloud_tpu_torch.datasets import (build_dataloader, load_batch,
                                                       load_data_to_device, to_torch_batch)
    from tsm_det_pointcloud_tpu_torch.datasets.waymo.synthetic import write_synthetic_waymo
    from tsm_det_pointcloud_tpu_torch.datasets.waymo.waymo_dataset import create_waymo_infos
    from tsm_det_pointcloud_tpu_torch.eval.waymo_eval import waymo_evaluation
    from tsm_det_pointcloud_tpu_torch.infer import (detect, load_cfg, profile_call,
                                                    randomize_eval_state)
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime import eval_utils, train_loop

    cfg_file = ROOT / "tools/cfgs/waymo_models/waymo_fast_cpc.yaml"
    # 2 training steps of b8 from 16 train frames: every frame, not every 5th
    overrides = ["DATA_CONFIG.SAMPLED_INTERVAL.train", "1"]
    cfg = load_cfg(cfg_file, overrides)
    classes = list(cfg.CLASS_NAMES)
    batch = WAYMO_BATCH
    tag = cfg.DATA_CONFIG.PROCESSED_DATA_TAG
    logger = logging.getLogger("chip_smoke.waymo")
    logger.setLevel(logging.WARNING)
    tmp = tempfile.TemporaryDirectory()
    root, out = Path(tmp.name) / "waymo", Path(tmp.name) / "out"

    # ---- 25. a synthetic Waymo root of tfrecords, then its infos and gt database ----
    t0 = time.perf_counter()
    write_synthetic_waymo(root, WAYMO_TRAIN_SEQ, WAYMO_VAL_SEQ, WAYMO_SEQ_FRAMES,
                          workers=WAYMO_PREP_WORKERS)
    t1 = time.perf_counter()
    create_waymo_infos(cfg.DATA_CONFIG, classes, root, root, processed_data_tag=tag,
                       workers=WAYMO_PREP_WORKERS)
    t2 = time.perf_counter()
    n_val = WAYMO_VAL_SEQ * WAYMO_SEQ_FRAMES
    with open(root / f"{tag}_infos_val.pkl", "rb") as f:
        val_infos = pickle.load(f)
    with open(root / "pcdet_waymo_dbinfos_train_sampled_1.pkl", "rb") as f:
        db = pickle.load(f)
    check(len(val_infos) == n_val, f"{len(val_infos)} val infos")
    check(all(len(db.get(c, [])) > 0 for c in classes), f"gt database {sorted(db)}")
    frame_pts = [len(np.load(root / tag / i["point_cloud"]["lidar_sequence"]
                             / ("%04d.npy" % i["point_cloud"]["sample_idx"])))
                 for i in val_infos[:2]]
    _, echo = waymo_evaluation([i["annos"] for i in val_infos], echo_waymo_dets(val_infos),
                               tuple(classes))
    check(len(echo) == 12 and all(abs(v - 100.0) < 1e-6 for v in echo.values()),
          f"echoed gt does not score 100: {echo}")
    print(f"waymo data: {WAYMO_TRAIN_SEQ} + {WAYMO_VAL_SEQ} sequences of {WAYMO_SEQ_FRAMES} "
          f"frames written as tfrecords in {t1 - t0:.3f} s ({WAYMO_PREP_WORKERS} processes), "
          f"create_waymo_infos (npy frames, infos, gt database, "
          f"pcdet_waymo_dbinfos_train_sampled_1.pkl) in {t2 - t1:.3f} s "
          f"({ {c: len(v) for c, v in db.items()} } gt objects; {frame_pts} points in the "
          f"first val frames); echoed val gt scores 100.0 on all {len(echo)} APs and APHs")

    # ---- 26. waymo_fast_cpc.yaml eval over the val split through eval_one_ckpt ----
    test_set, test_loader, sampler = build_dataloader(
        cfg.DATA_CONFIG, classes, batch, root_path=root, workers=WAYMO_WORKERS,
        training=False, pin_memory=True)
    test_loader.start()   # the workers start during the comparisons below
    model = build_network(cfg.MODEL, len(classes), test_set, device=dev, seed=0)
    randomize_eval_state(model, 1)
    first = load_data_to_device(
        to_torch_batch(load_batch(test_set, sampler.batches()[0], 0, 0)), dev)
    n_pts = first["points"].shape[1]
    check(n_pts == WAYMO_TEST_POINTS and bool(first["points_mask"].all()),
          f"the test scans are not {WAYMO_TEST_POINTS} sampled points")
    rec = record_kernels(WAYMO_EVAL_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    detect(model, first["points"], first["points_mask"])
    torch.cuda.synchronize()
    rec.restore()
    for name, calls in rec.calls.items():
        check(len(calls) > 0, f"the Waymo data eval batch made no {name} call")
    print(f"waymo data eval: one batch {tuple(first['points'].shape)}, d-fps {n_pts} -> "
          f"{cfg.MODEL.BACKBONE_3D.S_SA_CONFIG.NPOINT_LIST[0][0]} on K6; peak memory of the "
          f"batch {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    PLAIN_NOTES.clear()
    report_eval = compare_recorded(rec.calls, "waymo data eval")
    notes_eval = dict(PLAIN_NOTES)
    del rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    res = eval_utils.eval_one_ckpt(model, test_loader, test_set, cfg, logger, out / "eval")
    launches_eval = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name in WAYMO_EVAL_KERNELS:
        check(launches_eval[name] > 0,
              f"kernel {name} was not launched on the Waymo data eval path")
    with open(out / "eval" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    check(len(annos) == n_val, f"{len(annos)} prediction dicts for {n_val} frames")
    for a in annos:
        check(np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all(),
              f"frame {a['frame_id']}: non-finite predictions")
    aps = {k: float(v) for k, v in res.items() if "/" in k}
    check(len(aps) == 12 and all(np.isfinite(v) for v in aps.values()), f"AP dict {aps}")
    print(f"waymo data eval main path: {n_val} scans ({len(test_loader)} batches) x {n_pts} "
          f"points: {res['scans_per_s']:.3f} scans/s (host clock, loader included, "
          f"{WAYMO_WORKERS} workers), sec_per_example {res['sec_per_example']:.4f}, loader "
          f"wait {res['loader_first_wait_s']:.4f} s for the first batch, "
          f"{res['loader_wait_s']:.4f} s for each later one; detections per scan "
          f"{[len(a['name']) for a in annos[:batch]]}; launches {launches_eval}; peak memory "
          f"{peak:.2f} GiB")
    print(f"waymo data eval AP dict: {json.dumps(aps)}")
    del test_loader

    # ---- 27. train --data_root, 2 epochs, the first step recorded; evaluate --ckpt ----
    torch.cuda.synchronize()
    _kernels.reset_launches()
    with first_call_recorded(train_loop, "train_step", TSM_KERNELS) as step0:
        ckpt_dir, epochs = train.main([
            "--cfg_file", str(cfg_file), "--data_root", str(root), "--epochs",
            str(WAYMO_EPOCHS), "--workers", str(WAYMO_WORKERS), "--batch", str(batch),
            "--output_dir", str(out / "train"), "--device", str(dev), "--set", *overrides])
    launches_train = dict(_kernels.LAUNCHES)
    for name in TSM_KERNELS:
        check(launches_train[name] > 0,
              f"kernel {name} was not launched on the Waymo data training path")
    for i, e in enumerate(epochs):
        check(np.isfinite(e["mean_loss"]), f"epoch {i + 1}: mean loss {e['mean_loss']}")
    rec = step0[0][0]
    for name, calls in rec.calls.items():
        check(len(calls) > 0, f"the Waymo data training step made no {name} call")
    train_pts = rec.calls["fps_block"][0][0].shape[1]
    last = epochs[-1]
    print(f"waymo data training main path: {WAYMO_EPOCHS} epochs of {last['steps']} steps x "
          f"{batch} scans x {train_pts} points, {WAYMO_WORKERS} workers, the config's "
          f"augmentors: epoch 1 (its first step recorded) {epochs[0]['scans_per_s']:.3f}, "
          f"epoch {WAYMO_EPOCHS} {last['scans_per_s']:.3f} train scans/s (host clock, loader "
          f"included); loader wait {epochs[0]['loader_first_wait_s']:.4f} s for the first "
          f"step, {last['loader_wait_s'] / max(last['steps'] - 1, 1):.4f} s for each later one "
          f"of epoch {WAYMO_EPOCHS}; mean losses {[round(e['mean_loss'], 4) for e in epochs]}; "
          f"launches {launches_train}; peak memory "
          f"{max(e['peak_gib'] or 0.0 for e in epochs):.2f} GiB")
    PLAIN_NOTES.clear()
    report_train = compare_recorded(rec.calls, "waymo data train")
    notes_train = dict(PLAIN_NOTES)
    del rec, step0[:]
    ckpt = ckpt_dir / f"checkpoint_epoch_{WAYMO_EPOCHS}.pth"
    check(ckpt.exists(), f"no checkpoint {ckpt}")
    eres = evaluate.main(["--cfg_file", str(cfg_file), "--data_root", str(root), "--ckpt",
                          str(ckpt), "--workers", str(WAYMO_WORKERS), "--batch_size",
                          str(batch), "--output_dir", str(out / "train"), "--device", str(dev)])
    check(all(f"{c}/{m}_L{lv}" in eres and np.isfinite(eres[f"{c}/{m}_L{lv}"])
              for c in classes for m in ("AP", "APH") for lv in (1, 2)),
          f"evaluate --ckpt gave no Waymo AP dict: {sorted(eres)}")
    print(f"waymo data evaluate --ckpt {ckpt.name}: {eres['scans_per_s']:.3f} scans/s, "
          f"Vehicle/AP_L1 {float(eres['Vehicle/AP_L1']):.4f}")

    def profile_eval_batch():
        print("waymo data eval: one profiled batch (forward + NMS)")
        wall, busy = profile_call(lambda: detect(model, first["points"], first["points_mask"]),
                                  top=10)
        print(f"waymo data eval: device idle share of a profiled batch "
              f"{100 - 100 * busy / wall:.1f}% ({busy:.3f} of {wall:.3f} ms busy)")
        tmp.cleanup()

    return (report_eval, launches_eval, notes_eval, report_train, launches_train, notes_train,
            profile_eval_batch)


def run_recorded(label, entry, argv, owner, attr, names):
    """`entry.main(argv)` with the launch counts zeroed before and read after
    and the first call of owner.attr recorded (first_call_recorded).
    Returns (its result, the launch counts, the peak device memory in GiB,
    the Recorder, the first call's result); fails if a kernel of `names`
    was not launched or not called in the recorded pass."""
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    with first_call_recorded(owner, attr, names) as first:
        result = entry.main(argv)
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(first), f"{label}: no pass was recorded")
    rec, first_out = first[0]
    for name in names:
        check(launches[name] > 0, f"kernel {name} was not launched on the {label} path")
        check(len(rec.calls[name]) > 0, f"the {label} recorded pass made no {name} call")
    return result, launches, peak, rec, first_out


def check_kitti_aps(res, classes, label):
    aps = {k: float(v) for k, v in res.items() if "/" in k}
    check(all(f"{c}_3d/{d}_R40" in aps for c in classes for d in ("easy", "moderate", "hard"))
          and all(np.isfinite(v) for v in aps.values()), f"{label}: AP dict {aps}")
    return aps


def epochs_line(epochs):
    last = epochs[-1]
    for i, e in enumerate(epochs):
        check(np.isfinite(e["mean_loss"]), f"epoch {i + 1}: mean loss {e['mean_loss']}")
    return (f"{len(epochs)} epoch(s) of {last['steps']} steps: "
            f"{[round(e['scans_per_s'], 3) for e in epochs]} train scans/s (host clock, "
            f"loader included; the first epoch holds the recorded step); loader wait "
            f"{epochs[0]['loader_first_wait_s']:.4f} s for the first step, "
            f"{last['loader_wait_s'] / max(last['steps'] - 1, 1):.4f} s for each later one; "
            f"mean losses {[round(e['mean_loss'], 4) for e in epochs]}; peak memory "
            f"{max(e['peak_gib'] or 0.0 for e in epochs):.2f} GiB")


def eval_line(res):
    return (f"{res['scans_per_s']:.3f} scans/s (host clock, loader included), "
            f"sec_per_example {res['sec_per_example']:.4f}, loader wait "
            f"{res['loader_first_wait_s']:.4f} s for the first batch, "
            f"{res['loader_wait_s']:.4f} s for each later one")


def recipe_phases(dev, root):
    """Phase 28: fast_cpc_teacher.yaml's evaluate and train --data_root on the
    KITTI root of phase 22, then the student's train --data_root
    --pretrained_model on the teacher's checkpoint and its evaluate --ckpt.
    Returns the per-kernel reports and launch counts of the teacher's eval
    and training."""
    import torch

    from tsm_det_pointcloud_tpu_torch import evaluate, train
    from tsm_det_pointcloud_tpu_torch.infer import dataset_meta, load_cfg
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.models.dense_heads.point_head_vote import (
        STATISTIC_BUFFERS as STATISTIC_NAMES,
    )
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.runtime import train_loop
    from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import load_model_state
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import is_student

    teacher_cfg = ROOT / "tools/cfgs/kitti_models/fast_cpc_teacher.yaml"
    student_cfg = ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"
    classes = list(load_cfg(teacher_cfg).CLASS_NAMES)
    out = root.parent / "recipe"
    data = ["--data_root", str(root), "--workers", str(KITTI_WORKERS), "--device", str(dev)]
    batch = ["--batch", str(KITTI_BATCH)]

    # ---- 28. the teacher on the root, then the two-phase recipe ----
    res, launches_eval, peak, rec, _ = run_recorded(
        "teacher data eval", evaluate,
        ["--cfg_file", str(teacher_cfg), "--batch_size", str(KITTI_BATCH), "--output_dir",
         str(out / "teacher")] + data, detectors["3DSSD"], "forward", KITTI_DATA_EVAL_KERNELS)
    n_pts = rec.calls["fps_block"][0][0].shape[1]
    check_kitti_aps(res, classes, "teacher evaluate")
    print(f"teacher data eval (evaluate, seeded weights): {KITTI_VAL} scans x {n_pts} points "
          f"(d-fps on K6) at b{KITTI_BATCH}: {eval_line(res)}; launches {launches_eval}; "
          f"peak memory {peak:.2f} GiB")
    report_eval = compare_recorded(rec.calls, "teacher data eval")

    (t_dir, t_epochs), launches_train, _, rec, _ = run_recorded(
        "teacher data train", train,
        ["--cfg_file", str(teacher_cfg), "--epochs", "1", "--output_dir",
         str(out / "teacher")] + batch + data, train_loop, "train_step", KITTI_KERNELS)
    t_ckpt = t_dir / "checkpoint_epoch_1.pth"
    print(f"teacher data train (train --data_root): {epochs_line(t_epochs)}; launches "
          f"{launches_train}")
    report_train = compare_recorded(rec.calls, "teacher data train")

    (s_dir, s_epochs), launches, _, rec, _ = run_recorded(
        "student data train", train,
        ["--cfg_file", str(student_cfg), "--epochs", "1", "--output_dir", str(out / "student"),
         "--pretrained_model", str(t_ckpt)] + batch + data, train_loop, "train_step",
        KITTI_KERNELS)
    print(f"student data train (train --data_root --pretrained_model {t_ckpt.name}): "
          f"{epochs_line(s_epochs)}; launches {launches}")
    compare_recorded(rec.calls, "student data train")
    teacher = load_model_state(t_ckpt)
    s_ckpt = s_dir / "checkpoint_epoch_1.pth"
    student = load_model_state(s_ckpt)
    for b in STATISTIC_NAMES:
        check(torch.equal(student[f"module_list.1.{b}"], teacher[f"module_list.1.head.{b}"]),
              f"the student's {b} is not the teacher's")
    scfg = load_cfg(student_cfg)
    names = [n for n, _ in build_network(scfg.MODEL, len(classes),
                                         dataset_meta(scfg, 16384, "train"),
                                         device="cpu").named_parameters()
             if not is_student(n)]
    for n in names:
        check(torch.equal(student[n], teacher[n]), f"teacher parameter {n} changed in the "
              f"student's training")
    moved = sum(bool(teacher[f"module_list.1.head.{b}"].abs().max()) for b in STATISTIC_NAMES)
    print(f"handoff on the root: {len(names)} teacher parameters and the statistics "
          f"({moved} of {len(STATISTIC_NAMES)} buffers non-zero after the teacher's epoch) "
          f"bit-equal in the student's checkpoint after its epoch")

    res, launches, peak, rec, _ = run_recorded(
        "student data eval", evaluate,
        ["--cfg_file", str(student_cfg), "--ckpt", str(s_ckpt), "--batch_size",
         str(KITTI_BATCH), "--output_dir", str(out / "student")] + data,
        detectors["3DSSD"], "forward", KITTI_DATA_EVAL_KERNELS)
    aps = check_kitti_aps(res, classes, "student evaluate --ckpt")
    print(f"student data eval (evaluate --ckpt {s_ckpt.name}): {eval_line(res)}; launches "
          f"{launches}; peak memory {peak:.2f} GiB; Car_3d/moderate_R40 "
          f"{aps['Car_3d/moderate_R40']:.4f}")
    compare_recorded(rec.calls, "student data eval")
    return report_eval, launches_eval, report_train, launches_train


def second_data_phases(dev, root):
    """Phase 29: second.yaml's evaluate and train --data_root on the first
    SECOND_DATA_FRAMES val and train frames of the KITTI root of phase 22.
    Returns the per-kernel reports and launch counts of both."""
    import pickle

    import torch

    from tsm_det_pointcloud_tpu_torch import evaluate, train
    from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
    from tsm_det_pointcloud_tpu_torch.infer import load_cfg
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.runtime import train_loop

    cfg_file = ROOT / "tools/cfgs/kitti_models/second.yaml"
    n = SECOND_DATA_FRAMES
    for split in ("train", "val"):
        with open(root / f"kitti_infos_{split}.pkl", "rb") as f:
            infos = pickle.load(f)[:n]
        with open(root / f"kitti_infos_{split}_{n}.pkl", "wb") as f:
            pickle.dump(infos, f)
    sets = ["--set", "DATA_CONFIG.INFO_PATH.train", f"['kitti_infos_train_{n}.pkl']",
            "DATA_CONFIG.INFO_PATH.test", f"['kitti_infos_val_{n}.pkl']"]
    cfg = load_cfg(cfg_file, sets[1:])
    classes = list(cfg.CLASS_NAMES)
    test_set = KittiDataset(cfg.DATA_CONFIG, classes, training=False, root_path=root)
    in_fov = [len(test_set[i]["points"]) for i in range(n)]
    dropped = [max(k - test_set.max_points, 0) for k in in_fov]
    out = root.parent / "second"
    data = ["--data_root", str(root), "--workers", str(KITTI_WORKERS), "--device", str(dev)]

    # ---- 29. SECOND on the root ----
    res, launches_eval, peak, rec, first_out = run_recorded(
        "second data eval", evaluate,
        ["--cfg_file", str(cfg_file), "--batch_size", str(SECOND_BATCH), "--output_dir",
         str(out)] + data + sets, detectors["SECONDNet"], "forward", SECOND_KERNELS)
    voxels = first_out["voxel_mask"].sum(1).tolist()
    del first_out
    check_kitti_aps(res, classes, "SECOND evaluate")
    for name, k in SECOND_CALLS.items():
        check(len(rec.calls[name]) == k and launches_eval[name] == k * (n // SECOND_BATCH),
              f"SECOND data eval: {len(rec.calls[name])} {name} calls a forward, "
              f"{launches_eval[name]} in all")
    print(f"second data eval (evaluate, seeded weights): {n} scans at b{SECOND_BATCH}: points "
          f"in the field of view {in_fov}, dropped by the collate (MAX_POINTS "
          f"{test_set.max_points}) {dropped} (mean {np.mean(dropped):.1f} a scan); voxels a "
          f"scan of the first batch {voxels}; {eval_line(res)}; launches {launches_eval}; "
          f"peak memory {peak:.2f} GiB")
    report_eval = compare_recorded(rec.calls, "second data eval")

    (_, epochs), launches_train, _, rec, _ = run_recorded(
        "second data train", train,
        ["--cfg_file", str(cfg_file), "--epochs", "1", "--batch", str(SECOND_BATCH),
         "--output_dir", str(out)] + data + sets, train_loop, "train_step", SECOND_KERNELS)
    print(f"second data train (train --data_root): {epochs_line(epochs)}; launches "
          f"{launches_train}")
    report_train = compare_recorded(rec.calls, "second data train")
    torch.cuda.empty_cache()
    return report_eval, launches_eval, report_train, launches_train


def demo_phases(dev, root):
    """Phase 30: a synthetic reference checkpoint of a seeded full-width
    fast_cpc.yaml detector through convert_torch_ckpt, then demo --ckpt on
    DEMO_SCANS raw scans of the KITTI root of phase 22. Returns the
    per-kernel report and launch counts of the demo."""
    import torch

    from tsm_det_pointcloud_tpu_torch import convert_torch_ckpt, demo
    from tsm_det_pointcloud_tpu_torch.datasets import load_data_to_device, to_torch_batch
    from tsm_det_pointcloud_tpu_torch.infer import build_detector, detect
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import restore_checkpoint

    cfg_file = ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"
    out = root.parent / "demo"
    out.mkdir()

    # ---- 30. a reference checkpoint converted, then demo --ckpt ----
    cfg, src_model = build_detector(cfg_file, dev, seed=3, n_points=20000)
    src = {k: v.detach().cpu() for k, v in src_model.state_dict().items()}
    ref, source = convert_torch_ckpt.reference_state_dict(src, cfg.MODEL)
    torch.save({"model_state": ref, "epoch": 80, "it": 37120}, out / "reference.pth")
    report = convert_torch_ckpt.main(["--ckpt", str(out / "reference.pth"), "--cfg_file",
                                      str(cfg_file), "--out", str(out / "converted.pth")])
    check(not report["unplaced"], f"unplaced tensors {report['unplaced']}")
    conv = torch.load(out / "converted.pth", weights_only=True)["model_state"]
    tied, misplaced, equal = set(report["tied"]), [], 0
    for name, key in source.items():
        coll, path = convert_torch_ckpt.map_name(name)
        if coll is None:
            continue
        if report["placements"][coll][path] != key:
            misplaced.append(name)
        elif path not in tied:
            check(torch.equal(conv[key], src[key]), f"{name}, placed without a tie, is not "
                  f"its source {key}")
            equal += 1
    unmatched = [u for u in report["unmatched"] if not u.endswith(".num_batches_tracked")]
    print(f"reference checkpoint: {len(ref)} tensors of a seeded full-width fast_cpc.yaml "
          f"detector in OpenPCDet's layouts; converted {report['converted']}, unmatched "
          f"{len(report['unmatched'])} ({unmatched} and the BNs' num_batches_tracked), "
          f"unplaced 0, placed among more than one candidate {len(tied)}, placed without a "
          f"tie and bit-equal to the source {equal}, misplaced {len(misplaced)} {misplaced}")
    scans = out / "scans"
    scans.mkdir()
    val_ids = (root / "ImageSets" / "val.txt").read_text().split()[:DEMO_SCANS]
    for sid in val_ids:
        shutil.copy(root / "training" / "velodyne" / f"{sid}.bin", scans / f"{sid}.bin")
    if not misplaced:
        lost = {source[u] for u in unmatched}
        for key, t in conv.items():
            check(key in lost or torch.equal(t, src[key]), f"converted {key} is not its source")
        conv_model = build_detector(cfg_file, dev, seed=0, n_points=20000)[1]
        restore_checkpoint(out / "converted.pth", conv_model)
        scan = demo.DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, scans)
        batch = load_data_to_device(to_torch_batch(scan.collate(scan[0])), dev)
        (o_src, p_src), (o_conv, p_conv) = (detect(m, batch["points"], batch["points_mask"])
                                            for m in (src_model, conv_model))
        diff = max(float((o_src[k] - o_conv[k]).abs().max())
                   for k in ("batch_cls_preds", "batch_box_preds"))
        print(f"reference checkpoint: every converted entry equals its source, so the "
              f"converted model is the source's on the eval path (only {unmatched} differ, "
              f"not on it); one scan's forward: max abs difference {diff:g}, detections "
              f"{int(p_src['count'][0])} / {int(p_conv['count'][0])}")
        del conv_model, o_src, o_conv, p_src, p_conv
    del src_model, conv
    torch.cuda.empty_cache()

    (preds, rate), launches, peak, rec, _ = run_recorded(
        "demo", demo, ["--cfg_file", str(cfg_file), "--data_path", str(scans), "--ckpt",
                       str(out / "converted.pth"), "--device", str(dev)],
        detectors["3DSSD"], "forward", KITTI_DATA_EVAL_KERNELS)
    post_max = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    check(len(preds) == DEMO_SCANS, f"demo detected on {len(preds)} scans")
    for p in preds:
        check(len(p["pred_labels"]) <= post_max and np.isfinite(p["pred_boxes"]).all()
              and np.isfinite(p["pred_scores"]).all(), "demo: bad detections")
    n_pts = rec.calls["fps_block"][0][0].shape[1]
    print(f"demo --ckpt converted.pth: {DEMO_SCANS} raw scans of {KITTI_SCAN_POINTS} points "
          f"over 360 degrees, {n_pts} sampled a scan (d-fps on K6): detections a scan "
          f"{[len(p['pred_labels']) for p in preds]}; {rate:.3f} scans/s (host clock, a scan a "
          f"batch, loading included); launches {launches}; peak memory {peak:.2f} GiB")
    report_demo = compare_recorded(rec.calls, "demo")
    return report_demo, launches


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the card")
    sys.path.insert(0, str(ROOT))
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, synth_points,
                                                    synth_waymo)
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
    rec = record_kernels(KITTI_KERNELS)
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
    for name in KITTI_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the training path")
    print(f"training main path: {TRAIN_ITERS} steps x {MAIN_BATCH} scans x {MAIN_POINTS} "
          f"points in {dt:.3f} s = {TRAIN_ITERS * MAIN_BATCH / dt:.3f} train scans/s "
          f"({1e3 * dt / TRAIN_ITERS:.1f} ms/step); losses "
          f"{[round(float(l), 4) for l in losses]}; {n_student} student tensors changed, "
          f"teacher unchanged; launches {launches}; peak memory {peak:.2f} GiB")

    del tr_model, opt, tbatches, before, losses
    torch.cuda.empty_cache()

    # ---- 9. capture the Waymo eval forward's kernel calls ----
    wcfg_file = ROOT / "tools/cfgs/waymo_models/waymo_fast_cpc.yaml"
    wcfg, wmodel = build_detector(wcfg_file, dev, seed=0, n_points=WAYMO_POINTS)
    wpost_max = int(wcfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    wlo, whi = wcfg.MODEL.POINT_HEAD.SAMPLE_RANGE
    wbatches = [torch.from_numpy(synth_waymo(WAYMO_BATCH, WAYMO_POINTS, seed=s)).to(dev)
                for s in range(WAYMO_ITERS)]
    wmask = torch.ones((WAYMO_BATCH, WAYMO_POINTS), dtype=torch.bool, device=dev)
    rec = record_kernels(WAYMO_EVAL_KERNELS)
    detect(wmodel, wbatches[0], wmask)
    torch.cuda.synchronize()
    rec.restore()
    for name, calls in rec.calls.items():
        check(len(calls) > 0, f"the Waymo capture forward made no {name} call")

    # ---- 10. each kernel against its plain version at Waymo shapes ----
    PLAIN_NOTES.clear()
    report_waymo = compare_recorded(rec.calls, "waymo")
    notes_waymo = dict(PLAIN_NOTES)
    # K6 again on a mask that empties whole Morton blocks (x <= 0 beyond the
    # first 40000 points), a whole scan, and all but 100 points of another
    xyz = rec.calls["fps_block"][0][0]
    hard = torch.ones_like(wmask)
    hard[:, 40000:] = xyz[:, 40000:, 0] > 0
    hard[1] = False
    hard[2, 100:] = False
    compare_fps_block((xyz, rec.calls["fps_block"][0][1], hard))
    print("waymo fps_block: masked input (empty blocks, an empty scan, a 100-point "
          "scan) index-equal to the plain FPS")
    # K6 at waymo_fast_cpc.yaml's 163840 test points a row (a cluster of 16
    # CTAs), on the clustered scans and on the same kind of mask
    xyz = torch.from_numpy(np.ascontiguousarray(
        synth_waymo(WAYMO_BATCH, WAYMO_TEST_POINTS, seed=7)[..., :3])).to(dev)
    compare_recorded({"fps_block": [(xyz, rec.calls["fps_block"][0][1], None)]},
                     f"waymo fps_block at {WAYMO_TEST_POINTS}")
    hard = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    hard[:, 40000:] = xyz[:, 40000:, 0] > 0
    hard[1] = False
    hard[2, 100:] = False
    compare_fps_block((xyz, rec.calls["fps_block"][0][1], hard))
    print(f"waymo fps_block at {WAYMO_TEST_POINTS}: clustered and masked inputs index-equal "
          f"to the plain FPS")
    del rec, xyz, hard

    # ---- 11. the Waymo main path, counted ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    preds = [detect(wmodel, pts, wmask) for pts in wbatches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_waymo = dict(_kernels.LAUNCHES)
    for out, pred in preds:
        for key in ("batch_cls_preds", "batch_box_preds"):
            check(bool(torch.isfinite(out[key]).all()), f"Waymo: non-finite {key}")
        check(tuple(out["batch_box_preds"].shape) == (WAYMO_BATCH, whi - wlo, 7),
              f"Waymo box preds shape {tuple(out['batch_box_preds'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"Waymo: non-finite {key}")
        check(bool((pred["count"] <= wpost_max).all()), "Waymo: count > NMS_POST_MAXSIZE")
    counts = [int(c) for c in preds[-1][1]["count"]]
    for name in WAYMO_EVAL_KERNELS:
        check(launches_waymo[name] > 0,
              f"kernel {name} was not launched on the Waymo eval path")
    print(f"Waymo main path: {WAYMO_ITERS} batches x {WAYMO_BATCH} scans x {WAYMO_POINTS} "
          f"points in {dt:.3f} s = {WAYMO_ITERS * WAYMO_BATCH / dt:.3f} scans/s; "
          f"detections per scan (last batch) {counts}; launches {launches_waymo}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del wmodel, preds, wbatches, out, pred
    torch.cuda.empty_cache()

    # ---- 12. the Waymo training step, counted ----
    _, wtr_model, wopt = build_trainer(wcfg_file, dev, seed=0, n_points=WAYMO_POINTS,
                                       total_steps=WAYMO_TRAIN_ITERS + 1)
    wmeta = wtr_model.dataset_meta
    wtbatches = [synth_train_batch(WAYMO_BATCH, WAYMO_POINTS, s, dev,
                                   wmeta.point_cloud_range, wmeta.num_point_features)
                 for s in range(WAYMO_TRAIN_ITERS + 1)]
    rec = record_kernels(TSM_KERNELS)
    warm_loss, _ = train_step(wtr_model, wopt, wtbatches[0])   # warm-up
    torch.cuda.synchronize()
    rec.restore()
    check(bool(torch.isfinite(warm_loss)), "Waymo warm-up step loss is not finite")
    for name, calls in rec.calls.items():
        check(len(calls) > 0, f"the Waymo warm-up step made no {name} call")
    # every kernel call of the step against its plain version, at this
    # path's shapes (the teacher's sa1 and U-Net, every conv's backward)
    PLAIN_NOTES.clear()
    report_wtrain = compare_recorded(rec.calls, "waymo train")
    notes_wtrain = dict(PLAIN_NOTES)
    del rec
    before = {n: p.detach().clone() for n, p in wtr_model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [train_step(wtr_model, wopt, b)[0] for b in wtbatches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_wtrain = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, l in enumerate(losses):
        check(bool(torch.isfinite(l)), f"Waymo training step {i} loss is not finite")
    n_student = 0
    for n, p in wtr_model.named_parameters():
        if is_student(n):
            n_student += 1
            check(not torch.equal(p, before[n]), f"Waymo: student parameter {n} did not change")
        else:
            check(torch.equal(p, before[n]), f"Waymo: teacher parameter {n} changed")
    for name in TSM_KERNELS:
        check(launches_wtrain[name] > 0,
              f"kernel {name} was not launched on the Waymo training path")
    print(f"Waymo training main path: {WAYMO_TRAIN_ITERS} steps x {WAYMO_BATCH} scans x "
          f"{WAYMO_POINTS} points in {dt:.3f} s = "
          f"{WAYMO_TRAIN_ITERS * WAYMO_BATCH / dt:.3f} train scans/s "
          f"({1e3 * dt / WAYMO_TRAIN_ITERS:.1f} ms/step); losses "
          f"{[round(float(l), 4) for l in losses]}; {n_student} student tensors changed, "
          f"teacher unchanged; launches {launches_wtrain}; peak memory {peak:.2f} GiB")
    del wtr_model, wopt, wtbatches, before, losses
    torch.cuda.empty_cache()

    report_second, launches_second = second_phases(dev)
    report_strain, launches_strain = second_train_phases(dev)
    report_teval, launches_teval, report_ttrain, launches_ttrain = teacher_phases(dev)
    (report_kdata, launches_kdata, report_kdtrain, launches_kdtrain, profile_kdata,
     kitti_root) = kitti_data_phases(dev)
    (report_wdata, launches_wdata, notes_wdata, report_wdtrain, launches_wdtrain,
     notes_wdtrain, profile_wdata) = waymo_data_phases(dev)
    report_tdata, launches_tdata, report_tdtrain, launches_tdtrain = recipe_phases(
        dev, kitti_root)
    report_sdata, launches_sdata, report_sdtrain, launches_sdtrain = second_data_phases(
        dev, kitti_root)
    report_demo, launches_demo = demo_phases(dev, kitti_root)
    take_device_times({"eval": report_eval, "train": report, "waymo": report_waymo,
                       "waymo train": report_wtrain, "second": report_second,
                       "second train": report_strain, "teacher eval": report_teval,
                       "teacher train": report_ttrain, "kitti data eval": report_kdata,
                       "kitti data train": report_kdtrain, "waymo data eval": report_wdata,
                       "waymo data train": report_wdtrain, "teacher data eval": report_tdata,
                       "teacher data train": report_tdtrain, "second data eval": report_sdata,
                       "second data train": report_sdtrain, "demo": report_demo})
    profile_kdata()
    profile_wdata()
    from tsm_det_pointcloud_tpu_torch.datasets import stop_workers
    started = descendants()
    stop_workers()
    left = running(started)
    check(not left, f"processes still running after the loaders were stopped: {left}")
    print(f"stopped the {len(started)} processes the run had left (loader workers, "
          f"fork server, resource tracker); none still runs")

    def numbers(a, n):
        return {"launches": n, "max_abs_err": a["err"], "ms": a["ms"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound"],
                "bound_by": a["bound_by"], "library_ms": a["lib_ms"],
                **{k: a[k] for k in EXTRA_KEYS if k in a}}

    rows = []
    for name, (src, replaces) in KERNELS.items():
        waymo = ({**numbers(report_waymo[name], launches_waymo[name]),
                  "plain_note": notes_waymo.get(name)}
                 if name in report_waymo else None)
        waymo_train = ({**numbers(report_wtrain[name], launches_wtrain[name]),
                        "plain_note": notes_wtrain.get(name)}
                       if name in report_wtrain else None)
        second = (numbers(report_second[name], launches_second[name])
                  if name in report_second else None)
        second_train = (numbers(report_strain[name], launches_strain[name])
                        if name in report_strain else None)
        teacher = (numbers(report_teval[name], launches_teval[name])
                   if name in report_teval else None)
        teacher_train = (numbers(report_ttrain[name], launches_ttrain[name])
                         if name in report_ttrain else None)
        kitti_data = (numbers(report_kdata[name], launches_kdata[name])
                      if name in report_kdata else None)
        kitti_data_train = (numbers(report_kdtrain[name], launches_kdtrain[name])
                            if name in report_kdtrain else None)
        waymo_data = ({**numbers(report_wdata[name], launches_wdata[name]),
                       "plain_note": notes_wdata.get(name)}
                      if name in report_wdata else None)
        waymo_data_train = ({**numbers(report_wdtrain[name], launches_wdtrain[name]),
                             "plain_note": notes_wdtrain.get(name)}
                            if name in report_wdtrain else None)
        new_paths = {
            key: (numbers(rep[name], lau[name]) if name in rep else None)
            for key, rep, lau in (("teacher_data", report_tdata, launches_tdata),
                                  ("teacher_data_train", report_tdtrain, launches_tdtrain),
                                  ("second_data", report_sdata, launches_sdata),
                                  ("second_data_train", report_sdtrain, launches_sdtrain),
                                  ("demo", report_demo, launches_demo))}
        if name in report:
            own, path = numbers(report[name], launches[name]), "kitti_train"
        elif waymo is not None:
            own, path = waymo, "waymo_eval"
        else:
            own, path = second, "second_eval"
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "path": path, **own,
            "eval": (numbers(report_eval[name], launches_eval[name])
                     if name in report_eval else None),
            "waymo": waymo, "waymo_train": waymo_train, "second": second,
            "second_train": second_train, "teacher": teacher, "teacher_train": teacher_train,
            "kitti_data": kitti_data, "kitti_data_train": kitti_data_train,
            "waymo_data": waymo_data, "waymo_data_train": waymo_data_train, **new_paths,
        })
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s, the kernels' "
          f"build included")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
