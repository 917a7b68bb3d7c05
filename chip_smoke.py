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
     events around a host loop of launches, with the bound from the inputs
     (the plain versions of K1, K2 and K6, tenths of a second to seconds a
     call, on the comparison's own run: one run, no warm-up).
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
     Every such device time is taken at the end, after phase 16 (a
     profiler window slows the host's later launches, and no path is timed
     after one), a pass's calls one after another in one window. K1's log line gives its plan (cluster size,
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
     its plain version (seconds a call) is timed on the comparison's run,
     without a warm-up. K6 also prints its plan (cluster size,
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
     scan, scans/s and peak memory;
 31. data-parallel training: fast_cpc.yaml's `train --launcher pytorch
     --data_root` on phase 22's root as 2 ranks (fresh spawned processes,
     gloo: NCCL takes one rank a card), b8 each, one epoch of 3 steps from
     phase 28's teacher checkpoint (--pretrained_model), each rank's first
     step recorded and every K1-K5 call held against its plain version
     (rank 0, then rank 1, so that no other rank shares the card while one
     times); after every step the parameters, BN running statistics and
     class statistics bit-equal across the ranks, and the reduced gradients
     of step 1 too; step 1's loss and tb terms (the ranks' mean) against
     the same step in this process at b16 on the same 16 samples (as phase
     7), in the loader's order and in the ranks' (rank 0's samples, then
     rank 1's, every BN's sums taken over each half and added, as the
     all-reduce adds them: `halves_stats`); prints how far the student
     gradients lie from both (relative L2 over all of them, and the tensors
     past the per-tensor tolerance below) and how far the one process's own
     move when only its summation order changes: the fast_cpc step
     amplifies the last bits of its BN sums past any such tolerance, so its
     gradients are figures, not a check; the tiny TSM's step,
     which the ranks take in their process group before the epoch, at b2 a
     rank against b4 in this process,
     every student gradient at rtol 1e-3 with atol 1e-4 * max(max|g| of the
     tensor, 1e-2 * the largest). Prints the
     ranks' and the process's train scans/s (no speed-up figure: the ranks
     share the SMs) and each rank's peak memory;
 32. NCCL at world size 1: `train --launcher pytorch` (WORLD_SIZE=1, NCCL)
     for 2 steps on phase 29's 12 train frames, then `evaluate --ckpt` on
     one batch of its 12 val frames, and the same with --launcher none,
     each a fresh process with deterministic algorithms on: losses, every
     state tensor and every detection bit-equal;
 33. sharded eval: `evaluate --launcher pytorch` on phase 31's checkpoint
     as 2 ranks over gloo at b8 each on the val split (the ranks then run
     phase 34's jobs in turn, each job in a process group of its own on a
     port of its own: one spawn for the three); rank 0's merged
     result.pkl (frame order, boxes, scores, names), its 72 APs and its
     summed recall lines equal those of one `evaluate` in this process at
     b8;
 34. point axis: waymo_fast_cpc.yaml's `evaluate --launcher pytorch
     --point_axis 2` on every 2nd val frame of phase 25's root (one batch)
     as 2 ranks over gloo, b8 x 163840
     (81920 points a scan a rank: d-fps on K6 a segment), the first forward
     recorded and every K1-K4 / K6 call held against its plain version;
     layer 0's picks equal `segment_local_fps_plain` on the whole cloud, the
     ranks' batch_box_preds bit-equal (the entry points run the point axis
     with deterministic algorithms on the card), the AP dict finite; then
     `train --point_axis 2` for one step at b2 x 120000: loss
     finite, K1-K6 launched, the ranks' parameters and buffers bit-equal
     after it (the train loop's check). Its gradients are held on the CPU
     (tests/test_torch_point_sharding.py).
 35. zoo reference: the tiny PointPillars (tiny.py, the JAX package's
     converted PRNGKey(0) init in tsm_det_pointcloud_tpu_torch/data/
     pointpillar_tiny_state.npz) reproduces tests/goldens/pointpillar_forward.npz
     and the tiny CenterPoint (tiny.centerpoint_eval_state()) reproduces
     tsm_det_pointcloud_tpu_torch/data/centerpoint_tiny_forward.npz on the card
     (golden tolerance; labels and counts exact);
 36. pointpillar.yaml at full width on synthetic scans (seeded weights and
     eval state as infer.build_detector makes them): a warm-up batch, then 3
     counted eval batches of forward + class-agnostic NMS at b16 x 20000
     (40000 pillars of 32 points, 321,408 anchors a scan); prints scans/s,
     peak memory, the pillars a scan, the anchors over SCORE_THRESH and the
     boxes that reach NMS a scan; then a warm-up and 2 counted training
     steps at b4 x 20000 (16000 pillars): losses finite, every parameter
     changed; prints train scans/s and peak memory. PointPillars runs no
     hand-written kernel: the phase checks that none was called or
     launched, and adds no row to the kernels line;
 37. centerpoint.yaml at full width on synthetic scans (seeded weights and
     eval state): one recorded eval batch at b4 x 20000 (8 K3 and 21 K7
     calls: 4 subm rulebooks and 4 plans, 17 submanifold and 4 strided
     convs), each call held against its plain version at phase 14's
     tolerances and timed, K7's log line giving each conv's (C, Co, K) and
     hits; then 3 counted batches (launches 8 and 21 a forward; outputs
     finite, final boxes (4, 500, 7), count <= 500); then one recorded
     training step (K7 under autograd; every parameter a gradient, every
     sparse-conv weight a nonzero one), held and timed likewise, and 2
     counted steps: losses and the hm_loss_0 / reg_loss_0 terms finite,
     every parameter changed, launches 8 and 21 a step;
 38. zoo data path, on phase 22's root: for pointpillar.yaml and
     centerpoint.yaml, the val gt echoed through the config's dataset
     scores 100.0 on all 72 APs; `evaluate` at b4 and `train --data_root`
     for 1 epoch at b4 on phase 29's SECOND_DATA_FRAMES val and train
     frames, recorded and held as in phase 29 (centerpoint's K3 / K7;
     pointpillar's runs must launch no kernel), then `evaluate --ckpt` on
     the trained checkpoint; then pointpillar.yaml's `demo --ckpt` on phase
     30's raw scans. Prints the points each scan holds in the field of view
     and those the collate drops past MAX_POINTS, the voxels or pillars a
     scan, scans/s, train scans/s and peak memory;
 39. zoo profiles, after every timed path and profile: `infer --profile`
     of pointpillar.yaml and of centerpoint.yaml at b4 (x 20000), in
     a fresh process (with phase 44's):
     the device's busy share, the top kernels, the post-processing's device
     time alone; no cuDNN FFT kernel (`fft` / `cgemm` in its name) may run.
 40. two-stage reference: the tiny Part-A2 and PV-RCNN
     (tiny.two_stage_state) reproduce tsm_det_pointcloud_tpu_torch/data/
     {parta2,pvrcnn}_tiny_forward.npz on the card (golden tolerance; labels,
     counts and the RoIs' labels exact);
 41. PartA2.yaml at full width on synthetic scans (seeded weights and eval
     state): one recorded eval batch at b4 x 20000 (UNetV2's 21 by-key
     convs, K4, 40000 voxels a level), each call held against its plain
     version at phase 14's tolerances and timed; 3 counted batches (outputs
     finite, rois (4, 100, 7), count <= 500, 21 K4 launches a forward;
     prints scans/s, peak memory, the proposals kept and the RoI boxes over
     SCORE_THRESH a scan, and the RoI-aware pool's time a batch); one
     recorded training step at b4 (16000 voxels a level; every parameter a
     gradient, every sparse-conv weight a nonzero one; each K4 and K5 call
     held, K5 bit-equal between two launches; the proposals and sampled
     RoIs a scan), then 2 counted steps: losses and the RCNN terms finite,
     every parameter changed but those with a zero gradient and value
     (`still_params`);
 42. pvrcnn.yaml at full width, as phase 41: eval b4 x 20000 (one d-fps of
     2048 keypoints over 20000 points on K6, six K2 calls: the VSA's raw
     points and x_conv1..4 and the RoI grid's 21,600 queries a scan, 8 K3
     and 12 K7 calls a forward, each held) and training b2 (the RoI grid's
     110,592 queries a scan);
 43. two-stage data path, on phase 22's root: for PartA2.yaml and
     pvrcnn.yaml, the val gt echoed through the config's dataset scores
     100.0 on all 72 APs; `evaluate` at b4, `train --data_root` for 1 epoch
     (b4 / b2) on phase 29's SECOND_DATA_FRAMES val and train frames, each
     first forward or step recorded and held as in phase 29, `evaluate
     --ckpt` on the trained checkpoint and `demo --ckpt` on phase 30's raw
     scans, its first forward recorded;
 44. two-stage profiles, after every timed path: `infer --profile` of both
     at b4 x 20000, in phase 39's fresh process (busy share, top kernels, post-processing alone; no FFT
     kernel), and the device time alone of the proposal layer's NMS on one
     eval batch's anchor boxes at the test mode's NMS_PRE_MAXSIZE (1024) and
     at the training mode's (9000);
 45. PointRCNN reference: the tiny PointRCNN (tiny.two_stage_state) reproduces
     tsm_det_pointcloud_tpu_torch/data/pointrcnn_tiny_forward.npz on the card
     through K1 and K2 (golden tolerance; labels, counts and the RoIs' labels
     exact); then the RCNN losses with a non-empty foreground: the tiny
     PointRCNN's and Part-A2's RoI heads (training states) take RoIs made from
     jittered gt boxes (tiny.gt_roi_proposals) beside their first stages'
     outputs, and rcnn_cls / reg / corner losses and the gradients of reg +
     corner (head parameters, proposal boxes) on the card are held against
     the same heads on the CPU (losses 1e-4, gradients rtol 1e-3 above the
     rounding floor);
 46. pointrcnn.yaml at full width on synthetic scans, as phase 41: one
     recorded eval batch at b4 x 16384 (PointNet2MSG's four d-fps, 16384 ->
     4096 -> 1024 -> 256 -> 64, and four two-scale ball queries; the in-RoI
     encoder's two d-fps, 512 -> 128 -> 32, and two ball queries over 400
     rows), every K1 / K2 call held against its plain version (indices
     exact) with K1's plan, waves and rows with no valid lane printed; the
     in-RoI d-fps and ball query again with every third row emptied by hand
     (the synthetic scans' eval RoIs all hold points; an emptied row must
     pick index 0 and find nothing, as in the plain version); 3 counted
     batches (scans/s, peak memory, the proposal layer's share of a batch:
     NMS over 9000 of 16384 point boxes a scan); one recorded training step
     at b2 (1024 in-RoI rows) held likewise, every parameter a gradient, and
     2 counted steps (losses finite, `still_params`);
 47. pointrcnn.yaml's data path on phase 22's root: echoed gt 100.0 on all 72
     APs through its dataset (sample_points, shuffle_points), `evaluate` at
     b4 and `train --data_root` for 1 epoch at b2 on phase 29's frames, each
     first forward or step recorded and held, `evaluate --ckpt`, `demo --ckpt`
     on phase 30's scans; then convert_torch_ckpt on a synthetic reference
     checkpoint of a seeded full-width detector (nothing unplaced, loads
     strictly, detects on a raw scan);
 48. PointRCNN's profile, after every timed path: `infer --profile` at b4 x
     16384 in phase 39's fresh process, and the proposal layer's NMS alone at
     9000 boxes a scan (test and training modes);
 49. Voxel R-CNN and SECONDNetIoU references: both tiny detectors
     (tiny.two_stage_state) reproduce their JAX goldens on the card, through
     K3 and K7 (and K2's two RoI-grid window queries of the tiny Voxel
     R-CNN; golden tolerance; labels, counts and the RoIs' labels exact);
     then their RoI heads on RoIs made from the gt boxes, as phase 45:
     Voxel R-CNN's cls / reg / corner losses and SECONDNetIoU's IoU loss,
     with the gradients of reg + corner (of the IoU loss) on the head's
     parameters and the proposals' boxes, card against CPU;
 50. voxel_rcnn_car.yaml (eval b4, training b2) and second_iou.yaml (eval
     and training b4) at full width on synthetic scans of 20000 points, as
     phase 41: one recorded eval batch with every K2 (Voxel R-CNN's three
     9^3-window queries of its 6^3 RoI lattice over x_conv2..4), K3 and K7
     call held against its plain version (indices exact) and timed; 3
     counted batches (scans/s, peak memory, proposals kept; SECONDNetIoU's
     rectified scores in [0, 1]); one recorded training step held likewise,
     every parameter a gradient, peak memory (SECONDNetIoU's pool is (4,
     512, 175616) f32); 2 counted steps (losses finite, `still_params`);
 51. both configs' data path on phase 22's root: echoed gt 100.0 on every
     AP of the config's classes (Car alone for voxel_rcnn_car.yaml),
     `evaluate`, `train --data_root` for 1 epoch, `evaluate --ckpt` and
     `demo --ckpt`, each first forward or step recorded and held, as phase
     43; convert_torch_ckpt on a synthetic reference checkpoint of each
     seeded full-width detector, as phase 47;
 52. their profiles, after every timed path: `infer --profile` at b4 x 20000
     in phase 39's fresh process, and the proposal layer's NMS alone at 1024
     and 9000 boxes a scan.
 53. PV-RCNN++ reference: the tiny PV-RCNN++ (tiny.two_stage_state)
     reproduces tsm_det_pointcloud_tpu_torch/data/
     pvrcnnplusplus_tiny_forward.npz on the card through one K1 launch of
     its 2 x 6 sector rows, six K2 calls (VectorPool on the raw points and
     x_conv3, x_conv4's SAGroup, the RoI grid), 8 K3 and 12 K7 calls
     (golden tolerance; labels, counts and the RoIs' labels exact);
 54. pv_rcnn_plusplus.yaml at full width on synthetic scans, as phase 42:
     eval b4 x 20000 (one K6 launch over the 4 x 6 sector rows at 686 picks,
     the six VectorPool K2 queries of 4096 keypoints a scan and the RoI
     grid's, 8 K3 and 12 K7 calls, each held against its plain version and
     timed; the capture prints the distinct keypoints a scan and the copies
     of point 0 marked valid); the K6 launch again with each scan's fullest
     sector thinned to 100 valid points (the synthetic scans' x >= 0 leaves
     sectors 0 and 5 empty and most rows without point 0), index-equal to the
     plain d-fps; 3 counted batches (scans/s, peak memory); training b2;
 55. its data path on phase 22's root, as phase 43 (echoed gt 100.0 on all
     72 APs, `evaluate`, `train --data_root`, `evaluate --ckpt`, `demo
     --ckpt`), and the converter on a synthetic reference checkpoint, as
     phase 47, then again with its VectorPool layers under OpenPCDet's names
     (their 15 BN scales land on no leaf);
 56. its profile, after every timed path: `infer --profile` at b4 x 20000
     in phase 39's fresh process, and the proposal layer's NMS alone at 1024
     and 9000 boxes a scan.
 57. nuScenes reference: the tiny nuScenes CenterPoint
     (tiny.centerpoint_nusc_state: two class groups, a vel head each, 5 point
     features) reproduces tsm_det_pointcloud_tpu_torch/data/
     centerpoint_nusc_tiny_forward.npz on the card through 8 K3 and 21 K7
     calls (9-column decoded boxes; golden tolerance, labels and counts
     exact);
 58. cbgs_voxel01_res3d_centerpoint.yaml (OpenPCDet's nuScenes CenterPoint:
     1024 x 1024 x 40 grid, six head groups with velocity) at full width on
     synthetic nuScenes-range scans of 300000 points x 5 features: eval b4
     (the recorded forward's 8 K3 and 21 K7 calls held against their plain
     versions and timed; voxels a scan, the decoded boxes over SCORE_THRESH
     and their velocities, finite), 3 counted batches (scans/s, peak
     memory), a training step b4 on 10-column gt boxes of all ten classes
     (every head group trains) recorded and held,
     2 counted steps;
 59. its data path on a synthetic nuScenes root (1 + 1 scenes of 4
     keyframes, each after nine sweeps of 34,720 points: the writer,
     `create_nuscenes_infos` with the train gt database; the points a
     10-sweep val scan holds before and after the range crop; echoed val gt
     NDS 0.8 and mAP 1), `evaluate` (a finite NDS dict), `train --data_root`
     for an epoch with CBGS and gt sampling (the loader's wait), each first
     forward or step recorded and held, the converter on an OpenPCDet-named
     reference checkpoint of the seeded detector (NUSC_PLACEMENTS), and
     `demo --ckpt` of the converted checkpoint on two .npy scans;
 60. its profiles, after every timed path: `infer --profile` at b4 x 300000
     in phase 39's fresh process, then a training step traced in this one;
 61. Lyft reference: the tiny Lyft CenterPoint (tiny.centerpoint_lyft_state:
     Lyft's nine classes in five groups, no vel head) reproduces
     tsm_det_pointcloud_tpu_torch/data/centerpoint_lyft_tiny_forward.npz on
     the card through 8 K3 and 21 K7 calls (7-column decoded boxes; golden
     tolerance, labels and counts exact);
 62. lyft_models/centerpoint_voxel01_res3d.yaml (nuScenes' CenterPoint widths
     on Lyft's +-80 m range: a 1600 x 1600 x 41 grid, five head groups) at
     full width on synthetic scans of 300000 points x 5 features, as phase
     58: eval b4 (the recorded forward's 8 K3 and 21 K7 calls held against
     their plain versions and timed; voxels a scan and the decoded boxes over
     SCORE_THRESH), 2 counted batches (scans/s, peak memory), a training step
     b4 on gt boxes of all nine classes (every head group trains) recorded
     and held, 2 counted steps;
 63. its data path on a synthetic Lyft root (2 + 2 scenes of 4 key frames,
     each after nine sweeps of 65,000 points: the writer,
     `create_lyft_infos` with the train gt database; the points a 5-sweep
     val scan holds before and after the range crop; echoed val gt: Lyft
     mAP 1 and, through eval_metric "kitti", AP 100 on every 3D R40
     difficulty of the four KITTI classes Lyft's map to), `evaluate` (a
     finite mAP dict), `train --data_root` for an epoch with gt sampling
     (the loader's wait), each first forward or step recorded and held;
 64. the PandaSet data path on pandaset_models/centerpoint.yaml at full
     width (centerpoint.yaml's model on a 2816 x 1600 x 41 grid), on a
     synthetic root of 2 + 2 sequences of 4 frames of 115,200 Pandar64
     points (pandas pickles, world frame): the writer,
     `create_pandaset_infos` with the train gt database, the points a frame
     keeps, the val frames' gt boxes fed back through
     `generate_prediction_dicts` onto their world cuboids within 1e-4 m,
     `train --data_root` for an epoch, then `evaluate` of its checkpoint
     (the empty result, as the reference's; result.pkl holds a cuboid
     DataFrame a frame), each first step or forward recorded and held.
 65. CaDDN reference: the tiny CaDDN of both depth networks (CompactDDN and
     the DDNDeepLabV3 plan LAYERS [1, 1, 1, 1], WIDTH 8; tiny.caddn_state)
     reproduces data/caddn_tiny_forward.npz on the card: eval outputs at
     the golden tolerance, labels and counts exact, the training loss and
     tb terms within 1e-4;
 66. CaDDN.yaml (OpenPCDet's CaDDN: ResNet-101 + ASPP DDN at output stride
     8, Conv2DCollapse of a 280 x 376 x 25 frustum volume of 64 features,
     BaseBEVBackbone [10, 10, 10], 157,920 anchors a scan) eval at b2 on
     synthetic camera batches (375 x 1242 noise images, KITTI's
     P2 R0 Tr_velo_to_cam): the first batch timed apart, 3 timed batches,
     the frustum's voxels and the anchors over SCORE_THRESH a scan, peak
     memory, and one scan held against the port's CPU forward;
 67. CaDDN.yaml's training step at b2 (depth targets from the points, the
     fg / bg balancer on the boxes' image extents): the first step timed
     apart, every gradient present and finite, 2 timed steps, peak memory;
 68. the JAX registry's module variants on the tiny SECOND / PointPillars
     (tiny.VARIANTS), each on the card against the port's CPU forward:
     eval outputs, the training loss and its tb terms;
 69. CaDDN's profile, after every timed path: one eval batch of phase 66
     traced (busy share, top kernels, post-processing alone).
     Phases 65-69 run no hand-written kernel: no row of the kernels line
     is theirs.
 70. PVSSDA reference: the tiny PVSSDA on PointNet2FSMSG (tiny.pvssda_state:
     d-fps, f-fps, s-fps, a 40-sample dilated annulus, confidence scores)
     reproduces tsm_det_pointcloud_tpu_torch/data/pvssda_tiny_forward.npz on
     the card through three K1 launches, K2's two-entry kernel and K2
     (golden tolerance; labels and counts exact);
 71. pvssda_3dssd.yaml (3DSSD's fusion-sampling backbone under a per-point
     box head) at full width on synthetic scans: one recorded eval batch at
     b16 x 16384 (three d-fps on K1; layers 0 and 1's three-scale queries,
     64 samples in the widest ball, on K2's two-entry kernel, layer 2's on
     K2), every call held against its plain version (indices exact, K2's
     layer-0 call on a stride of queries as in phase 10) and timed; 3
     counted batches (outputs finite, (16, 512, 7) boxes, count <= 500,
     launches 3 / 1 / 2 a forward; scans/s, peak memory), and one more batch
     with the two f-fps calls (plain PyTorch) timed apart: their share;
 72. its training step at the largest of b16 / b8 / b4 that fits: every
     parameter a finite gradient, then 2 counted steps (losses finite, the
     kernels launched; train scans/s, peak memory);
 73. K6's weighted instantiation (s-fps past K1's 16384 points a row, which
     no config reaches) at b4 x 65536 and b8 x 122880 with random weights
     and a tenth of the points invalid, 4096 picks: index-equal to the
     plain s-fps, timed with its bound, plan and latency floor as K6 is;
     then the same inputs through `furthest_point_sample_weights`, counted;
 74. pvssda_3dssd.yaml's `evaluate` on phase 22's root over phase 29's
     val frames at b4, its first forward recorded and every K1 / K2 call
     held; the AP dict holds every class's 3d / bev / image AP at each
     difficulty, R11 and R40 (aos where computed), finite; and (with phase 39's
     fresh process) its `infer --profile` at b4 x 16384.
 75. DSASNet reference: the tiny DSASNet on SparsePointBackbone
     (tiny.dsasnet_state) reproduces
     tsm_det_pointcloud_tpu_torch/data/dsasnet_tiny_forward.npz on the card
     through 3 K1, 5 K2, 10 K3 and 12 K7 launches (golden tolerance;
     labels, counts and RoI labels exact);
 76. dsasnet.yaml (VoxelBackBone8x, the hybrid SparsePointBackbone,
     DSASNetHead, DSASNetRoIHead) at full width on synthetic scans, as phase
     42: one recorded eval batch at b4 x 20000 (d-fps 20000 -> 4096 on K6,
     the two s-fps stages on K1, four window queries and the RoI grid on
     K2, 8 + 2 probes on K3, 12 convs on K7), every call held against its
     plain version and timed, the second s-fps stage again with its weights
     left on 100 points a row and none on row 0 (all-zero ties); 3 counted
     batches (outputs finite, (4, 100, 7) RoIs, count <= 500, the launches a
     forward), scans/s, peak memory;
 77. its training step at b2 (pvrcnn.yaml's BATCH_SIZE_PER_GPU; the
     hybrid's fg prior at 0, so that its key points reach the statistics'
     0.3): recorded and held; every parameter a finite gradient but the
     hybrid's fg, cls and statistic-tag layers and the trunk's conv_out,
     which no loss reads (none, as the JAX package's are zero); the class
     statistics moved; 2 counted steps (train scans/s, peak memory);
 78. the variants (`infer.variant_cfg`): PointFromVoxel, VoxelPointCross and
     BEVPoint in SparsePointBackbone's place, PVSSDA on its BEV topology with
     the VoxelPointCross neck: an eval batch and a training step at b1 x 20000
     each, BEVPoint's at b2 (finite outputs and gradients), each with its
     kernel calls recorded, their count and the launches as `VARIANT_CALLS`,
     and every call held against its plain version; and one scan on the card
     against the CPU forward of the same weights (4000 points, 6000 for the
     neck, at that voxel capacity): the hybrid's outputs before and after its
     selections by score, the card's picks fed to the CPU once they are a top-k
     of the CPU's scores at the golden tolerance (how many differ from the
     CPU's own printed), the neck's PVSSDA up to its anchor head (golden
     tolerance); the phase runs on cuDNN's heuristics: its autotune of
     BEVPoint's backward convs took 329 s;
 79. dsasnet.yaml's `evaluate` on phase 22's root over phase 29's val
     frames at b4, its first forward recorded and every K1 / K2 / K3 / K6 /
     K7 call held; every class's 3d / bev / image AP at each difficulty, R11
     and R40, finite;
 80. its `infer --profile` at b4 x 20000 (phase 39's fresh process) and its
     proposal NMS alone at 1024 and 9000 boxes a scan.
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
`launches` from its 4 scans; null for K5, K7), `dist_train` that of phase
31 (rank 0's recorded step, `launches` from rank 0's epoch; null for K6,
K7), `point_axis` that of phase 34 (rank 0's recorded forward,
`launches` from rank 0's run; null for K5, K7), `centerpoint` and
`centerpoint_train` those of phase 37 (per recorded forward and step,
`launches` from the counted batches and steps; null but for K3 and K7) and
`centerpoint_data` and `centerpoint_data_train` those of phase 38's
centerpoint evaluate and train (null but for K3 and K7), `parta2` and
`parta2_train` those of phase 41 (null but for K4, and K5 in training),
`pvrcnn` and `pvrcnn_train` those of phase 42 (null for K1, K4, K5),
`parta2_data`, `parta2_data_train`, `pvrcnn_data` and `pvrcnn_data_train`
those of phase 43's evaluate and train, `pointrcnn` and `pointrcnn_train`
those of phase 46 and `pointrcnn_data` and `pointrcnn_data_train` those of
phase 47 (null but for K1 and K2), `voxelrcnn`, `voxelrcnn_train`,
`secondnetiou` and `secondnetiou_train` those of phase 50 and their `_data`
and `_data_train` objects those of phase 51 (null but for K2, K3 and K7;
SECONDNetIoU's K2 null too), `pvrcnnplusplus` and `pvrcnnplusplus_train`
those of phase 54 and its `_data` and `_data_train` objects those of phase
55 (null for K1, K4, K5), `centerpoint_nusc` and `centerpoint_nusc_train`
those of phase 58 and `centerpoint_nusc_data` and
`centerpoint_nusc_data_train` those of phase 59's evaluate and train,
`centerpoint_lyft` and `centerpoint_lyft_train` those of phase 62,
`centerpoint_lyft_data` and `centerpoint_lyft_data_train` those of phase
63's evaluate and train, and `centerpoint_pandaset_data` and
`centerpoint_pandaset_data_train` those of phase 64's (null but for K3 and
K7), `dsasnet` and `dsasnet_train` those of phases 76-77, `dsasnet_data`
that of phase 79 (null for K4, K5), `variant_pointfromvoxel`,
`variant_voxelpointcross`, `variant_bevpoint` and `variant_neck` (each with
its `_train`) those of phase 78's eval batches and training steps,
`pvssda` that of phase 71 and `pvssda_data` that of phase 74 (null
but for K1, K2 and K2's two-entry kernel, `query_group_wide`) and
`weighted_fps` that of phase 73 (null but for K6's weighted instantiation,
`fps_block_weighted`, whose `launches` come from phase 73's counted calls:
no config's path reaches it). K6 is on no KITTI path of
synthetic scans (only on those of 20000-point test scans: the data evals and
the demo): its row's own numbers are the Waymo eval path's; K7 is on
SECOND's paths alone, and its row's own numbers are SECOND's eval path's;
`query_group_wide`'s are phase 71's and `fps_block_weighted`'s phase 73's
(`path` says which path a row's own numbers are from).
K6's and K2's `ms` is their launch alone; `prep_ms` beside it is the
PyTorch prep (Morton sort, gathers, boxes) that precedes each launch (K2's
tiles counted once a pass for the calls that share them).
The last line is the result.
"""
from __future__ import annotations

import json
import os
import pickle
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
# phases 31-34: ranks a process group, a rank's batch, its loader workers,
# seconds a phase's ranks may take; phase 32's train and val frames (the
# trimmed info files of phase 29)
DIST_WORLD, DIST_BATCH, DIST_WORKERS, DIST_TIMEOUT = 2, 8, 2, 400
WORLD1_FRAMES = SECOND_DATA_FRAMES
# phase 34's training step: b2, every 8th of the 16 train frames; its eval:
# every 2nd of the 16 val frames, one batch at b8
PAX_TRAIN_BATCH, PAX_TRAIN_INTERVAL, PAX_EVAL_INTERVAL = 2, 8, 2
# phases 35-39: points a scan (the configs' MAX_POINTS), pointpillar.yaml's
# eval batch, the configs' BATCH_SIZE_PER_GPU (centerpoint.yaml's eval batch
# too), counted batches and steps; centerpoint.yaml's K3 / K7 calls a forward
# (4 subm rulebooks + 4 plans, 17 subm + 4 strided convs)
ZOO_POINTS, PILLAR_BATCH, ZOO_TRAIN_BATCH, ZOO_ITERS, ZOO_TRAIN_ITERS = 20000, 16, 4, 3, 2
# phase 39's profile of pointpillar.yaml runs at b4: in the profiles' fresh process its first batch
# at b16 spent ~22 s more in cuDNN's autotune of the 496 x 432 BEV maps (50 s against 28 s)
PILLAR_PROFILE_BATCH = 4
CENTERPOINT_CALLS = {"probe": 8, "spconv_gather": 21}
# phases 40-44: points a scan (the configs' MAX_POINTS), counted eval batches
# and training steps; by config: its file, eval batch, training batch
# (BATCH_SIZE_PER_GPU) and the hand-written kernels a forward calls: Part-A2's
# UNetV2 makes 21 by-key convs (K4; K5 in their backward); PV-RCNN one d-fps
# of 2048 keypoints over 20000 points (K6), five VSA queries and the RoI
# grid's (K2), and VoxelBackBone8x's 8 probes and 12 convs (K3, K7)
TWO_STAGE_POINTS, TWO_STAGE_ITERS, TWO_STAGE_TRAIN_ITERS = 20000, 3, 2
TWO_STAGE = {
    "parta2": ("PartA2.yaml", 4, 4, {"spconv_bykey": 21}),
    "pvrcnn": ("pvrcnn.yaml", 4, 2, {"fps_block": 1, "query_group": 6, "probe": 8,
                                     "spconv_gather": 12}),
}
# phases 45-48: PointRCNN (pointrcnn.yaml), as TWO_STAGE: its file, eval
# batch, training batch (BATCH_SIZE_PER_GPU) and the hand-written kernels a
# forward calls: PointNet2MSG's four d-fps (16384 -> 4096 -> 1024 -> 256 ->
# 64) and multi-scale ball queries, then the in-RoI encoder's two (512 ->
# 128 -> 32 over B * R rows), K1 and K2; its scans hold the config's
# MAX_POINTS (sample_points' NUM_POINTS), within K1's rows
POINTRCNN = {"pointrcnn": ("pointrcnn.yaml", 4, 2, {"fps": 6, "query_group": 6})}
SCAN_POINTS = {"pointrcnn": 16384}
# phases 49-52: Voxel R-CNN (voxel_rcnn_car.yaml) and SECONDNetIoU
# (second_iou.yaml), as TWO_STAGE: both on VoxelBackBone8x's 8 probes and 12
# convs (K3, K7); Voxel R-CNN's RoI grid pools x_conv2..4 by one K2 window
# query each (6^3 lattice points a RoI), SECONDNetIoU's samples the BEV map
# (no hand-written kernel)
VOXEL_ROI = {
    "voxelrcnn": ("voxel_rcnn_car.yaml", 4, 2, {"probe": 8, "spconv_gather": 12,
                                                "query_group": 3}),
    "secondnetiou": ("second_iou.yaml", 4, 4, {"probe": 8, "spconv_gather": 12}),
}
# what phase 51's converter leaves unplaced of their reference checkpoints:
# the 1x1 deblock0 and the anchor head's 1x1 convs, 2-D kernels no 4-D leaf
# takes (ROADMAP §C)
VOXEL_ROI_UNPLACED = ("backbone_2d/deblock0/kernel", "dense_head/conv_box/kernel",
                      "dense_head/conv_cls/kernel", "dense_head/conv_dir_cls/kernel")
# phases 53-56: PV-RCNN++ (pv_rcnn_plusplus.yaml), as TWO_STAGE: PV-RCNN's
# topology with its keypoints by sector d-fps (one K6 launch over B x 6
# sector rows of 20000 points at 686 picks, sector 0's share of 4096) and
# VectorPool on the raw points, x_conv3 and x_conv4 (six single-scale K2
# queries), the RoI grid's K2 query, VoxelBackBone8x's 8 probes and 12 convs
# (K3, K7); its converter phase also reads the VectorPool layers under
# OpenPCDet's names, whose BN scales no rule takes (ROADMAP §C)
PVRCNN_PP = {"pvrcnnplusplus": ("pv_rcnn_plusplus.yaml", 4, 2,
                                {"fps_block": 1, "query_group": 7, "probe": 8,
                                 "spconv_gather": 12})}
SECTORS = 6                    # pv_rcnn_plusplus.yaml's SPC_SAMPLING.NUM_SECTORS
SECTOR_THIN_POINTS = 100       # phase 54's under-filled rows keep this many points
VECTOR_POOL_BN_SCALES = 15     # 3 sources x (2 groups x 2 BNs + the aggregation's 1)
# phases 57-60: nuScenes' CenterPoint (cbgs_voxel01_res3d_centerpoint.yaml): its
# file under tools/cfgs; phase 58's points a synthetic scan (about a 10-sweep
# scan after the range crop), the config's BATCH_SIZE_PER_GPU (its eval batch
# too), counted batches and steps; VoxelResBackBone8x's K3 / K7 calls a pass
# are centerpoint.yaml's (CENTERPOINT_CALLS)
NUSC_CFG = "nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml"
NUSC_POINTS, NUSC_BATCH, NUSC_ITERS, NUSC_TRAIN_ITERS = 300000, 4, 3, 2
# phase 59's synthetic root: train and val scenes, keyframes a scene (each
# after nine sweeps), points a sweep (nuScenes' 32-beam lidar); the demo's
# .npy scans (each a val keyframe's 10-sweep cloud)
NUSC_TRAIN_SCENES, NUSC_VAL_SCENES, NUSC_KEYFRAMES, NUSC_SWEEP_POINTS = 1, 1, 4, 34720
NUSC_DEMO_SCANS = 2
# phases 81-85 (below): the last options of the JAX package
PP_MULTIHEAD_CFG = "nuscenes_models/cbgs_pp_multihead.yaml"
# its BATCH_SIZE_PER_GPU (the eval batch too), counted batches; the scans are
# phase 58's (NUSC_POINTS)
PP_MULTIHEAD_BATCH, PP_MULTIHEAD_ITERS = 4, 3
# pillar_options: pointpillar.yaml's BATCH_SIZE_PER_GPU, counted batches, steps
# an optimizer and of its train --data_root run (on as many train frames of
# phase 22's root as that takes: the synthetic steps' shapes, whose cuDNN
# choices are made then)
PILLAR_OPTIONS_BATCH, PILLAR_OPTIONS_ITERS, PILLAR_OPTIONS_STEPS = 4, 3, 2
# a pass's kernel calls of the variants (eval, training step); the teacher3
# eval's are fast_cpc.yaml's plus teacher layer 1's s-fps, voxel query, probes
# and U-Net, its step's plus layer 2's; the RoI head's SA stack without the
# group-all layer makes the same calls as pointrcnn.yaml's
OPTION_CALLS = {
    "teacher3": ({"fps": 3, "query_group": 4, "probe": 4, "spconv_bykey": 20},
                 {"fps": 4, "query_group": 6, "probe": 6, "spconv_bykey": 30,
                  "spconv_bykey_bwd": 10}),
    "pointrcnn_pool_last": ({"fps": 6, "query_group": 6}, {"fps": 6, "query_group": 6})}
OPTION_BATCH = {"teacher3": (16, 16), "pointrcnn_pool_last": (4, 2)}   # eval, training
OPTION_POINTS = 16384
OPTION_KERNELS = ("fps", "query_group", "probe", "spconv_bykey", "spconv_bykey_bwd")
OPTION_HELD = {"teacher3": ("s_point_features", "s_point_coords", "batch_cls_preds",
                            "batch_box_preds")}
# what its converter makes of the OpenPCDet-named reference checkpoint of the
# seeded full-width detector: (unplaced, placed on their own leaf, placed on
# another leaf); the groups' branches share their shapes (ROADMAP §C)
NUSC_PLACEMENTS = (38, 182, 248)
# phases 61-64: Lyft's CenterPoint (the Lyft config: nuScenes' CenterPoint
# widths, five head groups, no velocity, a 1600 x 1600 x 41 grid) and
# PandaSet's (centerpoint.yaml's model on a 2816 x 1600 x 41 grid): their
# files under tools/cfgs; phase 62's points a synthetic scan (about a 5-sweep
# Lyft scan after the range crop), the config's BATCH_SIZE_PER_GPU (its eval
# batch too), counted batches and steps
LYFT_CFG = "lyft_models/centerpoint_voxel01_res3d.yaml"
PANDASET_CFG = "pandaset_models/centerpoint.yaml"
LYFT_POINTS, LYFT_BATCH, LYFT_ITERS, LYFT_TRAIN_ITERS = 300000, 4, 2, 2
# phase 63's synthetic Lyft root: train and val scenes, key frames a scene
# (each after nine sweeps), points a sweep (the order of Lyft's roof lidar)
LYFT_TRAIN_SCENES, LYFT_VAL_SCENES, LYFT_KEYFRAMES, LYFT_SWEEP_POINTS = 2, 2, 4, 65000
# phase 64's synthetic PandaSet root: train and val sequences (ids the
# config's SEQUENCES name), frames a sequence, Pandar64 points a frame (64
# beams x 1800 azimuths, single return), the config's batch
PANDASET_TRAIN_SEQ, PANDASET_VAL_SEQ = ("001", "002"), ("004", "007")
# b2, not b4: the first training step's cuDNN autotune of the 2816 x 1600
# grid's BEV convs takes 49-70 s at b4, 24 s at b2
PANDASET_FRAMES, PANDASET_POINTS, PANDASET_BATCH = 4, 115200, 2
# phases 70-74: PVSSDA on 3DSSD's fusion-sampling backbone (pvssda_3dssd.yaml)
# at b16 x 16384 (pointrcnn.yaml's sample_points, the main path's scans) and
# its counted batches; its hand-written kernel calls a forward: three d-fps
# on K1 (16384 -> 4096, 4096 -> 512, and 512 -> 256 over points 512-1023;
# its two f-fps are plain PyTorch), layers 0 and 1's three-scale queries on
# K2's two-entry kernel (64 samples in the widest ball) and layer 2's on K2;
# its training batches, the largest that fits first, and counted steps
PVSSDA_CFG = "pvssda_3dssd.yaml"
PVSSDA_BATCH, PVSSDA_POINTS, PVSSDA_ITERS = 16, 16384, 3
PVSSDA_CALLS = {"fps": 3, "query_group": 1, "query_group_wide": 2}
PVSSDA_TRAIN_BATCHES, PVSSDA_TRAIN_ITERS = (16, 8, 4), 2
PVSSDA_DATA_BATCH = 4
# its `infer --profile` (phase 74) at b4: at b16 the trace's events made the
# profile ~41 s of the 1200 s budget on a slower host
PVSSDA_PROFILE_BATCH = 4
# phases 75-80: DSASNet (dsasnet.yaml: VoxelBackBone8x, the hybrid
# SparsePointBackbone, DSASNetHead, DSASNetRoIHead), as TWO_STAGE: its file,
# eval batch, training batch (pvrcnn.yaml's BATCH_SIZE_PER_GPU) and the
# hand-written kernels a forward calls: d-fps of 4096 key-point candidates
# over 20000 points (K6), the two s-fps stages 4096 -> 1536 and -> 512 (K1),
# the window pool's two sources at the candidates and at the votes and the
# RoI grid (K2), the trunk's 8 probes and the containing-voxel lookups at
# both (K3), the trunk's 12 convs (K7)
DSASNET = {"dsasnet": ("dsasnet.yaml", 4, 2, {"fps_block": 1, "fps": 2, "query_group": 5,
                                              "probe": 10, "spconv_gather": 12})}
# the parameters no loss of DSASNet reaches (the hybrid's fg, cls and
# statistic-tag layers, the trunk's conv_out): no gradient, as the JAX
# package's is zero
DSASNET_IDLE = ("module_list.1.conv_out.", "module_list.3.features_fg.",
                "module_list.3.fg_hidden.", "module_list.3.fg_pred_out.",
                "module_list.3.temp_features.", "module_list.3.features_cls.",
                "module_list.3.cls_block", "module_list.3.cls_out")
# phase 78: the variants (`infer.variant_cfg`): each hybrid in dsasnet.yaml's
# place and PVSSDA on its BEV topology with the VoxelPointCross neck, an eval
# batch and a training step of VARIANT_BATCH x 20000, every hand-written kernel
# call of both recorded and held against its plain version. The calls each
# makes (`VARIANT_CALLS`, eval and training; the counts of
# `_kernels.LAUNCHES`): under each hybrid the trunk's 8 probes (K3) and 12
# convs (K7) and the RoI grid (K2); VoxelPointCross's ball query over its picks
# (K2); in training PointFromVoxel's two subset d-fps over the 20000 raw points
# (K6) and VoxelPointCross's over them (K6) and over its 1536 picks (K1); the
# neck's PointNet2MSG: d-fps 20000 -> 4096 (K6), three more (K1) and its four
# grouping calls (K2). Then each one's scan on the card against the CPU forward
# of the same weights at a voxel capacity and points a scan of
# VARIANT_CPU_POINTS (PointNet2MSG's 4096 picks need more on the neck's), which
# keep the CPU's share of the phase in seconds, through the module list to its
# hybrid (the neck's PVSSDA to its anchor head): `VARIANT_HELD`, the outputs
# before and after the score-ordered selections, the card's picks fed to the
# CPU (`top_k_fed`)
VARIANTS = ("PointFromVoxel", "VoxelPointCross", "BEVPoint", "neck")
_TRUNK = {"query_group": 1, "probe": 8, "spconv_gather": 12}
VARIANT_CALLS = {
    "PointFromVoxel": (_TRUNK, {**_TRUNK, "fps_block": 2}),
    "VoxelPointCross": ({**_TRUNK, "query_group": 2},
                        {**_TRUNK, "query_group": 2, "fps": 1, "fps_block": 1}),
    "BEVPoint": (_TRUNK, _TRUNK),
    "neck": ({"fps": 3, "fps_block": 1, "query_group": 4},) * 2}
VARIANT_KERNELS = ("fps", "fps_block", "query_group", "probe", "spconv_gather")
_POINTS_HELD = ("spatial_features_2d", "point_coords", "point_valid", "point_features")
VARIANT_HELD = {"PointFromVoxel": _POINTS_HELD + (
                    "fg_preds", "point_center_preds", "point_candidate_preds",
                    "candidate_coords", "candidate_features"),
                "VoxelPointCross": _POINTS_HELD + (
                    "fg_preds", "point_corner_preds", "point_candidate_preds",
                    "candidate_coords", "candidate_valid", "candidate_features"),
                "BEVPoint": _POINTS_HELD + ("raw_fg_preds",),
                "neck": ("point_coords", "point_features", "spatial_features_2d",
                         "batch_cls_preds", "batch_box_preds")}
# each one's batch: b1 where the memory is not the point, to keep the phase
# short; BEVPoint at b2, whose densified 800 x 704 maps take 52 GiB in training
VARIANT_BATCH = {"PointFromVoxel": 1, "VoxelPointCross": 1, "BEVPoint": 2, "neck": 1}
VARIANT_POINTS = 20000
VARIANT_CPU_POINTS = {"PointFromVoxel": 4000, "VoxelPointCross": 4000, "BEVPoint": 4000,
                      "neck": 6000}
# phase 73: K6's weighted rows (batch, points a row) with random weights,
# their picks and the share of points marked invalid
WEIGHTED_ROWS, WEIGHTED_NPOINT, WEIGHTED_INVALID = ((4, 65536), (8, 122880)), 4096, 0.1
# phases 65-69: CaDDN.yaml at b2 on synthetic camera batches (KITTI's 375 x
# 1242 images; the points feed the depth targets in training alone)
CADDN_CFG = "CaDDN.yaml"
CADDN_BATCH, CADDN_POINTS, CADDN_ITERS, CADDN_TRAIN_ITERS = 2, 16384, 3, 2
# OpenPCDet's names of CenterHead's shared conv and SeparateHead where the
# port's (the flax ones) differ
CENTER_HEAD_OPENPCDET_NAMES = (
    (r"^dense_head\.shared_conv\.", "dense_head.shared_conv.0."),
    (r"^dense_head\.shared_bn\.", "dense_head.shared_conv.1."),
    (r"^dense_head\.head_(\d+)\.(\w+?)_conv(\d+)\.", r"dense_head.heads_list.\1.\2.\3.0."),
    (r"^dense_head\.head_(\d+)\.(\w+?)_bn(\d+)\.", r"dense_head.heads_list.\1.\2.\3.1."),
    (r"^dense_head\.head_(\d+)\.(\w+?)_out\.", r"dense_head.heads_list.\1.\2.1."),
)
# the RCNN terms of each two-stage detector's tb_dict (a training step's must
# hold them all) and the term its counted steps print
RCNN_TERMS = {"parta2": ("rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss", "point_loss"),
              "pvrcnn": ("rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss", "point_loss"),
              "pointrcnn": ("rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss", "point_loss"),
              "voxelrcnn": ("rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss"),
              "secondnetiou": ("rcnn_iou_loss",),
              "pvrcnnplusplus": ("rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss",
                                 "point_loss"),
              "dsasnet": ("rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss", "point_loss")}


# the RoI head's inputs (first-stage scores and boxes) of each two-stage
# config's first synthetic eval batch (phases 41, 42, 46, 50), on the host,
# for the proposal NMS timed alone in phases 44, 48 and 52
PROPOSALS = {}


def stage_spec(which):
    return {**TWO_STAGE, **POINTRCNN, **VOXEL_ROI, **PVRCNN_PP, **DSASNET}[which]


def scan_points(which):
    return SCAN_POINTS.get(which, TWO_STAGE_POINTS)


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
    "query_group_wide": ("tsm_det_pointcloud_tpu_torch/csrc/group.cu",
                         "tsm_det_pointcloud_tpu/ops/group_pallas.py:108 (nsample 33-64)"),
    "fps_block_weighted": ("tsm_det_pointcloud_tpu_torch/csrc/fps_block.cu",
                           "tsm_det_pointcloud_tpu/ops/fps_pallas.py:67 (weighted, rows past "
                           "16384 points)"),
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


def timed_once(fn):
    """(fn(), its ms between two CUDA events): one run, no warm-up. The
    plain versions of K1, K2 and K6 (tenths of a second to seconds a call)
    are timed on the run that their comparison with the kernel makes."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, reps, kernels=None, warm=True):
    """Device time of `fn`'s kernels alone, per call, from a torch.profiler
    window of `reps` calls: for each kernel, its mean time times the
    launches it makes a call. Unlike cuda_time_ms it leaves out the host's
    dispatch gaps between launches. The profiler at times hands back a
    window short of a kernel record or two, which the means ride out; a
    window with no device time, or (given `kernels`) another number of
    launches a call, is taken again, up to five times. `warm` False: no
    warm-up call, for a function this process has run on these shapes.
    Without `kernels` the window traces the device alone (its CPU events,
    which only a launch count's check reads, make key_averages ~2x slower
    on a window of thousands of operations such as the 9000-box NMS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsm_det_pointcloud_tpu_torch.infer import self_device_us

    if warm:
        fn()
    for _ in range(5):
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] if kernels is None else [ProfilerActivity.CPU,
                                                                 ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
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
    want, plain_ms = timed_once(
        lambda: sampling.furthest_point_sample_plain(xyz, npoint, valid, weights))
    check(bool((got == want).all()), f"K1 fps differs from its plain version at {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    ops = (npoint - 1) * B * N * (10 if weights is not None else 9)
    nbytes = B * N * 12 + B * npoint * 4 + (B * N if valid is not None else 0) \
        + (B * N * 4 if weights is not None else 0)
    # beside the bound, a latency floor: the steps times one exchange round
    # of this call's cluster layout, timed alone by a probe kernel
    plan = sampling.fps_plan(N, weights is not None)
    round_us = exchange_round_us(min(B, plan["active_clusters"]), plan["cluster_size"])
    # a batch of more rows than clusters resident at once runs in waves
    waves = -(-B // plan["active_clusters"])
    floor_ms = waves * (npoint - 1) * round_us / 1e3
    empty = int((~valid.bool()).all(1).sum()) if valid is not None else 0
    EXTRAS["fps"] = {"floor_ms": floor_ms, "steps": npoint - 1, "empty_rows": empty}
    print(f"  K1 plan at b{B} x {N} ({'s-fps' if weights is not None else 'd-fps'}): "
          f"cluster size {plan['cluster_size']}, cudaOccupancyMaxActiveClusters "
          f"{plan['active_clusters']} ({waves} wave{'s' if waves > 1 else ''}), "
          f"{plan['smem_bytes']} B shared memory a CTA; {empty} rows with no valid lane; one "
          f"exchange round {round_us:.4f} us, so a latency floor of {floor_ms:.4f} ms for "
          f"{waves} x {npoint - 1} steps")
    # the plain FPS (about a second a call) is timed on the comparison's run
    return (0.0, lambda: sampling._fps_kernel(xyz, npoint, valid, weights), plain_ms,
            None, ops, nbytes, 5, 0)


def compare_fps_block(args):
    from tsm_det_pointcloud_tpu_torch.ops import sampling

    xyz, npoint, valid = args
    got, visits = sampling._fps_block_kernel(xyz, npoint, valid)
    want, plain_ms = timed_once(lambda: sampling.furthest_point_sample_plain(xyz, npoint, valid))
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
    # the plain lockstep FPS takes seconds at Waymo shapes: timed on the
    # comparison's run
    return (0.0, lambda: sampling._fps_block_launch(xyz, state, npoint), plain_ms,
            None, ops, nbytes, reps, 0)


def compare_fps_block_weighted(args):
    """K6's weighted instantiation (s-fps past K1's rows) against the plain
    lockstep s-fps, index for index; timed as K6 is, with its prep apart,
    its bound (the visited blocks' 10 operations a point: d2, min, the
    weight's product) and its latency floor."""
    from tsm_det_pointcloud_tpu_torch.ops import sampling

    xyz, npoint, valid, weights = args
    got, visits = sampling._fps_block_kernel(xyz, npoint, valid, weights)
    want, plain_ms = timed_once(
        lambda: sampling.furthest_point_sample_plain(xyz, npoint, valid, weights))
    n_diff = int((got != want).sum())
    check(n_diff == 0, f"K6 weighted differs from the plain s-fps at {tuple(xyz.shape)}: "
                       f"{n_diff} of {got.numel()} picks")
    B, N, _ = xyz.shape
    nb = -(-N // sampling.FPS_BLOCK)
    n_visits = int(visits.sum())
    ops = n_visits * sampling.FPS_BLOCK * 10
    nbytes = B * N * (12 + 4) + B * npoint * 4 + (B * N if valid is not None else 0)
    reps = 3
    xyz = xyz.detach().contiguous().float()
    prep_ms = cuda_time_ms(lambda: sampling.block_prep(xyz, valid, weights), reps)
    state = sampling.block_prep(xyz, valid, weights)
    plan = sampling.fps_block_plan(nb, True)
    round_us = exchange_round_us(min(B, plan["active_clusters"]), plan["cluster_size"])
    waves = -(-B // plan["active_clusters"])
    floor_ms = waves * (npoint - 1) * round_us / 1e3
    EXTRAS["fps_block_weighted"] = {"prep_ms": prep_ms, "floor_ms": floor_ms,
                                    "steps": npoint - 1}
    print(f"  K6 weighted at b{B} x {N} -> {npoint}: visited {n_visits} of "
          f"{(npoint - 1) * nb * B} (step, block) pairs "
          f"({100 * n_visits / ((npoint - 1) * nb * B):.2f}%); the prep alone {prep_ms:.4f} ms; "
          f"plan: cluster size {plan['cluster_size']}, cudaOccupancyMaxActiveClusters "
          f"{plan['active_clusters']} ({waves} wave{'s' if waves > 1 else ''}), "
          f"{plan['smem_bytes']} B shared memory a CTA; one exchange round {round_us:.4f} us, "
          f"so a latency floor of {floor_ms:.4f} ms for {waves} x {npoint - 1} steps")
    return (0.0, lambda: sampling._fps_block_launch(xyz, state, npoint), plain_ms,
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
    kname = "query_group_wide" if max(int(sc[2]) for sc in scales) > 32 else "query_group"
    gi, gc, gg = grouping._query_group_kernel(*args)
    # the plain version materialises every (query, source) pair: above
    # PAIR_TESTS_PLAIN pairs it runs on every `stride`-th query (all sources)
    # and the kernel's full-shape result is held against it on those
    stride = -(-src_xyz.shape[0] * src_xyz.shape[1] * q_xyz.shape[1] // PAIR_TESTS_PLAIN)
    plain_args = args[:7]
    if stride > 1:
        PLAIN_NOTES[kname] = (f"plain version run and timed on every {stride}th "
                              f"query of the {q_xyz.shape[1]}-query call")
        print(f"  K2 {PLAIN_NOTES[kname]}")
        plain_args = (src_xyz, src_valid, q_xyz[:, ::stride].contiguous(), scales, payload,
                      src_coords,
                      None if q_coords is None else q_coords[:, ::stride].contiguous())
        gi, gc = gi[:, ::stride], gc[:, ::stride]
        gg = None if gg is None else gg[:, ::stride]
    (wi, wc, wg), plain_ms = timed_once(lambda: grouping.query_group_plain(*plain_args))
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
    EXTRAS[kname] = {"prep_ms": prep_ms,
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
    # the plain version is timed on the comparison's run
    return (err, lambda: grouping._query_group_launch(prep, qx, scales_n, pl, qcc), plain_ms,
            None, ops, nbytes, 5, 0)


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
           "fps_block_weighted": compare_fps_block_weighted,
           "query_group": compare_query_group, "query_group_wide": compare_query_group,
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
            # a number: the plain version's ms, taken on the comparison's run
            p_ms = pfn if isinstance(pfn, float) else cuda_time_ms(pfn, preps)
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
    """The deferred device times (see Deferred), summed over each pass: a
    pass's calls of one figure run one after another in one profiler window
    of `reps` repetitions, whose device time a repetition is their sum."""
    import torch

    for label, report in reports.items():
        for name, agg in report.items():
            figures = {}
            for k, d in agg.pop("deferred", []):
                figures.setdefault(k, []).append(d)
            for k, ds in figures.items():
                calls = [(d.fn, [a.cuda() if isinstance(a, torch.Tensor) else a for a in d.args],
                          d.kwargs or {}) for d in ds]
                kernels = (None if any(d.kernels is None for d in ds)
                           else sum(d.kernels for d in ds))
                agg[k] = device_ms(lambda: [fn(*args, **kw) for fn, args, kw in calls],
                                   ds[0].reps, kernels)
                del calls
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
        if name not in SECOND_KERNELS_OF:   # those are recorded by their source's wrapper
            rec.wrap(*where[name], name)
    return rec


# the second kernels of two sources: each is launched through its source's
# wrapper, and `split_calls` sorts the recorded calls to it
SECOND_KERNELS_OF = {"query_group_wide": "query_group", "fps_block_weighted": "fps_block"}


def split_calls(calls):
    """Recorded calls by the kernel they launch: a K2 call with a scale of
    more than 32 samples runs K2's two-entry kernel, a K6 call with weights
    its weighted instantiation."""
    wide = lambda args: max(int(sc[2]) for sc in args[3]) > 32
    weighted = lambda args: len(args) > 3 and args[3] is not None
    out = {k: list(v) for k, v in calls.items()}
    for name, test in (("query_group_wide", wide), ("fps_block_weighted", weighted)):
        src = SECOND_KERNELS_OF[name]
        if src in out:
            out[name] = [a for a in out[src] if test(a)]
            out[src] = [a for a in out[src] if not test(a)]
    return {k: v for k, v in out.items() if v}


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
        wall, busy, _ = profile_call(lambda: detect(model, first["points"], first["points_mask"]),
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
    counted runs, the plain-version notes of each, a function that profiles
    one eval batch (to be called after every timed path: see Deferred) and
    removes the root, and the root (phase 34 runs on it)."""
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
        wall, busy, _ = profile_call(lambda: detect(model, first["points"], first["points_mask"]),
                                  top=10)
        print(f"waymo data eval: device idle share of a profiled batch "
              f"{100 - 100 * busy / wall:.1f}% ({busy:.3f} of {wall:.3f} ms busy)")
        tmp.cleanup()

    return (report_eval, launches_eval, notes_eval, report_train, launches_train, notes_train,
            profile_eval_batch, root)


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


# ---------------------------------------------------------------------------
# phases 31-34: the process group. Each phase starts its ranks as fresh
# spawned processes (rank_main); two ranks share the one card over gloo.
# ---------------------------------------------------------------------------

def rank_main(rank, world, port, job, args, out, backend, env):
    """A rank of phases 31-34: torchrun's environment, then JOBS[job](rank,
    *args) with `comm.init_distributed` on `backend` (None: the launcher's
    own, NCCL on the card); its result is torch.save'd to out/rank<r>.pt.
    The rank's loader workers and their fork server stop before it ends."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port), **env)
    import torch

    from tsm_det_pointcloud_tpu_torch.datasets import stop_workers
    from tsm_det_pointcloud_tpu_torch.parallel import comm

    init = comm.init_distributed

    def init_on_backend(launcher, device="cuda", backend_=None):
        dev = init(launcher, device, backend_ or backend)
        BACKENDS.append(torch.distributed.get_backend() if launcher != "none" else None)
        return dev

    comm.init_distributed = init_on_backend
    try:
        torch.save(JOBS[job](rank, *args), Path(out) / f"rank{rank}.pt")
    finally:
        stop_workers()


def free_ports(n):
    """n distinct free ports on localhost."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def start_ranks(job, args, world=DIST_WORLD, backend="gloo", env=None):
    """Spawn the `world` ranks of `job`; returns the handle wait_ranks takes."""
    import tempfile

    import torch.multiprocessing as mp

    port, = free_ports(1)
    out = tempfile.mkdtemp(prefix=f"chip_smoke_{job}_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, port, job, args, out, backend, env or {}))
             for r in range(world)]
    for p in procs:
        p.start()
    return job, procs, out, time.perf_counter()


def wait_ranks(handle, timeout=DIST_TIMEOUT):
    """Every rank's result, in rank order; fails (stopping the others) as
    soon as a rank fails, or when the ranks outlive `timeout` s."""
    import torch

    job, procs, out, t0 = handle
    while any(p.is_alive() for p in procs):
        bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
        if bad or time.perf_counter() - t0 > timeout:
            for p in procs:
                p.kill()
                p.join()
            fail(f"{job}: a rank failed (exit codes {[p.exitcode for p in procs]})" if bad
                 else f"{job}: the ranks ran past {timeout} s")
        time.sleep(0.2)
    codes = [p.exitcode for p in procs]
    check(codes == [0] * len(procs), f"{job}: rank exit codes {codes}")
    results = [torch.load(Path(out) / f"rank{r}.pt", weights_only=False)
               for r in range(len(procs))]
    shutil.rmtree(out, ignore_errors=True)
    return results, time.perf_counter() - t0


def compare_in_turn(rank, out, calls, label):
    """compare_recorded on rank 0, then on rank 1 (each waits for the one
    before, so that no other rank's kernels share the card while it times);
    device-time extras stay out."""
    flag = Path(out) / f"compared{rank}"
    if rank > 0:
        prev = Path(out) / f"compared{rank - 1}"
        while not prev.exists():
            time.sleep(0.1)
    report = compare_recorded(calls, label)
    for agg in report.values():
        agg.pop("deferred", None)
    flag.touch()
    return report


def arrays(t):
    """A dict of tensors as CPU numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in t.items()}


TINY_BATCH = 4    # phase 31's tiny TSM step: b2 a rank, b4 in one process


def tiny_step(rank=0, world=1):
    """One training step of the tiny TSM (its committed state, seeded class
    statistics, tiny.synth_points / synth_gt "wide" of TINY_BATCH scans; this
    rank's contiguous share of them) on the card, under DDP when the process
    group has more than one rank. Returns (loss, {student tensor: its
    reduced gradient})."""
    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.parallel.train_state import wrap_data_parallel
    from tsm_det_pointcloud_tpu_torch.runtime.optimization import build_optimizer
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import freeze_teacher, train_step

    dev = torch.device("cuda", 0)
    flax = to_flax_variables(tiny.load_state())
    flax["statistics"] = {"module_list_1": tiny.train_statistics()}
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device=dev)
    model.load_state_dict(from_flax_variables(flax), strict=True)
    opt = build_optimizer({"OPTIMIZER": "adam_onecycle", "LR": 0.01, "WEIGHT_DECAY": 0.01},
                          freeze_teacher(model), 10)
    b = TINY_BATCH // world
    gt, gmask = tiny.synth_gt(TINY_BATCH, "wide")
    whole = {"points": tiny.synth_points(TINY_BATCH), "gt_boxes": gt, "gt_boxes_mask": gmask}
    batch = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]).to(dev) for k, v in whole.items()}
    batch["points_mask"] = torch.ones(batch["points"].shape[:2], dtype=torch.bool, device=dev)
    batch["batch_size"] = b
    grads, step = {}, opt.step

    def then_step():
        grads.update(arrays({n: p.grad for n, p in model.named_parameters()
                             if p.grad is not None}))
        return step()

    opt.step = then_step
    loss, _ = train_step(wrap_data_parallel(model, dev), opt, batch)
    return float(loss), grads


def job_dist_train(rank, cfg_file, root, pretrained, out):
    """Phase 31's rank: `train --launcher pytorch` for one epoch at b8, the
    first step recorded, after the tiny TSM's step (`tiny_step`) in the same
    process group; after every step the step's loss, tb terms, frames,
    the tensors that differ across the ranks and the seconds that check
    took (the epoch's clock holds them); the first step's reduced
    gradients."""
    import torch

    from tsm_det_pointcloud_tpu_torch import train
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.parallel.train_state import replica_mismatches, unwrap
    from tsm_det_pointcloud_tpu_torch.runtime import train_loop

    steps, grads = [], {}
    step = train_loop.train_step

    def checked_step(model, opt, batch):
        if not steps:
            opt_step = opt.step

            def reduced_then_step():
                grads.update(arrays({n: p.grad for n, p in unwrap(model).named_parameters()
                                     if p.grad is not None}))
                opt.step = opt_step
                return opt_step()

            opt.step = reduced_then_step
        loss, tb = step(model, opt, batch)
        t0 = time.perf_counter()
        steps.append(dict(loss=float(loss), tb={k: float(v) for k, v in tb.items()},
                          frames=list(batch["frame_id"]),
                          mismatches=replica_mismatches(model)))
        steps[-1]["check_s"] = time.perf_counter() - t0
        return loss, tb

    from tsm_det_pointcloud_tpu_torch.parallel import comm

    tiny, on_dataset = [], train.train_on_dataset

    def tiny_first(args, dev):   # in train's process group, before its epoch
        tiny.append(tiny_step(rank, comm.get_world_size()))
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        return on_dataset(args, dev)

    train.train_on_dataset = tiny_first
    train_loop.train_step = checked_step
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    with first_call_recorded(train_loop, "train_step", KITTI_KERNELS) as first:
        ckpt_dir, epochs = train.main([
            "--cfg_file", str(cfg_file), "--data_root", str(root), "--launcher", "pytorch",
            "--batch", str(DIST_BATCH), "--epochs", "1", "--workers", str(DIST_WORKERS),
            "--pretrained_model", str(pretrained), "--output_dir", str(out / "train"),
            "--device", "cuda"])
    launches = dict(_kernels.LAUNCHES)
    peak = max(e["peak_gib"] for e in epochs)
    report = compare_in_turn(rank, out, first[0][0].calls, f"dist train rank {rank}")
    return dict(steps=steps, grads=grads, epochs=epochs, launches=launches, peak=peak,
                report=report, ckpt=str(ckpt_dir / "checkpoint_epoch_1.pth"), tiny=tiny[0])


def job_world1(rank, launcher, cfg_file, root, out, sets):
    """Phase 32's process: train 2 steps and evaluate 1 batch, deterministic
    algorithms on; returns the losses, the trained state and the
    predictions."""
    import pickle

    import torch

    from tsm_det_pointcloud_tpu_torch import evaluate, train
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import load_model_state

    torch.use_deterministic_algorithms(True)
    data = ["--cfg_file", str(cfg_file), "--data_root", str(root), "--launcher", launcher,
            "--workers", str(DIST_WORKERS), "--output_dir", str(out), "--device", "cuda",
            "--set", *sets]
    ckpt_dir, epochs = train.main(data + ["--batch", str(WORLD1_FRAMES // 2), "--epochs", "1"])
    ckpt = ckpt_dir / "checkpoint_epoch_1.pth"
    with first_call_recorded(detectors["3DSSD"], "forward", ()) as first:
        evaluate.main(data + ["--ckpt", str(ckpt), "--batch_size", str(WORLD1_FRAMES)])
    raw = arrays({k: first[0][1][k] for k in ("batch_cls_preds", "batch_box_preds")})
    with open(out / "eval" / "default" / "result.pkl", "rb") as f:
        annos = pickle.load(f)
    losses = [json.loads(line).get("train/loss")
              for line in (out / "metrics.jsonl").read_text().splitlines()]
    return dict(losses=[v for v in losses if v is not None], steps=epochs[0]["steps"],
                state=arrays(load_model_state(ckpt)), annos=annos, raw=raw,
                backends=list(BACKENDS))


def job_dist_eval(rank, cfg_file, root, ckpt, out):
    """Phase 33's rank: `evaluate --launcher pytorch` at b8 on the val split."""
    import torch

    from tsm_det_pointcloud_tpu_torch import evaluate
    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    res = evaluate.main([
        "--cfg_file", str(cfg_file), "--data_root", str(root), "--launcher", "pytorch",
        "--ckpt", str(ckpt), "--batch_size", str(DIST_BATCH), "--workers", str(DIST_WORKERS),
        "--output_dir", str(out), "--eval_tag", "two_ranks", "--device", "cuda"])
    return dict(res=res, launches=dict(_kernels.LAUNCHES),
                peak=torch.cuda.max_memory_allocated() / 2**30)


def job_point_axis(rank, cfg_file, root, out):
    """Phase 34's rank: `evaluate --point_axis 2` on the Waymo val split, the
    first forward recorded with its layer-0 picks and the whole batch it
    was cut from; rank 0 holds the picks against segment_local_fps_plain."""
    import torch

    from tsm_det_pointcloud_tpu_torch import evaluate
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.parallel import point_sharding

    seen = {}
    cut, fps = point_sharding.shard_batch, point_sharding.segment_local_fps

    def keep_whole(batch, ctx):
        seen.setdefault("whole", (batch["points"][..., :3].clone(),
                                  batch["points_mask"].clone()))
        return cut(batch, ctx)

    def keep_picks(xyz, npoint, ctx, valid_mask=None):
        idx = fps(xyz, npoint, ctx, valid_mask)
        seen.setdefault("picks", (idx.cpu(), npoint, ctx.size, xyz.shape[1]))
        return idx

    point_sharding.shard_batch, point_sharding.segment_local_fps = keep_whole, keep_picks
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    try:
        with first_call_recorded(detectors["3DSSD"], "forward", WAYMO_EVAL_KERNELS) as first:
            res = evaluate.main([
                "--cfg_file", str(cfg_file), "--data_root", str(root), "--launcher",
                "pytorch", "--point_axis", str(DIST_WORLD), "--batch_size", str(WAYMO_BATCH),
                "--workers", str(DIST_WORKERS), "--output_dir", str(out), "--device", "cuda",
                "--set", "DATA_CONFIG.SAMPLED_INTERVAL.test", str(PAX_EVAL_INTERVAL)])
    finally:
        point_sharding.shard_batch, point_sharding.segment_local_fps = cut, fps
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rec, first_out = first[0]
    boxes = first_out["batch_box_preds"].cpu().numpy()
    picks, npoint, pax, n_local = seen["picks"]
    plain_equal = None
    if rank == 0:
        xyz, mask = seen["whole"]
        plain = point_sharding.segment_local_fps_plain(xyz.cuda(), npoint, pax, mask.cuda())
        plain_equal = bool(torch.equal(plain.cpu(), picks))
    report = compare_in_turn(rank, out, rec.calls, f"point axis rank {rank}")
    return dict(res=res, launches=launches, peak=peak, boxes=boxes, report=report,
                plain_equal=plain_equal, n_local=n_local, npoint=npoint,
                scans_per_s=res.get("scans_per_s"))


BACKENDS = []   # a rank's process-group backend, each time it joined one
def job_point_axis_train(rank, cfg_file, root, out):
    """Phase 34's training rank: `train --point_axis 2` for one step at b2
    (the epoch's end checks the ranks' parameters and buffers bit-equal)."""
    import torch

    from tsm_det_pointcloud_tpu_torch import train
    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    _, epochs = train.main([
        "--cfg_file", str(cfg_file), "--data_root", str(root), "--launcher", "pytorch",
        "--point_axis", str(DIST_WORLD), "--batch", str(PAX_TRAIN_BATCH), "--epochs", "1",
        "--workers", str(DIST_WORKERS), "--output_dir", str(out), "--device", "cuda",
        "--set", "DATA_CONFIG.SAMPLED_INTERVAL.train", str(PAX_TRAIN_INTERVAL)])
    return dict(epochs=epochs, launches=dict(_kernels.LAUNCHES),
                deterministic=torch.are_deterministic_algorithms_enabled())


def job_in_turn(rank, jobs):
    """Phases 33-34's ranks: each (job name, its arguments, a port) of
    `jobs` in turn in these processes, each in a process group of its own
    (MASTER_PORT the job's port; the entry points leave their group at
    their end), the cache allocator emptied between them. Returns each job's
    result and seconds."""
    import torch

    out = []
    for job, args, port in jobs:
        os.environ["MASTER_PORT"] = str(port)
        t0 = time.perf_counter()
        out.append((JOBS[job](rank, *args), time.perf_counter() - t0))
        torch.cuda.empty_cache()
    return out


JOBS = {"dist_train": job_dist_train, "world1": job_world1, "dist_eval": job_dist_eval,
        "point_axis": job_point_axis, "point_axis_train": job_point_axis_train,
        "in_turn": job_in_turn}


def rel_l2(want, got, names):
    """|got - want| / |want| over the concatenated tensors `names`."""
    num = sum(float(np.sum((got[n].astype(np.float64) - want[n]) ** 2)) for n in names)
    den = sum(float(np.sum(want[n].astype(np.float64) ** 2)) for n in names)
    return (num / max(den, 1e-300)) ** 0.5


def halves_stats(x, mask):
    """pointnet2_modules._masked_stats with the sums, squared sums and count
    taken over each half of the batch's rows and then added, as two ranks'
    all-reduce adds their halves (phase 31's one-process reference)."""
    import torch

    C = x.shape[-1]
    flat = x.reshape(-1, C)
    m = None if mask is None else mask.reshape(-1, 1)
    h = flat.shape[0] // 2
    parts = []
    for rows in (slice(0, h), slice(h, None)):
        f = flat[rows]
        if m is None:
            n = torch.full((1,), f.shape[0], dtype=f.dtype, device=f.device)
        else:
            n = m[rows].sum().to(f.dtype)[None]
            f = torch.where(m[rows], f, torch.zeros((), dtype=f.dtype, device=f.device))
        parts.append(torch.cat([f.sum(0), (f * f).sum(0), n]))
    sums = parts[0] + parts[1]
    mean = sums[:C] / sums[2 * C]
    mean2 = sums[C:2 * C] / sums[2 * C]
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def recall_lines(eval_dir):
    """The recall lines of the eval log under eval_dir."""
    logs = sorted(Path(eval_dir).glob("log_eval_*.txt"))
    check(len(logs) == 1, f"{len(logs)} eval logs under {eval_dir}")
    return [line.split("  ")[-1] for line in logs[0].read_text().splitlines()
            if "recall_" in line]


def multi_process_phases(dev, kitti_root, waymo_root):
    """Phases 31-34. Returns the per-kernel reports and launch counts of
    phase 31's recorded step (rank 0) and of phase 34's recorded forward
    (rank 0)."""
    import pickle

    import torch

    from tsm_det_pointcloud_tpu_torch import evaluate
    from tsm_det_pointcloud_tpu_torch.datasets import (build_dataloader, load_batch,
                                                       load_data_to_device, to_torch_batch)
    from tsm_det_pointcloud_tpu_torch.infer import load_cfg
    from tsm_det_pointcloud_tpu_torch.models.backbones_3d import pointnet2_modules
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import is_student, train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer

    cfg_file = ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"
    cfg = load_cfg(cfg_file)
    classes = list(cfg.CLASS_NAMES)
    teacher = kitti_root.parent / "recipe" / "teacher" / "ckpt" / "checkpoint_epoch_1.pth"
    check(teacher.exists(), f"no teacher checkpoint {teacher}")
    out = kitti_root.parent / "multi"
    torch.cuda.empty_cache()

    t_phase = time.perf_counter()

    def took(phase):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_phase:.1f} s")
        t_phase = now

    # ---- 31. data-parallel training: two ranks on the card over gloo ----
    ranks, wall = wait_ranks(start_ranks("dist_train", (cfg_file, kitti_root, teacher, out)))
    r0, r1 = ranks
    n_steps = len(r0["steps"])
    check(n_steps == KITTI_TRAIN // (DIST_WORLD * DIST_BATCH) and len(r1["steps"]) == n_steps,
          f"{n_steps} / {len(r1['steps'])} steps")
    for i in range(n_steps):
        for r in ranks:
            check(r["steps"][i]["mismatches"] == [], f"after step {i + 1} these tensors differ "
                  f"across the ranks: {r['steps'][i]['mismatches'][:5]}")
    differ = [k for k in r0["grads"] if not np.array_equal(r0["grads"][k], r1["grads"][k])]
    check(not differ, f"the reduced gradients differ across the ranks: {differ[:5]}")
    for name in KITTI_KERNELS:
        for r in ranks:
            check(r["launches"][name] > 0, f"kernel {name} was not launched on a rank's "
                  f"data-parallel training path")
    # the one-process references: the same first step at b16 on the same 16
    # samples, once in the loader's order, once with rank 0's samples, then
    # rank 1's, and every BN's sums taken over each rank's half and added
    # (the ranks' summation order); each from a model built as train builds it
    train_set, _, sampler = build_dataloader(cfg.DATA_CONFIG, classes, KITTI_BATCH,
                                             root_path=kitti_root, workers=0, seed=0)
    first16, second16 = sampler.batches()[:2]
    frames = sorted(str(f) for r in ranks for f in r["steps"][0]["frames"])
    by_id = {str(train_set.kitti_infos[i]["point_cloud"]["lidar_idx"]): i for i in first16}
    check(sorted(by_id) == frames, "the ranks' first batches are not the first 16 samples")
    rank_order = [by_id[str(f)] for r in ranks for f in r["steps"][0]["frames"]]

    def one_step(indices, split_stats):
        _, model, opt = build_trainer(cfg_file, dev, 0, total_steps=n_steps,
                                      pretrained_model=teacher, dataset=train_set)
        batch = load_data_to_device(to_torch_batch(load_batch(train_set, indices, 0, 0)), dev)
        grads, opt_step = {}, opt.step

        def then_step():
            grads.update(arrays({n: p.grad for n, p in model.named_parameters()
                                 if p.grad is not None}))
            return opt_step()

        opt.step = then_step
        stats = pointnet2_modules._masked_stats
        if split_stats:
            pointnet2_modules._masked_stats = halves_stats
        try:
            loss, tb = train_step(model, opt, batch)
            torch.cuda.synchronize()
        finally:
            pointnet2_modules._masked_stats = stats
        return model, opt, float(loss), {k: float(v) for k, v in tb.items()}, grads

    def grad_excess(want, got, names):
        """Over `names`, the largest excess of `got` over rtol 1e-3 around
        `want` in units of the tensor's atol, and the tensors past it."""
        scale = max(float(np.abs(want[n]).max()) for n in names)
        ratios = {}
        for n in names:
            atol = 1e-4 * max(float(np.abs(want[n]).max()), 1e-2 * scale)
            ratios[n] = float(np.max(np.abs(got[n] - want[n]) - 1e-3 * np.abs(want[n]))) / atol
        return max(ratios.values()), sorted((n for n, v in ratios.items() if v > 1),
                                            key=lambda n: -ratios[n])

    _, _, loss_s, tb_s, grads_s = one_step(rank_order, True)
    model, opt, loss, tb, grads = one_step(first16, False)
    trained = [n for n in grads if is_student(n)]
    check(set(trained) == set(r0["grads"]) == {n for n in grads_s if is_student(n)},
          "the ranks' and the process's gradients differ in their tensors")
    batch2 = load_data_to_device(to_torch_batch(load_batch(train_set, second16, 0, 0)), dev)
    t0 = time.perf_counter()
    train_step(model, opt, batch2)
    torch.cuda.synchronize()
    one_rate = KITTI_BATCH / (time.perf_counter() - t0)
    del model, opt, batch2
    torch.cuda.empty_cache()
    rank_loss = float(np.mean([r["steps"][0]["loss"] for r in ranks]))
    for ref_loss, ref_tb, what in ((loss_s, tb_s, "in the ranks' order"),
                                   (loss, tb, "in the loader's order")):
        check(close_scalar(rank_loss, ref_loss), f"step 1 loss {rank_loss} vs one process "
              f"{what} {ref_loss}")
        for k, v in ref_tb.items():
            got = float(np.mean([r["steps"][0]["tb"][k] for r in ranks]))
            check(close_scalar(got, v), f"step 1 tb {k}: {got} vs one process {what} {v}")
    # the tiny TSM's step, whose gradients are well conditioned: every
    # student tensor held at the tolerance
    t_loss, t_grads = tiny_step()
    tiny_loss = float(np.mean([r["tiny"][0] for r in ranks]))
    check(close_scalar(tiny_loss, t_loss), f"tiny step loss {tiny_loss} vs one process {t_loss}")
    t_trained = sorted(t_grads)
    check(t_trained == sorted(r0["tiny"][1]) and len(t_trained) > 100, "tiny gradient tensors")
    t_worst, t_over = grad_excess(t_grads, r0["tiny"][1], t_trained)
    check(not t_over, f"tiny step gradients past the tolerance: {t_over[:5]}")
    # full width: the gradients against both references, as figures
    worst, over = grad_excess(grads_s, r0["grads"], trained)
    worst_plain, over_plain = grad_excess(grads, r0["grads"], trained)
    worst_order, over_order = grad_excess(grads, grads_s, trained)
    rel = [rel_l2(a, b, trained) for a, b in ((grads_s, r0["grads"]), (grads, r0["grads"]),
                                                (grads, grads_s))]
    print(f"phase 31: the tiny TSM's step (b2 a rank against b{TINY_BATCH} in one process, "
          f"on the card): loss {tiny_loss:.6f} vs {t_loss:.6f}, {len(t_trained)} student "
          f"gradients within the tolerance (worst {t_worst:.4f} of it). fast_cpc.yaml's step "
          f"1, {len(trained)} student gradients (relative L2 difference of all of them; past "
          f"the per-tensor tolerance): ranks vs one process in the ranks' summation order "
          f"{rel[0]:.3g}, {len(over)} (worst {worst:.1f}); ranks vs one process in the "
          f"loader's order {rel[1]:.3g}, {len(over_plain)} (worst {worst_plain:.1f}: "
          f"{over_plain[:4]}); the one process against itself with only its BN sums in the "
          f"ranks' order {rel[2]:.3g}, {len(over_order)} (worst {worst_order:.1f})")
    # each rank's epoch without the cross-rank checks of phase 31's own
    rates = [r["epochs"][0]["steps"] * DIST_BATCH / (r["epochs"][0]["seconds"] - sum(
        st["check_s"] for st in r["steps"])) for r in ranks]
    print(f"phase 31 data-parallel training (train --launcher pytorch, 2 ranks over gloo on "
          f"the one card, b{DIST_BATCH} each, {n_steps} steps, --pretrained_model "
          f"{teacher.name}): step 1 loss {rank_loss:.6f} (ranks' mean) vs {loss:.6f} one "
          f"process at b{KITTI_BATCH} ({loss_s:.6f} in the ranks' order); {len(tb)} tb terms "
          f"agree; "
          f"parameters, buffers and statistics bit-equal across the ranks after each step; "
          f"train scans/s per rank {[round(x, 3) for x in rates]} (sum {sum(rates):.3f}; an "
          f"epoch of {n_steps} steps whose first is recorded, the loader included, the checks "
          f"left out: {[round(sum(st['check_s'] for st in r['steps']), 3) for r in ranks]} s) vs "
          f"{one_rate:.3f} for one process at b{KITTI_BATCH} (its second step alone): the "
          f"ranks share the card's SMs, so this is no speed-up figure; peak memory per rank "
          f"{[round(r['peak'], 2) for r in ranks]} GiB; launches rank 0 {r0['launches']}; "
          f"{wall:.1f} s for the ranks")

    took(31)

    # ---- 32. the NCCL path at world size 1 against --launcher none ----
    sets = ["DATA_CONFIG.INFO_PATH.train", f"['kitti_infos_train_{WORLD1_FRAMES}.pkl']",
            "DATA_CONFIG.INFO_PATH.test", f"['kitti_infos_val_{WORLD1_FRAMES}.pkl']"]
    det_env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    runs = {launcher: start_ranks("world1", (launcher, cfg_file, kitti_root,
                                             out / f"world1_{launcher}", sets),
                                  world=1, backend=None, env=det_env)
            for launcher in ("pytorch", "none")}
    runs = {k: wait_ranks(h)[0][0] for k, h in runs.items()}
    a, b = runs["pytorch"], runs["none"]
    check(a["backends"] == ["nccl", "nccl"] and b["backends"] == [None, None],
          f"process groups joined: {a['backends']} and {b['backends']}")
    check(a["steps"] == 2 and a["losses"] == b["losses"] and len(a["losses"]) > 0,
          f"world-1 losses {a['losses']} vs --launcher none {b['losses']}")
    differ = [k for k in b["state"] if not np.array_equal(a["state"][k], b["state"][k])]
    check(not differ and set(a["state"]) == set(b["state"]),
          f"world-1 parameters differ from --launcher none: {differ[:5]}")
    check(len(a["annos"]) == len(b["annos"]) == WORLD1_FRAMES, "world-1 eval frames")
    for k, v in b["raw"].items():
        check(np.array_equal(a["raw"][k], v), f"world-1 eval {k} differs from --launcher none")
    for x, y in zip(a["annos"], b["annos"]):
        check(x["frame_id"] == y["frame_id"] and all(
            np.array_equal(x[k], y[k]) for k in ("boxes_lidar", "score", "name")),
            f"world-1 detections of frame {x['frame_id']} differ from --launcher none")
    print(f"phase 32 NCCL at world size 1 (train --launcher pytorch, 2 steps, then evaluate "
          f"1 batch of {WORLD1_FRAMES}; deterministic algorithms on): losses "
          f"{[round(v, 6) for v in a['losses']]}, {len(a['state'])} state tensors, the eval "
          f"forward's batch_cls_preds / batch_box_preds {b['raw']['batch_box_preds'].shape} and "
          f"{sum(len(x['name']) for x in a['annos'])} detections bit-equal to --launcher none")

    took(32)

    # ---- 33-34: one spawn of two ranks runs phase 33's sharded eval, then
    # phase 34's point-axis eval and training, each in a group of its own ----
    ckpt = Path(r0["ckpt"])
    wcfg = ROOT / "tools/cfgs/waymo_models/waymo_fast_cpc.yaml"
    jobs = [("dist_eval", (cfg_file, kitti_root, ckpt, out)),
            ("point_axis", (wcfg, waymo_root, out / "pax")),
            ("point_axis_train", (wcfg, waymo_root, out / "pax_train"))]
    in_turn, wall = wait_ranks(start_ranks(
        "in_turn", ([(job, args, port) for (job, args), port in zip(jobs, free_ports(3))],)))
    (evals, eval_s), (paxes, pax_s), (trains, train_s) = (
        ([r[i][0] for r in in_turn], max(r[i][1] for r in in_turn)) for i in range(3))
    print(f"phases 33-34's ranks: {wall:.1f} s in one spawn (the jobs {eval_s:.1f}, "
          f"{pax_s:.1f} and {train_s:.1f} s on the slower rank)")

    # ---- 33. sharded eval: two ranks over gloo against one process ----
    ranks = evals
    res2 = ranks[0]["res"]
    check(ranks[1]["res"] == {}, "rank 1 returned an eval result")
    res1 = evaluate.main(["--cfg_file", str(cfg_file), "--data_root", str(kitti_root),
                          "--ckpt", str(ckpt), "--batch_size", str(DIST_BATCH), "--workers",
                          str(DIST_WORKERS), "--output_dir", str(out), "--eval_tag",
                          "one_process", "--device", str(dev)])
    with open(out / "eval" / "two_ranks" / "result.pkl", "rb") as f:
        two = pickle.load(f)
    with open(out / "eval" / "one_process" / "result.pkl", "rb") as f:
        one = pickle.load(f)
    check([x["frame_id"] for x in two] == [x["frame_id"] for x in one] and len(one) == KITTI_VAL,
          "the merged frames are not the one-process frames in order")
    for x, y in zip(two, one):
        check(all(np.array_equal(x[k], y[k]) for k in ("boxes_lidar", "score", "name")),
              f"merged detections of frame {x['frame_id']} differ from one process's")
    aps1 = {k: float(v) for k, v in res1.items() if "/" in k}
    aps2 = {k: float(v) for k, v in res2.items() if "/" in k}
    keys = sorted(aps1)
    check(keys == sorted(aps2) and len(keys) > 0 and np.array_equal(
        [aps1[k] for k in keys], [aps2[k] for k in keys], equal_nan=True),
        f"the merged AP dict differs from one process's: {aps2} vs {aps1}")
    rec2, rec1 = (recall_lines(out / "eval" / t) for t in ("two_ranks", "one_process"))
    check(rec2 == rec1 and len(rec1) > 0, f"recall {rec2} vs one process {rec1}")
    print(f"phase 33 sharded eval (evaluate --launcher pytorch, 2 ranks over gloo, b{DIST_BATCH} "
          f"each): rank 0's merged {len(two)} frames, their boxes and scores, the {len(aps1)} "
          f"APs and the summed recall ({'; '.join(rec1)}) equal one process's; "
          f"{res2['scans_per_s']:.3f} scans/s merged over rank 0's loop vs "
          f"{res1['scans_per_s']:.3f} one process; peak memory per rank "
          f"{[round(r['peak'], 2) for r in ranks]} GiB; {eval_s:.1f} s for the ranks")

    # ---- 34. the point axis: two ranks split each Waymo scan's points ----
    ranks = paxes
    p0, p1 = ranks
    check(p0["plain_equal"] is True, "layer 0's picks differ from segment_local_fps_plain")
    check(p0["n_local"] == WAYMO_TEST_POINTS // DIST_WORLD, f"{p0['n_local']} points a segment")
    check(np.array_equal(p0["boxes"], p1["boxes"]), "the ranks' batch_box_preds differ")
    check(np.isfinite(p0["boxes"]).all(), "non-finite box preds")
    for name in WAYMO_EVAL_KERNELS:
        for r in ranks:
            check(r["launches"][name] > 0, f"kernel {name} was not launched on a rank's "
                  f"point-axis path")
    aps = {k: float(v) for k, v in p0["res"].items() if "/" in k}
    check(len(aps) == 12 and all(np.isfinite(v) for v in aps.values()), f"AP dict {aps}")
    print(f"phase 34 point axis (evaluate --point_axis {DIST_WORLD}, waymo_fast_cpc.yaml, "
          f"b{WAYMO_BATCH} x {WAYMO_TEST_POINTS}: {p0['n_local']} points a scan a rank): "
          f"layer 0's {p0['npoint']} picks equal segment_local_fps_plain on the whole cloud, "
          f"the ranks' batch_box_preds {p0['boxes'].shape} bit-equal, AP dict finite; "
          f"{p0['scans_per_s']:.3f} scans/s; peak memory per rank "
          f"{[round(r['peak'], 2) for r in ranks]} GiB; launches rank 0 {p0['launches']}; "
          f"{pax_s:.1f} s for the ranks")
    ranks = trains
    for r in ranks:
        e = r["epochs"][0]
        check(r["deterministic"] and e["steps"] == 1 and np.isfinite(e["mean_loss"]),
              f"point-axis training: {e['steps']} steps, mean loss {e['mean_loss']}")
        for name in TSM_KERNELS:
            check(r["launches"][name] > 0, f"kernel {name} was not launched on a rank's "
                  f"point-axis training step")
    e = ranks[0]["epochs"][0]
    print(f"phase 34 point-axis training (train --point_axis {DIST_WORLD}, 1 step at "
          f"b{PAX_TRAIN_BATCH} x 120000, 60000 points a scan a rank, deterministic "
          f"algorithms): loss {e['mean_loss']:.4f}, parameters and buffers bit-equal across "
          f"the ranks after it; peak memory per rank "
          f"{[round(r['epochs'][0]['peak_gib'], 2) for r in ranks]} GiB; launches rank 0 "
          f"{ranks[0]['launches']}; {train_s:.1f} s for the ranks")
    took("33-34")
    return r0["report"], r0["launches"], p0["report"], p0["launches"]


# ---------------------------------------------------------------------------
# phases 35-39: PointPillars (pointpillar.yaml) and CenterPoint
# (centerpoint.yaml)
# ---------------------------------------------------------------------------

def zoo_golden_phase(dev):
    """Phase 35: the tiny PointPillars and the tiny CenterPoint reproduce
    their JAX goldens on the card."""
    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import detect
    from tsm_det_pointcloud_tpu_torch.models import build_network

    pts = torch.from_numpy(tiny.second_points(2)).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    cases = (("pointpillar", tiny.pointpillar_model_cfg(), tiny.POINTPILLAR_META,
              tiny.load_state(tiny.POINTPILLAR_STATE_PATH),
              ROOT / "tests/goldens/pointpillar_forward.npz"),
             ("centerpoint", tiny.centerpoint_model_cfg(), tiny.CENTERPOINT_META,
              tiny.centerpoint_eval_state(), tiny.CENTERPOINT_FORWARD_PATH))
    for name, cfg, meta, state, path in cases:
        model = build_network(cfg, len(meta.class_names), meta, device=dev)
        model.load_state_dict(state, strict=True)
        out, pred = detect(model, pts, mask)
        with np.load(path) as golden:
            for key in golden.files:
                want = golden[key]
                got = (out[key] if key in out else pred[key]).cpu().numpy()
                if want.dtype.kind in "iu":
                    check(np.array_equal(got, want), f"tiny {name} {key} differs from the "
                          f"golden: {got} against {want}")
                    continue
                scale = max(1.0, float(np.abs(want).max()))
                diff = float(np.abs(got - want).max())
                check(got.shape == want.shape
                      and np.allclose(got, want, atol=1e-3 * scale, rtol=1e-3),
                      f"tiny {name} {key} differs from the golden: max abs diff {diff}")
                print(f"zoo reference: tiny {name} {key} {got.shape} max abs diff vs golden "
                      f"{diff:.3g}")
        del model, out, pred


def pointpillar_phases(dev):
    """Phase 36: pointpillar.yaml's eval and training step at full width on
    synthetic scans. PointPillars runs no hand-written kernel: the phase
    checks that none was called or launched."""
    import torch

    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, synth_scans,
                                                    voxel_anchor_counts)
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    cfg_file = ROOT / "tools/cfgs/kitti_models/pointpillar.yaml"
    cfg, model = build_detector(cfg_file, dev, seed=0, n_points=ZOO_POINTS)
    post = cfg.MODEL.POST_PROCESSING
    post_max, pre = int(post.NMS_CONFIG.NMS_POST_MAXSIZE), int(post.NMS_CONFIG.NMS_PRE_MAXSIZE)
    meta = model.dataset_meta
    batches = [torch.from_numpy(synth_scans(meta, PILLAR_BATCH, ZOO_POINTS, seed=s)).to(dev)
               for s in range(ZOO_ITERS)]
    mask = torch.ones((PILLAR_BATCH, ZOO_POINTS), dtype=torch.bool, device=dev)
    rec = record_kernels(KERNELS)
    _kernels.reset_launches()
    out, _ = detect(model, batches[0], mask)   # warm-up: cuDNN times its algorithms
    torch.cuda.synchronize()
    rec.restore()
    check(not any(rec.calls.values()) and not any(_kernels.LAUNCHES.values()),
          f"pointpillar called hand-written kernels: {dict(_kernels.LAUNCHES)}")
    pillars, over = voxel_anchor_counts(model, out)
    n_anchors = out["batch_cls_preds"].shape[1]
    del out, rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    preds = [detect(model, pts, mask) for pts in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(not any(_kernels.LAUNCHES.values()), f"pointpillar launched {dict(_kernels.LAUNCHES)}")
    for out, pred in preds:
        for key in ("batch_cls_preds", "batch_box_preds"):
            check(bool(torch.isfinite(out[key]).all()), f"pointpillar: non-finite {key}")
        check(tuple(out["batch_box_preds"].shape) == (PILLAR_BATCH, 321408, 7),
              f"pointpillar box preds shape {tuple(out['batch_box_preds'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"pointpillar: non-finite {key}")
        check(bool((pred["count"] <= post_max).all()), "pointpillar: count > NMS_POST_MAXSIZE")
    counts = [int(c) for c in preds[-1][1]["count"]]
    print(f"pointpillar eval: {ZOO_ITERS} batches x {PILLAR_BATCH} scans x {ZOO_POINTS} points "
          f"in {dt:.3f} s = {ZOO_ITERS * PILLAR_BATCH / dt:.3f} scans/s; pillars a scan "
          f"(capacity {meta.max_voxels}, {meta.max_points_per_voxel} points a pillar) "
          f"{pillars}; anchors over SCORE_THRESH {post.SCORE_THRESH} a scan {over} of "
          f"{n_anchors}; boxes into NMS a scan {[min(o, pre) for o in over]}; detections "
          f"a scan (last batch) {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; no hand-written kernel "
          f"called or launched (no row in the kernels line)")
    del model, preds, batches, out, pred
    torch.cuda.empty_cache()

    _, model, opt = build_trainer(cfg_file, dev, seed=0, n_points=ZOO_POINTS,
                                  total_steps=ZOO_TRAIN_ITERS + 1)
    meta = model.dataset_meta
    tbatches = [synth_train_batch(ZOO_TRAIN_BATCH, ZOO_POINTS, s, dev, meta.point_cloud_range,
                                  meta.num_point_features)
                for s in range(ZOO_TRAIN_ITERS + 1)]
    warm, tb = train_step(model, opt, tbatches[0])
    check(bool(torch.isfinite(warm)), "pointpillar warm-up step loss is not finite")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [train_step(model, opt, b)[0] for b in tbatches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(not any(_kernels.LAUNCHES.values()), f"pointpillar launched {dict(_kernels.LAUNCHES)}")
    for i, loss in enumerate(losses):
        check(bool(torch.isfinite(loss)), f"pointpillar training step {i} loss is not finite")
    for n, p in model.named_parameters():
        check(not torch.equal(p, before[n]), f"pointpillar parameter {n} did not change")
    print(f"pointpillar training: voxel capacity {meta.max_voxels}; warm-up loss "
          f"{float(warm):.4f} ({', '.join(f'{k} {float(v):.4f}' for k, v in tb.items())}); "
          f"{ZOO_TRAIN_ITERS} steps x {ZOO_TRAIN_BATCH} scans x {ZOO_POINTS} points in "
          f"{dt:.3f} s = {ZOO_TRAIN_ITERS * ZOO_TRAIN_BATCH / dt:.3f} train scans/s "
          f"({1e3 * dt / ZOO_TRAIN_ITERS:.1f} ms/step); losses "
          f"{[round(float(v), 4) for v in losses]}; {len(before)} parameters changed; "
          f"peak memory {peak:.2f} GiB")
    del model, opt, tbatches, before, losses
    torch.cuda.empty_cache()


def centerpoint_phases(dev):
    """Phase 37: centerpoint.yaml's eval and training step at full width on
    synthetic scans, every K3 and K7 call of a recorded eval batch and of a
    recorded training step held against its plain version. Returns the
    per-kernel reports and the launch counts of both."""
    import torch

    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, synth_scans,
                                                    voxel_anchor_counts)
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    cfg_file = ROOT / "tools/cfgs/kitti_models/centerpoint.yaml"
    cfg, model = build_detector(cfg_file, dev, seed=0, n_points=ZOO_POINTS)
    post = cfg.MODEL.POST_PROCESSING
    post_max = int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
    k_max = int(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE)
    meta = model.dataset_meta
    batches = [torch.from_numpy(synth_scans(meta, ZOO_TRAIN_BATCH, ZOO_POINTS, seed=s)).to(dev)
               for s in range(ZOO_ITERS)]
    mask = torch.ones((ZOO_TRAIN_BATCH, ZOO_POINTS), dtype=torch.bool, device=dev)
    rec = record_kernels(SECOND_KERNELS)
    out, _ = detect(model, batches[0], mask)
    torch.cuda.synchronize()
    rec.restore()
    for name, n in CENTERPOINT_CALLS.items():
        check(len(rec.calls[name]) == n,
              f"the centerpoint capture forward made {len(rec.calls[name])} {name} calls, "
              f"not {n}")
    voxels, over = voxel_anchor_counts(model, out)
    print(f"centerpoint capture: voxel capacity {meta.max_voxels}; voxels a scan {voxels}; "
          f"decoded boxes over SCORE_THRESH {post.SCORE_THRESH} a scan {over} of {k_max}")
    del out
    report_eval = compare_recorded(rec.calls, "centerpoint")
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
        for key in ("final_boxes", "final_scores"):
            check(bool(torch.isfinite(out[key]).all()), f"centerpoint: non-finite {key}")
        check(tuple(out["final_boxes"].shape) == (ZOO_TRAIN_BATCH, k_max, 7),
              f"centerpoint final boxes shape {tuple(out['final_boxes'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"centerpoint: non-finite {key}")
        check(bool((pred["count"] <= post_max).all()), "centerpoint: count > NMS_POST_MAXSIZE")
    for name, n in CENTERPOINT_CALLS.items():
        check(launches_eval[name] == n * ZOO_ITERS,
              f"kernel {name} launched {launches_eval[name]} times on the centerpoint path, "
              f"not {n} a forward")
    counts = [int(c) for c in preds[-1][1]["count"]]
    print(f"centerpoint eval: {ZOO_ITERS} batches x {ZOO_TRAIN_BATCH} scans x {ZOO_POINTS} "
          f"points in {dt:.3f} s = {ZOO_ITERS * ZOO_TRAIN_BATCH / dt:.3f} scans/s; detections "
          f"a scan (last batch) {counts}; launches {launches_eval}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, preds, batches, out, pred
    torch.cuda.empty_cache()

    _, model, opt = build_trainer(cfg_file, dev, seed=0, n_points=ZOO_POINTS,
                                  total_steps=ZOO_TRAIN_ITERS + 1)
    meta = model.dataset_meta
    tbatches = [synth_train_batch(ZOO_TRAIN_BATCH, ZOO_POINTS, s, dev, meta.point_cloud_range,
                                  meta.num_point_features)
                for s in range(ZOO_TRAIN_ITERS + 1)]
    rec = record_kernels(SECOND_KERNELS)
    opt.zero_grad(set_to_none=True)
    out = model(dict(tbatches[0]))
    out["loss"].backward()
    torch.cuda.synchronize()
    rec.restore()
    for name, n in CENTERPOINT_CALLS.items():
        check(len(rec.calls[name]) == n,
              f"the centerpoint training step made {len(rec.calls[name])} {name} calls, "
              f"not {n}")
    for n, p in model.named_parameters():
        check(p.grad is not None, f"centerpoint parameter {n} got no gradient")
        if p.dim() == 3:
            check(bool(p.grad.abs().sum() > 0), f"sparse-conv weight {n} got a zero gradient")
    opt.step()
    check(bool(torch.isfinite(out["loss"])), "centerpoint warm-up step loss is not finite")
    print(f"centerpoint training capture: voxel capacity {meta.max_voxels}; loss "
          f"{float(out['loss'].detach()):.4f}, "
          + ", ".join(f"{k} {float(v.detach()):.4f}" for k, v in out["tb_dict"].items()))
    del out
    report_train = compare_recorded(rec.calls, "centerpoint train")
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
    for i, (loss, tb) in enumerate(steps):
        check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(v)) for v in tb.values()),
              f"centerpoint training step {i}: loss {float(loss)}, {tb}")
    for n, p in model.named_parameters():
        check(not torch.equal(p, before[n]), f"centerpoint parameter {n} did not change")
    for name, n in CENTERPOINT_CALLS.items():
        check(launches_train[name] == n * ZOO_TRAIN_ITERS,
              f"kernel {name} launched {launches_train[name]} times on the centerpoint "
              f"training path, not {n} a step")
    print(f"centerpoint training: {ZOO_TRAIN_ITERS} steps x {ZOO_TRAIN_BATCH} scans x "
          f"{ZOO_POINTS} points in {dt:.3f} s = {ZOO_TRAIN_ITERS * ZOO_TRAIN_BATCH / dt:.3f} "
          f"train scans/s ({1e3 * dt / ZOO_TRAIN_ITERS:.1f} ms/step); losses "
          + str([(round(float(loss), 4), round(float(tb["hm_loss_0"]), 4),
                  round(float(tb["reg_loss_0"]), 4)) for loss, tb in steps])
          + f" (loss, hm_loss_0, reg_loss_0); {len(before)} parameters changed; launches "
          f"{launches_train}; peak memory {peak:.2f} GiB")
    del model, opt, tbatches, before, steps
    torch.cuda.empty_cache()
    return report_eval, launches_eval, report_train, launches_train


def zoo_data_phases(dev, root):
    """Phase 38: pointpillar.yaml and centerpoint.yaml on the KITTI root of
    phase 22: echoed gt through each config's dataset, then `evaluate` and
    `train --data_root` on phase 29's SECOND_DATA_FRAMES val and train
    frames and `evaluate --ckpt` on the trained checkpoint, then `demo
    --ckpt` of pointpillar.yaml on phase 30's raw scans. Returns
    centerpoint's per-kernel reports and launch counts of its evaluate and
    train."""
    import torch

    from tsm_det_pointcloud_tpu_torch import demo, evaluate, train
    from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
    from tsm_det_pointcloud_tpu_torch.infer import load_cfg
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.runtime import train_loop

    n = SECOND_DATA_FRAMES
    sets = ["--set", "DATA_CONFIG.INFO_PATH.train", f"['kitti_infos_train_{n}.pkl']",
            "DATA_CONFIG.INFO_PATH.test", f"['kitti_infos_val_{n}.pkl']"]
    data = ["--data_root", str(root), "--workers", str(KITTI_WORKERS), "--device", str(dev)]
    reports, ckpts = {}, {}
    for name, names in (("pointpillar", ()), ("centerpoint", SECOND_KERNELS)):
        cfg_file = ROOT / f"tools/cfgs/kitti_models/{name}.yaml"
        cfg = load_cfg(cfg_file, sets[1:])
        classes = list(cfg.CLASS_NAMES)
        full = KittiDataset(load_cfg(cfg_file).DATA_CONFIG, classes, training=False,
                            root_path=root)
        _, echo = full.evaluation(echo_gt_annos(full.kitti_infos), classes)
        check(len(echo) == 72 and all(abs(v - 100.0) < 1e-6 for v in echo.values()),
              f"{name}: echoed gt does not score 100: {echo}")
        test_set = KittiDataset(cfg.DATA_CONFIG, classes, training=False, root_path=root)
        in_fov = [len(test_set[i]["points"]) for i in range(n)]
        dropped = [max(k - test_set.max_points, 0) for k in in_fov]
        out = root.parent / name
        res, launches_eval, peak, rec, first_out = run_recorded(
            f"{name} data eval", evaluate,
            ["--cfg_file", str(cfg_file), "--batch_size", str(ZOO_TRAIN_BATCH), "--output_dir",
             str(out)] + data + sets, detectors[cfg.MODEL.NAME], "forward", names)
        voxels = first_out["voxel_mask"].sum(1).tolist()
        del first_out
        check_kitti_aps(res, classes, f"{name} evaluate")
        for kname, k in CENTERPOINT_CALLS.items() if names else ():
            check(len(rec.calls[kname]) == k and launches_eval[kname] == k * (n // ZOO_TRAIN_BATCH),
                  f"{name} data eval: {len(rec.calls[kname])} {kname} calls a forward, "
                  f"{launches_eval[kname]} in all")
        if not names:
            check(not any(launches_eval.values()), f"{name} data eval launched {launches_eval}")
        print(f"{name} data eval (evaluate, seeded weights): echoed val gt through its "
              f"dataset scores 100.0 on all {len(echo)} APs; {n} scans at b{ZOO_TRAIN_BATCH}: "
              f"points in the field of view {in_fov}, dropped by the collate (MAX_POINTS "
              f"{test_set.max_points}) {dropped} (mean {np.mean(dropped):.1f} a scan); voxels "
              f"a scan of the first batch {voxels}; {eval_line(res)}; launches {launches_eval}; "
              f"peak memory {peak:.2f} GiB")
        if names:
            reports[f"{name}_data"] = (compare_recorded(rec.calls, f"{name} data eval"),
                                       launches_eval)
        (ckpt_dir, epochs), launches_train, _, rec, _ = run_recorded(
            f"{name} data train", train,
            ["--cfg_file", str(cfg_file), "--epochs", "1", "--batch", str(ZOO_TRAIN_BATCH),
             "--output_dir", str(out)] + data + sets, train_loop, "train_step", names)
        if not names:
            check(not any(launches_train.values()), f"{name} data train launched "
                  f"{launches_train}")
        print(f"{name} data train (train --data_root): {epochs_line(epochs)}; launches "
              f"{launches_train}")
        if names:
            reports[f"{name}_data_train"] = (compare_recorded(rec.calls, f"{name} data train"),
                                             launches_train)
        ckpts[name] = ckpt_dir / "checkpoint_epoch_1.pth"
        res = evaluate.main(["--cfg_file", str(cfg_file), "--ckpt", str(ckpts[name]),
                             "--batch_size", str(ZOO_TRAIN_BATCH), "--output_dir",
                             str(out / "ckpt_eval")] + data + sets)
        aps = check_kitti_aps(res, classes, f"{name} evaluate --ckpt")
        print(f"{name} data eval (evaluate --ckpt {ckpts[name].name}): {eval_line(res)}; "
              f"Car_3d/moderate_R40 {aps['Car_3d/moderate_R40']:.4f}")
        torch.cuda.empty_cache()

    cfg_file = ROOT / "tools/cfgs/kitti_models/pointpillar.yaml"
    scans = root.parent / "demo" / "scans"
    (preds, rate), launches, peak, _, _ = run_recorded(
        "pointpillar demo", demo, ["--cfg_file", str(cfg_file), "--data_path", str(scans),
                                   "--ckpt", str(ckpts["pointpillar"]), "--device", str(dev)],
        detectors["PointPillar"], "forward", ())
    post_max = int(load_cfg(cfg_file).MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    check(len(preds) == DEMO_SCANS and not any(launches.values()),
          f"pointpillar demo: {len(preds)} scans, launches {launches}")
    for p in preds:
        check(len(p["pred_labels"]) <= post_max and np.isfinite(p["pred_boxes"]).all()
              and np.isfinite(p["pred_scores"]).all(), "pointpillar demo: bad detections")
    print(f"pointpillar demo --ckpt {ckpts['pointpillar'].name}: {DEMO_SCANS} raw scans over "
          f"360 degrees: detections a scan {[len(p['pred_labels']) for p in preds]}; "
          f"{rate:.3f} scans/s (a scan a batch, loading included); peak memory {peak:.2f} GiB")
    return reports


def cfg_path(name):
    """A config file under tools/cfgs: `name` with its folder, or a KITTI
    config's file name."""
    return ROOT / "tools/cfgs" / (name if "/" in name else f"kitti_models/{name}")


def infer_profiles(jobs):
    """`infer --profile` of each (config file name, batch, points) of `jobs`
    in turn, in one fresh process, its output echoed; returns {config file
    name: `infer.main`'s two `profile_call` results}. That process starts
    with cuDNN's autotuner and the allocator empty: in this one, after the
    other phases, the autotuner once ended on an FFT conv for
    pointpillar.yaml, which fresh processes never picked."""
    argvs = [["--cfg_file", str(cfg_path(name)), "--batch", str(batch), "--points",
              str(points), "--iters", "0", "--profile"]
             for name, batch, points in jobs]
    code = ("import json, time; from tsm_det_pointcloud_tpu_torch import infer\n"
            f"for argv in {argvs!r}:\n"
            "    t0 = time.perf_counter()\n"
            "    print('PROFILE ' + json.dumps(infer.main(argv)), flush=True)\n"
            "    print(f'infer --profile of {argv[1]}: {time.perf_counter() - t0:.1f} s')\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    check(proc.returncode == 0, f"infer --profile failed: {proc.stderr[-3000:]}")
    results, lines = [], []
    for line in proc.stdout.splitlines():
        if line.startswith("PROFILE "):
            results.append(json.loads(line[len("PROFILE "):]))
        else:
            lines.append(line)
    print("\n".join(lines))
    check(len(results) == len(jobs), f"infer --profile gave {len(results)} of {len(jobs)}")
    print(f"infer --profile of {len(jobs)} configs in one process: "
          f"{time.perf_counter() - t0:.1f} s")
    return {name: r for (name, _, _), r in zip(jobs, results)}


# the profiles of phases 39, 44, 48, 52, 56 and 60: config file, batch, points a scan
PROFILES = (("pointpillar.yaml", PILLAR_PROFILE_BATCH, ZOO_POINTS),
            ("centerpoint.yaml", ZOO_TRAIN_BATCH, ZOO_POINTS),
            *((name, batch, TWO_STAGE_POINTS) for name, batch, _, _ in TWO_STAGE.values()),
            *((name, batch, scan_points(w)) for w, (name, batch, _, _) in POINTRCNN.items()),
            *((name, batch, TWO_STAGE_POINTS) for name, batch, _, _ in VOXEL_ROI.values()),
            *((name, batch, TWO_STAGE_POINTS) for name, batch, _, _ in PVRCNN_PP.values()),
            (NUSC_CFG, NUSC_BATCH, NUSC_POINTS), (PVSSDA_CFG, PVSSDA_PROFILE_BATCH, PVSSDA_POINTS),
            (PP_MULTIHEAD_CFG, PP_MULTIHEAD_BATCH, NUSC_POINTS),
            *((name, batch, TWO_STAGE_POINTS) for name, batch, _, _ in DSASNET.values()))


def zoo_profiles(profiles):
    """Phase 39, after every timed path (a profiler window slows the later
    launches of its process): `infer --profile` of pointpillar.yaml and of
    centerpoint.yaml at b4, 20000 points a scan (`profiles`, from
    `infer_profiles`); no cuDNN FFT (`fft` / `cgemm`) kernel may run."""
    for name in ("pointpillar", "centerpoint"):
        (wall, busy, names), (pwall, pbusy, _) = profiles[f"{name}.yaml"]
        fft = [k for k in names if "fft" in k.lower() or "cgemm" in k.lower()]
        check(not fft, f"{name}: cuDNN ran FFT convolutions: {fft}")
        print(f"{name} profile: busy {busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.1f}%), "
              f"post-processing alone {pbusy:.3f} ms device time of {pwall:.3f} ms; "
              f"{len(names)} kernels, none an FFT (`fft` / `cgemm`)")


# ---------------------------------------------------------------------------
# phases 40-44: Part-A2 (PartA2.yaml) and PV-RCNN (pvrcnn.yaml)
# ---------------------------------------------------------------------------

def hold_golden(label, out, pred, path):
    """The outputs and predictions of a tiny model's eval forward against a
    JAX golden: integer arrays (labels, counts) exact, the rest at the golden
    tolerance (atol 1e-3 * max(1, max|want|), rtol 1e-3)."""
    with np.load(path) as golden:
        for key in golden.files:
            want = golden[key]
            got = (out[key] if key in out else pred[key]).cpu().numpy()
            if want.dtype.kind in "iu":
                check(np.array_equal(got, want),
                      f"{label} {key} differs from the golden: {got} against {want}")
                continue
            scale = max(1.0, float(np.abs(want).max()))
            diff = float(np.abs(got - want).max())
            check(got.shape == want.shape
                  and np.allclose(got, want, atol=1e-3 * scale, rtol=1e-3),
                  f"{label} {key} differs from the golden: max abs diff {diff}")
            print(f"{label} {key} {got.shape} max abs diff vs golden {diff:.3g}")


# the tiny two-stage goldens of phases 40, 49 and 53, and the hand-written
# kernels each tiny forward launches (None: not counted)
TINY_GOLDENS = {"parta2": ("PARTA2_FORWARD_PATH", None),
                "pvrcnn": ("PVRCNN_FORWARD_PATH", None),
                "voxelrcnn": ("VOXELRCNN_FORWARD_PATH",
                              {"probe": 8, "spconv_gather": 12, "query_group": 2}),
                "secondnetiou": ("SECONDNETIOU_FORWARD_PATH",
                                 {"probe": 8, "spconv_gather": 12}),
                "pvrcnnplusplus": ("PVRCNNPLUSPLUS_FORWARD_PATH",
                                   {"fps": 1, "query_group": 6, "probe": 8,
                                    "spconv_gather": 12}),
                "dsasnet": ("DSASNET_FORWARD_PATH",
                            {"fps": 3, "query_group": 5, "probe": 10, "spconv_gather": 12})}


def two_stage_golden_phase(dev, whiches=("parta2", "pvrcnn")):
    """Phase 40 (49 with voxelrcnn and secondnetiou, 53 with
    pvrcnnplusplus, 75 with dsasnet): the tiny detectors
    (tiny.two_stage_state) reproduce their JAX goldens on the card (labels,
    counts and kept RoI labels exact), through the kernels they launch."""
    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import detect
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    pts = torch.from_numpy(tiny.second_points(2, 256)).to(dev)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    for which in whiches:
        path, launches = TINY_GOLDENS[which]
        cfg, meta = tiny.two_stage_model(which)
        model = build_network(cfg, 1, meta, device=dev)
        model.load_state_dict(tiny.two_stage_state(which), strict=True)
        _kernels.reset_launches()
        out, pred = detect(model, pts, mask)
        got = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        check(launches is None or got == launches, f"tiny {which} launches {got}")
        hold_golden(f"two-stage reference: tiny {which}", out, pred, getattr(tiny, path))
        del model, out, pred


def pool_all(out, grid_size):
    """Part-A2's RoI-aware pooling of a batch, as its RoI head runs it."""
    from tsm_det_pointcloud_tpu_torch.models.roi_heads.partA2_head import (roiaware_cells,
                                                                           roiaware_pool)

    seg = out["point_features"] * out["point_cls_scores"][..., None]
    for p, f, part, v, r in zip(out["point_coords"], seg, out["point_part_offset"],
                                out["point_valid"], out["rois"]):
        cells = roiaware_cells(p, v, r, grid_size)
        roiaware_pool(p, part, v, r, grid_size, "avg", cells)
        roiaware_pool(p, f, v, r, grid_size, "max", cells)


def keypoint_line(out, points):
    """PV-RCNN++'s keypoints of an eval forward, per scan: the distinct
    keypoints, and the copies of point 0 among them and how many of those
    are marked valid (an empty sector's picks are all index 0, and
    point_valid reads point 0's validity, as in the JAX package)."""
    import torch

    kp, valid = out["point_coords"], out["point_valid"]
    distinct = [int(torch.unique(k, dim=0).shape[0]) for k in kp]
    zero = (kp == points[:, :1, :3]).all(-1)
    return (f"distinct keypoints a scan {distinct} of {kp.shape[1]}; copies of point 0 a "
            f"scan {zero.sum(1).tolist()}, marked valid {(zero & valid).sum(1).tolist()}")


def hold_sector_rows(which, args):
    """Phase 54's K6 sector launch again, on its recorded rows (B x SECTORS
    sector rows: the empty sectors of a scan over KITTI's range, rows whose
    valid set excludes index 0) with each scan's fullest sector thinned to
    SECTOR_THIN_POINTS valid points, fewer than its picks: index-equal to
    the plain d-fps, as phase 10's masked input."""
    import torch

    xyz, npoint, valid = args
    counts = valid.sum(1)
    empty = int((counts == 0).sum())
    no_zero = int((~valid[:, 0] & (counts > 0)).sum())
    thinned = valid.clone()
    rows = (counts.reshape(-1, SECTORS).argmax(1)
            + torch.arange(xyz.shape[0] // SECTORS, device=xyz.device) * SECTORS).tolist()
    for r in rows:
        keep = torch.nonzero(valid[r])[:SECTOR_THIN_POINTS, 0]
        thinned[r] = False
        thinned[r, keep] = True
    check(empty > 0 and no_zero > 0, f"{which}: the sector rows hold {empty} empty rows and "
          f"{no_zero} rows without point 0")
    compare_fps_block((xyz, npoint, thinned))
    EXTRAS.pop("fps_block", None)
    print(f"{which} fps_block on the sector rows {tuple(xyz.shape)} at {npoint} picks: "
          f"{empty} empty rows, {no_zero} non-empty rows whose valid set excludes index 0, "
          f"the valid points a row {counts.tolist()}; index-equal to the plain d-fps, and "
          f"again with {len(rows)} rows thinned to {SECTOR_THIN_POINTS} valid points "
          f"(fewer than the picks)")


def hold_zero_weight_rows(which, args):
    """Phase 76's second s-fps stage (its 512 picks over the key-point
    candidates outside the first stage's, weights 0 within 40 m) again on
    its recorded rows, with weights left on only 100 points of each row and
    none at all on the first row: the later picks are all-zero ties, which
    K1 must break to the lowest index as the plain s-fps does."""
    xyz, npoint, valid, weights = args
    thinned = weights.clone()
    thinned[:, 100:] = 0
    thinned[0] = 0
    zero_rows = int(((weights * valid) == 0).all(1).sum())
    compare_fps((xyz, npoint, valid, thinned))
    EXTRAS.pop("fps", None)
    print(f"{which} fps (s-fps stage 2) on its recorded rows {tuple(xyz.shape)} at {npoint} "
          f"picks: the weighted points a row {((weights > 0) & valid).sum(1).tolist()} "
          f"({zero_rows} rows all zero); index-equal to the plain s-fps again with weights on "
          f"100 points a row and on none of row 0")


def _through(model, batch, n_modules):
    """The first `n_modules` of the detector's module list on `batch`, no
    gradient: the batch dict they write."""
    import torch

    with torch.no_grad():
        for m in model.module_list[:n_modules]:
            batch = m(batch)
    return batch


@contextmanager
def top_k_fed(picks=None):
    """Within the block, the hybrids' score-ordered selections
    (`point_bev_hybrids._top_k`) either record their picks (`picks` None:
    the yielded list gets each call's (B, k) indices, on the host) or take
    the picks of such a record, call by call, once they are held against
    this run's own top-k: as many valid picks a row, no pick twice, and this
    run's scores at them, sorted, equal to its own top-k's at the golden
    tolerance (atol 1e-3 * max(1, max|score|), rtol 1e-3). The two devices'
    scores differ in their rounding, so near-equal scores can order apart;
    the yielded list then gets, a call, (the picks not in this run's own
    top-k, all picks, the largest gap of the sorted scores)."""
    import torch

    from tsm_det_pointcloud_tpu_torch.models.backbones_2d import point_bev_hybrids as hyb

    orig = hyb._top_k
    out = []

    def record(s, k):
        idx = orig(s, k)
        out.append(idx.cpu())
        return idx

    def fed(s, k):
        own = orig(s, k)
        i = len(out)
        check(i < len(picks), f"top-k call {i}: the card made {len(picks)}")
        got = picks[i].to(s.device)
        check(got.shape == own.shape, f"top-k call {i}: {tuple(got.shape)} picks on the card, "
                                      f"{tuple(own.shape)} here")
        srt = got.sort(1).values
        check(bool((srt[:, 1:] != srt[:, :-1]).all()), f"top-k call {i}: a pick twice")
        want_v = torch.gather(s, 1, own)
        got_v = torch.gather(s, 1, got).sort(1, descending=True).values
        fin = torch.isfinite(want_v)
        check(torch.equal(fin, torch.isfinite(got_v)), f"top-k call {i}: the card picked "
                                                        f"another count of valid points")
        scale = max(1.0, float(s[torch.isfinite(s)].abs().max())) if fin.any() else 1.0
        gap = (got_v - want_v)[fin].abs()
        check(bool((gap <= 1e-3 * scale + 1e-3 * want_v[fin].abs()).all()),
              f"top-k call {i}: the card's picks score up to {float(gap.max())} off the top "
              f"{k} here")
        differ = int((~(got[:, :, None] == own[:, None, :]).any(-1)).sum())
        out.append((differ, got.numel(), float(gap.max()) if gap.numel() else 0.0))
        return got

    hyb._top_k = record if picks is None else fed
    try:
        yield out
    finally:
        hyb._top_k = orig
    if picks is not None:
        check(len(out) == len(picks), f"{len(out)} top-k calls here, {len(picks)} on the card")


def check_variant_calls(label, calls, launches, want):
    """The recorded calls of a pass (`split_calls`) and its launch counts
    both as `want`, kernel by kernel."""
    got = {k: len(v) for k, v in calls.items()}
    ran = {k: v for k, v in launches.items() if v}
    check(got == want and ran == want,
          f"{label}: recorded kernel calls {got}, launches {ran}, not {want}")


def _hold_close(label, got, want):
    """Each tensor of `want` (CPU) against `got` (the card's) at the golden
    tolerance (bool and integer tensors equal); the worst difference in units
    of max(1, max|want|)."""
    import torch

    worst = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        if w.dtype in (torch.bool, torch.int32, torch.int64):
            check(torch.equal(g, w), f"{label}: {k} on the card differs from the CPU's")
            continue
        scale = max(1.0, float(w.abs().max()))
        diff = float((g - w).abs().max())
        check(g.shape == w.shape and bool(torch.allclose(g, w, rtol=1e-3, atol=1e-3 * scale)),
              f"{label}: {k} on the card differs from the CPU's by {diff}")
        worst = max(worst, diff / scale)
    return worst


def _held_within(name, res):
    """The card's outputs of `VARIANT_HELD[name]` against the CPU's
    (`_hold_close`); the worst difference in units of max(1, max|want|)."""
    return _hold_close(name, res["cuda"], {k: res["cpu"][k] for k in VARIANT_HELD[name]})


def dsasnet_variant_phases(dev):
    """Phase 78: each of VARIANTS (`infer.variant_cfg`) at full width on
    synthetic scans, on cuDNN's heuristics (its first-use autotune of these
    maps' backward convs took 329.0 s for BEVPoint's 800 x 704 ones, 25.2 s
    for VoxelPointCross's and 14.9 s for the neck's on the card, PERF.md):
    one eval batch and one training step of VARIANT_BATCH x VARIANT_POINTS
    (seeded weights; outputs, detections and the loss finite, the
    gradients finite, no parameter without one but those no loss reads),
    each with every kernel call recorded, its calls and launches as
    VARIANT_CALLS, and each call held against its plain version; then one
    scan of VARIANT_CPU_POINTS points through the same weights at that voxel
    capacity on the card and on the CPU, the module list up to
    VARIANT_HELD's outputs (the hybrid; the neck's PVSSDA up to its anchor
    head, before NMS), the card's score-ordered picks fed to the CPU and held
    there (`top_k_fed`), the outputs at the golden tolerance (atol 1e-3 *
    max(1, max|want|), rtol 1e-3). Returns {"variant_<name>[_train]": (the
    per-kernel report, the launch counts)}."""
    import dataclasses

    import torch

    from tsm_det_pointcloud_tpu_torch import infer
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    keys = ("point_features", "batch_cls_preds", "batch_box_preds", "spatial_features_2d")
    reports = {}
    try:
        for name in VARIANTS:
            t_v = time.perf_counter()
            cfg = infer.variant_cfg(name)
            want_eval, want_train = VARIANT_CALLS[name]
            batch = VARIANT_BATCH[name]
            _, model = infer.build_detector(cfg, dev, seed=0, n_points=VARIANT_POINTS)
            torch.backends.cudnn.benchmark = False      # build_network turns it on
            meta = model.dataset_meta
            pts = torch.from_numpy(infer.synth_scans(meta, batch, VARIANT_POINTS,
                                                     seed=0)).to(dev)
            mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launches()
            rec = record_kernels(VARIANT_KERNELS)
            t0 = time.perf_counter()
            out, pred = infer.detect(model, pts, mask)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rec.restore()
            launches = dict(_kernels.LAUNCHES)
            calls = split_calls(rec.calls)
            check_variant_calls(f"variant {name} eval", calls, launches, want_eval)
            post_max = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
            for key in keys:
                check(bool(torch.isfinite(out[key]).all()), f"{name}: non-finite {key}")
            check(bool((pred["count"] <= post_max).all()) and all(
                bool(torch.isfinite(pred[k]).all()) for k in ("pred_boxes", "pred_scores")),
                f"{name}: detections {pred['count'].tolist()}")
            print(f"variant {name} eval: b{batch} x {VARIANT_POINTS}, the first batch "
                  f"(its kernel calls recorded), {1e3 * dt:.1f} ms; points to the heads "
                  f"{tuple(out['point_features'].shape)}, map "
                  f"{tuple(out['spatial_features_2d'].shape)}; detections "
                  f"{pred['count'].tolist()}; launches {want_eval}; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            del model, out, pred, rec
            torch.cuda.empty_cache()
            slug = f"variant_{name.lower()}"
            reports[slug] = (compare_recorded(calls, f"variant {name}"), launches)
            del calls
            t_eval = time.perf_counter() - t_v

            _, tmodel, opt = build_trainer(cfg, dev, seed=0, n_points=VARIANT_POINTS)
            torch.backends.cudnn.benchmark = False
            tb = synth_train_batch(batch, VARIANT_POINTS, 0, dev,
                                   meta.point_cloud_range, meta.num_point_features)
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launches()
            rec = record_kernels(VARIANT_KERNELS)
            t0 = time.perf_counter()
            tout = tmodel(dict(tb, accumulated_iter=0))
            tout["loss"].backward()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rec.restore()
            launches = dict(_kernels.LAUNCHES)
            calls = split_calls(rec.calls)
            check_variant_calls(f"variant {name} training step", calls, launches, want_train)
            idle = [n for n, p in tmodel.named_parameters() if p.grad is None]
            for n, p in tmodel.named_parameters():
                check(p.grad is None or bool(torch.isfinite(p.grad).all()),
                      f"{name}: parameter {n} got a non-finite gradient")
            check(bool(torch.isfinite(tout["loss"])) and tmodel.unused_parameters == bool(idle),
                  f"{name} training step: loss {float(tout['loss'].detach())}, {len(idle)} "
                  f"parameters without a gradient")
            print(f"variant {name} training step: b{batch}, loss "
                  f"{float(tout['loss'].detach()):.4f}, {1e3 * dt:.1f} ms (the first, its kernel "
                  f"calls recorded); {len(idle)} of {sum(1 for _ in tmodel.parameters())} "
                  f"parameters without a gradient (no loss reads them: "
                  f"{sorted({'.'.join(n.split('.')[:3]) for n in idle})[:8]}); launches "
                  f"{want_train}; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del tmodel, opt, tb, tout, rec
            torch.cuda.empty_cache()
            reports[f"{slug}_train"] = (compare_recorded(calls, f"variant {name} train"),
                                        launches)
            del calls
            t_train = time.perf_counter() - t_v - t_eval

            n = VARIANT_CPU_POINTS[name]
            small = dataclasses.replace(meta, max_voxels=n, max_points=n)
            scan = torch.from_numpy(infer.synth_scans(small, 1, n, seed=1))
            upto = 6 if name == "neck" else 4
            res, picks = {}, None
            for where in (dev, torch.device("cpu")):
                m = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), small, device=where)
                torch.backends.cudnn.benchmark = False
                m.load_state_dict(state, strict=True)
                with top_k_fed(picks) as seen:
                    o = _through(m, {"points": scan.to(where), "batch_size": 1,
                                     "points_mask": torch.ones(1, n, dtype=torch.bool,
                                                               device=where)}, upto)
                if picks is None:
                    picks = seen
                res[where.type] = {k: o[k].cpu() for k in VARIANT_HELD[name]}
                del m, o
            worst = _held_within(name, res)
            fed = "; ".join(f"{d} of {p} differ from the CPU's own top-k, their scores within "
                            f"{g:.3g}" for d, p, g in seen) or "none"
            print(f"variant {name}: a scan of {n} points on the card against the CPU (voxel "
                  f"capacity {n}, modules 0-{upto - 1}): {', '.join(VARIANT_HELD[name])} within "
                  f"{worst:.3g} x max(1, max|want|); the card's score-ordered picks fed to the "
                  f"CPU: {fed}; seconds: eval and its calls held {t_eval:.1f}, training step "
                  f"and its calls held {t_train:.1f}, card against CPU "
                  f"{time.perf_counter() - t_v - t_eval - t_train:.1f}")
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = True
    return reports


def two_stage_phases(dev, which):
    """Phase 41 (which "parta2"), 42 ("pvrcnn"), 46 ("pointrcnn"), 50
    ("voxelrcnn", "secondnetiou"), 54 ("pvrcnnplusplus") or 76-77
    ("dsasnet": its second s-fps stage again on rows of zero weights,
    `hold_zero_weight_rows`; in training the layers no loss reads without a
    gradient and the hybrid's class statistics moved): the
    config's eval and training step at full width on synthetic scans, every
    hand-written kernel call of one recorded eval batch and of one recorded
    training step held against its plain version. PointRCNN's recorded eval
    batch must give K1 rows with no valid lane (padded and empty RoIs), and
    its counted batches print the proposal layer's share of a batch.
    PV-RCNN++'s capture prints its keypoints (`keypoint_line`) and its K6
    sector launch is held once more with rows thinned (`hold_sector_rows`).
    Returns the per-kernel reports and the launch counts of both."""
    import torch

    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, rois_over,
                                                    synth_scans, voxel_anchor_counts)
    from tsm_det_pointcloud_tpu_torch.models.roi_heads import roi_head_template as tmpl
    from tsm_det_pointcloud_tpu_torch.ops import _kernels, grouping
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    cfg_name, batch, tbatch, calls = stage_spec(which)
    n_pts = scan_points(which)
    names = tuple(calls)
    cfg_file = ROOT / f"tools/cfgs/kitti_models/{cfg_name}"
    cfg, model = build_detector(cfg_file, dev, seed=0, n_points=n_pts)
    post = cfg.MODEL.POST_PROCESSING
    post_max = int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
    n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE)
    meta = model.dataset_meta
    batches = [torch.from_numpy(synth_scans(meta, batch, n_pts, seed=s)).to(dev)
               for s in range(TWO_STAGE_ITERS)]
    mask = torch.ones((batch, n_pts), dtype=torch.bool, device=dev)
    rec = record_kernels(names)
    out, _ = detect(model, batches[0], mask)
    torch.cuda.synchronize()
    rec.restore()
    for name, n in calls.items():
        check(len(rec.calls[name]) == n, f"the {which} capture forward made "
              f"{len(rec.calls[name])} {name} calls, not {n}")
    voxels, over = voxel_anchor_counts(model, out)
    print(f"{which} capture: voxel capacity {meta.max_voxels}; voxels a scan {voxels}; anchors "
          f"over SCORE_THRESH {post.SCORE_THRESH} a scan {over}; (proposals kept, RoI boxes "
          f"over SCORE_THRESH) a scan {rois_over(model, out)}"
          + (f"; {keypoint_line(out, batches[0])}" if which in PVRCNN_PP else ""))
    del out
    report_eval = compare_recorded(rec.calls, which)
    if which in PVRCNN_PP:
        hold_sector_rows(which, rec.calls["fps_block"][0])
    if which in DSASNET:
        hold_zero_weight_rows(which, rec.calls["fps"][-1])
    if which == "pointrcnn":
        # the in-RoI encoder's first d-fps (B * R rows of 512 slots) again,
        # with whole rows emptied and rows of one valid slot, as padded RoIs
        # and RoIs that hold no point or one give them
        xyz, npoint, valid, _ = rec.calls["fps"][-2]
        holed = valid.clone()
        holed[::3] = False
        holed[1::3, 1:] = False
        holed_report = compare_recorded({"fps": [(xyz, npoint, holed, None)]},
                                        "pointrcnn in-RoI fps, rows emptied")
        empty = holed_report["fps"]["empty_rows"]
        check(empty > 0, "pointrcnn: the emptied rows did not reach K1")
        # and the in-RoI encoder's first ball query with the same rows' sources
        # emptied: their queries must find nothing (cnt 0), as in the plain version
        src, src_valid, q, scales, payload = rec.calls["query_group"][-2][:5]
        src_holed = src_valid.clone()
        src_holed[::3] = False
        compare_recorded({"query_group": [(src, src_holed, q, scales, payload, None, None,
                                           None)]}, "pointrcnn in-RoI query_group, rows emptied")
        cnt = grouping.query_group_plain(src[::3], src_holed[::3], q[::3], scales)[1]
        check(not bool(cnt.any()), "pointrcnn: a query on an emptied row found a source")
        print(f"pointrcnn: the recorded eval batch gave {report_eval['fps']['empty_rows']} K1 "
              f"rows with no valid lane; its in-RoI d-fps ({tuple(xyz.shape)}) with {empty} rows "
              f"emptied and {int((holed.sum(1) == 1).sum())} of one valid slot is index-equal to "
              f"the plain version")
    del rec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    preds = [detect(model, pts, mask) for pts in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_eval = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for out, pred in preds:
        for key in ("batch_cls_preds", "batch_box_preds", "rois"):
            check(bool(torch.isfinite(out[key]).all()), f"{which}: non-finite {key}")
        check(tuple(out["rois"].shape) == (batch, n_rois, 7),
              f"{which} rois shape {tuple(out['rois'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"{which}: non-finite {key}")
        check(bool((pred["count"] <= post_max).all()), f"{which}: count > NMS_POST_MAXSIZE")
        if out.get("cls_preds_normalized"):   # SECONDNetIoU's rectified scores
            rect = out["batch_cls_preds"]
            check(bool((rect >= 0).all() and (rect <= 1).all()),
                  f"{which}: rectified scores outside [0, 1]")
    for name, n in calls.items():
        check(launches_eval[name] == n * TWO_STAGE_ITERS, f"kernel {name} launched "
              f"{launches_eval[name]} times on the {which} path, not {n} a forward")
    counts = [int(c) for c in preds[-1][1]["count"]]
    # the RoI head's inputs of the first batch, for the proposal NMS timed
    # alone after every timed path (two_stage_profiles)
    seen = {}
    hook = model.module_list[-1].register_forward_pre_hook(lambda m, a: seen.update(
        cls=a[0]["batch_cls_preds"].detach(), box=a[0]["batch_box_preds"].detach()))
    detect(model, batches[0], mask)
    hook.remove()
    PROPOSALS[which] = {k: v.cpu() for k, v in seen.items()}
    extra = ""
    if which == "pointrcnn":
        ncfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
        nms_ms = cuda_time_ms(lambda: tmpl.proposal_layer(seen["cls"], seen["box"], ncfg), 1)
        extra = (f"; the proposal layer ({seen['box'].shape[1]} point boxes a scan, NMS over "
                 f"the best {ncfg.NMS_PRE_MAXSIZE}) {nms_ms:.3f} ms a batch, "
                 f"{100 * nms_ms / (1e3 * dt / TWO_STAGE_ITERS):.1f}% of a counted batch")
    del seen
    if which == "parta2":
        g = int(cfg.MODEL.ROI_HEAD.ROI_AWARE_POOL.POOL_SIZE)
        pool_ms = cuda_time_ms(lambda: pool_all(preds[-1][0], g), 3)
        extra = f"; RoI-aware pool (both pools, {g}^3 cells a RoI) {pool_ms:.3f} ms a batch"
    print(f"{which} eval: {TWO_STAGE_ITERS} batches x {batch} scans x {n_pts} "
          f"points in {dt:.3f} s = {TWO_STAGE_ITERS * batch / dt:.3f} scans/s; (proposals "
          f"kept, RoI boxes over SCORE_THRESH) a scan {rois_over(model, preds[-1][0])}; "
          f"detections a scan (last batch) {counts}; launches {launches_eval}; peak memory "
          f"{peak:.2f} GiB{extra}")
    del model, preds, batches, out, pred
    torch.cuda.empty_cache()

    _, model, opt = build_trainer(cfg_file, dev, seed=0, n_points=n_pts,
                                  total_steps=TWO_STAGE_TRAIN_ITERS + 1)
    meta = model.dataset_meta
    tbatches = [synth_train_batch(tbatch, n_pts, s, dev, meta.point_cloud_range,
                                  meta.num_point_features)
                for s in range(TWO_STAGE_TRAIN_ITERS + 1)]
    idle_want, stats_before = (), None
    if which in DSASNET:
        # the hybrid's fg prior at 0: its key points score 0.5, over the
        # statistics' 0.3, so that the first step (accumulated_iter 0, its
        # STAT_START_ITER) replaces them
        model.module_list[3].fg_pred_out.bias.data.zero_()
        idle_want = DSASNET_IDLE
        stats_before = model.module_list[3].object_statistics.object_statistic_features.clone()
    rec = record_kernels(names + (("spconv_bykey_bwd",) if which == "parta2" else ()))
    opt.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    out = model(dict(tbatches[0], accumulated_iter=opt.state["count"]))
    out["loss"].backward()
    torch.cuda.synchronize()
    rec.restore()
    for name, n in calls.items():
        check(len(rec.calls[name]) == n, f"the {which} training step made "
              f"{len(rec.calls[name])} {name} calls, not {n}")
    if which == "parta2":
        check(len(rec.calls["spconv_bykey_bwd"]) > 0, "the parta2 training step made no K5 call")
    idle = []
    for n, p in model.named_parameters():
        if n.startswith(idle_want):
            check(p.grad is None, f"{which} parameter {n}, which no loss reads, got a gradient")
            idle.append(n)
            continue
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"{which} parameter {n} got no finite gradient")
        if p.dim() == 3:
            check(bool(p.grad.abs().sum() > 0), f"sparse-conv weight {n} got a zero gradient")
    if stats_before is not None:
        stats = model.module_list[3].object_statistics.object_statistic_features
        check(not torch.equal(stats, stats_before) and bool(torch.isfinite(stats).all()),
              f"{which}: the class statistics did not move in the first step")
        print(f"{which} training capture: {len(idle)} parameters without a gradient, as in the "
              f"JAX package ({sorted({n.split('.')[2] for n in idle})}); the class statistics "
              f"moved: row norms {[round(float(v), 4) for v in stats.norm(dim=1)]}")
    opt.step()
    tb = out["tb_dict"]
    terms = RCNN_TERMS[which]
    check(bool(torch.isfinite(out["loss"])) and set(terms) <= set(tb),
          f"{which} warm-up step: loss {float(out['loss'].detach())}, terms {sorted(tb)}")
    targets = out.get("roi_targets")
    sampled = ("no RoI sampling (every valid RoI trains the IoU branch)" if targets is None
               else f"sampled RoIs a scan {targets['sampled'].sum(1).tolist()}, of them "
               f"foreground {(targets['sampled'] & targets['fg']).sum(1).tolist()}")
    print(f"{which} training capture: voxel capacity {meta.max_voxels}; proposals kept a scan "
          f"{out['roi_valid'].sum(1).tolist()}, {sampled}; loss "
          f"{float(out['loss'].detach()):.4f}, "
          + ", ".join(f"{k} {float(v.detach()):.4f}" for k, v in tb.items())
          + f"; K5 calls {len(rec.calls.get('spconv_bykey_bwd', []))}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out, targets, tb
    report_train = compare_recorded(rec.calls, f"{which} train")
    del rec
    if which == "pointrcnn":
        print(f"pointrcnn: the recorded training step gave {report_train['fps']['empty_rows']} "
              f"K1 rows with no valid lane")

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
    for i, (loss, tb) in enumerate(steps):
        check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(v)) for v in tb.values())
              and set(terms) <= set(tb), f"{which} training step {i}: loss {float(loss)}, {tb}")
    still = still_params(model, before, which)
    for name, n in calls.items():
        check(launches_train[name] == n * TWO_STAGE_TRAIN_ITERS, f"kernel {name} launched "
              f"{launches_train[name]} times on the {which} training path, not {n} a step")
    print(f"{which} training: {TWO_STAGE_TRAIN_ITERS} steps x {tbatch} scans x "
          f"{n_pts} points in {dt:.3f} s = "
          f"{TWO_STAGE_TRAIN_ITERS * tbatch / dt:.3f} train scans/s "
          f"({1e3 * dt / TWO_STAGE_TRAIN_ITERS:.1f} ms/step); losses "
          + str([(round(float(loss), 4), round(float(tb[terms[0]]), 4))
                 for loss, tb in steps])
          + f" (loss, {terms[0]}); {len(before) - len(still)} of {len(before)} parameters "
          f"changed (unchanged, with a zero gradient and value: {still}); launches "
          f"{launches_train}; peak memory {peak:.2f} GiB")
    del model, opt, tbatches, before, steps
    torch.cuda.empty_cache()
    return report_eval, launches_eval, report_train, launches_train


def two_stage_data_phases(dev, root, table=TWO_STAGE):
    """Phase 43 (phase 47 with table POINTRCNN, 51 with VOXEL_ROI, 55 with
    PVRCNN_PP): PartA2.yaml and pvrcnn.yaml (pointrcnn.yaml;
    voxel_rcnn_car.yaml and second_iou.yaml; pv_rcnn_plusplus.yaml)
    on the KITTI root of phase 22:
    echoed gt through each config's dataset, `evaluate` and `train
    --data_root` for 1 epoch on phase 29's SECOND_DATA_FRAMES val and train
    frames (the first forward or step recorded and held), `evaluate --ckpt`
    on the trained checkpoint and `demo --ckpt` on phase 30's raw scans.
    Returns the per-kernel reports and launch counts of each evaluate and
    train."""
    import torch

    from tsm_det_pointcloud_tpu_torch import demo, evaluate, train
    from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
    from tsm_det_pointcloud_tpu_torch.infer import load_cfg
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.runtime import train_loop

    n = SECOND_DATA_FRAMES
    sets = ["--set", "DATA_CONFIG.INFO_PATH.train", f"['kitti_infos_train_{n}.pkl']",
            "DATA_CONFIG.INFO_PATH.test", f"['kitti_infos_val_{n}.pkl']"]
    data = ["--data_root", str(root), "--workers", str(KITTI_WORKERS), "--device", str(dev)]
    reports = {}
    for which, (cfg_name, batch, tbatch, calls) in table.items():
        names = tuple(calls)
        tnames = names + (("spconv_bykey_bwd",) if which == "parta2" else ())
        cfg_file = ROOT / f"tools/cfgs/kitti_models/{cfg_name}"
        cfg = load_cfg(cfg_file, sets[1:])
        classes = list(cfg.CLASS_NAMES)
        full = KittiDataset(load_cfg(cfg_file).DATA_CONFIG, classes, training=False,
                            root_path=root)
        _, echo = full.evaluation(echo_gt_annos(full.kitti_infos), classes)
        check(len(echo) == 24 * len(classes) and all(abs(v - 100.0) < 1e-6
                                                     for v in echo.values()),
              f"{which}: echoed gt does not score 100: {echo}")
        out = root.parent / which
        res, launches_eval, peak, rec, first_out = run_recorded(
            f"{which} data eval", evaluate,
            ["--cfg_file", str(cfg_file), "--batch_size", str(batch), "--output_dir",
             str(out)] + data + sets, detectors[cfg.MODEL.NAME], "forward", names)
        voxels = (first_out["voxel_mask"].sum(1).tolist() if "voxel_mask" in first_out
                  else None)
        proposals = first_out["roi_valid"].sum(1).tolist()
        if which in PVRCNN_PP:   # the FOV crop leaves 4 of the 6 sectors empty
            proposals = f"{proposals}; {keypoint_line(first_out, first_out['points'])}"
        del first_out
        check_kitti_aps(res, classes, f"{which} evaluate")
        for kname, k in calls.items():
            check(len(rec.calls[kname]) == k and launches_eval[kname] == k * (n // batch),
                  f"{which} data eval: {len(rec.calls[kname])} {kname} calls a forward, "
                  f"{launches_eval[kname]} in all")
        print(f"{which} data eval (evaluate, seeded weights): echoed val gt through its dataset "
              f"scores 100.0 on all {len(echo)} APs; {n} scans at b{batch}: "
              + ("" if voxels is None else f"voxels a scan of the first batch {voxels}, ")
              + f"proposals kept {proposals}; {eval_line(res)}; "
              f"launches {launches_eval}; peak memory {peak:.2f} GiB")
        reports[f"{which}_data"] = (compare_recorded(rec.calls, f"{which} data eval"),
                                    launches_eval)
        (ckpt_dir, epochs), launches_train, _, rec, _ = run_recorded(
            f"{which} data train", train,
            ["--cfg_file", str(cfg_file), "--epochs", "1", "--batch", str(tbatch),
             "--output_dir", str(out)] + data + sets, train_loop, "train_step", tnames)
        print(f"{which} data train (train --data_root): {epochs_line(epochs)}; launches "
              f"{launches_train}")
        reports[f"{which}_data_train"] = (compare_recorded(rec.calls, f"{which} data train"),
                                          launches_train)
        ckpt = ckpt_dir / "checkpoint_epoch_1.pth"
        res = evaluate.main(["--cfg_file", str(cfg_file), "--ckpt", str(ckpt), "--batch_size",
                             str(batch), "--output_dir", str(out / "ckpt_eval")] + data + sets)
        aps = check_kitti_aps(res, classes, f"{which} evaluate --ckpt")
        print(f"{which} data eval (evaluate --ckpt {ckpt.name}): {eval_line(res)}; "
              f"Car_3d/moderate_R40 {aps['Car_3d/moderate_R40']:.4f}")
        (preds, rate), launches, peak, _, _ = run_recorded(
            f"{which} demo", demo, ["--cfg_file", str(cfg_file), "--data_path",
                                    str(root.parent / "demo" / "scans"), "--ckpt", str(ckpt),
                                    "--device", str(dev)],
            detectors[cfg.MODEL.NAME], "forward", names)
        post_max = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
        check(len(preds) == DEMO_SCANS, f"{which} demo: {len(preds)} scans")
        for p in preds:
            check(len(p["pred_labels"]) <= post_max and np.isfinite(p["pred_boxes"]).all()
                  and np.isfinite(p["pred_scores"]).all(), f"{which} demo: bad detections")
        print(f"{which} demo --ckpt {ckpt.name}: {DEMO_SCANS} raw scans over 360 degrees: "
              f"detections a scan {[len(p['pred_labels']) for p in preds]}; {rate:.3f} scans/s "
              f"(a scan a batch, loading included); launches {launches}; peak memory "
              f"{peak:.2f} GiB")
        torch.cuda.empty_cache()
    return reports


def two_stage_profiles(dev, profiles, table=TWO_STAGE):
    """Phase 44 (phase 48 with table POINTRCNN: pointrcnn.yaml at b4 x 16384;
    52 with VOXEL_ROI: voxel_rcnn_car.yaml and second_iou.yaml at b4 x 20000;
    56 with PVRCNN_PP: pv_rcnn_plusplus.yaml at b4 x 20000),
    after every timed path: `infer --profile` of PartA2.yaml and
    pvrcnn.yaml at b4 x 20000 (`profiles`, from `infer_profiles`), then the
    device time alone of the proposal layer's NMS on the first-stage boxes of
    the config's first synthetic eval batch (`PROPOSALS`, kept by
    `two_stage_phases`), at the test mode's NMS_PRE_MAXSIZE and at the
    training mode's (9000 boxes a scan)."""
    from tsm_det_pointcloud_tpu_torch import infer
    from tsm_det_pointcloud_tpu_torch.models.roi_heads import roi_head_template as tmpl

    for which, (cfg_name, _, _, _) in table.items():
        cfg = infer.load_cfg(ROOT / f"tools/cfgs/kitti_models/{cfg_name}")
        (wall, busy, names), (pwall, pbusy, _) = profiles[cfg_name]
        fft = [k for k in names if "fft" in k.lower() or "cgemm" in k.lower()]
        check(not fft, f"{which}: cuDNN ran FFT convolutions: {fft}")
        seen = {k: v.to(dev) for k, v in PROPOSALS.pop(which).items()}
        nms = {}
        for mode in ("TEST", "TRAIN"):
            ncfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG[mode]
            # one call a window, no warm-up (the proposal layer ran on these
            # shapes in the config's phases): the 9000-box NMS runs ~0.9 s
            nms[mode] = device_ms(lambda: tmpl.proposal_layer(seen["cls"], seen["box"], ncfg),
                                  1, warm=False)
        print(f"{which} profile: busy {busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.1f}%), "
              f"post-processing alone {pbusy:.3f} ms device time of {pwall:.3f} ms; "
              f"{len(names)} kernels, none an FFT; proposal layer's NMS alone, device time a "
              f"batch: {nms['TEST']:.3f} ms at NMS_PRE_MAXSIZE "
              f"{cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE} (test), "
              f"{nms['TRAIN']:.3f} ms at {cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE} "
              f"(training)")
        del seen


# ---------------------------------------------------------------------------
# phases 45-48: PointRCNN (pointrcnn.yaml)
# ---------------------------------------------------------------------------

def pointrcnn_golden_phase(dev):
    """Phase 45: the tiny PointRCNN (tiny.two_stage_state("pointrcnn"))
    reproduces its JAX golden on the card (labels, counts and the RoIs'
    labels exact), through K1 and K2."""
    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import detect
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    pts = torch.from_numpy(tiny.second_points(2, 256)).to(dev)
    cfg, meta = tiny.two_stage_model("pointrcnn")
    model = build_network(cfg, 1, meta, device=dev)
    model.load_state_dict(tiny.two_stage_state("pointrcnn"), strict=True)
    _kernels.reset_launches()
    out, pred = detect(model, pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev))
    check(_kernels.LAUNCHES["fps"] == 3 and _kernels.LAUNCHES["query_group"] == 3,
          f"tiny pointrcnn launches {dict(_kernels.LAUNCHES)}")
    hold_golden("pointrcnn reference: tiny pointrcnn", out, pred, tiny.POINTRCNN_FORWARD_PATH)


def _tree(fn, v):
    """fn on every tensor of a batch entry: a tensor, a sparse level (a
    SparseTensor named tuple) or a dict of them; other values as they are."""
    import torch

    if isinstance(v, torch.Tensor):
        return fn(v)
    if isinstance(v, dict):
        return {k: _tree(fn, x) for k, x in v.items()}
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_tree(fn, x) for x in v))
    return v


# the RoI head's launches on the tiny gt-RoI batch, and the losses whose sum
# is held with its gradients: regression + corner, or SECONDNetIoU's IoU loss
GT_ROI = {"pointrcnn": ({"fps": 1, "query_group": 1}, ("rcnn_reg_loss", "rcnn_corner_loss")),
          "parta2": ({}, ("rcnn_reg_loss", "rcnn_corner_loss")),
          "voxelrcnn": ({"query_group": 2}, ("rcnn_reg_loss", "rcnn_corner_loss")),
          "secondnetiou": ({}, ("rcnn_iou_loss",))}


def rcnn_gt_roi_phase(dev, whiches=("pointrcnn", "parta2")):
    """Phase 45 (49 with voxelrcnn and secondnetiou): the RCNN losses with a
    non-empty foreground. The tiny detectors' RoI heads (their training
    states) take RoIs made from the gt boxes (`tiny.gt_roi_proposals`:
    jittered within REG_FG_THRESH) beside the first stages' own outputs of
    their training batch; the RCNN losses and the gradients of reg + corner
    (SECONDNetIoU: of its IoU loss) on the head's parameters and on the
    proposals' boxes are held on the card against the same head on the CPU
    (the plain path: the heads' K1 and K2 calls run their plain versions
    there). Losses atol 1e-4 * max(1, |want|) + rtol 1e-4, gradients
    rtol 1e-3 above atol 1e-4 * max(the tensor's largest |g|, 1e-2 * the
    head's)."""
    import copy

    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    cpu = torch.device("cpu")
    for which in whiches:
        launches, held = GT_ROI[which]
        cfg, meta = tiny.two_stage_model(which)
        gt, gmask = tiny.two_stage_gt(which)
        model = build_network(cfg, 1, meta, device=cpu)
        model.load_state_dict(tiny.two_stage_state(which, train=True), strict=True)
        model.train()
        bd = {"points": torch.from_numpy(tiny.second_points(2, 256)),
              "points_mask": torch.ones(2, 256, dtype=torch.bool), "batch_size": 2,
              "gt_boxes": torch.from_numpy(gt), "gt_boxes_mask": torch.from_numpy(gmask)}
        with torch.no_grad():
            for m in model.module_list[:-1]:
                bd = m(bd)
        logits, boxes = tiny.gt_roi_proposals(gt, gmask, 256)
        bd = {k: _tree(torch.Tensor.detach, v) for k, v in bd.items()
              if k not in ("batch_cls_preds", "batch_box_preds", "cls_preds_normalized")}
        bd.update(batch_cls_preds=torch.from_numpy(logits), cls_preds_normalized=False)
        results = []
        for d in (dev, cpu):
            head = copy.deepcopy(model.module_list[-1]).to(d).train()
            box = torch.from_numpy(boxes).to(d).requires_grad_(True)
            _kernels.reset_launches()
            out = head(dict(_tree(lambda t: t.to(d), bd), batch_box_preds=box))
            tb = out["tb_dict_rcnn"]
            sum(tb[k] for k in held).backward()
            fg = (int((out["roi_targets"]["fg"] & out["roi_targets"]["sampled"]).sum())
                  if "roi_targets" in out else None)
            results.append(dict(
                tb={k: float(v.detach()) for k, v in tb.items()}, fg=fg,
                launches=dict(_kernels.LAUNCHES), box=box.grad.cpu().numpy(),
                grads={n: p.grad.cpu().numpy() for n, p in head.named_parameters()
                       if p.grad is not None}))
        got, want = results
        check(got["fg"] == want["fg"] and (want["fg"] is None or want["fg"] > 0),
              f"{which} gt RoIs: sampled foreground {got['fg']} / {want['fg']}")
        check({k: v for k, v in got["launches"].items() if v} == launches,
              f"{which} gt RoIs: launches {got['launches']}")
        for k, v in want["tb"].items():
            check(close_scalar(got["tb"][k], v) and v > 0,
                  f"{which} gt RoIs: {k} {got['tb'][k]} on the card, {v} on the CPU")
        scale = max(float(np.abs(g).max()) for g in want["grads"].values())
        worst = 0.0
        check(set(got["grads"]) == set(want["grads"]) and len(want["grads"]) > 5,
              f"{which} gt RoIs: gradients of {sorted(set(got['grads']) ^ set(want['grads']))}")
        for n, w in list(want["grads"].items()) + [("proposal boxes", want["box"])]:
            g = got["box"] if n == "proposal boxes" else got["grads"][n]
            atol = 1e-4 * max(float(np.abs(w).max()), 1e-2 * scale)
            check(np.allclose(g, w, rtol=1e-3, atol=atol),
                  f"{which} gt RoIs: gradient of {n} differs: {float(np.abs(g - w).max())}")
            worst = max(worst, float(np.abs(g - w).max()))
        fg = "" if got["fg"] is None else f"{got['fg']} foreground RoIs sampled; "
        print(f"{which} gt RoIs (card against CPU): {fg}"
              + ", ".join(f"{k} {got['tb'][k]:.6f} ({want['tb'][k]:.6f})" for k in want["tb"])
              + f"; {len(want['grads'])} parameter gradients and the boxes' held (of "
              f"{' + '.join(held)}), max abs diff {worst:.3g}; launches on the card "
              f"{got['launches']}")


def vector_pool_openpcdet_names(model_cfg):
    """A function renaming a reference checkpoint's PV-RCNN++ VectorPool
    layers from the port's names (the flax ones) to OpenPCDet's:
    `pfe.SA_rawpoints` or `pfe.SA_layers.<j>` (j the x_conv source's place
    among the PFE's), `layer_<k>.post_mlps.<3 i, or 3 i + 1 for the BN>`
    for group k's layer i, `msg_post_mlps.<...>` for the aggregation."""
    import re

    srcs = [s for s in model_cfg.PFE.FEATURES_SOURCE if s.startswith("x_conv")]
    pat = re.compile(r"^pfe\.sa_(rawpoints|x_conv\d)\.(?:scale(\d)\.post_mlp|agg)\.(fc|bn)(\d)"
                     r"\.(.*)$")

    def rename(name):
        m = pat.match(name)
        if m is None:
            return name
        src, k, kind, i, leaf = m.groups()
        head = "pfe.SA_rawpoints" if src == "rawpoints" else f"pfe.SA_layers.{srcs.index(src)}"
        mid = "msg_post_mlps" if k is None else f"layer_{k}.post_mlps"
        return f"{head}.{mid}.{3 * int(i) + (kind == 'bn')}.{leaf}"

    return rename


def pointrcnn_converter_phase(dev, root, which="pointrcnn", unplaced=()):
    """Phase 47 (51 with voxelrcnn and secondnetiou, 55 with
    pvrcnnplusplus): convert_torch_ckpt on a synthetic reference checkpoint
    of a seeded full-width detector of the config (OpenPCDet's layouts,
    `reference_state_dict`): nothing unplaced but `unplaced` (the 1x1 BEV
    convs no 4-D leaf takes, ROADMAP §C); the tensors placed off their own
    leaf (ties of leaf name and shape) are counted; the converted checkpoint
    loads strictly and detects on phase 30's first raw scan with finite
    outputs. For PV-RCNN++ the same checkpoint again with its VectorPool
    layers under OpenPCDet's names (`vector_pool_openpcdet_names`): their
    VECTOR_POOL_BN_SCALES BN scales land on no leaf; the others' placements
    are counted."""
    import torch

    from tsm_det_pointcloud_tpu_torch import convert_torch_ckpt, demo
    from tsm_det_pointcloud_tpu_torch.datasets import load_data_to_device, to_torch_batch
    from tsm_det_pointcloud_tpu_torch.infer import build_detector, detect
    from tsm_det_pointcloud_tpu_torch.runtime.checkpoint import restore_checkpoint

    cfg_file = ROOT / f"tools/cfgs/kitti_models/{stage_spec(which)[0]}"
    out = root.parent / f"{which}_convert"
    out.mkdir()
    cfg, src_model = build_detector(cfg_file, dev, seed=3, n_points=scan_points(which))
    src = {k: v.detach().cpu() for k, v in src_model.state_dict().items()}
    del src_model
    ref, source = convert_torch_ckpt.reference_state_dict(src, cfg.MODEL)
    # SECOND's conv_out kernel (3, 1, 1), which neither converter reads (ROADMAP §C)
    ref.pop("backbone_3d.conv_out.weight", None)
    torch.save({"model_state": ref, "epoch": 80, "it": 37120}, out / "reference.pth")
    report = convert_torch_ckpt.main(["--ckpt", str(out / "reference.pth"), "--cfg_file",
                                      str(cfg_file), "--out", str(out / "converted.pth")])
    check(report["unplaced"] == list(unplaced),
          f"{which} converter: unplaced {report['unplaced']}")
    conv = torch.load(out / "converted.pth", weights_only=True)["model_state"]
    equal = sum(torch.equal(conv[key], src[key]) for key in source.values())
    model = build_detector(cfg_file, dev, seed=0, n_points=scan_points(which))[1]
    restore_checkpoint(out / "converted.pth", model)
    scans = demo.DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root.parent / "demo" / "scans")
    batch = load_data_to_device(to_torch_batch(scans.collate(scans[0])), dev)
    o, p = detect(model, batch["points"], batch["points_mask"])
    check(all(bool(torch.isfinite(t).all()) for t in (o["batch_cls_preds"], o["batch_box_preds"],
                                                      p["pred_boxes"], p["pred_scores"])),
          f"{which} converter: non-finite outputs of the converted model")
    print(f"{which} reference checkpoint: {len(ref)} tensors of a seeded full-width "
          f"{cfg_file.name} detector in OpenPCDet's layouts; converted {report['converted']}, "
          f"unplaced {report['unplaced']}, placed among more than one candidate "
          f"{len(report['tied'])}, "
          f"{equal} of {len(source)} port entries bit-equal to their source after it; the "
          f"converted model loads strictly and detects {int(p['count'][0])} boxes on a raw "
          f"scan, outputs finite")
    del model, o, p
    if which in PVRCNN_PP:
        rename = vector_pool_openpcdet_names(cfg.MODEL)
        named = {rename(k): v for k, v in ref.items()}
        pool = {rename(k): key for k, key in source.items() if rename(k) != k}
        template = build_detector(cfg_file, "cpu", seed=0, n_points=scan_points(which))[1]
        state, rep = convert_torch_ckpt.convert_checkpoint(named, template.state_dict())
        lost = [p_ for p_ in rep["unplaced"] if p_ not in unplaced]
        home = sum(torch.equal(state[key], src[key]) for key in pool.values())
        check(len(lost) == VECTOR_POOL_BN_SCALES
              and all(p_.endswith(("/1/kernel", "/4/kernel")) for p_ in lost),
              f"{which} converter under OpenPCDet's names: unplaced {lost}")
        print(f"{which} reference checkpoint under OpenPCDet's VectorPool names ({len(pool)} "
              f"tensors renamed, e.g. {next(iter(pool))}): unplaced beyond the above "
              f"{len(lost)} (every VectorPool BN scale), {home} of the {len(pool)} VectorPool "
              f"entries equal to their source after it")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 57-60: nuScenes' CenterPoint (cbgs_voxel01_res3d_centerpoint.yaml)
# ---------------------------------------------------------------------------

def openpcdet_center_head_name(name):
    """A port state-dict name (a reference_state_dict name) under
    OpenPCDet's CenterHead names."""
    import re

    for pat, rep in CENTER_HEAD_OPENPCDET_NAMES:
        if re.match(pat, name):
            return re.sub(pat, rep, name)
    return name


def center_golden_phase(dev, label, model_cfg, meta, state, path, n_cols):
    """Phases 57 and 61: a tiny CenterPoint with several class groups
    (tiny.centerpoint_nusc_state, tiny.centerpoint_lyft_state) reproduces its
    JAX golden on the card through 8 K3 and 21 K7 calls: n_cols-column
    decoded boxes, labels and counts exact."""
    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import detect
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    model = build_network(model_cfg, len(meta.class_names), meta, device=dev)
    model.load_state_dict(state, strict=True)
    pts = torch.from_numpy(tiny.nusc_points(2)).to(dev)
    _kernels.reset_launches()
    out, pred = detect(model, pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev))
    got = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    check(got == CENTERPOINT_CALLS, f"tiny {label} launches {got}")
    groups = len(model_cfg.DENSE_HEAD.CLASS_NAMES_EACH_HEAD)
    k_max = groups * int(model_cfg.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE)
    check(tuple(out["final_boxes"].shape) == (2, k_max, n_cols),
          f"tiny {label} final boxes {tuple(out['final_boxes'].shape)}")
    hold_golden(f"{label} reference: tiny {label}", out, pred, path)
    del model, out, pred


def velocity_line(model, out):
    """The decoded boxes over SCORE_THRESH a scan and their speeds; fails on
    a non-finite velocity."""
    from tsm_det_pointcloud_tpu_torch.infer import velocities_over

    rows = velocities_over(model, out)
    check(rows is not None and all(finite for *_, finite in rows),
          f"nuScenes: decoded velocities {rows}")
    return ("decoded boxes over SCORE_THRESH a scan " + str([n for n, *_ in rows])
            + ", their velocities finite, speed mean / max a scan "
            + str([(round(m, 3), round(t, 3)) for _, m, t, _ in rows]) + " m/s")


def center_phases(dev, cfg_name, points, batch, iters, train_iters, label):
    """Phases 58 and 62: a CenterPoint config of several class groups
    (cbgs_voxel01_res3d_centerpoint.yaml, the Lyft config) at full width on
    synthetic scans of its range of `points` points (x, y, z, intensity,
    time lag): an eval batch and a training step at b`batch` recorded, each
    K3 and K7 call held against its plain version and timed, then `iters`
    counted batches and `train_iters` counted steps; the training batches'
    gt boxes cycle through the config's classes (every head group trains)
    and carry velocities where the head predicts them. Returns the
    per-kernel reports and launch counts of both."""
    import torch

    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, synth_scans,
                                                    voxel_anchor_counts)
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import (build_trainer, predicts_velocity,
                                                    synth_train_batch)

    cfg_file = cfg_path(cfg_name)
    cfg, model = build_detector(cfg_file, dev, seed=0, n_points=points)
    velocity = predicts_velocity(model)
    n_cols = 9 if velocity else 7
    post = cfg.MODEL.POST_PROCESSING
    post_max = int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
    groups = len(cfg.MODEL.DENSE_HEAD.CLASS_NAMES_EACH_HEAD)
    k_max = groups * int(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE)
    meta = model.dataset_meta
    batches = [torch.from_numpy(synth_scans(meta, batch, points, seed=s)).to(dev)
               for s in range(iters)]
    mask = torch.ones((batch, points), dtype=torch.bool, device=dev)
    rec = record_kernels(SECOND_KERNELS)
    out, _ = detect(model, batches[0], mask)
    torch.cuda.synchronize()
    rec.restore()
    for name, n in CENTERPOINT_CALLS.items():
        check(len(rec.calls[name]) == n, f"the {label} capture forward made "
              f"{len(rec.calls[name])} {name} calls, not {n}")
    voxels, over = voxel_anchor_counts(model, out)
    boxes = velocity_line(model, out) if velocity else (
        f"decoded boxes over SCORE_THRESH a scan {over}")
    print(f"{label} capture: grid {meta.grid_size}, {points} points a scan of "
          f"{meta.num_point_features} features, voxel capacity {meta.max_voxels}; voxels a scan "
          f"{voxels}; {boxes} of {k_max}")
    del out
    report_eval = compare_recorded(rec.calls, label)
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
        for key in ("final_boxes", "final_scores"):
            check(bool(torch.isfinite(out[key]).all()), f"{label}: non-finite {key}")
        check(tuple(out["final_boxes"].shape) == (batch, k_max, n_cols),
              f"{label} final boxes shape {tuple(out['final_boxes'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"{label}: non-finite {key}")
        check(bool((pred["count"] <= post_max).all()),
              f"{label}: count > NMS_POST_MAXSIZE")
    for name, n in CENTERPOINT_CALLS.items():
        check(launches_eval[name] == n * iters,
              f"kernel {name} launched {launches_eval[name]} times on the {label} path, "
              f"not {n} a forward")
    counts = [int(c) for c in preds[-1][1]["count"]]
    print(f"{label} eval: {iters} batches x {batch} scans x {points} "
          f"points in {dt:.3f} s = {iters * batch / dt:.3f} scans/s; detections a "
          f"scan (last batch) {counts}; launches {launches_eval}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, preds, batches, out, pred
    torch.cuda.empty_cache()

    _, model, opt = build_trainer(cfg_file, dev, seed=0, n_points=points,
                                  total_steps=train_iters + 1)
    meta = model.dataset_meta
    tbatches = [synth_train_batch(batch, points, s, dev, meta.point_cloud_range,
                                  meta.num_point_features, velocity=velocity,
                                  n_classes=len(meta.class_names))
                for s in range(train_iters + 1)]
    rec = record_kernels(SECOND_KERNELS)
    opt.zero_grad(set_to_none=True)
    out = model(dict(tbatches[0]))
    out["loss"].backward()
    torch.cuda.synchronize()
    rec.restore()
    for name, n in CENTERPOINT_CALLS.items():
        check(len(rec.calls[name]) == n, f"the {label} training step made "
              f"{len(rec.calls[name])} {name} calls, not {n}")
    for n, p in model.named_parameters():
        check(p.grad is not None, f"{label} parameter {n} got no gradient")
        if p.dim() == 3 or ".vel_" in n:
            check(bool(p.grad.abs().sum() > 0), f"{label} {n} got a zero gradient")
    opt.step()
    check(bool(torch.isfinite(out["loss"])), f"{label} warm-up step loss is not finite")
    print(f"{label} training capture: voxel capacity {meta.max_voxels}, gt boxes "
          f"{tuple(tbatches[0]['gt_boxes'].shape)}{' (with velocities)' if velocity else ''} "
          f"of {len(meta.class_names)} classes; loss "
          f"{float(out['loss'].detach()):.4f}, "
          + ", ".join(f"{k} {float(v.detach()):.4f}" for k, v in out["tb_dict"].items()))
    del out
    report_train = compare_recorded(rec.calls, f"{label} train")
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
    for i, (loss, tb) in enumerate(steps):
        check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(v)) for v in tb.values()),
              f"{label} training step {i}: loss {float(loss)}, {tb}")
    for n, p in model.named_parameters():
        check(not torch.equal(p, before[n]), f"{label} parameter {n} did not change")
    for name, n in CENTERPOINT_CALLS.items():
        check(launches_train[name] == n * train_iters,
              f"kernel {name} launched {launches_train[name]} times on the {label} "
              f"training path, not {n} a step")
    print(f"{label} training: {train_iters} steps x {batch} scans x "
          f"{points} points in {dt:.3f} s = {train_iters * batch / dt:.3f} "
          f"train scans/s ({1e3 * dt / train_iters:.1f} ms/step); losses "
          + str([(round(float(loss), 4), round(float(tb["hm_loss_0"]), 4),
                  round(float(tb["reg_loss_0"]), 4)) for loss, tb in steps])
          + f" (loss, hm_loss_0, reg_loss_0); {len(before)} parameters changed; launches "
          f"{launches_train}; peak memory {peak:.2f} GiB")
    del model, opt, tbatches, before, steps
    torch.cuda.empty_cache()
    return report_eval, launches_eval, report_train, launches_train


def echo_nusc_dets(dataset, classes):
    """Prediction dicts of each info's own gt boxes of lidar points (score 1,
    7 columns)."""
    dets = []
    for info in dataset.infos:
        keep = np.array([n in classes for n in info["gt_names"]], bool) & (
            np.asarray(info["num_lidar_pts"]) > 0)
        labels = np.array([classes.index(n) + 1 for n in np.asarray(info["gt_names"])[keep]])
        dets += dataset.generate_prediction_dicts(
            {"metadata": [None]},
            [{"pred_boxes": np.asarray(info["gt_boxes"])[keep][:, :7],
              "pred_scores": np.ones(int(keep.sum()), np.float32), "pred_labels": labels}],
            classes)
    return dets


def nusc_data_phases(dev, base):
    """Phase 59: the nuScenes data path on a synthetic root at nuScenes'
    sweep size (NUSC_TRAIN_SCENES + NUSC_VAL_SCENES scenes of NUSC_KEYFRAMES
    keyframes, each after nine sweeps of NUSC_SWEEP_POINTS points): the
    writer, `create_nuscenes_infos` (10-sweep infos, the train gt database),
    echoed val gt through the dataset's NDS (0.8, mAP 1), `evaluate`
    (seeded weights: a finite NDS dict), `train --data_root` for an epoch
    (CBGS, gt sampling, the world augmentors; the loader's wait), each
    first forward or step recorded and its K3 / K7 calls held; the converter
    on an OpenPCDet-named reference checkpoint of the seeded full-width
    detector (NUSC_PLACEMENTS) and `demo --ckpt` of the converted checkpoint
    on .npy scans (val keyframes' 10-sweep clouds). Returns the per-kernel
    reports and launch counts of evaluate and train."""
    import torch

    from tsm_det_pointcloud_tpu_torch import convert_torch_ckpt, demo, evaluate, train
    from tsm_det_pointcloud_tpu_torch.datasets.nuscenes.nuscenes_dataset import (
        NuScenesDataset, create_nuscenes_infos)
    from tsm_det_pointcloud_tpu_torch.datasets.nuscenes.synthetic import (
        write_synthetic_nuscenes)
    from tsm_det_pointcloud_tpu_torch.infer import build_detector, load_cfg
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.runtime import train_loop

    cfg_file = cfg_path(NUSC_CFG)
    cfg = load_cfg(cfg_file)
    classes = list(cfg.CLASS_NAMES)
    root = base / "root"
    t0 = time.perf_counter()
    write_synthetic_nuscenes(root, NUSC_TRAIN_SCENES, NUSC_VAL_SCENES, NUSC_KEYFRAMES,
                             NUSC_SWEEP_POINTS, seed=0)
    t1 = time.perf_counter()
    create_nuscenes_infos(cfg.DATA_CONFIG, classes, root)
    t2 = time.perf_counter()
    test_set = NuScenesDataset(cfg.DATA_CONFIG, classes, training=False, root_path=root)
    train_set = NuScenesDataset(cfg.DATA_CONFIG, classes, training=True, root_path=root)
    points = [len(test_set.get_lidar_with_sweeps(i, cfg.DATA_CONFIG.MAX_SWEEPS))
              for i in range(len(test_set))]
    cropped = [len(test_set[i]["points"]) for i in range(len(test_set))]
    check(max(cropped) <= test_set.max_points, f"nuScenes scans cut by the collate: {cropped}")
    _, echo = test_set.evaluation(echo_nusc_dets(test_set, classes), classes)
    check(abs(echo["NDS"] - 0.8) < 1e-9 and echo["mAP"] > 1 - 1e-9,
          f"nuScenes echoed gt: NDS {echo['NDS']}, mAP {echo['mAP']}")
    print(f"nuScenes data: wrote {NUSC_TRAIN_SCENES} + {NUSC_VAL_SCENES} scenes of "
          f"{NUSC_KEYFRAMES} keyframes x 10 sweeps of {NUSC_SWEEP_POINTS} points in "
          f"{t1 - t0:.1f} s, infos and gt database in {t2 - t1:.1f} s; train infos "
          f"{len(train_set.infos)} after CBGS; points a val scan of 10 sweeps {points}, "
          f"{cropped} after the range crop (MAX_POINTS {test_set.max_points}); echoed val gt: "
          f"NDS {echo['NDS']:.4f}, mAP {echo['mAP']:.4f}, mAVE {echo['mAVE']:.4f}")

    common = ["--cfg_file", str(cfg_file), "--data_root", str(root), "--workers",
              str(KITTI_WORKERS), "--device", str(dev)]
    out_dir = base / "run"
    res, launches_eval, peak, rec, first_out = run_recorded(
        "centerpoint_nusc data eval", evaluate,
        common + ["--batch_size", str(NUSC_BATCH), "--output_dir", str(out_dir)],
        detectors["CenterPoint"], "forward", SECOND_KERNELS)
    voxels = first_out["voxel_mask"].sum(1).tolist()
    del first_out
    summary = {k: res[k] for k in ("NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE")}
    check(all(np.isfinite(v) for v in summary.values()), f"nuScenes evaluate: {summary}")
    for kname, k in CENTERPOINT_CALLS.items():
        check(len(rec.calls[kname]) == k, f"nuScenes data eval: {len(rec.calls[kname])} "
              f"{kname} calls a forward")
    print(f"centerpoint_nusc data eval (evaluate, seeded weights): {len(test_set)} scans at "
          f"b{NUSC_BATCH}: voxels a scan of the first batch {voxels}; "
          + "; ".join(f"{k} {v:.4f}" for k, v in summary.items())
          + f"; {eval_line(res)}; launches {launches_eval}; peak memory {peak:.2f} GiB")
    report_eval = compare_recorded(rec.calls, "centerpoint_nusc data eval")
    del rec
    (ckpt_dir, epochs), launches_train, _, rec, _ = run_recorded(
        "centerpoint_nusc data train", train,
        common + ["--epochs", "1", "--batch", str(NUSC_BATCH), "--output_dir", str(out_dir)],
        train_loop, "train_step", SECOND_KERNELS)
    print(f"centerpoint_nusc data train (train --data_root, CBGS and gt sampling): "
          f"{epochs_line(epochs)}; launches {launches_train}")
    report_train = compare_recorded(rec.calls, "centerpoint_nusc data train")
    del rec
    check((ckpt_dir / "checkpoint_epoch_1.pth").exists(), "nuScenes train wrote no checkpoint")

    # the converter on an OpenPCDet-named reference checkpoint of the seeded
    # full-width detector (seeded eval state: after an epoch of 10 steps the
    # trained checkpoint's BN statistics are far from its batches', and its
    # decoded sizes, exp of the dim map, overflow), then demo --ckpt of the
    # converted checkpoint on val keyframes' 10-sweep clouds
    cfg, src_model = build_detector(cfg_file, dev, seed=3, n_points=NUSC_POINTS)
    src = {k: v.detach().cpu() for k, v in src_model.state_dict().items()}
    del src_model
    ref, source = convert_torch_ckpt.reference_state_dict(src, cfg.MODEL)
    ref.pop("backbone_3d.conv_out.weight")   # (3, 1, 1): neither converter reads it
    ref = {openpcdet_center_head_name(k): v for k, v in ref.items()}
    source = {openpcdet_center_head_name(k): v for k, v in source.items()}
    torch.save({"model_state": ref, "epoch": 20, "it": 123}, base / "reference.pth")
    report = convert_torch_ckpt.main(["--ckpt", str(base / "reference.pth"), "--cfg_file",
                                      str(cfg_file), "--out", str(base / "converted.pth")])
    conv = torch.load(base / "converted.pth", weights_only=True)["model_state"]
    home = misplaced = 0
    for name, key in source.items():
        coll, path = convert_torch_ckpt.map_name(name)
        if name not in ref or coll is None or path in report["unplaced"]:
            continue
        if report["placements"][coll][path] == key:
            home += 1
        else:
            misplaced += 1
    got = (len(report["unplaced"]), home, misplaced)
    check(got == NUSC_PLACEMENTS, f"nuScenes converter: (unplaced, home, misplaced) {got}")
    equal = sum(torch.equal(conv[key], src[key]) for key in source.values())
    print(f"centerpoint_nusc reference checkpoint under OpenPCDet's CenterHead names "
          f"(dense_head.heads_list.<g>.<branch>, six groups with vel): {len(ref)} tensors; "
          f"unplaced {got[0]}, placed on their own leaf {got[1]}, on another leaf {got[2]} "
          f"(the groups' branches share their shapes); {equal} of {len(source)} entries "
          f"bit-equal to their source after it")
    del conv, src, ref

    scans = base / "demo"
    scans.mkdir()
    for i in range(NUSC_DEMO_SCANS):
        np.save(scans / f"{i:06d}.npy", test_set.get_lidar_with_sweeps(i, 10))
    (preds, rate), launches, peak, _, _ = run_recorded(
        "centerpoint_nusc demo", demo, ["--cfg_file", str(cfg_file), "--data_path", str(scans),
                                        "--ext", ".npy", "--ckpt", str(base / "converted.pth"),
                                        "--device", str(dev)],
        detectors["CenterPoint"], "forward", SECOND_KERNELS)
    post_max = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    check(len(preds) == NUSC_DEMO_SCANS, f"nuScenes demo: {len(preds)} scans")
    for p in preds:
        check(len(p["pred_labels"]) <= post_max and np.isfinite(p["pred_boxes"]).all()
              and np.isfinite(p["pred_scores"]).all(), "nuScenes demo: bad detections")
    print(f"centerpoint_nusc demo --ckpt converted.pth: {NUSC_DEMO_SCANS} .npy scans of 5 "
          f"columns (the converted model loads strictly): detections a scan "
          f"{[len(p['pred_labels']) for p in preds]}, finite; {rate:.3f} scans/s (a scan a "
          f"batch, loading included); launches {launches}; peak memory {peak:.2f} GiB")
    torch.cuda.empty_cache()
    return report_eval, launches_eval, report_train, launches_train


def nusc_profiles(dev, profiles):
    """Phase 60, after every timed path: `infer --profile` of the nuScenes
    config at b4 x NUSC_POINTS (from `infer_profiles`; no cuDNN FFT kernel
    may run), then one training step at b4 traced in this process (a
    warm-up step first), as `train --profile` traces it."""
    import torch

    from tsm_det_pointcloud_tpu_torch.infer import profile_call
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    (wall, busy, names), (pwall, pbusy, _) = profiles[NUSC_CFG]
    fft = [k for k in names if "fft" in k.lower() or "cgemm" in k.lower()]
    check(not fft, f"centerpoint_nusc: cuDNN ran FFT convolutions: {fft}")
    print(f"centerpoint_nusc eval profile: busy {busy:.3f} of {wall:.3f} ms "
          f"({100 * busy / wall:.1f}%), post-processing alone {pbusy:.3f} ms device time of "
          f"{pwall:.3f} ms; {len(names)} kernels, none an FFT")
    _, model, opt = build_trainer(cfg_path(NUSC_CFG), dev, seed=0, n_points=NUSC_POINTS,
                                  total_steps=2)
    meta = model.dataset_meta
    batches = [synth_train_batch(NUSC_BATCH, NUSC_POINTS, s, dev, meta.point_cloud_range,
                                 meta.num_point_features, velocity=True,
                                 n_classes=len(meta.class_names)) for s in range(2)]
    train_step(model, opt, batches[0])
    wall, busy, _ = profile_call(lambda: train_step(model, opt, batches[1]))
    print(f"centerpoint_nusc training profile: busy {busy:.3f} of {wall:.3f} ms "
          f"({100 * busy / wall:.1f}%)")
    del model, opt, batches
    torch.cuda.empty_cache()


def echo_lyft_dets(dataset, classes):
    """Prediction dicts of each info's own gt boxes (7 columns), at distinct
    scores (the KITTI eval's 41-point sweep steps through the true
    positives' scores)."""
    rng = np.random.RandomState(0)
    dets = []
    for info in dataset.infos:
        labels = np.array([classes.index(n) + 1 for n in info["gt_names"]])
        dets += dataset.generate_prediction_dicts(
            {"metadata": [None]},
            [{"pred_boxes": np.asarray(info["gt_boxes"])[:, :7],
              "pred_scores": rng.uniform(0.5, 1.0, len(labels)).astype(np.float32),
              "pred_labels": labels}], classes)
    return dets


def lyft_data_phases(dev, base):
    """Phase 63: the Lyft data path on a synthetic root at the order of
    Lyft's roof lidar (LYFT_TRAIN_SCENES + LYFT_VAL_SCENES scenes of
    LYFT_KEYFRAMES key frames, each after nine sweeps of LYFT_SWEEP_POINTS
    points): the writer, `create_lyft_infos` (10-sweep infos, the train gt
    database), the points a 5-sweep val scan holds before and after the
    range crop, echoed val gt through the dataset's Lyft mAP (1.0) and its
    pseudo-KITTI route (AP 100 on every 3D R40 difficulty of the four KITTI
    classes the Lyft classes map to), `evaluate` (seeded weights: a finite
    mAP dict), `train --data_root` for an epoch (gt sampling, the world
    augmentors; the loader's wait), each first forward or step recorded and
    its K3 / K7 calls held. Returns the per-kernel reports and launch counts
    of evaluate and train."""
    from tsm_det_pointcloud_tpu_torch import evaluate, train
    from tsm_det_pointcloud_tpu_torch.datasets.lyft.lyft_dataset import (
        MAP_NAME_TO_KITTI, LyftDataset, create_lyft_infos)
    from tsm_det_pointcloud_tpu_torch.datasets.lyft.synthetic import write_synthetic_lyft
    from tsm_det_pointcloud_tpu_torch.infer import load_cfg
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.runtime import train_loop

    cfg_file = cfg_path(LYFT_CFG)
    cfg = load_cfg(cfg_file)
    classes = list(cfg.CLASS_NAMES)
    root = base / "trainval"
    t0 = time.perf_counter()
    write_synthetic_lyft(root, LYFT_TRAIN_SCENES, LYFT_VAL_SCENES, LYFT_KEYFRAMES,
                         LYFT_SWEEP_POINTS, seed=0)
    t1 = time.perf_counter()
    create_lyft_infos(cfg.DATA_CONFIG, classes, root)
    t2 = time.perf_counter()
    test_set = LyftDataset(cfg.DATA_CONFIG, classes, training=False, root_path=root)
    points, cropped = [], []
    for i in range(len(test_set)):
        np.random.seed(i)
        points.append(len(test_set.get_lidar_with_sweeps(i, cfg.DATA_CONFIG.MAX_SWEEPS)))
        cropped.append(len(test_set[i]["points"]))
    check(max(cropped) <= test_set.max_points, f"Lyft scans cut by the collate: {cropped}")
    dets = echo_lyft_dets(test_set, classes)
    _, echo = test_set.evaluation(dets, classes)
    check(abs(echo["mAP"] - 1.0) < 1e-9, f"Lyft echoed gt: {echo}")
    _, kitti = test_set.evaluation(dets, classes, eval_metric="kitti")
    kitti_classes = sorted(set(MAP_NAME_TO_KITTI.values()))
    aps = {f"{c}_3d/{d}_R40": kitti.get(f"{c}_3d/{d}_R40") for c in kitti_classes
           for d in ("easy", "moderate", "hard")}
    check(all(v is not None and abs(v - 100.0) < 1e-6 for v in aps.values()),
          f"Lyft echoed gt through the KITTI route: {aps}")
    print(f"Lyft data: wrote {LYFT_TRAIN_SCENES} + {LYFT_VAL_SCENES} scenes of "
          f"{LYFT_KEYFRAMES} key frames (each after nine sweeps) of {LYFT_SWEEP_POINTS} "
          f"points a sweep in {t1 - t0:.1f} s, infos and gt database in {t2 - t1:.1f} s; "
          f"points a val scan of {cfg.DATA_CONFIG.MAX_SWEEPS} sweeps {points}, {cropped} after "
          f"the range crop (MAX_POINTS {test_set.max_points}); echoed val gt: Lyft mAP "
          f"{echo['mAP']:.4f}, pseudo-KITTI AP (3D R40) 100.0 for {kitti_classes} on every "
          f"difficulty")

    common = ["--cfg_file", str(cfg_file), "--data_root", str(root), "--workers",
              str(KITTI_WORKERS), "--device", str(dev)]
    out_dir = base / "run"
    res, launches_eval, peak, rec, first_out = run_recorded(
        "centerpoint_lyft data eval", evaluate,
        common + ["--batch_size", str(LYFT_BATCH), "--output_dir", str(out_dir)],
        detectors["CenterPoint"], "forward", SECOND_KERNELS)
    voxels = first_out["voxel_mask"].sum(1).tolist()
    del first_out
    check(set(classes) | {"mAP"} <= set(res) and all(np.isfinite(res[k]) for k in classes),
          f"Lyft evaluate: {res}")
    for kname, k in CENTERPOINT_CALLS.items():
        check(len(rec.calls[kname]) == k, f"Lyft data eval: {len(rec.calls[kname])} "
              f"{kname} calls a forward")
    print(f"centerpoint_lyft data eval (evaluate, seeded weights): {len(test_set)} scans at "
          f"b{LYFT_BATCH}: voxels a scan of the first batch {voxels}; mAP {res['mAP']:.4f}; "
          f"{eval_line(res)}; launches {launches_eval}; peak memory {peak:.2f} GiB")
    report_eval = compare_recorded(rec.calls, "centerpoint_lyft data eval")
    del rec
    (ckpt_dir, epochs), launches_train, _, rec, _ = run_recorded(
        "centerpoint_lyft data train", train,
        common + ["--epochs", "1", "--batch", str(LYFT_BATCH), "--output_dir", str(out_dir)],
        train_loop, "train_step", SECOND_KERNELS)
    print(f"centerpoint_lyft data train (train --data_root, gt sampling): "
          f"{epochs_line(epochs)}; launches {launches_train}")
    report_train = compare_recorded(rec.calls, "centerpoint_lyft data train")
    del rec
    check((ckpt_dir / "checkpoint_epoch_1.pth").exists(), "Lyft train wrote no checkpoint")
    return report_eval, launches_eval, report_train, launches_train


def pandaset_data_phases(dev, base):
    """Phase 64: the PandaSet data path on pandaset_models/centerpoint.yaml at
    full width, on a synthetic root of Pandar64 frames (PANDASET_FRAMES
    frames of PANDASET_POINTS points in each of the sequences
    PANDASET_TRAIN_SEQ and PANDASET_VAL_SEQ, ids the config's SEQUENCES
    name): the writer, `create_pandaset_infos` (infos, the train gt
    database), the points a frame holds before and after the range crop,
    the val frames' gt boxes fed back through `generate_prediction_dicts`
    onto their world cuboids (within 1e-4 m: the poses are float64 on the
    host), `train --data_root` for an epoch, then `evaluate` of its
    checkpoint (the empty result, as the reference's), each first step or
    forward recorded and its K3 / K7 calls held. Returns the per-kernel
    reports and launch counts of evaluate and train."""
    import pandas as pd

    from tsm_det_pointcloud_tpu_torch import evaluate, train
    from tsm_det_pointcloud_tpu_torch.datasets.pandaset.pandaset_dataset import (
        PandasetDataset, create_pandaset_infos)
    from tsm_det_pointcloud_tpu_torch.datasets.pandaset.synthetic import (
        write_synthetic_pandaset)
    from tsm_det_pointcloud_tpu_torch.infer import load_cfg
    from tsm_det_pointcloud_tpu_torch.models.detectors import __all__ as detectors
    from tsm_det_pointcloud_tpu_torch.runtime import train_loop

    cfg_file = cfg_path(PANDASET_CFG)
    cfg = load_cfg(cfg_file)
    classes = list(cfg.CLASS_NAMES)
    root = base / "root"
    t0 = time.perf_counter()
    write_synthetic_pandaset(root, PANDASET_TRAIN_SEQ + PANDASET_VAL_SEQ, PANDASET_FRAMES,
                             PANDASET_POINTS, seed=0)
    t1 = time.perf_counter()
    create_pandaset_infos(cfg.DATA_CONFIG, classes, root, root)
    t2 = time.perf_counter()
    test_set = PandasetDataset(cfg.DATA_CONFIG, classes, training=False, root_path=root)
    check(len(test_set) == len(PANDASET_VAL_SEQ) * PANDASET_FRAMES,
          f"PandaSet val infos: {len(test_set)}")
    mapped = set(cfg.DATA_CONFIG.TRAINING_CATEGORIES)
    cropped, worst, boxes = [], 0.0, 0
    for i, info in enumerate(test_set.infos):
        sample = test_set[i]
        cropped.append(len(sample["points"]))
        gt = sample["gt_boxes"]
        annos = test_set.generate_prediction_dicts(
            test_set.collate_batch([sample]),
            [{"pred_boxes": gt[:, :7], "pred_scores": np.ones(len(gt), np.float32),
              "pred_labels": gt[:, 7].astype(np.int64)}], classes)
        cub = pd.read_pickle(root / info["cuboids_path"])
        cub = cub[(cub["cuboids.sensor_id"] != 1) & cub.label.isin(mapped)]
        df = annos[0]["preds"]
        check(len(df) == len(cub) > 0, f"PandaSet frame {i}: {len(df)} boxes of {len(cub)}")
        for a in "xyz":
            worst = max(worst, float(np.abs(df[f"position.{a}"].to_numpy()
                                             - cub[f"position.{a}"].to_numpy()).max()))
        boxes += len(df)
    check(worst < 1e-4, f"PandaSet echoed cuboids {worst} m from the world ones")
    check(max(cropped) <= test_set.max_points, f"PandaSet frames cut by the collate: {cropped}")
    print(f"PandaSet data: wrote {len(PANDASET_TRAIN_SEQ)} + {len(PANDASET_VAL_SEQ)} "
          f"sequences of {PANDASET_FRAMES} frames of {PANDASET_POINTS} Pandar64 points (and "
          f"PandarGT points) in {t1 - t0:.1f} s, infos and gt database in {t2 - t1:.1f} s; "
          f"points a val frame after the Pandar64 pick and the range crop {cropped} "
          f"(MAX_POINTS {test_set.max_points}); {boxes} echoed val gt boxes back on their "
          f"world cuboids within {worst:.2e} m")

    # training first: its first step's cuDNN autotune of the 2816 x 1600 grid's
    # BEV convs (the widest the port runs: tens of seconds on the card) covers
    # the eval forward's shapes too, which evaluate then finds tuned
    common = ["--cfg_file", str(cfg_file), "--data_root", str(root), "--workers",
              str(KITTI_WORKERS), "--device", str(dev)]
    out_dir = base / "run"
    (ckpt_dir, epochs), launches_train, _, rec, _ = run_recorded(
        "centerpoint_pandaset data train", train,
        common + ["--epochs", "1", "--batch", str(PANDASET_BATCH), "--output_dir", str(out_dir)],
        train_loop, "train_step", SECOND_KERNELS)
    print(f"centerpoint_pandaset data train (train --data_root, gt sampling): "
          f"{epochs_line(epochs)}; launches {launches_train}")
    report_train = compare_recorded(rec.calls, "centerpoint_pandaset data train")
    del rec
    check((ckpt_dir / "checkpoint_epoch_1.pth").exists(), "PandaSet train wrote no checkpoint")
    res, launches_eval, peak, rec, first_out = run_recorded(
        "centerpoint_pandaset data eval", evaluate,
        common + ["--batch_size", str(PANDASET_BATCH), "--output_dir", str(out_dir)],
        detectors["CenterPoint"], "forward", SECOND_KERNELS)
    voxels = first_out["voxel_mask"].sum(1).tolist()
    del first_out
    check(set(res) == {"sec_per_example", "loader_first_wait_s", "loader_wait_s",
                       "scans_per_s"}, f"PandaSet evaluate: {res}")
    with open(out_dir / "eval" / "default" / "result.pkl", "rb") as f:
        result = pickle.load(f)
    check(len(result) == len(test_set) and all("preds" in a for a in result),
          f"PandaSet evaluate: {len(result)} prediction dicts")
    for kname, k in CENTERPOINT_CALLS.items():
        check(len(rec.calls[kname]) == k, f"PandaSet data eval: {len(rec.calls[kname])} "
              f"{kname} calls a forward")
    print(f"centerpoint_pandaset data eval (evaluate of the trained checkpoint): "
          f"{len(test_set)} frames at b{PANDASET_BATCH}: voxels a frame of the first batch "
          f"{voxels}; detections a frame {[len(a['name']) for a in result]} (world-frame cuboid "
          f"DataFrames), the empty result; {eval_line(res)}; launches {launches_eval}; peak "
          f"memory {peak:.2f} GiB")
    report_eval = compare_recorded(rec.calls, "centerpoint_pandaset data eval")
    del rec
    return report_eval, launches_eval, report_train, launches_train


# ---------------------------------------------------------------------------
# phases 65-69: CaDDN (CaDDN.yaml) and the JAX registry's module variants
# ---------------------------------------------------------------------------

def caddn_golden_phase(dev):
    """Phase 65: the tiny CaDDN of both depth networks (tiny.caddn_state)
    reproduces data/caddn_tiny_forward.npz on the card: eval outputs at the
    golden tolerance, predictions' labels and counts exact, the training
    loss and tb terms within 1e-4 (`close_scalar`); no hand-written kernel
    launches."""
    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import detect
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    with np.load(tiny.CADDN_FORWARD_PATH) as z:
        golden = {k: z[k] for k in z.files}
    cam_keys = ("images", "trans_lidar_to_cam_img")
    for which in tiny.CADDN_DDNS:
        model = build_network(tiny.caddn_model_cfg(which), 1, tiny.CADDN_META, device=dev)
        model.load_state_dict(tiny.caddn_state(which), strict=True)
        b = {k: torch.from_numpy(v).to(dev) for k, v in tiny.caddn_batch().items()}
        _kernels.reset_launches()
        out, pred = detect(model, b["points"], b["points_mask"], {k: b[k] for k in cam_keys})
        worst = 0.0
        for key in ("batch_cls_preds", "batch_box_preds", "pred_boxes", "pred_scores",
                    "pred_labels", "count"):
            want = golden[f"{which}/{key}"]
            got = (out[key] if key in out else pred[key]).cpu().numpy()
            if want.dtype.kind in "iu":
                check(np.array_equal(got, want), f"tiny CaDDN ({which}) {key}: {got} against "
                      f"the golden {want}")
                continue
            scale = max(1.0, float(np.abs(want).max()))
            diff = float(np.abs(got - want).max())
            check(got.shape == want.shape
                  and np.allclose(got, want, atol=1e-3 * scale, rtol=1e-3),
                  f"tiny CaDDN ({which}) {key} differs from the golden: max abs diff {diff}")
            worst = max(worst, diff / scale)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in tiny.caddn_train_batch(which).items()}
        tout = model.train()(dict(tb, batch_size=2))
        terms = {"loss": tout["loss"], **{f"tb/{k}": v for k, v in tout["tb_dict"].items()}}
        for key, v in terms.items():
            got, want = float(v.detach()), float(golden[f"{which}/{key}"])
            check(close_scalar(got, want),
                  f"tiny CaDDN ({which}) training {key} {got} differs from the golden {want}")
        torch.cuda.synchronize()
        check(not any(_kernels.LAUNCHES.values()),
              f"tiny CaDDN launched hand-written kernels: {dict(_kernels.LAUNCHES)}")
        print(f"CaDDN reference: tiny CaDDN ({which}) eval outputs within {worst:.3g} x "
              f"max(1, max|want|) of the golden, {int(pred['count'].sum())} detections equal; "
              f"training loss {float(terms['loss'].detach()):.6f} (golden "
              f"{float(golden[f'{which}/loss']):.6f}), depth_loss "
              f"{float(terms['tb/depth_loss'].detach()):.6f}")
        del model, out, pred, tout


def caddn_phases(dev):
    """Phases 66-67: CaDDN.yaml at full width (a ResNet-101 DDN at output
    stride 8 on 375 x 1242 images, a 280 x 376 x 25 frustum volume of 64
    features, 157,920 anchors a scan) on synthetic camera batches, seeded
    weights and eval state, conv_cls's bias at infer.CLS_BIAS. 66: eval b2,
    the first batch (cuDNN's autotune) timed apart, then CADDN_ITERS timed
    batches; the voxels in the camera frustum and the anchors over
    SCORE_THRESH a scan, peak memory; one scan's cls_preds / box_preds held
    against the port's CPU forward with the same weights (atol 1e-3 *
    max(1, max|cpu|), rtol 1e-3: the projection and its pixel and bin
    indices are elementwise and round alike on both; cuDNN's convs sum in
    another order than the CPU's). 67: a training step b2 (gt_boxes2d from
    the boxes' image extents), the first step timed apart, its loss, its
    depth_loss term and every gradient checked finite and present, then
    CADDN_TRAIN_ITERS timed steps, peak memory. Neither launches a
    hand-written kernel. Returns the eval model and one batch's inputs, for
    phase 69's profile."""
    import copy

    import torch

    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, synth_camera,
                                                    synth_scans, voxel_anchor_counts)
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import add_camera, build_trainer, synth_train_batch

    cfg_file = cfg_path(CADDN_CFG)
    cfg, cpu_model = build_detector(cfg_file, "cpu", seed=0, n_points=CADDN_POINTS)
    model = copy.deepcopy(cpu_model).to(dev)
    post = cfg.MODEL.POST_PROCESSING
    post_max, pre = int(post.NMS_CONFIG.NMS_POST_MAXSIZE), int(post.NMS_CONFIG.NMS_PRE_MAXSIZE)
    meta = model.dataset_meta

    def inputs(seed):
        pts = torch.from_numpy(synth_scans(meta, CADDN_BATCH, CADDN_POINTS, seed)).to(dev)
        cam = {k: torch.from_numpy(v).to(dev) for k, v in synth_camera(CADDN_BATCH, seed).items()}
        return pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev), cam

    batches = [inputs(s) for s in range(CADDN_ITERS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    out, _ = detect(model, *batches[0])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    first_peak = torch.cuda.max_memory_allocated() / 2**30
    frustum, over = voxel_anchor_counts(model, out)
    n_anchors = out["batch_cls_preds"].shape[1]
    del out
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preds = [detect(model, *b) for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(not any(_kernels.LAUNCHES.values()), f"CaDDN launched {dict(_kernels.LAUNCHES)}")
    for out, pred in preds:
        for key in ("batch_cls_preds", "batch_box_preds"):
            check(bool(torch.isfinite(out[key]).all()), f"CaDDN: non-finite {key}")
        check(tuple(out["batch_box_preds"].shape) == (CADDN_BATCH, 157920, 7),
              f"CaDDN box preds shape {tuple(out['batch_box_preds'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"CaDDN: non-finite {key}")
        check(bool((pred["count"] <= post_max).all()), "CaDDN: count > NMS_POST_MAXSIZE")
    check(min(frustum) > 0 and min(over) > 0, f"CaDDN: frustum voxels {frustum}, anchors over "
          f"SCORE_THRESH {over}")
    counts = [int(c) for c in preds[-1][1]["count"]]
    print(f"CaDDN eval: first batch {first:.3f} s (cuDNN's autotune; peak memory "
          f"{first_peak:.2f} GiB with its workspaces); {CADDN_ITERS} batches x "
          f"{CADDN_BATCH} scans x 375x1242 images in {dt:.3f} s = "
          f"{CADDN_ITERS * CADDN_BATCH / dt:.3f} scans/s; voxels in the camera frustum a scan "
          f"{frustum} of {int(np.prod(meta.grid_size))}; anchors over SCORE_THRESH "
          f"{post.SCORE_THRESH} a scan {over} of {n_anchors}; boxes into NMS a scan "
          f"{[min(o, pre) for o in over]}; detections a scan (last batch) {counts}; peak "
          f"memory of the timed batches {peak:.2f} GiB; no hand-written kernel called or "
          f"launched")
    del preds

    pts, mask, cam = batches[0]
    one = {"points": pts[:1], "points_mask": mask[:1], "batch_size": 1,
           **{k: v[:1] for k, v in cam.items()}}
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu_model({k: v.cpu() if torch.is_tensor(v) else v for k, v in one.items()})
        got = model(dict(one))
    cpu_s = time.perf_counter() - t0
    for key in ("voxels_in_frustum",):
        check(torch.equal(got[key].cpu(), want[key]), f"CaDDN {key}: card {got[key].tolist()} "
              f"against the CPU's {want[key].tolist()}")
    diffs = []
    for key in ("cls_preds", "box_preds"):
        w, g = want[key].numpy(), got[key].cpu().numpy()
        scale = max(1.0, float(np.abs(w).max()))
        diff = float(np.abs(g - w).max())
        check(np.allclose(g, w, atol=1e-3 * scale, rtol=1e-3),
              f"CaDDN {key}: card against CPU max abs diff {diff} (max |cpu| {scale})")
        diffs.append(f"{key} max abs diff {diff:.3g} (max |cpu| {float(np.abs(w).max()):.3g})")
    print(f"CaDDN eval: one scan on the card against the port's CPU forward with the same "
          f"weights ({cpu_s:.1f} s): {'; '.join(diffs)}; frustum voxels equal")
    del cpu_model, want, got

    _, tmodel, opt = build_trainer(cfg_file, dev, seed=0, n_points=CADDN_POINTS,
                                   total_steps=CADDN_TRAIN_ITERS + 1)
    tbatches = [add_camera(synth_train_batch(CADDN_BATCH, CADDN_POINTS, s, dev,
                                             meta.point_cloud_range, meta.num_point_features), s)
                for s in range(CADDN_TRAIN_ITERS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    opt.zero_grad(set_to_none=True)
    out = tmodel(dict(tbatches[0]))
    out["loss"].backward()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    missing = [n for n, p in tmodel.named_parameters() if p.grad is None]
    bad = [n for n, p in tmodel.named_parameters()
           if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    check(not missing and not bad, f"CaDDN training: no gradient {missing}; non-finite {bad}")
    opt.step()
    loss = float(out["loss"].detach())
    tb = {k: float(v.detach()) for k, v in out["tb_dict"].items()}
    check(np.isfinite(loss) and tb["depth_loss"] > 0, f"CaDDN training loss {loss}, {tb}")
    n_boxes2d = int((tbatches[0]["gt_boxes2d"] != 0).any(-1).sum())
    del out
    torch.cuda.synchronize()
    first_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [train_step(tmodel, opt, b)[0] for b in tbatches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(not any(_kernels.LAUNCHES.values()), f"CaDDN launched {dict(_kernels.LAUNCHES)}")
    for i, l in enumerate(losses):
        check(bool(torch.isfinite(l)), f"CaDDN training step {i} loss is not finite")
    n_params = sum(1 for _ in tmodel.parameters())
    print(f"CaDDN training: first step {first:.3f} s (cuDNN's autotune; peak memory "
          f"{first_peak:.2f} GiB with its workspaces), loss {loss:.4f} "
          f"({', '.join(f'{k} {v:.4f}' for k, v in tb.items())}); every one of {n_params} "
          f"gradients present and finite; {n_boxes2d} 2D gt boxes in the image; "
          f"{CADDN_TRAIN_ITERS} steps x {CADDN_BATCH} scans in {dt:.3f} s = "
          f"{CADDN_TRAIN_ITERS * CADDN_BATCH / dt:.3f} train scans/s "
          f"({1e3 * dt / CADDN_TRAIN_ITERS:.1f} ms/step); losses "
          f"{[round(float(v), 4) for v in losses]}; peak memory of the timed steps "
          f"{peak:.2f} GiB; no hand-written kernel called or launched")
    del tmodel, opt, tbatches, losses
    torch.cuda.empty_cache()
    return model, batches[0]


def variant_phases(dev):
    """Phase 68: each module variant of tiny.VARIANTS (the VFEs
    DynamicMeanVFE, MeanDensityVFE, SPVFE, VPCVFE, DynamicPillarVFE, the
    trunk SpaceVoxelBackBone8x, the heads AnchorHeadMulti, AnchorHeadSingleCls,
    AnchorHeadMultiCls) on its tiny SECOND / PointPillars topology on the
    card against the port's CPU forward with the same seeded weights: the
    eval outputs (cls_preds; the box heads' box_preds and decoded boxes too)
    at the golden tolerance, the voxel coordinates exact, the training loss
    and its tb terms (the cls-only heads' rpn_loss_cls) within 1e-4."""
    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.models import build_network

    pts = torch.from_numpy(tiny.second_points(2))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    for name in tiny.VARIANTS:
        cfg, meta = tiny.variant_model(name)
        cpu = build_network(cfg, len(meta.class_names), meta, device="cpu", seed=3)
        card = build_network(cfg, len(meta.class_names), meta, device=dev, seed=3)
        card.load_state_dict(cpu.state_dict(), strict=True)
        batch = {"points": pts, "points_mask": mask, "batch_size": 2}
        with torch.no_grad():
            want = cpu(dict(batch))
            got = card({k: v.to(dev) if torch.is_tensor(v) else v for k, v in batch.items()})
        check(torch.equal(got["voxel_coords"].cpu(), want["voxel_coords"]),
              f"variant {name}: voxel coordinates differ")
        worst = 0.0
        for key in ("cls_preds", "box_preds", "batch_box_preds"):
            if key not in want:
                continue
            w, g = want[key].numpy(), got[key].cpu().numpy()
            scale = max(1.0, float(np.abs(w).max()))
            check(np.allclose(g, w, atol=1e-3 * scale, rtol=1e-3),
                  f"variant {name} {key}: max abs diff {float(np.abs(g - w).max())}")
            worst = max(worst, float(np.abs(g - w).max()) / scale)
        gt, gmask = tiny.variant_gt(meta)
        tbatch = dict(batch, gt_boxes=torch.from_numpy(gt), gt_boxes_mask=torch.from_numpy(gmask))
        tw = cpu.train()(dict(tbatch))
        tg = card.train()({k: v.to(dev) if torch.is_tensor(v) else v for k, v in tbatch.items()})
        terms = {"loss": (tg["loss"], tw["loss"]),
                 **{k: (tg["tb_dict"][k], v) for k, v in tw["tb_dict"].items()}}
        for key, (g, w) in terms.items():
            g, w = float(g.detach()), float(w.detach())
            check(close_scalar(g, w), f"variant {name} training {key}: card {g} against CPU {w}")
        print(f"variant {name} ({' -> '.join(type(m).__name__ for m in card.module_list)}): "
              f"eval outputs within {worst:.3g} x max(1, max|cpu|) of the CPU's; training loss "
              f"{float(tg['loss'].detach()):.5f} (CPU {float(tw['loss'].detach()):.5f}), tb "
              f"terms {sorted(tw['tb_dict'])} within 1e-4")
        del cpu, card, want, got, tw, tg


def caddn_profile(model, inputs):
    """Phase 69, after every timed path (a profiler window slows the later
    launches of its process): one CaDDN eval batch of phase 66's model and
    inputs traced with torch.profiler (`infer.profile_batch`): the device's
    busy share, the top device kernels (the DDN's convs, the frustum gather,
    the BEV convs, the NMS) and the post-processing alone; lists any cuDNN
    FFT kernel (`fft` / `cgemm`) that ran."""
    from tsm_det_pointcloud_tpu_torch.infer import profile_batch

    pts, mask, cam = inputs
    (wall, busy, names), (pwall, pbusy, _) = profile_batch(model, pts, mask, camera=cam)
    fft = [k for k in names if "fft" in k.lower() or "cgemm" in k.lower()]
    print(f"CaDDN profile: busy {busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.1f}%), "
          f"post-processing alone {pbusy:.3f} ms device time of {pwall:.3f} ms; "
          f"{len(names)} kernels; cuDNN FFT kernels: {fft or 'none'}")


# ---------------------------------------------------------------------------
# phases 70-74: PVSSDA on 3DSSD's fusion-sampling backbone (pvssda_3dssd.yaml)
# ---------------------------------------------------------------------------

def pvssda_golden_phase(dev):
    """Phase 70: the tiny PVSSDA on PointNet2FSMSG (tiny.pvssda_state)
    reproduces data/pvssda_tiny_forward.npz on the card through three K1
    launches (d-fps, s-fps, d-fps), K2's two-entry kernel (layer 0's 40-sample
    annulus) and K2 (golden tolerance; labels and counts exact)."""
    import torch

    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.infer import detect
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    pts = torch.from_numpy(tiny.pvssda_points(2)).to(dev)
    model = build_network(tiny.pvssda_model_cfg("fsmsg"), 1, tiny.PVSSDA_META, device=dev)
    model.load_state_dict(tiny.pvssda_state("fsmsg"), strict=True)
    _kernels.reset_launches()
    out, pred = detect(model, pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev))
    got = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    check(got == {"fps": 3, "query_group": 1, "query_group_wide": 1},
          f"tiny pvssda launches {got}")
    hold_golden("pvssda reference: tiny pvssda", out, pred, tiny.PVSSDA_FORWARD_PATH)


def _pvssda_first_step(cfg_file, dev, tbatch, meta):
    """build_trainer and one forward + backward of pvssda_3dssd.yaml at
    `tbatch`: (model, optimizer, batches, output), or None where the step
    does not fit on the card."""
    import torch

    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    try:
        _, model, opt = build_trainer(cfg_file, dev, seed=0, n_points=PVSSDA_POINTS,
                                      total_steps=PVSSDA_TRAIN_ITERS + 1)
        tbatches = [synth_train_batch(tbatch, PVSSDA_POINTS, s, dev, meta.point_cloud_range,
                                      meta.num_point_features)
                    for s in range(PVSSDA_TRAIN_ITERS + 1)]
        opt.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        out = model(dict(tbatches[0]))
        out["loss"].backward()
        torch.cuda.synchronize()
        return model, opt, tbatches, out
    except torch.cuda.OutOfMemoryError:
        return None


def pvssda_phases(dev):
    """Phases 71-72: pvssda_3dssd.yaml at full width on synthetic scans. 71:
    one recorded eval batch at b16 x 16384 (PVSSDA_CALLS), every K1 and K2
    call held against its plain version (indices exact) and timed, K2's
    two-entry calls at 64 samples among them; 3 counted batches of forward +
    NMS (outputs finite, (16, 512, 7) boxes, count <= NMS_POST_MAXSIZE, K1,
    K2 and K2's two-entry kernel launched PVSSDA_CALLS a forward), scans/s,
    peak memory, and the two f-fps calls' share of a forward (one more batch
    with them timed apart, the card synchronised around each). 72: a
    training step at the largest of PVSSDA_TRAIN_BATCHES that fits, every
    parameter a finite gradient, then PVSSDA_TRAIN_ITERS counted steps
    (losses finite, the kernels launched). Returns phase 71's report and
    launch counts."""
    import torch

    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, synth_scans,
                                                    voxel_anchor_counts)
    from tsm_det_pointcloud_tpu_torch.ops import _kernels, sampling
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step

    cfg_file = cfg_path(PVSSDA_CFG)
    cfg, model = build_detector(cfg_file, dev, seed=0, n_points=PVSSDA_POINTS)
    post = cfg.MODEL.POST_PROCESSING
    post_max = int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
    n_head = sum(cfg.MODEL.BACKBONE_3D.SA_CONFIG.NPOINT_LIST[-1])
    meta = model.dataset_meta
    batches = [torch.from_numpy(synth_scans(meta, PVSSDA_BATCH, PVSSDA_POINTS, seed=s)).to(dev)
               for s in range(PVSSDA_ITERS)]
    mask = torch.ones((PVSSDA_BATCH, PVSSDA_POINTS), dtype=torch.bool, device=dev)
    rec = record_kernels(("fps", "query_group"))
    out, _ = detect(model, batches[0], mask)
    torch.cuda.synchronize()
    rec.restore()
    calls = split_calls(rec.calls)
    del rec
    for name, n in PVSSDA_CALLS.items():
        check(len(calls.get(name, [])) == n, f"the pvssda capture forward made "
              f"{len(calls.get(name, []))} {name} calls, not {n}")
    wide_ns = [max(int(sc[2]) for sc in a[3]) for a in calls["query_group_wide"]]
    check(wide_ns == [64, 64], f"pvssda: K2's two-entry calls take {wide_ns} samples")
    _, over = voxel_anchor_counts(model, out)
    print(f"pvssda capture: {out['point_coords'].shape[1]} points a scan reach the head; "
          f"boxes over SCORE_THRESH {post.SCORE_THRESH} a scan {over}; K2 calls' samples a "
          f"ball {[[int(sc[2]) for sc in a[3]] for a in calls['query_group'] + calls['query_group_wide']]}")
    del out
    report = compare_recorded(calls, "pvssda")
    del calls

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    preds = [detect(model, pts, mask) for pts in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for out, pred in preds:
        for key in ("batch_cls_preds", "batch_box_preds"):
            check(bool(torch.isfinite(out[key]).all()), f"pvssda: non-finite {key}")
        check(tuple(out["batch_box_preds"].shape) == (PVSSDA_BATCH, n_head, 7),
              f"pvssda box preds shape {tuple(out['batch_box_preds'].shape)}")
        for key in ("pred_boxes", "pred_scores"):
            check(bool(torch.isfinite(pred[key]).all()), f"pvssda: non-finite {key}")
        check(bool((pred["count"] <= post_max).all()), "pvssda: count > NMS_POST_MAXSIZE")
    for name, n in PVSSDA_CALLS.items():
        check(launches[name] == n * PVSSDA_ITERS, f"kernel {name} launched {launches[name]} "
              f"times on the pvssda path, not {n} a forward")
    counts = [int(c) for c in preds[-1][1]["count"]]
    del preds, out, pred
    # the f-fps calls' share of a forward: one more batch, each f-fps call
    # timed on the host clock between two synchronisations
    ffps = []
    orig = sampling.furthest_point_sample_feature

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx = orig(*args, **kwargs)
        torch.cuda.synchronize()
        ffps.append(1e3 * (time.perf_counter() - t))
        return idx

    sampling.furthest_point_sample_feature = timed
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        detect(model, batches[0], mask)
        torch.cuda.synchronize()
        fwd_ms = 1e3 * (time.perf_counter() - t1)
    finally:
        sampling.furthest_point_sample_feature = orig
    print(f"pvssda eval: {PVSSDA_ITERS} batches x {PVSSDA_BATCH} scans x {PVSSDA_POINTS} "
          f"points in {dt:.3f} s = {PVSSDA_ITERS * PVSSDA_BATCH / dt:.3f} scans/s "
          f"({1e3 * dt / PVSSDA_ITERS:.1f} ms a batch); detections a scan (last batch) "
          f"{counts}; launches {launches}; peak memory {peak:.2f} GiB; f-fps (plain PyTorch, "
          f"{len(ffps)} calls: {[round(v, 3) for v in ffps]} ms) {sum(ffps):.3f} of "
          f"{fwd_ms:.3f} ms of a forward + NMS batch timed apart "
          f"({100 * sum(ffps) / fwd_ms:.1f}%)")
    del model, batches
    torch.cuda.empty_cache()

    step = None
    for tbatch in PVSSDA_TRAIN_BATCHES:
        step = _pvssda_first_step(cfg_file, dev, tbatch, meta)
        if step is not None:
            break
        torch.cuda.empty_cache()
        print(f"pvssda training: a step at b{tbatch} does not fit on the card")
    check(step is not None, f"pvssda: no training batch of {PVSSDA_TRAIN_BATCHES} fits")
    model, opt, tbatches, out = step
    del step
    first_peak = torch.cuda.max_memory_allocated() / 2**30
    for n, p in model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"pvssda parameter {n} got no finite gradient")
    opt.step()
    check(bool(torch.isfinite(out["loss"])) and "point_loss" in out["tb_dict"],
          f"pvssda warm-up step: loss {float(out['loss'].detach())}")
    print(f"pvssda training capture at b{tbatch}: loss {float(out['loss'].detach()):.4f}; every "
          f"one of {sum(1 for _ in model.parameters())} parameters a finite gradient; peak "
          f"memory {first_peak:.2f} GiB")
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    steps = [train_step(model, opt, b) for b in tbatches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_train = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (loss, tb) in enumerate(steps):
        check(bool(torch.isfinite(loss)), f"pvssda training step {i}: loss {float(loss)}")
    for name, n in PVSSDA_CALLS.items():
        check(launches_train[name] == n * PVSSDA_TRAIN_ITERS, f"kernel {name} launched "
              f"{launches_train[name]} times on the pvssda training path, not {n} a step")
    print(f"pvssda training: {PVSSDA_TRAIN_ITERS} steps x {tbatch} scans x {PVSSDA_POINTS} "
          f"points in {dt:.3f} s = {PVSSDA_TRAIN_ITERS * tbatch / dt:.3f} train scans/s "
          f"({1e3 * dt / PVSSDA_TRAIN_ITERS:.1f} ms/step); losses "
          f"{[round(float(loss), 4) for loss, _ in steps]}; launches {launches_train}; peak "
          f"memory {peak:.2f} GiB")
    del model, opt, tbatches, steps
    torch.cuda.empty_cache()
    return report, launches


def weighted_fps_phase(dev):
    """Phase 73: K6's weighted instantiation (s-fps past K1's 16384 points a
    row; no config reaches it) on WEIGHTED_ROWS synthetic scans
    (infer.synth_waymo's clusters) with uniform random weights and
    WEIGHTED_INVALID of the points invalid, WEIGHTED_NPOINT picks: each held
    index for index against the plain lockstep s-fps, timed with its bound
    and latency floor (compare_fps_block_weighted); then the same inputs
    through `sampling.furthest_point_sample_weights`, the s-fps entry, with
    the launch counts zeroed before and read after: one weighted K6 launch
    a call, no K1 and no d-fps K6. Returns the report and those counts."""
    import torch

    from tsm_det_pointcloud_tpu_torch.infer import synth_waymo
    from tsm_det_pointcloud_tpu_torch.ops import _kernels, sampling

    inputs = []
    for b, n in WEIGHTED_ROWS:
        g = torch.Generator().manual_seed(n)
        xyz = torch.from_numpy(np.ascontiguousarray(synth_waymo(b, n, seed=b)[..., :3])).to(dev)
        valid = (torch.rand((b, n), generator=g) >= WEIGHTED_INVALID).to(dev)
        weights = torch.rand((b, n), generator=g).to(dev)
        inputs.append((xyz, WEIGHTED_NPOINT, valid, weights))
    report = compare_recorded({"fps_block_weighted": inputs}, "weighted fps")
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for xyz, npoint, valid, weights in inputs:
        sampling.furthest_point_sample_weights(xyz, weights, npoint, valid)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    check(launches["fps_block_weighted"] == len(inputs) and launches["fps"] == 0
          and launches["fps_block"] == 0, f"weighted s-fps launches {launches}")
    print(f"weighted fps: s-fps over {[n for _, n in WEIGHTED_ROWS]} points a row through "
          f"furthest_point_sample_weights: launches {launches}")
    del inputs
    torch.cuda.empty_cache()
    return report, launches


def pvssda_data_phase(dev, root):
    """Phase 74: pvssda_3dssd.yaml's `evaluate` on phase 22's KITTI root over
    phase 29's SECOND_DATA_FRAMES val frames at b4 (pointrcnn.yaml's data
    path: sample_points, no shuffle), its first forward recorded and each K1
    / K2 call held against its plain version; the AP dict holds the 3d, bev
    and image APs of the three classes at every difficulty, R11 and R40
    (aos ones only where the eval computes orientation), all finite.
    Returns the report and launch counts."""
    from tsm_det_pointcloud_tpu_torch import evaluate
    from tsm_det_pointcloud_tpu_torch.infer import load_cfg
    from tsm_det_pointcloud_tpu_torch.models.detectors import PVSSDA

    n = SECOND_DATA_FRAMES
    cfg_file = cfg_path(PVSSDA_CFG)
    classes = list(load_cfg(cfg_file).CLASS_NAMES)
    res, launches, peak, rec, _ = run_recorded(
        "pvssda data eval", evaluate,
        ["--cfg_file", str(cfg_file), "--batch_size", str(PVSSDA_DATA_BATCH), "--output_dir",
         str(root.parent / "pvssda"), "--data_root", str(root), "--workers", str(KITTI_WORKERS),
         "--device", str(dev), "--set", "DATA_CONFIG.INFO_PATH.test",
         f"['kitti_infos_val_{n}.pkl']"], PVSSDA, "forward", ("fps", "query_group"))
    aps = check_kitti_aps(res, classes, "pvssda evaluate")
    # every class's 3d / bev / image AP at each difficulty, R11 and R40 (the
    # aos ones only where the eval computes orientation)
    want = {f"{c}_{m}/{d}{r}" for c in classes for m in ("3d", "bev", "image")
            for d in ("easy", "moderate", "hard") for r in ("", "_R40")}
    extra = set(aps) - want
    check(want <= set(aps) and all(k.split("/")[0].endswith("_aos") for k in extra),
          f"pvssda evaluate: AP keys {sorted(aps)}")
    calls = split_calls(rec.calls)
    del rec
    for name, k in PVSSDA_CALLS.items():
        check(len(calls.get(name, [])) == k and launches[name] == k * (n // PVSSDA_DATA_BATCH),
              f"pvssda data eval: {len(calls.get(name, []))} {name} calls a forward, "
              f"{launches[name]} in all")
    print(f"pvssda data eval (evaluate, seeded weights): {n} scans at b{PVSSDA_DATA_BATCH}: "
          f"{len(aps)} APs ({len(extra)} aos), all finite; {eval_line(res)}; launches {launches}; peak memory "
          f"{peak:.2f} GiB")
    return compare_recorded(calls, "pvssda data eval"), launches


def dsasnet_data_phase(dev, root):
    """Phase 79: dsasnet.yaml's `evaluate` on phase 22's KITTI root over
    phase 29's SECOND_DATA_FRAMES val frames at its eval batch (pvrcnn.yaml's
    data path), its first forward recorded and each K1 / K2 / K3 / K6 / K7
    call held against its plain version, the launches a forward DSASNET's;
    the AP dict holds the 3d, bev and image APs of the three classes at
    every difficulty, R11 and R40 (aos ones only where the eval computes
    orientation), all finite. Returns the report and launch counts."""
    from tsm_det_pointcloud_tpu_torch import evaluate
    from tsm_det_pointcloud_tpu_torch.infer import load_cfg
    from tsm_det_pointcloud_tpu_torch.models.detectors import DSASNet

    (cfg_name, batch, _, calls), = DSASNET.values()
    n = SECOND_DATA_FRAMES
    cfg_file = cfg_path(cfg_name)
    classes = list(load_cfg(cfg_file).CLASS_NAMES)
    res, launches, peak, rec, first_out = run_recorded(
        "dsasnet data eval", evaluate,
        ["--cfg_file", str(cfg_file), "--batch_size", str(batch), "--output_dir",
         str(root.parent / "dsasnet"), "--data_root", str(root), "--workers", str(KITTI_WORKERS),
         "--device", str(dev), "--set", "DATA_CONFIG.INFO_PATH.test",
         f"['kitti_infos_val_{n}.pkl']"], DSASNet, "forward", tuple(calls))
    voxels = first_out["voxel_mask"].sum(1).tolist()
    del first_out
    aps = check_kitti_aps(res, classes, "dsasnet evaluate")
    want = {f"{c}_{m}/{d}{r}" for c in classes for m in ("3d", "bev", "image")
            for d in ("easy", "moderate", "hard") for r in ("", "_R40")}
    extra = set(aps) - want
    check(want <= set(aps) and all(k.split("/")[0].endswith("_aos") for k in extra),
          f"dsasnet evaluate: AP keys {sorted(aps)}")
    for name, k in calls.items():
        check(len(rec.calls[name]) == k and launches[name] == k * (n // batch),
              f"dsasnet data eval: {len(rec.calls[name])} {name} calls a forward, "
              f"{launches[name]} in all")
    print(f"dsasnet data eval (evaluate, seeded weights): {n} scans at b{batch}: voxels a scan "
          f"of the first batch {voxels}; {len(aps)} APs ({len(extra)} aos), all finite; "
          f"{eval_line(res)}; launches {launches}; peak memory {peak:.2f} GiB")
    return compare_recorded(rec.calls, "dsasnet data eval"), launches


def pvssda_profile(profiles):
    """pvssda_3dssd.yaml's `infer --profile` at b4 x 16384, in phase 39's
    fresh process, after every timed path: busy share, post-processing alone."""
    (wall, busy, names), (pwall, pbusy, _) = profiles[PVSSDA_CFG]
    print(f"pvssda profile: busy {busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.1f}%), "
          f"post-processing alone {pbusy:.3f} ms device time of {pwall:.3f} ms; "
          f"{len(names)} kernels; top {names[:6]}")


# ---------------------------------------------------------------------------
# phases 81-85: the JAX package's last options: OpenPCDet's
# cbgs_pp_multihead.yaml and the variants of `infer.variant_cfg` that are the
# first users of the others (pillar_options, teacher3, pointrcnn_pool_last)
# ---------------------------------------------------------------------------

def pp_multihead_phases(dev, nusc_root):
    """Phases 81-82: OpenPCDet's cbgs_pp_multihead.yaml. 81: the tiny
    multi-head's JAX golden (`tiny.pp_multihead_state()`) on the card. 82:
    eval at b4 on phase 58's 10-sweep synthetic scans (warm-up, then
    PP_MULTIHEAD_ITERS counted batches: scans/s, peak memory, pillars and
    anchors over SCORE_THRESH a scan), one scan on the card against the CPU,
    a training step at the published batch after a warm-up step, and
    `evaluate` (seeded weights) on phase 59's synthetic nuScenes root, the
    val keyframes: a finite NDS dict. PointPillars runs no hand-written
    kernel: none may be called or launched."""
    import torch

    from tsm_det_pointcloud_tpu_torch import evaluate, tiny
    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, synth_scans,
                                                    voxel_anchor_counts)
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    def no_kernel(label):
        check(not any(_kernels.LAUNCHES.values()),
              f"{label} launched hand-written kernels: {dict(_kernels.LAUNCHES)}")

    t0 = time.perf_counter()
    _kernels.reset_launches()
    m = build_network(tiny.pp_multihead_model_cfg(), 10, tiny.PP_MULTIHEAD_META, device=dev)
    m.load_state_dict(tiny.pp_multihead_state(), strict=True)
    pts = torch.from_numpy(tiny.nusc_points(2)).to(dev)
    out, pred = detect(m, pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=dev))
    hold_golden("pp_multihead tiny", out, pred, tiny.PP_MULTIHEAD_FORWARD_PATH)
    no_kernel("the tiny multi-head")
    del m, out, pred
    print(f"phase 81: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg_file = cfg_path(PP_MULTIHEAD_CFG)
    cfg, model = build_detector(cfg_file, dev, seed=0, n_points=NUSC_POINTS)
    post = cfg.MODEL.POST_PROCESSING
    post_max = int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
    meta = model.dataset_meta
    batches = [torch.from_numpy(synth_scans(meta, PP_MULTIHEAD_BATCH, NUSC_POINTS, seed=s))
               .to(dev) for s in range(PP_MULTIHEAD_ITERS)]
    mask = torch.ones(batches[0].shape[:2], dtype=torch.bool, device=dev)
    _kernels.reset_launches()
    t_w = time.perf_counter()
    detect(model, batches[0], mask)      # warm-up: cuDNN times its algorithms
    torch.cuda.synchronize()
    warm = time.perf_counter() - t_w
    torch.cuda.reset_peak_memory_stats()
    t_e = time.perf_counter()
    preds = [detect(model, b, mask) for b in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_e
    no_kernel("cbgs_pp_multihead eval")
    for o, p in preds:
        # spatial_features_2d: the shared conv's 64 channels over the 128 x 128 x 384 map
        check(tuple(o["batch_box_preds"].shape) == (PP_MULTIHEAD_BATCH, 327680, 7)
              and tuple(o["box_preds"].shape)[-1] == 8
              and tuple(o["spatial_features_2d"].shape[1:]) == (128, 128, 64)
              and model.module_list[2].get_output_feature_dim() == 384,
              f"cbgs_pp_multihead shapes {tuple(o['batch_box_preds'].shape)}, "
              f"{tuple(o['spatial_features_2d'].shape)}")
        for key in ("batch_cls_preds", "batch_box_preds"):
            check(bool(torch.isfinite(o[key]).all()), f"cbgs_pp_multihead: non-finite {key}")
        check(bool((p["count"] <= post_max).all()) and all(
            bool(torch.isfinite(p[k]).all()) for k in ("pred_boxes", "pred_scores")),
            f"cbgs_pp_multihead detections {p['count'].tolist()}")
    pillars, over = voxel_anchor_counts(model, preds[-1][0])
    print(f"cbgs_pp_multihead eval: {PP_MULTIHEAD_ITERS} batches x {PP_MULTIHEAD_BATCH} scans x "
          f"{NUSC_POINTS} points in {dt:.3f} s = {PP_MULTIHEAD_ITERS * PP_MULTIHEAD_BATCH / dt:.3f} "
          f"scans/s (warm-up batch {warm:.3f} s); pillars a scan (capacity {meta.max_voxels}, "
          f"{meta.max_points_per_voxel} points a pillar) {pillars}; anchors over SCORE_THRESH "
          f"{post.SCORE_THRESH} a scan {over} of 327680; detections (last batch) "
          f"{preds[-1][1]['count'].tolist()}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; no hand-written kernel")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    scan = batches[0][:1]
    with torch.no_grad():
        got = model({"points": scan, "points_mask": mask[:1], "batch_size": 1})
    cpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device="cpu").eval()
    cpu.load_state_dict(state, strict=True)
    with torch.no_grad():
        want = cpu({"points": scan.cpu(), "points_mask": mask[:1].cpu(), "batch_size": 1})
    keys = ("voxel_coords", "spatial_features_2d", "batch_cls_preds", "batch_box_preds")
    worst = _hold_close("cbgs_pp_multihead scan", got, {k: want[k] for k in keys})
    print(f"cbgs_pp_multihead: a scan of {NUSC_POINTS} points on the card against the CPU: "
          f"{', '.join(keys)} within {worst:.3g} x max(1, max|want|)")
    del model, preds, batches, cpu, got, want, o, p
    torch.cuda.empty_cache()

    _, tmodel, opt = build_trainer(cfg_file, dev, seed=0, n_points=NUSC_POINTS, total_steps=2)
    tmeta = tmodel.dataset_meta
    tb = [synth_train_batch(PP_MULTIHEAD_BATCH, NUSC_POINTS, s, dev, tmeta.point_cloud_range,
                            tmeta.num_point_features, n_classes=10) for s in range(2)]
    t_w = time.perf_counter()
    warm_loss, _ = train_step(tmodel, opt, tb[0])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t_w
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t_s = time.perf_counter()
    loss, tbd = train_step(tmodel, opt, tb[1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_s
    no_kernel("cbgs_pp_multihead training")
    check(bool(torch.isfinite(warm_loss)) and bool(torch.isfinite(loss)),
          f"cbgs_pp_multihead training losses {float(warm_loss)}, {float(loss)}")
    for n, p in tmodel.named_parameters():
        check(not torch.equal(p, before[n]), f"cbgs_pp_multihead parameter {n} did not change")
    print(f"cbgs_pp_multihead training: b{PP_MULTIHEAD_BATCH} x {NUSC_POINTS} points, gt boxes of "
          f"the ten classes; warm-up step {warm:.3f} s (cuDNN's first calls), loss "
          f"{float(warm_loss):.4f}; the counted step {1e3 * dt:.1f} ms = "
          f"{PP_MULTIHEAD_BATCH / dt:.3f} train scans/s, loss {float(loss):.4f} ("
          + ", ".join(f"{k} {float(v):.4f}" for k, v in tbd.items())
          + f"); {len(before)} parameters changed; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del tmodel, opt, tb, before
    torch.cuda.empty_cache()

    _kernels.reset_launches()
    res = evaluate.main(["--cfg_file", str(cfg_file), "--data_root", str(nusc_root),
                         "--workers", str(KITTI_WORKERS), "--device", str(dev),
                         "--batch_size", str(PP_MULTIHEAD_BATCH), "--output_dir",
                         str(nusc_root.parent / "pp_multihead")])
    no_kernel("cbgs_pp_multihead evaluate")
    summary = {k: res[k] for k in ("NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE")}
    check(all(np.isfinite(v) for v in summary.values()),
          f"cbgs_pp_multihead evaluate: {summary}")
    print(f"cbgs_pp_multihead evaluate (seeded weights) on phase 59's val keyframes: "
          + "; ".join(f"{k} {v:.4f}" for k, v in summary.items()) + f"; {eval_line(res)}")
    print(f"phase 82: {time.perf_counter() - t0:.1f} s")


def pp_multihead_profile(profiles):
    """Phase 82's profile: `infer --profile` of cbgs_pp_multihead.yaml at
    b4 x NUSC_POINTS (`profiles`, from `infer_profiles`): the device-only
    busy share of an eval batch and of its post-processing alone; no cuDNN
    FFT (`fft` / `cgemm`) kernel may run."""
    (wall, busy, names), (pwall, pbusy, _) = profiles[PP_MULTIHEAD_CFG]
    fft = [k for k in names if "fft" in k.lower() or "cgemm" in k.lower()]
    check(not fft, f"cbgs_pp_multihead: cuDNN ran FFT convolutions: {fft}")
    print(f"cbgs_pp_multihead profile: busy {busy:.3f} of {wall:.3f} ms "
          f"({100 * busy / wall:.1f}%), post-processing alone {pbusy:.3f} ms device time of "
          f"{pwall:.3f} ms; {len(names)} kernels, none an FFT")


def _multi_thresh_inputs(model, out, b):
    """Scan b's (max class score, boxes, 1-based labels) as the detector's
    post-processing hands them to `multi_thresh_nms`."""
    import torch

    scores, labels = torch.sigmoid(out["batch_cls_preds"][b]).max(-1)
    return scores, out["batch_box_preds"][b, :, :7], (labels + 1).to(torch.int32)


def pillar_options_phases(dev, kitti_root):
    """Phase 83: `infer.variant_cfg("pillar_options")` (pointpillar.yaml
    with a two-layer PFN on the distance, no absolute xyz, a strided-conv
    deblock0 and a deblock_final, per-class SCORE_THRESH with nms_normal, the
    frustum dropout, adam) at full width: eval b4 x 20000 (warm-up, then
    PILLAR_OPTIONS_ITERS counted batches: scans/s, the boxes the per-pass
    nms_normal keeps a scan); on the last batch's first scan the
    post-processing alone, device time, through the per-pass route with
    nms_normal and with nms_gpu over the 321,408 boxes and the matrix route
    over the best 4096 of them; one scan on the card against the CPU;
    PILLAR_OPTIONS_STEPS training steps under adam and as many under sgd,
    each step's lr printed; then `train --data_root` on phase 22's root, its
    first 8 train frames at b4 (2 steps) with the frustum dropout on. The JAX augmentor cuts the gt boxes a dropout drops but not their
    names nor gt_boxes_mask, so a sample that drops a box fails the mask at
    the end of the augmentor queue (IndexError; ROADMAP §C), in the port as
    in the JAX package: the phase first draws each train sample in this
    process as the loader draws it ((seed, epoch, index)), and the run must
    fail with that error when one of them does, else train its 2 steps."""
    import pickle

    import torch

    from tsm_det_pointcloud_tpu_torch import train
    from tsm_det_pointcloud_tpu_torch.config import cfg_from_list
    from tsm_det_pointcloud_tpu_torch.datasets import seed_for_sample
    from tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
    from tsm_det_pointcloud_tpu_torch.infer import (build_detector, detect, synth_scans,
                                                    variant_cfg, voxel_anchor_counts)
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.models.model_utils import model_nms_utils
    from tsm_det_pointcloud_tpu_torch.ops import _kernels
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    t0 = time.perf_counter()
    cfg, model = build_detector(None, dev, seed=0, n_points=ZOO_POINTS, variant="pillar_options")
    post = cfg.MODEL.POST_PROCESSING
    nms_cfg = dict(post.NMS_CONFIG)
    meta = model.dataset_meta
    batches = [torch.from_numpy(synth_scans(meta, PILLAR_OPTIONS_BATCH, ZOO_POINTS, seed=s))
               .to(dev) for s in range(PILLAR_OPTIONS_ITERS)]
    mask = torch.ones(batches[0].shape[:2], dtype=torch.bool, device=dev)
    _kernels.reset_launches()
    detect(model, batches[0], mask)      # warm-up: cuDNN times its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_e = time.perf_counter()
    preds = [detect(model, b, mask) for b in batches]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_e
    check(not any(_kernels.LAUNCHES.values()), f"pillar_options launched {dict(_kernels.LAUNCHES)}")
    out, pred = preds[-1]
    check(tuple(out["spatial_features_2d"].shape[1:]) == (248, 216, 384)
          and tuple(out["batch_box_preds"].shape) == (PILLAR_OPTIONS_BATCH, 321408, 7),
          f"pillar_options shapes {tuple(out['spatial_features_2d'].shape)}")
    for o, p in preds:
        check(all(bool(torch.isfinite(o[k]).all()) for k in ("batch_cls_preds",
                                                             "batch_box_preds"))
              and bool((p["count"] <= int(nms_cfg["NMS_POST_MAXSIZE"])).all()),
              f"pillar_options detections {p['count'].tolist()}")
    pillars, over = voxel_anchor_counts(model, out)
    print(f"pillar_options eval: {PILLAR_OPTIONS_ITERS} batches x {PILLAR_OPTIONS_BATCH} scans x "
          f"{ZOO_POINTS} points in {dt:.3f} s = {PILLAR_OPTIONS_ITERS * PILLAR_OPTIONS_BATCH / dt:.3f} "
          f"scans/s; pillars a scan {pillars}; anchors over their class's SCORE_THRESH a scan "
          f"{over} of 321408; boxes the per-pass nms_normal kept a scan (last batch) "
          f"{pred['count'].tolist()}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; no hand-written kernel")

    # the post-processing of one scan alone: the per-pass route (n > max(pre,
    # 4096)) with either NMS, and the matrix route over the same scan's best
    # 4096 boxes (n = 4096 takes it)
    scores, boxes, labels = _multi_thresh_inputs(model, out, 0)
    thresh = list(post.SCORE_THRESH)
    top = torch.sort(scores, descending=True, stable=True).indices[:4096]
    runs, nms_report = {}, {}
    for label, nms_type, sel in (("per-pass nms_normal", "nms_normal", None),
                                 ("per-pass nms_gpu", "nms_gpu", None),
                                 ("matrix nms_normal, best 4096", "nms_normal", top),
                                 ("matrix nms_gpu, best 4096", "nms_gpu", top)):
        args = ((scores, boxes, labels) if sel is None else
                (scores[sel], boxes[sel], labels[sel])) + (dict(nms_cfg, NMS_TYPE=nms_type),
                                                           thresh)
        _, cnt, _ = model_nms_utils.multi_thresh_nms(*args)
        runs[label] = (int(cnt), cuda_time_ms(lambda: model_nms_utils.multi_thresh_nms(*args), 3))
        # its device time alone after every timed path (Deferred)
        nms_report[label] = {"deferred": [("device_ms", deferred(
            model_nms_utils.multi_thresh_nms, args, 3))]}
    print("pillar_options post-processing of one scan alone (ms between CUDA events, boxes "
          "kept; the device time alone comes with the deferred ones): "
          + "; ".join(f"{k} {w:.3f} ms, {n}" for k, (n, w) in runs.items()))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    scan = batches[0][:1]
    with torch.no_grad():
        got = model({"points": scan, "points_mask": mask[:1], "batch_size": 1})
    cpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device="cpu").eval()
    cpu.load_state_dict(state, strict=True)
    with torch.no_grad():
        want = cpu({"points": scan.cpu(), "points_mask": mask[:1].cpu(), "batch_size": 1})
    keys = ("voxel_coords", "pillar_features", "spatial_features_2d", "batch_cls_preds",
            "batch_box_preds")
    worst = _hold_close("pillar_options scan", got, {k: want[k] for k in keys})
    print(f"pillar_options: a scan on the card against the CPU: {', '.join(keys)} within "
          f"{worst:.3g} x max(1, max|want|)")
    del model, preds, batches, out, pred, cpu, got, want
    torch.cuda.empty_cache()

    for optimizer in ("adam", "sgd"):
        tcfg = variant_cfg("pillar_options")
        tcfg.OPTIMIZATION.OPTIMIZER = optimizer
        _, tmodel, opt = build_trainer(tcfg, dev, seed=0, n_points=ZOO_POINTS,
                                       total_steps=PILLAR_OPTIONS_STEPS)
        tmeta = tmodel.dataset_meta
        before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for s in range(PILLAR_OPTIONS_STEPS):
            b = synth_train_batch(PILLAR_OPTIONS_BATCH, ZOO_POINTS, s, dev,
                                  tmeta.point_cloud_range, tmeta.num_point_features)
            lr = opt.lr_fn(opt.state["count"])
            t_s = time.perf_counter()
            loss, _ = train_step(tmodel, opt, b)
            torch.cuda.synchronize()
            steps.append((lr, float(loss), time.perf_counter() - t_s))
        check(all(np.isfinite(l) for _, l, _ in steps), f"pillar_options {optimizer}: {steps}")
        for n, p in tmodel.named_parameters():
            check(not torch.equal(p, before[n]),
                  f"pillar_options {optimizer}: parameter {n} did not change")
        print(f"pillar_options training under {optimizer} (LR {tcfg.OPTIMIZATION.LR}, "
              f"DECAY_STEP_LIST {tcfg.OPTIMIZATION.DECAY_STEP_LIST} epochs of 1000 steps): "
              f"b{PILLAR_OPTIONS_BATCH}; (lr, loss, s) a step "
              f"{[(lr, round(l, 4), round(t, 3)) for lr, l, t in steps]} (the first with "
              f"cuDNN's first calls); {len(before)} parameters changed; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del tmodel, opt, before
        torch.cuda.empty_cache()

    n = PILLAR_OPTIONS_STEPS * PILLAR_OPTIONS_BATCH
    with open(kitti_root / "kitti_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)[:n]
    with open(kitti_root / f"kitti_infos_train_{n}.pkl", "wb") as f:
        pickle.dump(infos, f)
    sets = ["DATA_CONFIG.INFO_PATH.train", f"['kitti_infos_train_{n}.pkl']"]
    dcfg = variant_cfg("pillar_options")
    cfg_from_list(list(sets), dcfg)
    classes = list(dcfg.CLASS_NAMES)
    ds = KittiDataset(dcfg.DATA_CONFIG, classes, training=True, root_path=kitti_root)
    failing = []
    for i in range(len(ds)):
        seed_for_sample(ds, 0, 0, i)
        try:
            ds[i]
        except IndexError as e:
            failing.append(i)
            reason = str(e)
    t_d = time.perf_counter()
    argv = ["--variant", "pillar_options", "--data_root", str(kitti_root), "--workers", "0",
            "--device", str(dev), "--epochs", "1", "--batch", str(PILLAR_OPTIONS_BATCH),
            "--output_dir", str(kitti_root.parent / "pillar_options"), "--set", *sets]
    if failing:
        try:
            train.main(argv)
            raised = None
        except IndexError as e:
            raised = str(e)
        check(raised is not None and "boolean index did not match" in raised,
              f"pillar_options train --data_root: samples {failing} drop a gt box, yet the run "
              f"raised {raised!r}")
        print(f"pillar_options train --data_root (frustum dropout top and left on, "
              f"{len(ds)} frames at b{PILLAR_OPTIONS_BATCH}): samples {failing} of the epoch "
              f"drop a gt box, and the run fails on the first, as the JAX package does "
              f"(ROADMAP §C): {raised} ({time.perf_counter() - t_d:.1f} s)")
    else:
        _, epochs = train.main(argv)
        print(f"pillar_options train --data_root (frustum dropout top and left on): no sample "
              f"drops a gt box; {epochs_line(epochs)}")
    print(f"phase 83: {time.perf_counter() - t0:.1f} s")
    return nms_report


def _option_pass(label, run, want):
    """One recorded pass (`run()`, eval forward or training step) of a
    variant: its kernel calls and launches as `want`. Returns (the run's
    result, the calls, the launches, its ms)."""
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launches()
    rec = record_kernels(OPTION_KERNELS)
    t0 = time.perf_counter()
    try:
        result = run()
        torch.cuda.synchronize()
    finally:
        rec.restore()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(_kernels.LAUNCHES)
    calls = split_calls(rec.calls)
    check_variant_calls(label, calls, launches, want)
    return result, calls, launches, ms


def _hold_rcnn_branches(cfg, model, scan, mask, state):
    """pointrcnn_pool_last's RCNN stage on the card's RoIs of one scan
    (backbone, point head and proposal layer on the card), on the card
    against the CPU; then a PointRCNNHead of the same settings without an
    SA_CONFIG (pooling the RoI's points; seeded weights) the same way."""
    import torch

    from tsm_det_pointcloud_tpu_torch.models.roi_heads import roi_head_template as tmpl
    from tsm_det_pointcloud_tpu_torch.models.roi_heads.pointrcnn_head import PointRCNNHead
    from tsm_det_pointcloud_tpu_torch.utils.edict import EDict

    head = model.module_list[2]
    c_in = head.xyz_up.fc0.in_features - 5     # [canonical xyz, score, depth, features]
    with torch.no_grad():
        bd = _through(model, {"points": scan, "points_mask": mask, "batch_size": 1}, 2)
        rois, _, _, roi_valid = tmpl.proposal_layer(
            bd["batch_cls_preds"], bd["batch_box_preds"], head.model_cfg["NMS_CONFIG"]["TEST"],
            score_normalized=bool(bd.get("cls_preds_normalized", False)))
    cpu_bd = {k: bd[k].cpu() for k in ("point_coords", "point_features", "point_valid",
                                        "point_cls_scores")}
    cpu_head = PointRCNNHead(head.model_cfg, c_in, 1).eval()
    cpu_head.load_state_dict({k[len("module_list.2."):]: v for k, v in state.items()
                              if k.startswith("module_list.2.")}, strict=True)
    torch.manual_seed(0)
    bare_cpu = PointRCNNHead(EDict({k: v for k, v in head.model_cfg.items()
                                    if k != "SA_CONFIG"}), c_in, 1).eval()
    bare = PointRCNNHead(bare_cpu.model_cfg, c_in, 1).to(scan.device).eval()
    bare.load_state_dict(bare_cpu.state_dict(), strict=True)
    lines = []
    for label, card_head, host_head in (("the last SA level pooled", head.eval(), cpu_head),
                                        ("no SA_CONFIG", bare, bare_cpu)):
        with torch.no_grad():
            got = card_head.rcnn(bd, rois, roi_valid)
            want = host_head.rcnn(cpu_bd, rois.cpu(), roi_valid.cpu())
        worst = _hold_close(f"pointrcnn_pool_last RCNN stage, {label}",
                            {"cls": got[0], "reg": got[1]}, {"cls": want[0], "reg": want[1]})
        lines.append(f"{label} within {worst:.3g} x max(1, max|want|)")
    print(f"pointrcnn_pool_last: the RCNN stage on the {int(roi_valid.sum())} RoIs of a scan, "
          f"card against CPU: {'; '.join(lines)}")


def _teacher_layer_cost(model, pts, mask, batch_ms):
    """What the eval pays for the teacher layers past 0, which no eval output
    reads (the JAX jit drops them): the backbone's teacher run through its
    eval layers and through layer 0 alone, ms between CUDA events over 3
    calls each."""
    import torch

    from tsm_det_pointcloud_tpu_torch.ops import grouping

    bb = model.module_list[0]
    bd = {"points": pts, "points_mask": mask}
    with torch.no_grad():
        t = {n: cuda_time_ms(lambda: bb._run_layers("SA_CONFIG", bd, n,
                                                     cache=grouping.TileCache()), 3)
             for n in (1, bb.n_teacher - 1)}
    extra = t[bb.n_teacher - 1] - t[1]
    return (f"the teacher's eval layers 0-{bb.n_teacher - 2} {t[bb.n_teacher - 1]:.1f} ms, layer "
            f"0 alone {t[1]:.1f} ms: the later ones, which no eval output reads, cost "
            f"{extra:.1f} ms ({100 * extra / batch_ms:.1f}% of the counted batch)")


def option_variant_phases(dev):
    """Phases 84-85: `infer.variant_cfg` "teacher3" (fast_cpc.yaml with a
    third teacher SA layer) and "pointrcnn_pool_last" (pointrcnn.yaml's RoI
    head pooling its last SA level, no group-all layer) at full width on
    synthetic scans of OPTION_POINTS points: an eval batch and a training
    step at OPTION_BATCH, each with every K1-K5 call recorded, its calls and
    launches as OPTION_CALLS and each call held against its plain version;
    then one counted eval batch and (teacher3) one counted training step.
    teacher3: one scan on the card against the CPU (OPTION_HELD), and what
    teacher layer 1, which no eval output reads, costs a batch
    (`_teacher_layer_cost`). pointrcnn_pool_last: its RoI head's RCNN stage (pool, xyz_up, the
    SA stack, the last level's masked max, the FC stack) on the card's RoIs
    of one scan, on the card against the CPU, and so a head without an
    SA_CONFIG (pooling the RoI's points), seeded. Returns {"<name>[_train]":
    (the per-kernel report, the launch counts)}."""
    import torch

    from tsm_det_pointcloud_tpu_torch import infer
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    reports = {}
    for name, (want_eval, want_train) in OPTION_CALLS.items():
        t_v = time.perf_counter()
        eb, tb = OPTION_BATCH[name]
        cfg, model = infer.build_detector(None, dev, seed=0, n_points=OPTION_POINTS,
                                          variant=name)
        meta = model.dataset_meta
        pts = [torch.from_numpy(infer.synth_scans(meta, eb, OPTION_POINTS, seed=s)).to(dev)
               for s in range(2)]
        mask = torch.ones(pts[0].shape[:2], dtype=torch.bool, device=dev)
        torch.cuda.reset_peak_memory_stats()
        (out, pred), calls, launches, first_ms = _option_pass(
            f"{name} eval", lambda: infer.detect(model, pts[0], mask), want_eval)
        post_max = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
        check(all(bool(torch.isfinite(out[k]).all()) for k in ("batch_cls_preds",
                                                              "batch_box_preds"))
              and bool((pred["count"] <= post_max).all()), f"{name}: detections "
              f"{pred['count'].tolist()}")
        del out, pred
        reports[name] = (compare_recorded(calls, name), launches)
        del calls
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        out, pred = infer.detect(model, pts[1], mask)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t_e)
        extra = ""
        if name == "teacher3":
            extra = f"; {_teacher_layer_cost(model, pts[1], mask, ms)}"
        print(f"{name} eval: b{eb} x {OPTION_POINTS}; the first batch (its calls recorded) "
              f"{first_ms:.1f} ms, a counted batch {ms:.1f} ms = {1e3 * eb / ms:.3f} scans/s"
              f"{extra}; detections {pred['count'].tolist()}; launches a batch {want_eval}; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        if name == "teacher3":
            scan = pts[1][:1]
            with torch.no_grad():
                got = model({"points": scan, "points_mask": mask[:1], "batch_size": 1})
            cpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device="cpu").eval()
            cpu.load_state_dict(state, strict=True)
            with torch.no_grad():
                want = cpu({"points": scan.cpu(), "points_mask": mask[:1].cpu(),
                            "batch_size": 1})
            worst = _hold_close("teacher3 scan", got,
                                {k: want[k] for k in OPTION_HELD[name]})
            print(f"teacher3: a scan on the card against the CPU: "
                  f"{', '.join(OPTION_HELD[name])} within {worst:.3g} x max(1, max|want|)")
            del cpu, got, want
        else:
            _hold_rcnn_branches(cfg, model, pts[1][:1], mask[:1], state)
        del model, out, pred
        torch.cuda.empty_cache()
        t_eval = time.perf_counter() - t_v

        _, tmodel, opt = build_trainer(infer.variant_cfg(name), dev, seed=0,
                                       n_points=OPTION_POINTS, total_steps=2)
        tbs = [synth_train_batch(tb, OPTION_POINTS, s, dev, meta.point_cloud_range,
                                 meta.num_point_features) for s in range(2)]
        torch.cuda.reset_peak_memory_stats()
        (loss, _), calls, launches, first_ms = _option_pass(
            f"{name} training step", lambda: train_step(tmodel, opt, tbs[0]), want_train)
        check(bool(torch.isfinite(loss)), f"{name} training step loss {float(loss)}")
        reports[f"{name}_train"] = (compare_recorded(calls, f"{name} train"), launches)
        del calls
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        loss2, _ = train_step(tmodel, opt, tbs[1])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t_s)
        check(bool(torch.isfinite(loss2)), f"{name} counted step loss {float(loss2)}")
        print(f"{name} training: b{tb}; the first step (its calls recorded) {first_ms:.1f} ms, "
              f"loss {float(loss):.4f}; a counted step {ms:.1f} ms = {1e3 * tb / ms:.3f} "
              f"train scans/s, loss {float(loss2):.4f}; launches a step {want_train}; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del tmodel, opt, tbs
        torch.cuda.empty_cache()
        print(f"{name}: eval {t_eval:.1f} s, training {time.perf_counter() - t_v - t_eval:.1f} s")
    return reports


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

    def mark(phases):
        print(f"chip_smoke: phases {phases} done at {time.perf_counter() - t_start:.1f} s")

    mark("1-12")
    report_second, launches_second = second_phases(dev)
    report_strain, launches_strain = second_train_phases(dev)
    report_teval, launches_teval, report_ttrain, launches_ttrain = teacher_phases(dev)
    mark("13-21")
    (report_kdata, launches_kdata, report_kdtrain, launches_kdtrain, profile_kdata,
     kitti_root) = kitti_data_phases(dev)
    (report_wdata, launches_wdata, notes_wdata, report_wdtrain, launches_wdtrain,
     notes_wdtrain, profile_wdata, waymo_root) = waymo_data_phases(dev)
    mark("22-27")
    report_tdata, launches_tdata, report_tdtrain, launches_tdtrain = recipe_phases(
        dev, kitti_root)
    report_sdata, launches_sdata, report_sdtrain, launches_sdtrain = second_data_phases(
        dev, kitti_root)
    report_demo, launches_demo = demo_phases(dev, kitti_root)
    mark("28-30")
    report_dist, launches_dist, report_pax, launches_pax = multi_process_phases(
        dev, kitti_root, waymo_root)
    mark("31-34")
    zoo_golden_phase(dev)
    pointpillar_phases(dev)
    report_cp, launches_cp, report_cptrain, launches_cptrain = centerpoint_phases(dev)
    zoo_data = zoo_data_phases(dev, kitti_root)
    mark("35-38")
    two_stage_golden_phase(dev)
    two_stage = {}
    for which in TWO_STAGE:
        rep_e, lau_e, rep_t, lau_t = two_stage_phases(dev, which)
        two_stage[which] = (rep_e, lau_e)
        two_stage[f"{which}_train"] = (rep_t, lau_t)
    two_stage.update(two_stage_data_phases(dev, kitti_root))
    mark("40-43")
    pointrcnn_golden_phase(dev)
    rcnn_gt_roi_phase(dev)
    rep_e, lau_e, rep_t, lau_t = two_stage_phases(dev, "pointrcnn")
    two_stage["pointrcnn"] = (rep_e, lau_e)
    two_stage["pointrcnn_train"] = (rep_t, lau_t)
    two_stage.update(two_stage_data_phases(dev, kitti_root, POINTRCNN))
    pointrcnn_converter_phase(dev, kitti_root)
    mark("45-47")
    two_stage_golden_phase(dev, tuple(VOXEL_ROI))
    rcnn_gt_roi_phase(dev, tuple(VOXEL_ROI))
    for which in VOXEL_ROI:
        rep_e, lau_e, rep_t, lau_t = two_stage_phases(dev, which)
        two_stage[which] = (rep_e, lau_e)
        two_stage[f"{which}_train"] = (rep_t, lau_t)
    two_stage.update(two_stage_data_phases(dev, kitti_root, VOXEL_ROI))
    for which in VOXEL_ROI:
        pointrcnn_converter_phase(dev, kitti_root, which, VOXEL_ROI_UNPLACED)
    mark("49-51")
    two_stage_golden_phase(dev, tuple(PVRCNN_PP))
    for which in PVRCNN_PP:
        rep_e, lau_e, rep_t, lau_t = two_stage_phases(dev, which)
        two_stage[which] = (rep_e, lau_e)
        two_stage[f"{which}_train"] = (rep_t, lau_t)
    two_stage.update(two_stage_data_phases(dev, kitti_root, PVRCNN_PP))
    for which in PVRCNN_PP:
        pointrcnn_converter_phase(dev, kitti_root, which, VOXEL_ROI_UNPLACED)
    mark("53-55")
    center_golden_phase(dev, "centerpoint_nusc", tiny.centerpoint_nusc_model_cfg(),
                        tiny.CENTERPOINT_NUSC_META, tiny.centerpoint_nusc_state(),
                        tiny.CENTERPOINT_NUSC_FORWARD_PATH, 9)
    nusc = {}
    rep_e, lau_e, rep_t, lau_t = center_phases(dev, NUSC_CFG, NUSC_POINTS, NUSC_BATCH,
                                               NUSC_ITERS, NUSC_TRAIN_ITERS, "centerpoint_nusc")
    nusc["centerpoint_nusc"] = (rep_e, lau_e)
    nusc["centerpoint_nusc_train"] = (rep_t, lau_t)
    rep_e, lau_e, rep_t, lau_t = nusc_data_phases(dev, kitti_root.parent / "nuscenes")
    nusc["centerpoint_nusc_data"] = (rep_e, lau_e)
    nusc["centerpoint_nusc_data_train"] = (rep_t, lau_t)
    mark("57-59")
    center_golden_phase(dev, "centerpoint_lyft", tiny.centerpoint_lyft_model_cfg(),
                        tiny.CENTERPOINT_LYFT_META, tiny.centerpoint_lyft_state(),
                        tiny.CENTERPOINT_LYFT_FORWARD_PATH, 7)
    rep_e, lau_e, rep_t, lau_t = center_phases(dev, LYFT_CFG, LYFT_POINTS, LYFT_BATCH,
                                               LYFT_ITERS, LYFT_TRAIN_ITERS, "centerpoint_lyft")
    nusc["centerpoint_lyft"] = (rep_e, lau_e)
    nusc["centerpoint_lyft_train"] = (rep_t, lau_t)
    rep_e, lau_e, rep_t, lau_t = lyft_data_phases(dev, kitti_root.parent / "lyft")
    nusc["centerpoint_lyft_data"] = (rep_e, lau_e)
    nusc["centerpoint_lyft_data_train"] = (rep_t, lau_t)
    rep_e, lau_e, rep_t, lau_t = pandaset_data_phases(dev, kitti_root.parent / "pandaset")
    nusc["centerpoint_pandaset_data"] = (rep_e, lau_e)
    nusc["centerpoint_pandaset_data_train"] = (rep_t, lau_t)
    mark("61-64")
    caddn_golden_phase(dev)
    caddn_model, caddn_inputs = caddn_phases(dev)
    variant_phases(dev)
    mark("65-68")
    pvssda_golden_phase(dev)
    report_pvssda, launches_pvssda = pvssda_phases(dev)
    report_weighted, launches_weighted = weighted_fps_phase(dev)
    report_pvdata, launches_pvdata = pvssda_data_phase(dev, kitti_root)
    mark("70-74")
    two_stage_golden_phase(dev, tuple(DSASNET))
    for which in DSASNET:
        rep_e, lau_e, rep_t, lau_t = two_stage_phases(dev, which)
        two_stage[which] = (rep_e, lau_e)
        two_stage[f"{which}_train"] = (rep_t, lau_t)
    two_stage.update(dsasnet_variant_phases(dev))
    two_stage["dsasnet_data"] = dsasnet_data_phase(dev, kitti_root)
    mark("75-79")
    pp_multihead_phases(dev, kitti_root.parent / "nuscenes" / "root")
    report_nms_options = pillar_options_phases(dev, kitti_root)
    two_stage.update(option_variant_phases(dev))
    mark("81-85")
    take_device_times({"eval": report_eval, "train": report, "waymo": report_waymo,
                       "waymo train": report_wtrain, "second": report_second,
                       "second train": report_strain, "teacher eval": report_teval,
                       "teacher train": report_ttrain, "kitti data eval": report_kdata,
                       "kitti data train": report_kdtrain, "waymo data eval": report_wdata,
                       "waymo data train": report_wdtrain, "teacher data eval": report_tdata,
                       "teacher data train": report_tdtrain, "second data eval": report_sdata,
                       "second data train": report_sdtrain, "demo": report_demo,
                       "centerpoint": report_cp, "centerpoint train": report_cptrain,
                       **{k: rep for k, (rep, _) in zoo_data.items()},
                       **{k: rep for k, (rep, _) in two_stage.items()},
                       **{k: rep for k, (rep, _) in nusc.items()},
                       "pvssda": report_pvssda, "weighted fps": report_weighted,
                       "pvssda data eval": report_pvdata,
                       "pillar_options post-processing": report_nms_options})
    mark("the deferred device times")
    profile_kdata()
    profile_wdata()
    profiles = infer_profiles(PROFILES)
    mark("the data paths' and the configs' profiles (39, 44, 48, 52, 56, 60)")
    zoo_profiles(profiles)
    two_stage_profiles(dev, profiles)
    two_stage_profiles(dev, profiles, POINTRCNN)
    two_stage_profiles(dev, profiles, VOXEL_ROI)
    two_stage_profiles(dev, profiles, PVRCNN_PP)
    two_stage_profiles(dev, profiles, DSASNET)
    mark("the proposal NMS's device times (44, 48, 52, 56, 80)")
    nusc_profiles(dev, profiles)
    pvssda_profile(profiles)
    pp_multihead_profile(profiles)
    mark("the nuScenes, PVSSDA and cbgs_pp_multihead profiles (60, 74, 82)")
    caddn_profile(caddn_model, caddn_inputs)
    del caddn_model, caddn_inputs
    mark("the CaDDN profile (69)")
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
                                  ("demo", report_demo, launches_demo),
                                  ("dist_train", report_dist, launches_dist),
                                  ("point_axis", report_pax, launches_pax),
                                  ("centerpoint", report_cp, launches_cp),
                                  ("centerpoint_train", report_cptrain, launches_cptrain),
                                  *((k, rep, lau) for k, (rep, lau) in zoo_data.items()),
                                  *((k, rep, lau) for k, (rep, lau) in two_stage.items()),
                                  *((k, rep, lau) for k, (rep, lau) in nusc.items()),
                                  ("pvssda", report_pvssda, launches_pvssda),
                                  ("pvssda_data", report_pvdata, launches_pvdata),
                                  ("weighted_fps", report_weighted, launches_weighted))}
        if name in report:
            own, path = numbers(report[name], launches[name]), "kitti_train"
        elif waymo is not None:
            own, path = waymo, "waymo_eval"
        elif second is not None:
            own, path = second, "second_eval"
        elif name in report_pvssda:
            own, path = new_paths["pvssda"], "pvssda_eval"
        else:
            own, path = new_paths["weighted_fps"], "weighted_fps"
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
