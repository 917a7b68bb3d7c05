"""The rank side of the port's multi-process tests (test_torch_comm.py,
test_torch_dist_train.py, test_torch_dist_zoo.py, test_torch_point_sharding.py): numpy and torch
only, since the ranks are spawned processes and must not import JAX (the
tests compute the JAX references in their own process).

`run_ranks(fn, args, tmp)` spawns `world` processes on the CPU, each joining
a gloo group through `comm.init_distributed("pytorch", "cpu")` on
torchrun's environment variables, runs `fn(rank, world, *args)` there and
returns every rank's result (torch.save'd under `tmp`); a rank that fails
or outlives JOIN_TIMEOUT fails the test.
"""
import os
import socket
import time
from pathlib import Path

import numpy as np
import torch

JOIN_TIMEOUT = 120
OPTIM = {"OPTIMIZER": "adam_onecycle", "LR": 0.01, "WEIGHT_DECAY": 0.01,
         "MOMS": [0.95, 0.85], "PCT_START": 0.3, "DIV_FACTOR": 10,
         "GRAD_NORM_CLIP": 10}
TOTAL_STEPS = 10


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank, world, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def _entry(rank, world, port, fn, args, out):
    os.environ.update(rank_env(rank, world, port))
    torch.set_num_threads(1)
    from tsm_det_pointcloud_tpu_torch.parallel import comm

    comm.init_distributed("pytorch", "cpu")
    try:
        torch.save(fn(rank, world, *args), Path(out) / f"rank{rank}.pt")
    finally:
        comm.shutdown()


def run_ranks(fn, args, tmp, world=2):
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} rank(s) still running after {JOIN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
    return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# comm
# ---------------------------------------------------------------------------

def comm_case(rank, world, n_samples):
    """The host helpers and the model's two collectives on this rank's
    values; the merge on the rank-strided shard of n_samples."""
    from tsm_det_pointcloud_tpu_torch.datasets import EpochBatchSampler
    from tsm_det_pointcloud_tpu_torch.parallel import comm

    shard = EpochBatchSampler(n_samples, 2, num_shards=world, shard_id=rank).indices()
    parts = [{"frame_id": int(i), "rank": rank} for i in shard]
    d = {"b": 0.25 * rank - 1.0, "a": float(rank + 1), "c": 3.0}
    t = torch.tensor([rank + 1.0, 2.0], requires_grad=True)
    s = comm.global_sum(t * 3.0)
    (s * torch.tensor([1.0, 10.0])).sum().backward()
    empty = torch.zeros(5, dtype=torch.bool)
    one = empty.clone()
    one[3] = rank == 1
    return dict(
        gathered=comm.all_gather_object({"rank": rank, "x": list(range(rank + 1))}),
        mean=comm.all_reduce_mean(3.0 * rank + 1.0),
        avg=comm.reduce_dict(d), summed=comm.reduce_dict(d, average=False),
        parts=parts, merged=comm.merge_results_dist(parts, n_samples),
        global_sum=s.detach().numpy(), global_sum_grad=t.grad.numpy(),
        any_empty=bool(comm.global_any(empty)), any_one=bool(comm.global_any(one)),
        scaled=float(comm.scale_to_global(torch.tensor(1.5))),
        world=comm.get_world_size(), rank=comm.get_rank())


def shared_memory_case(rank, world, root, shm_dir):
    """A Waymo training set with USE_SHARED_MEMORY made on this rank: the
    cached frames every rank sees once the dataset is made, this rank's
    share of them, and what is left after both ranks cleaned."""
    os.environ["TSM_SHM_DIR"] = shm_dir
    from tests.torch_waymo_cases import CLASSES, WAYMO_CPC, dataset_cfg
    from tsm_det_pointcloud_tpu_torch.datasets.waymo.waymo_dataset import WaymoDataset
    from tsm_det_pointcloud_tpu_torch.parallel import comm

    cfg = dataset_cfg(WAYMO_CPC, root)
    cfg.USE_SHARED_MEMORY = True
    ds = WaymoDataset(cfg, CLASSES, training=True, root_path=root)
    seen = sorted(os.listdir(shm_dir))
    mine = [key for key, _ in ds._shared_frames()]
    comm.barrier()
    ds.clean_shared_memory()
    comm.barrier()
    return dict(seen=seen, mine=mine, left=sorted(os.listdir(shm_dir)),
                keys=[f"{i['point_cloud']['lidar_sequence']}___{i['point_cloud']['sample_idx']}"
                      for i in ds.infos])


# ---------------------------------------------------------------------------
# data-parallel training steps
# ---------------------------------------------------------------------------

def tsm_state():
    """The tiny TSM's committed training init with tiny.train_statistics as
    its class statistics (the state test_torch_tsm_train.py starts from)."""
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables

    flax = to_flax_variables(tiny.load_state())
    flax["statistics"] = {"module_list_1": tiny.train_statistics()}
    return from_flax_variables(flax)


def tsm_batch(n_scans, which="wide", empty=()):
    """The tiny TSM training batch of n_scans (tiny.synth_points, the
    `which` gt boxes), the scans in `empty` with every point masked."""
    from tsm_det_pointcloud_tpu_torch import tiny

    gt, gmask = tiny.synth_gt(n_scans, which)
    mask = np.ones((n_scans, 256), bool)
    mask[list(empty)] = False
    return {"points": tiny.synth_points(n_scans), "points_mask": mask, "gt_boxes": gt,
            "gt_boxes_mask": gmask, "batch_size": n_scans}


def second_batch(n_scans):
    from tsm_det_pointcloud_tpu_torch import tiny

    gt, gmask = tiny.second_gt(n_scans, "anchored")
    return {"points": tiny.second_points(n_scans), "points_mask": np.ones((n_scans, 512), bool),
            "gt_boxes": gt, "gt_boxes_mask": gmask, "batch_size": n_scans}


def pointpillar_batch(n_scans):
    from tsm_det_pointcloud_tpu_torch import tiny

    gt, gmask = tiny.pointpillar_gt(n_scans)
    return {"points": tiny.second_points(n_scans), "points_mask": np.ones((n_scans, 512), bool),
            "gt_boxes": gt, "gt_boxes_mask": gmask, "batch_size": n_scans}


def centerpoint_batch(n_scans):
    from tsm_det_pointcloud_tpu_torch import tiny

    gt, gmask = tiny.centerpoint_gt(n_scans)
    return {"points": tiny.second_points(n_scans), "points_mask": np.ones((n_scans, 512), bool),
            "gt_boxes": gt, "gt_boxes_mask": gmask, "batch_size": n_scans}


def parta2_batch(n_scans, which="parta2"):
    """The tiny Part-A2's training batch (tiny.second_points at 256 points,
    tiny.two_stage_gt's scans in turn: a full RoI sample and an empty one),
    or the tiny PointRCNN's, SECONDNetIoU's or PV-RCNN++'s (`which`)."""
    from tsm_det_pointcloud_tpu_torch import tiny

    gt, gmask = tiny.two_stage_gt(which, n_scans)
    return {"points": tiny.second_points(n_scans, 256),
            "points_mask": np.ones((n_scans, 256), bool), "gt_boxes": gt,
            "gt_boxes_mask": gmask, "batch_size": n_scans}


def local_batch(batch, rank, world):
    """This rank's contiguous share of a numpy batch, as torch tensors (the
    JAX shard_batch's P("data") placement)."""
    b = batch["batch_size"] // world
    out = {k: torch.from_numpy(np.array(v[rank * b:(rank + 1) * b]))
           for k, v in batch.items() if k != "batch_size"}
    out["batch_size"] = b
    return out


def teacher_state():
    """The tiny teacher's committed training init with tiny.teacher_overrides
    (the state test_torch_teacher.py's training checks start from)."""
    from tsm_det_pointcloud_tpu_torch import tiny

    state = tiny.load_state(tiny.TEACHER_STATE_PATH)
    state.update({k: torch.from_numpy(v) for k, v in tiny.teacher_overrides().items()})
    return state


# the tiny SECONDNetIoU's proposal NMS in the data-parallel step: up to 64
# RoIs a scan at IoU 0.1 keeps 27, 26 | 27, 25 on the two ranks' scans (at
# its own 16 every scan fills all 16), so that the IoU loss's normaliser, the
# valid RoIs, differs between the ranks and the global one shows
SECONDNETIOU_TRAIN_NMS = {"NMS_THRESH": 0.1, "NMS_POST_MAXSIZE": 64}


def _model(which):
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.models import build_network

    if which == "second":
        model = build_network(tiny.second_model_cfg(), 1, tiny.SECOND_META, device="cpu")
        model.load_state_dict(tiny.load_state(tiny.SECOND_STATE_PATH), strict=True)
    elif which == "pointpillar":
        model = build_network(tiny.pointpillar_model_cfg(), 1, tiny.POINTPILLAR_META,
                              device="cpu")
        model.load_state_dict(tiny.load_state(tiny.POINTPILLAR_STATE_PATH), strict=True)
    elif which == "centerpoint":
        model = build_network(tiny.centerpoint_model_cfg(), 3, tiny.CENTERPOINT_META,
                              device="cpu")
        model.load_state_dict(tiny.load_state(tiny.CENTERPOINT_STATE_PATH), strict=True)
    elif which in ("parta2", "pointrcnn", "secondnetiou", "pvrcnnplusplus"):
        cfg, meta = tiny.two_stage_model(which)
        if which == "secondnetiou":
            cfg.ROI_HEAD.NMS_CONFIG.TRAIN.update(SECONDNETIOU_TRAIN_NMS)
        model = build_network(cfg, 1, meta, device="cpu")
        model.load_state_dict(tiny.two_stage_state(which, train=True), strict=True)
    elif which == "teacher":
        model = build_network(tiny.tiny_teacher_model_cfg(), 3, tiny.META, device="cpu")
        model.load_state_dict(teacher_state(), strict=True)
    else:
        model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
        model.load_state_dict(tsm_state(), strict=True)
    return model


def dist_step_case(rank, world, which, batch, point_axis=0):
    """One DDP training step of the tiny TSM ("tsm"), its teacher
    ("teacher": every parameter trains, the class statistics update),
    SECOND ("second"), PointPillars ("pointpillar"), CenterPoint
    ("centerpoint"), Part-A2 ("parta2"), PointRCNN ("pointrcnn"), PV-RCNN++
    ("pvrcnnplusplus") or SECONDNetIoU ("secondnetiou", its proposal NMS at
    SECONDNETIOU_TRAIN_NMS)
    on this rank's share of `batch` (under point_axis P, P ranks share a
    sample set and split its points). Returns this rank's loss and tb terms,
    the reduced gradients, the buffers after the forward, the parameters
    after the optimizer step and the names of the tensors whose bits differ
    across the ranks after it."""
    from contextlib import nullcontext

    from tsm_det_pointcloud_tpu_torch.parallel import point_sharding
    from tsm_det_pointcloud_tpu_torch.parallel.train_state import (replica_mismatches,
                                                                   wrap_data_parallel)
    from tsm_det_pointcloud_tpu_torch.runtime.optimization import build_optimizer
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import freeze_teacher, train_step

    model = _model(which)
    params = freeze_teacher(model) if which == "tsm" else list(model.parameters())
    opt = build_optimizer(OPTIM, params, TOTAL_STEPS)
    shard, n_shards = rank, world
    psh = None
    if point_axis > 1:
        psh = point_sharding.make_point_mesh(point_axis)
        shard, n_shards = psh.data_index, psh.n_data
    local = local_batch(batch, shard, n_shards)
    if psh is not None:
        local = point_sharding.shard_batch(local, psh)
    ddp = wrap_data_parallel(model, torch.device("cpu"))
    grads, step = {}, opt.step

    def reduced_then_step():   # DDP has reduced the gradients by now
        grads.update({n: p.grad.numpy().copy() for n, p in model.named_parameters()
                      if p.grad is not None})
        return step()

    opt.step = reduced_then_step
    with point_sharding.activate(psh) if psh is not None else nullcontext():
        loss, tb = train_step(ddp, opt, local)
    params_after = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    names = {n for n, _ in model.named_parameters()}
    buffers = {k: v.numpy().copy() for k, v in model.state_dict().items() if k not in names}
    return dict(loss=float(loss), tb={k: float(v) for k, v in tb.items()}, grads=grads,
                buffers=buffers, params=params_after, mismatches=replica_mismatches(ddp))


def dist_steps_case(rank, world, cases, point_axis=0):
    """dist_step_case of each (which, batch) of `cases`, in turn."""
    return [dist_step_case(rank, world, which, batch, point_axis) for which, batch in cases]


# ---------------------------------------------------------------------------
# point-axis sharding
# ---------------------------------------------------------------------------

def point_primitives_case(rank, world, xyz, feats, valid, npoint, scales, vox):
    """The four primitives at D = world on this rank's segments of the
    clouds; returns what each gives and what its single-process plain
    counterpart gives on the whole cloud."""
    from tsm_det_pointcloud_tpu_torch.ops import grouping
    from tsm_det_pointcloud_tpu_torch.parallel import point_sharding as ps

    ctx = ps.make_point_mesh(world)
    xyz, feats, valid = (torch.from_numpy(a) for a in (xyz, feats, valid))
    xl, fl, vl = (ps.local_segment(t, ctx) for t in (xyz, feats, valid))
    fps = ps.segment_local_fps(xl, npoint, ctx, vl)
    fps_nomask = ps.segment_local_fps(xl, npoint, ctx)
    rows = ps.gather_from_sharded(torch.cat([xl, fl], -1), fps, ctx)
    groups = ps.sharded_ball_group_multi(scales, xl, fl, vl, rows[..., :3], ctx)
    full = grouping.query_group(xyz, valid, rows[..., :3], scales,
                                payload=torch.cat([xyz, feats], -1))
    coords, vfeat, vvalid, capacity, grid = vox
    coords, vfeat, vvalid = (torch.from_numpy(a) for a in (coords, vfeat, vvalid))
    cent = ps.sharded_voxel_centroids(*(ps.local_segment(t, ctx)
                                        for t in (coords, vfeat, vvalid)),
                                      capacity, grid, ctx)
    return dict(
        fps=fps.numpy(), fps_nomask=fps_nomask.numpy(),
        fps_plain=ps.segment_local_fps_plain(xyz, npoint, world, valid).numpy(),
        fps_plain_nomask=ps.segment_local_fps_plain(xyz, npoint, world).numpy(),
        rows=rows.numpy(),
        groups=[(c.numpy(), g.numpy()) for c, g in groups],
        full=[(c.numpy(), g.numpy()) for _, c, g in full],
        centroids={k: v.numpy() for k, v in cent.items()})


def point_forward_case(rank, world, batch):
    """The tiny TSM's eval forward and post-processing at point axis
    `world` on the whole `batch` (every rank the same samples)."""
    from tsm_det_pointcloud_tpu_torch.parallel import point_sharding as ps

    model = _model("tsm").eval()
    ctx = ps.make_point_mesh(world)
    local = ps.shard_batch(local_batch(batch, 0, 1), ctx)
    with ps.activate(ctx), torch.no_grad():
        out = model(local)
        pred, _ = model.post_processing(out)
    keys = ("batch_cls_preds", "batch_box_preds", "point_coords", "s_point_coords")
    return dict(out={k: out[k].numpy() for k in keys if k in out},
                pred={k: v.numpy() for k, v in pred.items()})
