"""A synthetic Waymo root of raw tfrecords, for runs where no Waymo data is
at hand (the smoke run, rehearsals):

    python -m tsm_det_pointcloud_tpu_torch.datasets.waymo.synthetic ROOT \\
        [--train 4] [--val 4] [--frames 4] [--seed 0] [--workers 1]

writes ROOT/raw_data/<sequence>.tfrecord (Frame messages in the public
waymo_open_dataset/dataset.proto wire format, encoded here: the port imports
no test code) and ROOT/ImageSets/{train,val}.txt, which
`waymo_dataset.create_waymo_infos` then preprocesses. A frame holds:

  * the TOP laser, 64 x 2650 pixels, two returns, explicit beam inclinations
    (-17.6 to +2.4 degrees), an extrinsic with a small yaw, and the
    per-pixel pose (the frame's pose at every pixel);
  * the four short-range lasers (FRONT, SIDE_LEFT, SIDE_RIGHT, REAR), 200 x
    600 pixels, two returns (the second empty), inclinations from min / max,
    returns up to 20 m on a tenth of their outward pixels;
  * five camera calibrations, the frame pose (the ego drives 1 m a frame),
    a timestamp;
  * labels: twelve vehicles, six pedestrians, four cyclists, a sign and an
    `unknown` a sequence, static in the world, each box's
    num_lidar_points_in_box its first-return hits, a fifth of them marked
    difficulty 2.

A scan is cast, not drawn: every pixel's ray meets the ground (z = 0), the
boxes, or a wall of radius 60 m around the ego, so every TOP pixel returns
and a frame holds about 195k points inside POINT_CLOUD_RANGE's xy square
(more than waymo_fast_cpc.yaml's 163840 test points: the test-mode
`sample_points` subsamples, as on a real Waymo frame of ~170k); a third of
the rays that hit a box return the background as their second return; the
ground 20-30 m behind the ego (|y| < 5 m) is a no-label zone.
"""
from __future__ import annotations

import argparse
import struct
import zlib
from pathlib import Path

import numpy as np

from .waymo_preprocess import write_tfrecord

TOP, FRONT, SIDE_LEFT, SIDE_RIGHT, REAR = 1, 2, 3, 4, 5
TOP_SHAPE, SHORT_SHAPE = (64, 2650), (200, 600)
WALL_R, WALL_TOP, SHORT_RANGE = 60.0, 8.0, 20.0
# the TOP laser's 64 beam inclinations (radians, bottom beam first), denser
# near the horizon
TOP_INCLINATIONS = np.radians(-17.6 + 20.0 * np.linspace(0, 1, 64) ** 0.7)
SHORT_INCLINATION = (-np.pi / 2, np.radians(30.0))
# laser -> (translation, yaw) of its extrinsic
EXTRINSICS = {TOP: ((1.43, 0.0, 2.184), -0.0105), FRONT: ((4.07, 0.0, 0.69), 0.0),
              SIDE_LEFT: ((3.25, 1.03, 0.98), np.pi / 2),
              SIDE_RIGHT: ((3.25, -1.03, 0.98), -np.pi / 2), REAR: ((-1.15, 0.0, 0.47), np.pi)}
# label type -> (count a sequence, (l, w, h))
OBJECTS = {1: (12, (4.5, 2.0, 1.6)), 2: (6, (0.8, 0.8, 1.75)), 4: (4, (1.8, 0.8, 1.7)),
           3: (1, (0.6, 0.1, 2.5)), 0: (1, (1.0, 1.0, 1.0))}
CAMERAS = ((1920, 1280), (1920, 1280), (1920, 1280), (1920, 886), (1920, 886))


# -- protobuf wire format (the field numbers of waymo_preprocess.decode_frame) --

def _varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _f_varint(num, v):
    return _varint(num << 3) + _varint(int(v))


def _f_double(num, v):
    return _varint(num << 3 | 1) + struct.pack("<d", float(v))


def _f_bytes(num, v):
    if isinstance(v, str):
        v = v.encode()
    return _varint(num << 3 | 2) + _varint(len(v)) + v


def _transform(num, mat):
    return _f_bytes(num, b"".join(_f_double(1, x) for x in np.asarray(mat).reshape(-1)))


def _matrix(data):
    """A zlib-compressed MatrixFloat {data = 1 packed, shape = 2 {dims = 1}}."""
    msg = _f_bytes(1, np.ascontiguousarray(data, "<f4").tobytes())
    msg += _f_bytes(2, _f_bytes(1, b"".join(_varint(d) for d in data.shape)))
    return zlib.compress(msg, 1)


def _pose(yaw, t):
    m = np.eye(4)
    m[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    m[:3, 3] = t
    return m


def encode_frame(context_name, timestamp, pose, range_images, top_pose, labels):
    """A Frame message. range_images: laser -> (return 1, return 2), each
    (H, W, 4) f32; top_pose (64, 2650, 6) f32; labels: dicts of box (cx, cy,
    cz, l, w, h, heading), type, id, difficulty, npts."""
    ctx = _f_bytes(1, context_name)
    for j, (w, h) in enumerate(CAMERAS):
        ctx += _f_bytes(2, _f_varint(1, j + 1) + _f_varint(4, w) + _f_varint(5, h))
    for laser, (t, yaw) in EXTRINSICS.items():
        cal = _f_varint(1, laser)
        if laser == TOP:
            cal += b"".join(_f_double(2, v) for v in TOP_INCLINATIONS)
            cal += _f_double(3, TOP_INCLINATIONS[0]) + _f_double(4, TOP_INCLINATIONS[-1])
        else:
            cal += _f_double(3, SHORT_INCLINATION[0]) + _f_double(4, SHORT_INCLINATION[1])
        ctx += _f_bytes(3, cal + _transform(5, _pose(yaw, t)))
    frame = _f_bytes(1, ctx) + _f_varint(2, timestamp) + _transform(3, pose)
    for laser, (ri1, ri2) in range_images.items():
        r1 = _f_bytes(2, _matrix(ri1))
        if laser == TOP:
            r1 += _f_bytes(4, _matrix(top_pose))
        frame += _f_bytes(5, _f_varint(1, laser) + _f_bytes(2, r1)
                          + _f_bytes(3, _f_bytes(2, _matrix(ri2))))
    for lab in labels:
        box = b"".join(_f_double(i + 1, v) for i, v in enumerate(lab["box"]))
        frame += _f_bytes(6, _f_bytes(1, box) + _f_varint(3, lab["type"])
                          + _f_bytes(4, lab["id"]) + _f_varint(5, lab["difficulty"])
                          + _f_varint(6, lab["difficulty"]) + _f_varint(7, lab["npts"]))
    return frame


# -- the scene -----------------------------------------------------------------

def _rays(laser):
    """Unit ray directions (H, W, 3) in the vehicle frame and the origin, by
    waymo_preprocess.range_image_to_points' azimuth and inclination rules."""
    t, yaw = EXTRINSICS[laser]
    H, W = TOP_SHAPE if laser == TOP else SHORT_SHAPE
    if laser == TOP:
        incl = TOP_INCLINATIONS[::-1]
    else:
        lo, hi = SHORT_INCLINATION
        incl = ((np.arange(H) + 0.5) / H * (hi - lo) + lo)[::-1]
    az = ((np.arange(W, 0, -1) - 0.5) / W * 2 - 1) * np.pi   # vehicle frame: yaw corrected
    d = np.stack([np.cos(az)[None] * np.cos(incl)[:, None],
                  np.sin(az)[None] * np.cos(incl)[:, None],
                  np.broadcast_to(np.sin(incl)[:, None], (H, W))], -1)
    # the sensor's own azimuth of each column, for the outward hemisphere
    sensor_az = np.broadcast_to(np.angle(np.exp(1j * (az - yaw)))[None], (H, W))
    return np.asarray(t, np.float64), d, sensor_az


def _cast(origin, d, boxes):
    """First hits of rays from `origin` along d (P, 3): distance t (P,) and
    what was hit (P,): box index, -1 ground, -2 wall, -3 nothing; and the
    background's distance behind each ray (P,)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(d[:, 2] < 0, -origin[2] / d[:, 2], np.inf)
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = 2 * (origin[0] * d[:, 0] + origin[1] * d[:, 1])
        c = origin[0] ** 2 + origin[1] ** 2 - WALL_R ** 2
        t_wall = (-b + np.sqrt(b * b - 4 * a * c)) / (2 * a)
        t_wall = np.where((a > 0) & (origin[2] + t_wall * d[:, 2] < WALL_TOP), t_wall, np.inf)
        t_back = np.minimum(t_ground, t_wall)
        t = t_back.copy()
        what = np.where(np.isinf(t_back), -3, np.where(t_ground <= t_wall, -1, -2))
        if len(boxes):
            # only rays that pass within a box's bounding sphere can hit it
            oc = boxes[:, :3] - origin
            proj = d @ oc.T                                          # (P, K)
            near_sphere = (proj > 0) & ((oc ** 2).sum(1) - proj ** 2
                                        < (boxes[:, 3:6] ** 2).sum(1) / 4)
        for k, (cx, cy, cz, l, w, h, ry) in enumerate(boxes):
            idx = np.nonzero(near_sphere[:, k])[0]
            cs, sn = np.cos(-ry), np.sin(-ry)
            o = origin - (cx, cy, cz)
            lo_ = np.array([o[0] * cs - o[1] * sn, o[0] * sn + o[1] * cs, o[2]])
            dk = d[idx]
            ld = np.stack([dk[:, 0] * cs - dk[:, 1] * sn, dk[:, 0] * sn + dk[:, 1] * cs,
                           dk[:, 2]], 1)
            half = np.array([l, w, h]) / 2
            t1 = (-half - lo_) / ld
            t2 = (half - lo_) / ld
            near = np.nanmax(np.minimum(t1, t2), 1)
            far = np.nanmin(np.maximum(t1, t2), 1)
            hit = (near <= far) & (near > 0) & (near < t[idx])
            t[idx[hit]] = near[hit]
            what[idx[hit]] = k
    return t, what, t_back


def _intensity(rng, what):
    return np.where(what >= 0, rng.uniform(0.3, 1.0, what.shape),
                    rng.uniform(0.02, 0.2, what.shape)).astype(np.float32)


def _range_images(laser, boxes, rng):
    """(return 1, return 2) of a laser: (H, W, 4) f32 [range, intensity,
    elongation, no-label zone], and the first-return hits a box."""
    origin, d, sensor_az = _rays(laser)
    H, W = d.shape[:2]
    t, what, t_back = (a.reshape(H, W) for a in _cast(origin, d.reshape(-1, 3), boxes))
    if laser == TOP:
        live = ~np.isinf(t)
        second = live & (what >= 0) & (rng.uniform(size=(H, W)) < 1 / 3) & ~np.isinf(t_back)
    else:
        live = ((np.abs(sensor_az) < np.pi / 2) & (t < SHORT_RANGE)
                & (rng.uniform(size=(H, W)) < 0.1))
        second = np.zeros((H, W), bool)
    ri = np.zeros((2, H, W, 4), np.float32)
    returns = ((live, t, what), (second, t_back, np.full_like(what, -1)))
    for r, (mask, dist, kind) in enumerate(returns):
        with np.errstate(invalid="ignore"):
            pts = origin + np.where(mask, dist, 0)[..., None] * d
        nlz = (pts[..., 0] > -30) & (pts[..., 0] < -20) & (np.abs(pts[..., 1]) < 5)
        ri[r, ..., 0] = np.where(mask, dist, 0)
        ri[r, ..., 1] = np.where(mask, _intensity(rng, kind), 0)
        ri[r, ..., 2] = np.where(mask, rng.uniform(0, 0.3, (H, W)), 0)
        ri[r, ..., 3] = np.where(mask, np.where(nlz, 1.0, -1.0), 0)
    hits = np.bincount(what[live & (what >= 0)], minlength=len(boxes))
    return (ri[0], ri[1]), hits


def _world_objects(rng, seq_id, radius):
    """The sequence's labelled objects in the world: (type, id, box (7,),
    difficulty), boxes on the ground, their centres `radius` (min, max) m
    from the ego's mid-sequence position, none overlapping in the plane (an
    object with no room after 200 tries is left out)."""
    out, placed = [], []
    for typ, (n, (l, w, h)) in OBJECTS.items():
        for k in range(n):
            for _ in range(200):
                r, a = rng.uniform(*radius), rng.uniform(-np.pi, np.pi)
                c = np.array([1.5 + r * np.cos(a), r * np.sin(a)])
                if all(np.hypot(*(c - p)) > q + max(l, w) / 2 + 0.5 for p, q in placed):
                    break
            else:
                continue
            placed.append((c, max(l, w) / 2))
            box = np.array([c[0], c[1], h / 2, l, w, h, rng.uniform(-np.pi, np.pi)])
            out.append((typ, f"{seq_id}_{typ}_{k}", box, 2 if rng.uniform() < 0.2 else 0))
    return out


def sequence_frames(seq_id, n_frames, seed, radius=(8.0, 45.0)):
    """The serialised Frame messages of one sequence (objects `radius` m
    from the ego)."""
    rng = np.random.RandomState(seed)
    objects = _world_objects(rng, seq_id, radius)
    frames = []
    for f in range(n_frames):
        yaw, t = 0.01 * f, np.array([1.0 * f, 0.02 * f, 0.0])
        pose = _pose(yaw, t)
        rinv = pose[:3, :3].T
        boxes = np.array([np.concatenate([rinv @ (b[:3] - t), b[3:6], [b[6] - yaw]])
                          for _, _, b, _ in objects])
        range_images, hits = {}, np.zeros(len(boxes), np.int64)
        for laser in EXTRINSICS:
            range_images[laser], h = _range_images(laser, boxes, rng)
            hits += h
        top_pose = np.zeros(TOP_SHAPE + (6,), np.float32)
        top_pose[..., 2] = yaw
        top_pose[..., 3:] = t
        labels = [{"box": box, "type": typ, "id": oid, "difficulty": diff, "npts": int(n)}
                  for (typ, oid, _, diff), box, n in zip(objects, boxes, hits)]
        frames.append(encode_frame(seq_id, 1_550_000_000_000_000 + 100_000 * f, pose,
                                   range_images, top_pose, labels))
    return frames


def _write_sequence(args):
    path, seq_id, n_frames, seed, radius = args
    write_tfrecord(path, sequence_frames(seq_id, n_frames, seed, radius))


def write_synthetic_waymo(root, n_train, n_val, n_frames, seed=0, workers=1,
                          radius=(8.0, 45.0)):
    """Write `n_train` + `n_val` sequences of `n_frames` frames under `root`,
    the labelled objects `radius` (min, max) m from the ego; returns the
    train and val sequence file names."""
    root = Path(root)
    (root / "raw_data").mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    names = [f"segment-{seed:04d}{i:06d}_with_camera_labels" for i in range(n_train + n_val)]
    files = [f"{n}.tfrecord" for n in names]
    (root / "ImageSets" / "train.txt").write_text("\n".join(files[:n_train]) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(files[n_train:]) + "\n")
    jobs = [(root / "raw_data" / f, n, n_frames, seed * 100003 + i, tuple(radius))
            for i, (f, n) in enumerate(zip(files, names))]
    if workers > 1:
        from .. import forkserver_context

        with forkserver_context().Pool(workers) as pool:
            pool.map(_write_sequence, jobs)
    else:
        for job in jobs:
            _write_sequence(job)
    return files[:n_train], files[n_train:]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--train", type=int, default=4, help="train sequences")
    ap.add_argument("--val", type=int, default=4, help="val sequences")
    ap.add_argument("--frames", type=int, default=4, help="frames a sequence")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args(argv)
    train, val = write_synthetic_waymo(args.root, args.train, args.val, args.frames, args.seed,
                                       args.workers)
    print(f"{args.root}: {len(train)} train and {len(val)} val sequences of {args.frames} "
          f"frames")


if __name__ == "__main__":
    main()
