"""A synthetic PandaSet root in the dataset's on-disk layout, for runs where
no PandaSet data is at hand (the smoke run, rehearsals, the tests):

    python -m tsm_det_pointcloud_tpu_torch.datasets.pandaset.synthetic ROOT \\
        [--sequences 001 002 ...] [--frames 3] [--points 115200] [--seed 0]

writes ROOT/dataset/<seq>/lidar/{NN.pkl.gz, poses.json} and
ROOT/dataset/<seq>/annotations/cuboids/NN.pkl.gz for each sequence: a
frame is a pandas DataFrame of world-frame points (x, y, z, i in [0, 255),
t the timestamp, d the lidar: 0 the 360-degree Pandar64, 1 the forward
PandarGT), the cuboids a DataFrame of the world-frame boxes (uuid, label,
yaw, stationary, position.x/y/z, dimensions.x/y/z with y the length,
cuboids.sensor_id: -1 seen by both lidars, 0 or 1 by one), both pickled with
gzip as the dataset releases them (pandas is imported where they are
written). `poses.json` holds each frame's lidar pose (position, heading
quaternion w, x, y, z) in the world frame.

A sequence is `frames` frames at 10 Hz of an ego driving at 10 m/s on a
slow turn, its world position hundreds of metres from the origin with a
heading of a non-trivial yaw (and no pitch: the loader's yaw mapping
assumes it negligible). Its objects stand or move in the world: cars,
pickup trucks, pedestrians (with and without an object), bicycles and
motorcycles, which the config maps onto KITTI's three classes, and a bus, a
semi-truck and cones, which it drops; two of the cars are seen only by the
forward lidar (sensor_id 1). A frame holds `points` Pandar64 points (single
return: 64 beams x 1800 azimuths = 115,200 at 10 Hz, the sensor's 1.152 M
points/s), each object's points inside its box, the rest ground out to 100 m
and clutter, and a quarter as many PandarGT points ahead of the ego. Every
box is written in the frame the loader maps it out of, so each object's
points lie inside its box in the normative ego frame.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..nuscenes.synthetic import _rot
from .pandaset_dataset import ego_to_lidar_points, lidar_points_to_ego

FULL_POINTS = 115200
FRAME_S, EGO_SPEED, EGO_YAW_RATE, LIDAR_Z = 0.1, 10.0, 0.05, 1.8
# label, (width, length, height) m, speed m/s, points a frame at FULL_POINTS,
# objects a sequence
OBJECTS = (
    ("Car", (1.9, 4.6, 1.6), 8.0, 220, 8),
    ("Pickup Truck", (2.0, 5.4, 1.9), 6.0, 240, 2),
    ("Pedestrian", (0.7, 0.7, 1.75), 1.2, 50, 5),
    ("Pedestrian with Object", (0.8, 0.9, 1.75), 1.0, 50, 2),
    ("Bicycle", (0.6, 1.8, 1.5), 4.0, 40, 3),
    ("Motorcycle", (0.9, 2.2, 1.5), 7.0, 50, 2),
    ("Bus", (2.9, 12.0, 3.4), 5.0, 350, 1),
    ("Semi-truck", (2.6, 16.0, 3.8), 5.0, 400, 1),
    ("Cones", (0.4, 0.4, 0.8), 0.0, 12, 3),
)
FORWARD_ONLY = 2   # cars seen by the forward lidar alone


def _pose(t, x0, y0, h0):
    """The lidar pose at t: its world position and the heading quaternion
    (w, x, y, z) that turns the PandaSet ego frame (x right, y forward) into
    the world's: a turn about z by the driving direction less 90 degrees."""
    h = h0 + EGO_YAW_RATE * t
    r = EGO_SPEED / EGO_YAW_RATE
    pos = (x0 + r * (np.sin(h) - np.sin(h0)), y0 - r * (np.cos(h) - np.cos(h0)), LIDAR_Z)
    a = h - np.pi / 2
    return {"position": {"x": float(pos[0]), "y": float(pos[1]), "z": float(pos[2])},
            "heading": {"w": float(np.cos(a / 2)), "x": 0.0, "y": 0.0, "z": float(np.sin(a / 2))}}


def _zrot(pose):
    """The loader's world -> ego z rotation of this pose."""
    y = lidar_points_to_ego(np.array([[0.0, 0, 0], [0, 1.0, 0]]), pose)
    y = y[1] - y[0]
    return float(np.arctan2(-y[0], y[1]))


def _objects(rng, pos, h0):
    """The sequence's objects: label, (w, l, h), start centre (world, z at
    half the height), yaw, velocity (2,) along the box's length, points a
    frame at full scale and sensor id; placed ahead of or beside the ego's
    start, at least 8 m apart."""
    out, placed = [], []
    forward = np.array([np.cos(h0), np.sin(h0)])
    for label, wlh, speed, n_full, count in OBJECTS:
        for c in range(count):
            while True:
                d, a = rng.uniform(8.0, 45.0), h0 + rng.uniform(-1.2, 1.2)
                if label == "Car" and c < FORWARD_ONLY:   # ahead, inside the PandarGT's cone
                    d, a = rng.uniform(12.0, 40.0), h0 + rng.uniform(-0.3, 0.3)
                xy = pos[:2] + d * np.array([np.cos(a), np.sin(a)]) + 10.0 * forward
                if all(np.hypot(*(xy - q)) > 8.0 for q in placed):
                    break
            placed.append(xy)
            heading = rng.uniform(-np.pi, np.pi)
            v = speed * rng.uniform(0.5, 1.0)
            along = heading + np.pi / 2   # the world direction of the box's length
            out.append(dict(label=label, wlh=wlh, n_full=n_full, heading=heading,
                            start=np.array([xy[0], xy[1], wlh[2] / 2]),
                            velocity=v * np.array([np.cos(along), np.sin(along)]),
                            sensor=1 if label == "Car" and c < FORWARD_ONLY else -1))
    return out


def _normative_box(obj, t, pose, zrot):
    """The object's box (x, y, z, dx, dy, dz, yaw) in the normative ego frame
    at t, as the loader maps its cuboid, and its world centre."""
    c = obj["start"] + np.array([*(obj["velocity"] * t), 0.0])
    e = lidar_points_to_ego(c[None], pose)[0]
    w, l, h = obj["wlh"]
    return np.array([e[1], -e[0], e[2], l, w, h, obj["heading"] + zrot]), c


def _to_world(normative, pose):
    """Normative ego points (N, 3) -> world: the loader's mapping undone."""
    ego = np.stack([-normative[:, 1], normative[:, 0], normative[:, 2]], axis=1)
    return ego_to_lidar_points(ego, pose)


def _frame(rng, n_points, objs, t, pose):
    """One frame's points (world (N, 3), intensity, lidar id) and cuboid rows."""
    zrot = _zrot(pose)
    scale = n_points / FULL_POINTS
    parts, rows = [], []
    for i, obj in enumerate(objs):
        box, centre = _normative_box(obj, t, pose, zrot)
        n = max(3, int(round(obj["n_full"] * scale)))
        local = rng.uniform(-0.45, 0.45, (n, 3)) * box[3:6]
        parts.append((local @ _rot(box[6]).T + box[:3], 1 if obj["sensor"] == 1 else 0))
        rows.append({"uuid": f"obj{i}", "label": obj["label"], "yaw": float(obj["heading"]),
                     "stationary": bool(np.all(obj["velocity"] == 0)),
                     "position.x": centre[0], "position.y": centre[1], "position.z": centre[2],
                     "dimensions.x": obj["wlh"][0], "dimensions.y": obj["wlh"][1],
                     "dimensions.z": obj["wlh"][2], "cuboids.sensor_id": obj["sensor"]})
    n_obj = sum(len(p) for p, d in parts if d == 0)
    n_bg = max(n_points - n_obj, 0)
    n_ground = int(0.7 * n_bg)
    r = 100.0 * np.sqrt(rng.uniform(0.0, 1.0, n_ground))
    a = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(a), r * np.sin(a),
                       -LIDAR_Z + rng.normal(0.0, 0.03, n_ground)], 1)
    n_clutter = n_bg - n_ground
    clutter = np.stack([rng.uniform(-80, 80, n_clutter), rng.uniform(-60, 60, n_clutter),
                        rng.uniform(-1.8, 3.0, n_clutter)], 1)
    n_gt = n_points // 4   # the forward PandarGT: ahead of the ego, within +-0.35 rad
    ra, aa = rng.uniform(3.0, 90.0, n_gt), rng.uniform(-0.35, 0.35, n_gt)
    forward = np.stack([ra * np.cos(aa), ra * np.sin(aa), rng.uniform(-1.8, 1.0, n_gt)], 1)
    chunks = [(p, d) for p, d in parts] + [(ground, 0), (clutter, 0), (forward, 1)]
    normative = np.concatenate([p for p, _ in chunks])
    device = np.concatenate([np.full(len(p), d, np.int64) for p, d in chunks])
    return _to_world(normative, pose), rng.uniform(0, 255, len(device)), device, rows


def write_synthetic_pandaset(root, sequences=("001", "002"), n_frames=3, n_points=FULL_POINTS,
                             seed=0):
    """Write the root (see the module docstring); returns the sequences."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    for s, seq in enumerate(sequences):
        lidar_dir = Path(root) / "dataset" / seq / "lidar"
        cub_dir = Path(root) / "dataset" / seq / "annotations" / "cuboids"
        lidar_dir.mkdir(parents=True, exist_ok=True)
        cub_dir.mkdir(parents=True, exist_ok=True)
        x0, y0 = rng.uniform(200, 800), rng.uniform(-800, -200)
        h0 = rng.uniform(-np.pi, np.pi)
        objs = _objects(rng, np.array([x0, y0]), h0)
        poses = []
        for k in range(n_frames):
            t = k * FRAME_S
            pose = _pose(t, x0, y0, h0)
            poses.append(pose)
            world, intensity, device, rows = _frame(rng, n_points, objs, t, pose)
            gz = {"method": "gzip", "compresslevel": 1}
            pd.DataFrame({"x": world[:, 0], "y": world[:, 1], "z": world[:, 2], "i": intensity,
                          "t": np.full(len(device), 1.5e9 + s * 100 + t), "d": device}
                         ).to_pickle(lidar_dir / f"{k:02d}.pkl.gz", compression=gz)
            pd.DataFrame(rows).to_pickle(cub_dir / f"{k:02d}.pkl.gz", compression=gz)
        (lidar_dir / "poses.json").write_text(json.dumps(poses))
    return list(sequences)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--sequences", nargs="+", default=["001", "002"])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--points", type=int, default=FULL_POINTS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    seqs = write_synthetic_pandaset(args.root, args.sequences, args.frames, args.points,
                                    args.seed)
    print(f"{args.root}: sequences {' '.join(seqs)} of {args.frames} frames, {args.points} "
          f"Pandar64 points a frame")


if __name__ == "__main__":
    main()
