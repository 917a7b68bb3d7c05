"""A synthetic nuScenes root in the devkit's on-disk layout, for runs where
no nuScenes data is at hand (the smoke run, rehearsals, the tests):

    python -m tsm_det_pointcloud_tpu_torch.datasets.nuscenes.synthetic ROOT \\
        [--version v1.0-trainval] [--train 3] [--val 2] [--samples 6] \\
        [--points 34720] [--seed 0]

writes ROOT/<version>/ (the dataroot): samples/LIDAR_TOP/*.pcd.bin (the
keyframes) and sweeps/LIDAR_TOP/*.pcd.bin (the sweeps between them), each
float32 rows of (x, y, z, intensity, ring) in the sensor's frame, and
<version>/ with the JSON tables (category, attribute, sensor,
calibrated_sensor, ego_pose, log, scene, sample, sample_data,
sample_annotation, instance) and splits.json (the scene names of each
split, which the devkit ships as code).

A scene is `samples` keyframes at 2 Hz, each after nine sweeps at 20 Hz
(the first keyframe too), so that every keyframe's info has nine sweeps.
The ego drives at 5 m/s on a slow left turn; the lidar sits 1.84 m up and
0.94 m ahead of the ego's origin, turned -90 degrees about z. Each scene
holds tracked instances of all ten detection classes (4 cars, 2 trucks, a
construction vehicle, a bus, a trailer, 3 barriers, a motorcycle, a
bicycle, 3 pedestrians and 3 traffic cones; barriers and cones stand, the
rest move along their heading at class-typical speeds), an animal (a
category the detection classes ignore), a car annotated at one keyframe
only (no velocity: its neighbours are missing) and a car that no lidar
point reaches (3 radar points, so its annotation stays in the infos). A
sweep holds `points` points: each visible instance's points inside its box
at the sweep's time (about 150 for a car at the full 34,720, at least 3),
the rest ground (z -1.84 in the sensor frame, out to 55 m) and clutter.
Annotations carry the keyframe's count of lidar points in each box.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ...ops.boxes import points_in_boxes_np

FULL_POINTS = 34720          # a 32-beam sweep of nuScenes' lidar
LIDAR_FROM_CAR_T = (0.943, 0.0, 1.84)
LIDAR_YAW = -np.pi / 2
EGO_SPEED, EGO_YAW_RATE = 5.0, 0.05
KEYFRAME_S, SWEEP_S, SWEEPS = 0.5, 0.05, 9

# category, wlh (m), speed (m/s), points a sweep at FULL_POINTS, instances a scene
CLASSES = (
    ("vehicle.car", (1.95, 4.6, 1.73), 6.0, 150, 4),
    ("vehicle.truck", (2.5, 6.9, 2.8), 5.0, 220, 2),
    ("vehicle.construction", (2.8, 6.4, 3.2), 1.0, 220, 1),
    ("vehicle.bus.rigid", (2.9, 11.0, 3.5), 5.0, 300, 1),
    ("vehicle.trailer", (2.9, 12.3, 3.9), 4.0, 300, 1),
    ("movable_object.barrier", (2.5, 0.5, 1.0), 0.0, 40, 3),
    ("vehicle.motorcycle", (0.77, 2.1, 1.47), 5.0, 50, 1),
    ("vehicle.bicycle", (0.6, 1.7, 1.3), 3.0, 40, 1),
    ("human.pedestrian.adult", (0.67, 0.73, 1.77), 1.3, 40, 3),
    ("movable_object.trafficcone", (0.4, 0.4, 1.07), 0.0, 15, 3),
    ("animal", (0.3, 0.8, 0.5), 1.0, 20, 1),
)


def _quat_yaw(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _ego_pose(t, x0, y0, h0):
    """(translation (3,), yaw) of the ego at t seconds into its scene."""
    h = h0 + EGO_YAW_RATE * t
    r = EGO_SPEED / EGO_YAW_RATE
    x = x0 + r * (np.sin(h) - np.sin(h0))
    y = y0 - r * (np.cos(h) - np.cos(h0))
    return np.array([x, y, 0.0]), h


def _to_lidar(p_global, ego_t, ego_yaw):
    """Global points (N, 3) -> the lidar's frame at that ego pose."""
    p_car = (p_global - ego_t) @ _rot(ego_yaw)
    return (p_car - np.asarray(LIDAR_FROM_CAR_T)) @ _rot(LIDAR_YAW)


def _to_global(p_lidar, ego_t, ego_yaw):
    p_car = p_lidar @ _rot(LIDAR_YAW).T + np.asarray(LIDAR_FROM_CAR_T)
    return p_car @ _rot(ego_yaw).T + ego_t


def _instances(rng, ego_t):
    """The scene's instances: dicts of category, wlh, start centre (global,
    z half the height), heading, velocity (2,), points a sweep at full
    scale, and its role (track / single / occluded)."""
    out = []
    for cat, wlh, speed, n_full, count in CLASSES:
        static = speed == 0.0
        for _ in range(count):
            out.append(dict(cat=cat, wlh=wlh, speed=speed, n_full=n_full, role="track",
                            static=static))
    car = CLASSES[0]
    out.append(dict(cat=car[0], wlh=car[1], speed=car[2], n_full=car[3], role="single",
                    static=False))
    out.append(dict(cat=car[0], wlh=car[1], speed=0.0, n_full=0, role="occluded",
                    static=True))
    placed = []
    for inst in out:
        near, far = (6.0, 22.0) if inst["static"] else (8.0, 30.0)
        while True:
            d, a = rng.uniform(near, far), rng.uniform(-np.pi, np.pi)
            xy = ego_t[:2] + d * np.array([np.cos(a), np.sin(a)])
            if all(np.hypot(*(xy - q)) > 7.0 for q in placed):
                break
        placed.append(xy)
        heading = rng.uniform(-np.pi, np.pi)
        speed = inst["speed"] * rng.uniform(0.5, 1.0)
        inst.update(start=np.array([xy[0], xy[1], inst["wlh"][2] / 2]), heading=heading,
                    velocity=speed * np.array([np.cos(heading), np.sin(heading)]))
    return out


def _box_at(inst, t):
    """The instance's global box (x, y, z, l, w, h, heading) at time t."""
    c = inst["start"] + np.array([*(inst["velocity"] * t), 0.0])
    w, l, h = inst["wlh"]
    return np.array([c[0], c[1], c[2], l, w, h, inst["heading"]])


def _sweep_points(rng, n_points, insts, t, ego_t, ego_yaw):
    """One sweep's (N, 5) float32 rows in the lidar frame at time t."""
    scale = n_points / FULL_POINTS
    parts = []
    for inst in insts:
        if inst["role"] == "occluded":
            continue
        n = max(3, int(round(inst["n_full"] * scale)))
        box = _box_at(inst, t)
        local = rng.uniform(-0.45, 0.45, (n, 3)) * box[3:6]
        parts.append(local @ _rot(box[6]).T + box[:3])
    obj = _to_lidar(np.concatenate(parts), ego_t, ego_yaw) if parts else np.zeros((0, 3))
    n_bg = max(n_points - len(obj), 0)
    n_ground = int(0.75 * n_bg)
    r = 55.0 * np.sqrt(rng.uniform(0.0, 1.0, n_ground))
    a = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(a), r * np.sin(a),
                       -LIDAR_FROM_CAR_T[2] + rng.normal(0.0, 0.03, n_ground)], 1)
    clutter = np.stack([rng.uniform(-55, 55, n_bg - n_ground), rng.uniform(-55, 55, n_bg - n_ground),
                        rng.uniform(-1.8, 2.5, n_bg - n_ground)], 1)
    background = np.concatenate([ground, clutter])
    hidden = [_box_at(inst, t) for inst in insts if inst["role"] == "occluded"]
    if hidden:   # no point reaches an occluded instance
        inside = points_in_boxes_np(_to_global(background, ego_t, ego_yaw), np.stack(hidden))
        background = background[inside < 0]
    xyz = np.concatenate([obj, background])
    rows = np.zeros((len(xyz), 5), np.float32)
    rows[:, :3] = xyz
    rows[:, 3] = rng.uniform(0, 100, len(xyz))
    rows[:, 4] = rng.integers(0, 32, len(xyz))
    return rows


def write_synthetic_nuscenes(root, n_train=3, n_val=2, n_samples=6, n_points=FULL_POINTS,
                             seed=0, version="v1.0-trainval"):
    """Write the root (see the module docstring); returns the (train, val)
    scene names."""
    dataroot = Path(root) / version
    tdir = dataroot / version
    for sub in (tdir, dataroot / "samples" / "LIDAR_TOP", dataroot / "sweeps" / "LIDAR_TOP"):
        sub.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    T = {k: [] for k in ("category", "attribute", "sensor", "calibrated_sensor", "ego_pose",
                         "log", "scene", "sample", "sample_data", "sample_annotation",
                         "instance")}
    for i, (cat, *_) in enumerate(CLASSES):
        T["category"].append({"token": f"cat{i}", "name": cat, "description": ""})
    cat_token = {c["name"]: c["token"] for c in T["category"]}
    T["sensor"].append({"token": "sensor_lidar", "channel": "LIDAR_TOP", "modality": "lidar"})
    T["calibrated_sensor"].append({
        "token": "cs_lidar", "sensor_token": "sensor_lidar",
        "translation": list(LIDAR_FROM_CAR_T), "rotation": _quat_yaw(LIDAR_YAW),
        "camera_intrinsic": []})
    T["log"].append({"token": "log0", "logfile": "synthetic", "vehicle": "synthetic",
                     "date_captured": "2018-08-01", "location": "synthetic"})
    names = [f"scene-{s + 1:04d}" for s in range(n_train + n_val)]
    for s, name in enumerate(names):
        _write_scene(T, rng, s, name, n_samples, n_points, dataroot, cat_token)
    for table, rows in T.items():
        (tdir / f"{table}.json").write_text(json.dumps(rows))
    (tdir / "splits.json").write_text(json.dumps({"train": names[:n_train],
                                                  "val": names[n_train:]}))
    return names[:n_train], names[n_train:]


def _write_scene(T, rng, s, name, n_samples, n_points, dataroot, cat_token):
    t0_us = 1_533_000_000_000_000 + s * 100_000_000
    x0, y0, h0 = rng.uniform(-500, 500), rng.uniform(-500, 500), rng.uniform(-np.pi, np.pi)
    start_t = SWEEPS * SWEEP_S     # the scene's first sweep is at t = 0
    insts = _instances(rng, _ego_pose(start_t, x0, y0, h0)[0])
    scene_tok, sample_toks = f"scene{s}", [f"sample{s}_{k}" for k in range(n_samples)]
    T["scene"].append({"token": scene_tok, "log_token": "log0", "nbr_samples": n_samples,
                       "first_sample_token": sample_toks[0],
                       "last_sample_token": sample_toks[-1], "name": name,
                       "description": "synthetic"})
    ann_of = {i: [] for i in range(len(insts))}
    sd_prev = ""
    for k, tok in enumerate(sample_toks):
        t_kf = start_t + k * KEYFRAME_S
        anns = []
        for j in range(SWEEPS, -1, -1):          # nine sweeps, then the keyframe
            t = t_kf - j * SWEEP_S
            t_us = t0_us + int(round(t * 1e6))
            ego_t, ego_yaw = _ego_pose(t, x0, y0, h0)
            sd_tok = f"sd{s}_{k}_{j}"
            T["ego_pose"].append({"token": f"ep{s}_{k}_{j}", "timestamp": t_us,
                                  "rotation": _quat_yaw(ego_yaw),
                                  "translation": [float(v) for v in ego_t]})
            rows = _sweep_points(rng, n_points, insts, t, ego_t, ego_yaw)
            rel = (f"{'samples' if j == 0 else 'sweeps'}/LIDAR_TOP/"
                   f"{name}__LIDAR_TOP__{t_us}.pcd.bin")
            rows.tofile(dataroot / rel)
            if sd_prev:
                T["sample_data"][-1]["next"] = sd_tok
            T["sample_data"].append({
                "token": sd_tok, "sample_token": tok, "ego_pose_token": f"ep{s}_{k}_{j}",
                "calibrated_sensor_token": "cs_lidar", "timestamp": t_us, "fileformat": "pcd",
                "is_key_frame": j == 0, "height": 0, "width": 0, "filename": rel,
                "prev": sd_prev, "next": ""})
            sd_prev = sd_tok
        keyframe_global = _to_global(rows[:, :3].astype(np.float64), ego_t, ego_yaw)
        for i, inst in enumerate(insts):
            if inst["role"] == "single" and k != n_samples // 2:
                continue
            box = _box_at(inst, t_kf)
            n_lidar = int((points_in_boxes_np(keyframe_global, box[None]) == 0).sum())
            ann_tok = f"ann{s}_{k}_{i}"
            anns.append(ann_tok)
            ann_of[i].append(ann_tok)
            T["sample_annotation"].append({
                "token": ann_tok, "sample_token": tok, "instance_token": f"inst{s}_{i}",
                "visibility_token": "4", "attribute_tokens": [],
                "translation": [float(v) for v in box[:3]], "size": list(inst["wlh"]),
                "rotation": _quat_yaw(box[6]), "num_lidar_pts": n_lidar,
                "num_radar_pts": 3 if inst["role"] == "occluded" else 0,
                "prev": "", "next": ""})
        T["sample"].append({"token": tok, "timestamp": t0_us + int(round(t_kf * 1e6)),
                            "prev": sample_toks[k - 1] if k else "",
                            "next": sample_toks[k + 1] if k + 1 < n_samples else "",
                            "scene_token": scene_tok, "data": {"LIDAR_TOP": sd_prev},
                            "anns": anns})
    by_tok = {a["token"]: a for a in T["sample_annotation"]}
    for i, inst in enumerate(insts):
        chain = ann_of[i]
        for a, b in zip(chain, chain[1:]):
            by_tok[a]["next"], by_tok[b]["prev"] = b, a
        T["instance"].append({"token": f"inst{s}_{i}", "category_token": cat_token[inst["cat"]],
                              "nbr_annotations": len(chain), "first_annotation_token": chain[0],
                              "last_annotation_token": chain[-1]})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--train", type=int, default=3)
    ap.add_argument("--val", type=int, default=2)
    ap.add_argument("--samples", type=int, default=6)
    ap.add_argument("--points", type=int, default=FULL_POINTS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    train, val = write_synthetic_nuscenes(args.root, args.train, args.val, args.samples,
                                          args.points, args.seed, args.version)
    print(f"{args.root}/{args.version}: {len(train)} train and {len(val)} val scenes of "
          f"{args.samples} keyframes, {args.points} points a sweep")


if __name__ == "__main__":
    main()
