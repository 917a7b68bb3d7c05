"""A synthetic Lyft Level 5 root in the dataset's on-disk layout, for runs
where no Lyft data is at hand (the smoke run, rehearsals, the tests):

    python -m tsm_det_pointcloud_tpu_torch.datasets.lyft.synthetic ROOT \\
        [--train 2] [--val 2] [--samples 4] [--points 65000] [--seed 0]

writes ROOT (the dataset's DATA_PATH): data/ with the JSON tables (category,
attribute, sensor, calibrated_sensor, ego_pose, log, scene, sample,
sample_data, sample_annotation, instance) and lidar/*.bin, each a sweep of
float32 rows (x, y, z, intensity, ring) in the sensor's frame; and beside
ROOT, ROOT/../ImageSets/{train,val}.txt, the scene names of each split,
where `create_lyft_info` reads them.

A scene is a stream of sweeps at 10 Hz: nine lead-in sweeps, then
`samples` key frames at 5 Hz (a sweep between two key frames), so that every
key frame's info holds nine sweeps of which a 5-sweep config draws four. The
ego drives at 8 m/s on a slow left turn, far from the world origin; the
lidar sits 1.8 m up and 1.2 m ahead of the ego's origin, turned 0.1 rad
about z. Each scene holds tracked instances of all nine Lyft classes, at
class-typical sizes (10 cars, 6 trucks, a bus, an emergency vehicle, 2 other
vehicles, 3 motorcycles, 3 bicycles, 6 pedestrians and an animal: enough
that 2 val scenes of 4 key frames give each class the pseudo-KITTI eval maps
41 gt boxes or more); the animal and the pedestrians stand, the rest move
along their heading. A sweep holds `points` points: each instance's points
inside its box at the sweep's time (about 160 for a car at the full 65,000,
at least 3), the rest ground (z -1.8 in the sensor frame, out to 90 m, some
of it beyond the ±80 m range) and clutter. 65,000 points a sweep is the
order of Lyft's roof lidar; the figure is this writer's, not a measured one.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..nuscenes.synthetic import _quat_yaw, _rot

FULL_POINTS = 65000
LIDAR_FROM_CAR_T = (1.2, 0.0, 1.8)
LIDAR_YAW = 0.1
EGO_SPEED, EGO_YAW_RATE = 8.0, 0.04
SWEEP_S, LEAD_IN, SWEEPS_PER_KEYFRAME = 0.1, 9, 2

# category, wlh (m), speed (m/s), points a sweep at FULL_POINTS, instances a scene
CLASSES = (
    ("car", (1.93, 4.76, 1.72), 7.0, 160, 10),
    ("truck", (2.84, 10.24, 3.44), 5.0, 300, 6),
    ("bus", (2.96, 12.34, 3.44), 5.0, 320, 1),
    ("emergency_vehicle", (2.45, 6.52, 2.39), 6.0, 200, 1),
    ("other_vehicle", (2.79, 8.20, 3.23), 4.0, 240, 2),
    ("motorcycle", (0.96, 2.35, 1.59), 6.0, 50, 3),
    ("bicycle", (0.63, 1.76, 1.44), 3.0, 40, 3),
    ("pedestrian", (0.77, 0.81, 1.78), 0.0, 40, 6),
    ("animal", (0.36, 0.73, 0.51), 0.0, 15, 1),
)


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


def _instances(rng, ego_t):
    """The scene's instances: dicts of category, wlh, start centre (global,
    z half the height), heading, velocity (2,) and points a sweep at full
    scale, at least 9 m apart."""
    out, placed = [], []
    for cat, wlh, speed, n_full, count in CLASSES:
        for _ in range(count):
            far = 30.0 if speed == 0.0 else 55.0
            while True:
                d, a = rng.uniform(8.0, far), rng.uniform(-np.pi, np.pi)
                xy = ego_t[:2] + d * np.array([np.cos(a), np.sin(a)])
                if all(np.hypot(*(xy - q)) > 9.0 for q in placed):
                    break
            placed.append(xy)
            heading = rng.uniform(-np.pi, np.pi)
            v = speed * rng.uniform(0.5, 1.0)
            out.append(dict(cat=cat, wlh=wlh, n_full=n_full,
                            start=np.array([xy[0], xy[1], wlh[2] / 2]), heading=heading,
                            velocity=v * np.array([np.cos(heading), np.sin(heading)])))
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
        n = max(3, int(round(inst["n_full"] * scale)))
        box = _box_at(inst, t)
        local = rng.uniform(-0.45, 0.45, (n, 3)) * box[3:6]
        parts.append(local @ _rot(box[6]).T + box[:3])
    obj = _to_lidar(np.concatenate(parts), ego_t, ego_yaw)
    n_bg = max(n_points - len(obj), 0)
    n_ground = int(0.7 * n_bg)
    r = 90.0 * np.sqrt(rng.uniform(0.0, 1.0, n_ground))
    a = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(a), r * np.sin(a),
                       -LIDAR_FROM_CAR_T[2] + rng.normal(0.0, 0.03, n_ground)], 1)
    n_clutter = n_bg - n_ground
    clutter = np.stack([rng.uniform(-75, 75, n_clutter), rng.uniform(-75, 75, n_clutter),
                        rng.uniform(-1.8, 2.5, n_clutter)], 1)
    xyz = np.concatenate([obj, ground, clutter])
    rows = np.zeros((len(xyz), 5), np.float32)
    rows[:, :3] = xyz
    rows[:, 3] = rng.uniform(0, 100, len(xyz))
    rows[:, 4] = rng.integers(0, 64, len(xyz))
    return rows


def write_synthetic_lyft(root, n_train=2, n_val=2, n_samples=4, n_points=FULL_POINTS, seed=0):
    """Write the root (see the module docstring); returns the (train, val)
    scene names."""
    root = Path(root)
    tdir, ldir, sets = root / "data", root / "lidar", root.parent / "ImageSets"
    for sub in (tdir, ldir, sets):
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
                     "date_captured": "2019-05-01", "location": "synthetic"})
    names = [f"host-s{s:03d}-scene" for s in range(n_train + n_val)]
    for s, name in enumerate(names):
        _write_scene(T, rng, s, name, n_samples, n_points, root, cat_token)
    for table, rows in T.items():
        (tdir / f"{table}.json").write_text(json.dumps(rows))
    (sets / "train.txt").write_text("".join(n + "\n" for n in names[:n_train]))
    (sets / "val.txt").write_text("".join(n + "\n" for n in names[n_train:]))
    return names[:n_train], names[n_train:]


def _write_scene(T, rng, s, name, n_samples, n_points, root, cat_token):
    t0_us = 1_557_000_000_000_000 + s * 100_000_000
    x0, y0, h0 = rng.uniform(-2000, 2000), rng.uniform(-2000, 2000), rng.uniform(-np.pi, np.pi)
    insts = _instances(rng, _ego_pose(LEAD_IN * SWEEP_S, x0, y0, h0)[0])
    scene_tok, sample_toks = f"scene{s}", [f"sample{s}_{k}" for k in range(n_samples)]
    T["scene"].append({"token": scene_tok, "log_token": "log0", "nbr_samples": n_samples,
                       "first_sample_token": sample_toks[0],
                       "last_sample_token": sample_toks[-1], "name": name,
                       "description": "synthetic"})
    ann_of = {i: [] for i in range(len(insts))}
    sd_prev = ""
    n_sweeps = LEAD_IN + SWEEPS_PER_KEYFRAME * (n_samples - 1) + 1
    for j in range(n_sweeps):
        t = j * SWEEP_S
        k, key = divmod(j - LEAD_IN, SWEEPS_PER_KEYFRAME)
        is_key = j >= LEAD_IN and key == 0
        t_us = t0_us + int(round(t * 1e6))
        ego_t, ego_yaw = _ego_pose(t, x0, y0, h0)
        sd_tok = f"sd{s}_{j}"
        T["ego_pose"].append({"token": f"ep{s}_{j}", "timestamp": t_us,
                              "rotation": _quat_yaw(ego_yaw),
                              "translation": [float(v) for v in ego_t]})
        rel = f"lidar/{name}_lidar_top_{t_us}.bin"
        _sweep_points(rng, n_points, insts, t, ego_t, ego_yaw).tofile(root / rel)
        if sd_prev:
            T["sample_data"][-1]["next"] = sd_tok
        tok = sample_toks[min(max(k + (0 if is_key else 1), 0), n_samples - 1)]
        T["sample_data"].append({
            "token": sd_tok, "sample_token": tok, "ego_pose_token": f"ep{s}_{j}",
            "calibrated_sensor_token": "cs_lidar", "timestamp": t_us, "fileformat": "bin",
            "is_key_frame": is_key, "height": 0, "width": 0, "filename": rel,
            "prev": sd_prev, "next": ""})
        sd_prev = sd_tok
        if not is_key:
            continue
        anns = []
        for i, inst in enumerate(insts):
            box = _box_at(inst, t)
            ann_tok = f"ann{s}_{k}_{i}"
            anns.append(ann_tok)
            ann_of[i].append(ann_tok)
            T["sample_annotation"].append({
                "token": ann_tok, "sample_token": sample_toks[k],
                "instance_token": f"inst{s}_{i}", "attribute_tokens": [],
                "translation": [float(v) for v in box[:3]], "size": list(inst["wlh"]),
                "rotation": _quat_yaw(box[6]), "num_lidar_pts": 0, "num_radar_pts": 0,
                "category_name": inst["cat"], "prev": "", "next": ""})
        T["sample"].append({"token": sample_toks[k], "timestamp": t_us,
                            "prev": sample_toks[k - 1] if k else "",
                            "next": sample_toks[k + 1] if k + 1 < n_samples else "",
                            "scene_token": scene_tok, "data": {"LIDAR_TOP": sd_tok},
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
    ap.add_argument("--train", type=int, default=2)
    ap.add_argument("--val", type=int, default=2)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--points", type=int, default=FULL_POINTS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    train, val = write_synthetic_lyft(args.root, args.train, args.val, args.samples,
                                      args.points, args.seed)
    print(f"{args.root}: {len(train)} train and {len(val)} val scenes of {args.samples} key "
          f"frames, {args.points} points a sweep")


if __name__ == "__main__":
    main()
