"""Lyft Level 5 metadata and offline info creation without the devkit: the
port's own copy of tsm_det_pointcloud_tpu/datasets/lyft/lyft_tables.py.

Lyft's devkit is a fork of nuScenes' schema: the same JSON tables, kept in
a `data/` directory, read through the port's `NuScenesTables` with its
quaternion helpers (datasets/nuscenes/nuscenes_tables.py). What the
reference uses (pcdet/datasets/lyft/lyft_utils.py:46-222 and
lyft_dataset.py:251-307) is rebuilt on them: the annotation boxes in the
key frame's lidar frame (`_annotation_boxes7`: 7 columns, no velocity, the
raw Lyft class names), `fill_trainval_infos` (sweeps with their
transforms and time lags) and `create_lyft_info` with the scene splits of
ImageSets/{train,val,test}.txt beside the data directory.
"""
from __future__ import annotations

import pickle
from functools import reduce
from pathlib import Path

import numpy as np

from ..nuscenes.nuscenes_tables import (
    NuScenesTables,
    quat_rotation_matrix,
    transform_matrix,
)


class LyftTables(NuScenesTables):
    """Lyft metadata: same tables, `data/` table directory."""

    def __init__(self, dataroot):
        super().__init__(dataroot, version="lyft",
                         table_dir=Path(dataroot) / "data")


def _annotation_boxes7(tables, sample, ref_from_car, car_from_global):
    """Annotation boxes of `sample` in the ref-lidar frame, Lyft layout:
    (boxes7 (N, 7), names, tokens (N, 1), velocity (N, 3) = NaN).
    Parity: lyft_utils.get_sample_data + fill_trainval_infos:196-216 —
    the Lyft reference never sets Box.velocity, so it stays NaN."""
    anns = [tables.get("sample_annotation", t) for t in sample["anns"]]
    n = len(anns)
    if n == 0:
        return (np.zeros((0, 7)), np.array([], object),
                np.zeros((0, 1), object), np.zeros((0, 3)))
    ref_rot = ref_from_car[:3, :3] @ car_from_global[:3, :3]
    ref_t = (ref_from_car @ car_from_global)[:3, 3]

    centers = np.array([a["translation"] for a in anns], np.float64)
    wlh = np.array([a["size"] for a in anns], np.float64)
    centers = centers @ ref_rot.T + ref_t
    dims = wlh[:, [1, 0, 2]]  # wlh -> dx(l), dy(w), dz(h)
    yaws = np.empty(n)
    for i, a in enumerate(anns):
        box_x = quat_rotation_matrix(a["rotation"]) @ np.array([1.0, 0, 0])
        v = ref_rot @ box_x
        yaws[i] = np.arctan2(v[1], v[0])
    boxes7 = np.concatenate([centers, dims, yaws[:, None]], axis=1)
    names = np.array([tables.get("category", tables.get(
        "instance", a["instance_token"])["category_token"])["name"]
        if "category_name" not in a else a["category_name"] for a in anns],
        object)
    tokens = np.array([a["token"] for a in anns], object).reshape(-1, 1)
    return boxes7, names, tokens, np.full((n, 3), np.nan)


def fill_trainval_infos(data_path, tables, train_scene_tokens, test=False,
                        max_sweeps=10):
    """Parity: lyft_utils.fill_trainval_infos (:86-222)."""
    train_infos, val_infos = [], []
    data_path = Path(data_path)
    for sample in tables.sample:
        ref_sd = tables.get("sample_data", sample["data"]["LIDAR_TOP"])
        ref_cs = tables.get("calibrated_sensor",
                            ref_sd["calibrated_sensor_token"])
        ref_pose = tables.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]
        ref_lidar_path = tables.sample_data_path(ref_sd)
        ref_from_car = transform_matrix(
            ref_cs["translation"], ref_cs["rotation"], inverse=True)
        car_from_global = transform_matrix(
            ref_pose["translation"], ref_pose["rotation"], inverse=True)

        info = {
            "lidar_path": str(ref_lidar_path.relative_to(data_path)),
            "ref_from_car": ref_from_car,
            "ref_to_car": transform_matrix(
                ref_cs["translation"], ref_cs["rotation"], inverse=False),
            "token": sample["token"],
            "car_from_global": car_from_global,
            "car_to_global": transform_matrix(
                ref_pose["translation"], ref_pose["rotation"],
                inverse=False),
            "timestamp": ref_time,
            "sweeps": [],
        }

        curr = ref_sd
        sweeps = []
        while len(sweeps) < max_sweeps - 1:
            if curr["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": info["lidar_path"],
                        "sample_data_token": curr["token"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr = tables.get("sample_data", curr["prev"])
                pose = tables.get("ego_pose", curr["ego_pose_token"])
                cs = tables.get("calibrated_sensor",
                                curr["calibrated_sensor_token"])
                tm = reduce(np.dot, [
                    ref_from_car, car_from_global,
                    transform_matrix(pose["translation"], pose["rotation"],
                                     inverse=False),
                    transform_matrix(cs["translation"], cs["rotation"],
                                     inverse=False)])
                sweeps.append({
                    "lidar_path": str(tables.sample_data_path(
                        curr).relative_to(data_path)),
                    "sample_data_token": curr["token"],
                    "transform_matrix": tm,
                    "time_lag": ref_time - 1e-6 * curr["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            boxes7, names, tokens, velo = _annotation_boxes7(
                tables, sample, ref_from_car, car_from_global)
            info["gt_boxes"] = boxes7
            info["gt_boxes_velocity"] = velo
            info["gt_names"] = names
            info["gt_boxes_token"] = tokens

        if sample["scene_token"] in train_scene_tokens:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def create_lyft_info(version, data_path, save_path, split=None,
                     max_sweeps=10):
    """Parity: lyft_dataset.create_lyft_info (:251-307) — scene-name
    splits from ImageSets/{train,val,test,one_scene}.txt."""
    data_path, save_path = Path(data_path), Path(save_path)
    split_path = data_path.parent / "ImageSets"
    if split is not None:
        save_path = save_path / split
        split_path = split_path / split
    save_path.mkdir(exist_ok=True, parents=True)
    assert version in ("trainval", "one_scene", "test")
    names = {
        "trainval": ("train.txt", "val.txt"),
        "test": ("test.txt", None),
        "one_scene": ("one_scene.txt", "one_scene.txt"),
    }[version]

    def read_split(fname):
        if fname is None:
            return []
        p = split_path / fname
        return [x.strip() for x in p.read_text().splitlines()] \
            if p.exists() else []

    train_scenes, val_scenes = read_split(names[0]), read_split(names[1])
    tables = LyftTables(data_path)
    by_name = {s["name"]: s["token"] for s in tables.scene}
    train_tokens = {by_name[n] for n in train_scenes if n in by_name}
    print("%s: train scene(%d), val scene(%d)" % (
        version, len(train_tokens),
        len({by_name[n] for n in val_scenes if n in by_name})))
    train_infos, val_infos = fill_trainval_infos(
        data_path, tables, train_tokens, test=version == "test",
        max_sweeps=max_sweeps)
    if version == "test":
        print("test sample: %d" % len(train_infos))
        with open(save_path / "lyft_infos_test.pkl", "wb") as f:
            pickle.dump(train_infos + val_infos, f)
        return
    print("train sample: %d, val sample: %d" % (
        len(train_infos), len(val_infos)))
    with open(save_path / "lyft_infos_train.pkl", "wb") as f:
        pickle.dump(train_infos, f)
    with open(save_path / "lyft_infos_val.pkl", "wb") as f:
        pickle.dump(val_infos, f)
