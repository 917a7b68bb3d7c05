"""nuScenes metadata and offline info creation without the devkit: the
port's own copy of tsm_det_pointcloud_tpu/datasets/nuscenes/nuscenes_tables.py.

The nuscenes-devkit is, for info creation, a JSON-table ORM plus quaternion
geometry. This module rebuilds the subset the reference uses
(pcdet/datasets/nuscenes/nuscenes_utils.py:157-382: get_available_scenes /
get_sample_data / box_velocity / quaternion_yaw / transform_matrix /
fill_trainval_infos) on the released JSON tables with numpy.

Output info pkls carry the reference schema bit-for-bit: lidar_path,
cam_front_path, cam_intrinsic, token, sweeps (transform_matrix /
time_lag / ...), ref_from_car, car_from_global, timestamp, gt_boxes
(N, 9: xyz dxdydz yaw vx vy in the ref-lidar frame), gt_names (mapped to
detection classes), gt_boxes_velocity, gt_boxes_token, num_lidar_pts,
num_radar_pts.

Splits: the official trainval split is a curated scene-name list that
ships with the devkit (nuscenes/utils/splits.py), i.e. data, not
derivable from the tables. The v1.0-mini lists are embedded; for
trainval either pass `splits` explicitly or drop a `splits.json`
({"train": [...], "val": [...]}) next to the version directory.
"""
from __future__ import annotations

import json
import pickle
from functools import reduce
from pathlib import Path

import numpy as np

# nuScenes general -> detection-challenge class mapping (public constant;
# reference nuscenes_utils.py:31-56)
MAP_NAME_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}

# official v1.0-mini split (devkit splits.py; 8 + 2 scenes)
MINI_TRAIN = [
    "scene-0061", "scene-0553", "scene-0655", "scene-0757",
    "scene-0796", "scene-1077", "scene-1094", "scene-1100",
]
MINI_VAL = ["scene-0103", "scene-0916"]


# -- quaternion geometry (w, x, y, z convention, as in the JSON tables) --

def quat_rotation_matrix(q):
    """(4,) wxyz unit quaternion -> (3, 3) rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quaternion_yaw(q):
    """Heading of the box +x axis in the xy plane (parity:
    nuscenes_utils.py:234-249)."""
    vx, vy, _ = quat_rotation_matrix(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(vy, vx))


def transform_matrix(translation, rotation_q, inverse=False):
    """4x4 homogeneous transform from translation + wxyz quaternion
    (parity: devkit geometry_utils.transform_matrix)."""
    tm = np.eye(4)
    rot = quat_rotation_matrix(rotation_q)
    t = np.asarray(translation, np.float64)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = rot.T @ -t
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = t
    return tm


class NuScenesTables:
    """Token-indexed access to the released JSON metadata tables."""

    TABLES = ("category", "attribute", "sensor", "calibrated_sensor",
              "ego_pose", "log", "scene", "sample", "sample_data",
              "sample_annotation", "instance")

    def __init__(self, dataroot, version="v1.0-trainval", table_dir=None):
        self.dataroot = Path(dataroot)
        self.version = version
        # Lyft (a nuScenes schema fork) keeps its tables in a fixed
        # `data/` directory instead of a version directory
        table_dir = (Path(table_dir) if table_dir is not None
                     else self.dataroot / version)
        self._tables = {}
        self._index = {}
        for name in self.TABLES:
            path = table_dir / f"{name}.json"
            rows = json.loads(path.read_text()) if path.exists() else []
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}
        # sample_annotation rows grouped by sample (fill order = table order)
        self._anns_by_sample = {}
        for r in self._tables["sample_annotation"]:
            self._anns_by_sample.setdefault(r["sample_token"], []).append(r)

    def __getattr__(self, name):
        if name in self.TABLES:
            return self._tables[name]
        raise AttributeError(name)

    def get(self, table, token):
        return self._index[table][token]

    def sample_annotations(self, sample_token):
        return self._anns_by_sample.get(sample_token, [])

    def sample_data_path(self, sd_rec):
        return self.dataroot / sd_rec["filename"]

    def box_velocity(self, ann_token, max_time_diff=1.5):
        """Global-frame (3,) velocity estimated from the neighbouring
        annotations of the same instance (parity: devkit box_velocity)."""
        current = self.get("sample_annotation", ann_token)
        has_prev = current["prev"] != ""
        has_next = current["next"] != ""
        if not (has_prev or has_next):
            return np.full(3, np.nan)
        first = (self.get("sample_annotation", current["prev"])
                 if has_prev else current)
        last = (self.get("sample_annotation", current["next"])
                if has_next else current)
        pos_diff = (np.asarray(last["translation"], np.float64)
                    - np.asarray(first["translation"], np.float64))
        t_first = 1e-6 * self.get("sample", first["sample_token"])["timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        time_diff = t_last - t_first
        if time_diff > max_time_diff:
            return np.full(3, np.nan)
        return pos_diff / time_diff

    def split_scene_tokens(self, splits=None):
        """{'train': set(tokens), 'val': set(tokens)} from scene NAMES.
        Order of resolution: explicit arg -> <version>/splits.json ->
        built-in mini lists (v1.0-mini) -> error."""
        if splits is None:
            sp = self.dataroot / self.version / "splits.json"
            if sp.exists():
                splits = json.loads(sp.read_text())
            elif self.version == "v1.0-mini":
                splits = {"train": MINI_TRAIN, "val": MINI_VAL}
            elif self.version == "v1.0-test":
                splits = {"train": [], "val": []}
            else:
                raise RuntimeError(
                    "trainval scene splits are devkit data "
                    "(nuscenes/utils/splits.py) — provide them via "
                    f"{sp} as {{'train': [...], 'val': [...]}}")
        by_name = {s["name"]: s["token"] for s in self.scene}
        return {k: {by_name[n] for n in v if n in by_name}
                for k, v in splits.items()}


def _annotation_boxes(tables, sample, ref_from_car, car_from_global):
    """All annotation boxes of `sample` in the ref-lidar frame.

    Returns (boxes9 (N, 9), names (N,), tokens (N,), velo3 (N, 3),
    num_lidar_pts (N,), num_radar_pts (N,)). boxes9 = xyz, dxdydz
    (l=x-extent from wlh), yaw, vx, vy — reference fill_trainval_infos
    layout (nuscenes_utils.py:360-369).
    """
    anns = [tables.get("sample_annotation", t) for t in sample["anns"]]
    n = len(anns)
    if n == 0:
        z = np.zeros
        return (z((0, 9)), np.array([], object), np.array([], object),
                z((0, 3)), z((0,), np.int64), z((0,), np.int64))
    ref_rot = ref_from_car[:3, :3] @ car_from_global[:3, :3]
    ref_t = (ref_from_car @ car_from_global)[:3, 3]

    centers = np.array([a["translation"] for a in anns], np.float64)
    wlh = np.array([a["size"] for a in anns], np.float64)
    centers = centers @ ref_rot.T + ref_t
    dims = wlh[:, [1, 0, 2]]  # wlh -> dx(l), dy(w), dz(h)

    yaws = np.empty(n)
    velos = np.empty((n, 3))
    for i, a in enumerate(anns):
        # compose the global->ref rotation with the box orientation by
        # rotating the box +x axis (what quaternion_yaw measures)
        box_x = quat_rotation_matrix(a["rotation"]) @ np.array([1.0, 0, 0])
        v = ref_rot @ box_x
        yaws[i] = np.arctan2(v[1], v[0])
        velos[i] = ref_rot @ tables.box_velocity(a["token"])

    boxes9 = np.concatenate(
        [centers, dims, yaws[:, None], velos[:, :2]], axis=1)
    names = np.array([tables.get("category", tables.get(
        "instance", a["instance_token"])["category_token"])["name"]
        if "category_name" not in a else a["category_name"] for a in anns],
        object)
    tokens = np.array([a["token"] for a in anns], object)
    nlp = np.array([a.get("num_lidar_pts", 0) for a in anns], np.int64)
    nrp = np.array([a.get("num_radar_pts", 0) for a in anns], np.int64)
    return boxes9, names, tokens, velos, nlp, nrp


def fill_trainval_infos(data_path, tables, train_scene_tokens,
                        test=False, max_sweeps=10):
    """Hermetic rebuild of reference fill_trainval_infos
    (nuscenes_utils.py:252-379): same walk, same info schema."""
    train_infos, val_infos = [], []
    data_path = Path(data_path)

    for sample in tables.sample:
        ref_sd = tables.get("sample_data", sample["data"]["LIDAR_TOP"])
        ref_cs = tables.get("calibrated_sensor",
                            ref_sd["calibrated_sensor_token"])
        ref_pose = tables.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]
        ref_lidar_path = tables.sample_data_path(ref_sd)

        cam_sd = tables.get("sample_data", sample["data"]["CAM_FRONT"]) \
            if "CAM_FRONT" in sample["data"] else None
        cam_path = (tables.sample_data_path(cam_sd)
                    if cam_sd else ref_lidar_path)
        cam_cs = (tables.get("calibrated_sensor",
                             cam_sd["calibrated_sensor_token"])
                  if cam_sd else None)

        ref_from_car = transform_matrix(
            ref_cs["translation"], ref_cs["rotation"], inverse=True)
        car_from_global = transform_matrix(
            ref_pose["translation"], ref_pose["rotation"], inverse=True)

        info = {
            "lidar_path": str(ref_lidar_path.relative_to(data_path)),
            "cam_front_path": str(cam_path.relative_to(data_path)),
            "cam_intrinsic": (np.array(cam_cs["camera_intrinsic"])
                              if cam_cs else None),
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }

        # sweep chain: walk `prev` links, composing current-sensor ->
        # ref-sensor transforms; pad by repeating the last entry
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
                global_from_car = transform_matrix(
                    pose["translation"], pose["rotation"], inverse=False)
                car_from_current = transform_matrix(
                    cs["translation"], cs["rotation"], inverse=False)
                tm = reduce(np.dot, [ref_from_car, car_from_global,
                                     global_from_car, car_from_current])
                sweeps.append({
                    "lidar_path": str(tables.sample_data_path(
                        curr).relative_to(data_path)),
                    "sample_data_token": curr["token"],
                    "transform_matrix": tm,
                    "global_from_car": global_from_car,
                    "car_from_current": car_from_current,
                    "time_lag": ref_time - 1e-6 * curr["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            boxes9, names, tokens, velos, nlp, nrp = _annotation_boxes(
                tables, sample, ref_from_car, car_from_global)
            mask = (nlp + nrp) > 0  # reference: 0.5-1 mAP (":352-355")
            info["gt_boxes"] = boxes9[mask]
            info["gt_boxes_velocity"] = velos[mask]
            info["gt_names"] = np.array(
                [MAP_NAME_TO_DETECTION.get(n, n) for n in names], object
            )[mask]
            info["gt_boxes_token"] = tokens[mask]
            info["num_lidar_pts"] = nlp[mask]
            info["num_radar_pts"] = nrp[mask]

        if sample["scene_token"] in train_scene_tokens:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def create_nuscenes_info(version, data_path, save_path, max_sweeps=10,
                         splits=None):
    """Offline info creation (reference nuscenes_dataset.py:383-412 /
    nuscenes_utils.fill_trainval_infos), hermetic. Writes
    nuscenes_infos_{max_sweeps}sweeps_{train,val,test}.pkl under
    save_path/version."""
    data_path = Path(data_path) / version
    save_path = Path(save_path) / version
    save_path.mkdir(parents=True, exist_ok=True)
    tables = NuScenesTables(data_path, version)
    scene_tokens = tables.split_scene_tokens(splits)
    test = version == "v1.0-test"
    train_infos, val_infos = fill_trainval_infos(
        data_path, tables, scene_tokens["train"], test=test,
        max_sweeps=max_sweeps)
    if test:
        print(f"test samples: {len(train_infos) + len(val_infos)}")
        with open(save_path / f"nuscenes_infos_{max_sweeps}sweeps_test.pkl",
                  "wb") as f:
            pickle.dump(train_infos + val_infos, f)
        return
    print(f"train samples: {len(train_infos)}, val samples: {len(val_infos)}")
    with open(save_path / f"nuscenes_infos_{max_sweeps}sweeps_train.pkl",
              "wb") as f:
        pickle.dump(train_infos, f)
    with open(save_path / f"nuscenes_infos_{max_sweeps}sweeps_val.pkl",
              "wb") as f:
        pickle.dump(val_infos, f)
