"""Waymo tfrecord -> npy / pkl preprocessing in Python and numpy (the port's
own copy of tsm_det_pointcloud_tpu/datasets/waymo/waymo_preprocess.py; no
TensorFlow, no waymo_open_dataset package).

The three pieces:

  1. TFRecord framing: [len u64le][masked crc32c(len)][payload]
     [masked crc32c(payload)], the mask ((crc >> 15 | crc << 17) +
     0xa282ead8). The CRC32C runs in the host library
     (`ops.host_native.crc32c`; `crc32c_plain` is the JAX package's
     byte-at-a-time body, which the tests hold it against): a frame's
     payload is megabytes, too many for a loop in Python.
  2. Protobuf wire format: a generic proto2 decoder (varint / 64-bit /
     length-delimited / 32-bit, packed and unpacked repeated scalars) and
     the field numbers of the subset of the public
     waymo_open_dataset/dataset.proto the preprocessing reads (Frame,
     Context, LaserCalibration, Laser, RangeImage, MatrixFloat / Shape,
     Label / Box, Transform). `datasets.waymo.synthetic` encodes with the
     same maps.
  3. Range image -> points: the official
     range_image_utils.extract_point_cloud_from_range_image math in numpy:
     a uniform azimuth sweep corrected by the extrinsic yaw, beam
     inclinations (given, or uniform from min to max), spherical -> sensor
     -> vehicle frame by the extrinsic, and for the TOP laser the per-pixel
     pose to the world and the inverse frame pose back to the vehicle.

The output layout is what `WaymoDataset` reads:
  <save>/<sequence>/%04d.npy  float32 (N, 6) [x y z intensity elongation NLZ]
  <save>/<sequence>/<sequence>.pkl  the list of per-frame info dicts
"""
from __future__ import annotations

import pickle
import struct
import zlib
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# 1. TFRecord framing
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of `data`, continuing from `crc`, in the host
    library."""
    from ...ops import host_native

    return host_native.crc32c(data, crc)


def crc32c_plain(data: bytes, crc: int = 0) -> int:
    """`crc32c` a byte at a time in Python (the JAX package's body)."""
    table = _crc32c_table()
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def read_tfrecord(path):
    """Yield payload bytes from a TFRecord file, verifying both CRCs."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if len(head) == 0:
                return
            if len(head) < 12:
                raise IOError(f"truncated tfrecord header in {path}")
            (length,) = struct.unpack("<Q", head[:8])
            (len_crc,) = struct.unpack("<I", head[8:12])
            if _masked_crc(head[:8]) != len_crc:
                raise IOError(f"tfrecord length crc mismatch in {path}")
            payload = f.read(length)
            (data_crc,) = struct.unpack("<I", f.read(4))
            if _masked_crc(payload) != data_crc:
                raise IOError(f"tfrecord payload crc mismatch in {path}")
            yield payload


def write_tfrecord(path, payloads):
    """Write payloads with TFRecord framing (fixtures / re-export)."""
    with open(path, "wb") as f:
        for p in payloads:
            head = struct.pack("<Q", len(p))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(p)
            f.write(struct.pack("<I", _masked_crc(p)))


# ---------------------------------------------------------------------------
# 2. Protobuf wire format (proto2 subset)
# ---------------------------------------------------------------------------

def _read_varint(buf, i):
    val = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def parse_fields(buf):
    """Decode a serialized message into {field_num: [raw values]}.
    Wire types: 0 varint -> int; 1 fixed64 -> bytes(8); 2 len-delim ->
    bytes; 5 fixed32 -> bytes(4)."""
    out = {}
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fnum})")
        out.setdefault(fnum, []).append(v)
    return out


def _scalar_doubles(vals):
    """repeated double: unpacked (each 8-byte) or packed (one blob)."""
    out = []
    for v in vals:
        arr = np.frombuffer(v, "<f8")
        out.extend(arr.tolist())
    return out


def _scalar_floats_packed(vals):
    out = []
    for v in vals:
        out.append(np.frombuffer(v, "<f4"))
    return np.concatenate(out) if out else np.zeros(0, np.float32)


def _scalar_int32s(vals):
    """repeated int32: packed varints in one blob, or unpacked ints."""
    out = []
    for v in vals:
        if isinstance(v, int):
            out.append(v)
        else:
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                out.append(x)
    return out


def _double(vals, default=0.0):
    if not vals:
        return default
    return float(np.frombuffer(vals[-1], "<f8")[0])


def _transform(vals):
    """Transform { repeated double transform = 1; } -> (4, 4) or None."""
    if not vals:
        return None
    f = parse_fields(vals[-1])
    t = _scalar_doubles(f.get(1, []))
    return np.asarray(t, np.float64).reshape(4, 4) if len(t) == 16 else None


def _matrix(blob, dtype):
    """zlib MatrixFloat/MatrixInt32 {data=1 packed, shape=2{dims=1}}."""
    f = parse_fields(zlib.decompress(blob))
    if dtype == np.float32:
        data = _scalar_floats_packed(f.get(1, []))
    else:
        data = np.asarray(_scalar_int32s(f.get(1, [])), np.int32)
    dims = [1]
    if 2 in f:
        shape_f = parse_fields(f[2][-1])
        dims = _scalar_int32s(shape_f.get(1, []))
    return np.asarray(data).reshape(dims)


# field-number maps (public waymo_open_dataset/dataset.proto)
LASER_TOP = 1
_WAYMO_CLASSES = ["unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist"]


def decode_frame(payload):
    """Decode the Frame subset the preprocessing needs. Returns a dict:
    context_name, timestamp_micros, pose (4,4), camera_hw [(h, w) in proto order],
    laser_calib {laser: dict}, range_images {laser: [ri1, ri2]},
    top_pose (H, W, 6) or None, labels list of dicts."""
    f = parse_fields(payload)
    out = {"context_name": "", "timestamp_micros": 0,
           "pose": np.eye(4), "camera_hw": [], "laser_calib": {},
           "range_images": {}, "top_pose": None, "labels": []}
    # Frame.context = 1
    if 1 in f:
        ctx = parse_fields(f[1][-1])
        if 1 in ctx:
            out["context_name"] = ctx[1][-1].decode("utf-8", "replace")
        # camera_calibrations = 2 {name=1, width=4, height=5} — kept as a
        # LIST in proto order: the reference indexes
        # frame.context.camera_calibrations[j] positionally
        # (waymo_utils.py), not by camera name
        for cal in ctx.get(2, []):
            c = parse_fields(cal)
            w = c.get(4, [0])[-1]
            h = c.get(5, [0])[-1]
            out["camera_hw"].append((int(h), int(w)))
        # laser_calibrations = 3 {name=1, beam_inclinations=2,
        #   beam_inclination_min=3, beam_inclination_max=4, extrinsic=5}
        for cal in ctx.get(3, []):
            c = parse_fields(cal)
            name = int(c.get(1, [0])[-1])
            out["laser_calib"][name] = {
                "beam_inclinations": np.asarray(
                    _scalar_doubles(c.get(2, [])), np.float64),
                "beam_inclination_min": _double(c.get(3, [])),
                "beam_inclination_max": _double(c.get(4, [])),
                "extrinsic": _transform(c.get(5, [])),
            }
    # Frame.timestamp_micros = 2
    if 2 in f:
        out["timestamp_micros"] = int(f[2][-1])
    # Frame.pose = 3
    pose = _transform(f.get(3, []))
    if pose is not None:
        out["pose"] = pose
    # Frame.lasers = 5 {name=1, ri_return1=2, ri_return2=3}
    for laser in f.get(5, []):
        l = parse_fields(laser)
        name = int(l.get(1, [0])[-1])
        ris = []
        for fn in (2, 3):
            if fn not in l:
                ris.append(None)
                continue
            ri = parse_fields(l[fn][-1])
            # RangeImage.range_image_compressed = 2 (zlib MatrixFloat)
            img = _matrix(ri[2][-1], np.float32) if 2 in ri else None
            ris.append(img)
            # RangeImage.range_image_pose_compressed = 4 (TOP, return 1)
            if fn == 2 and name == LASER_TOP and 4 in ri:
                out["top_pose"] = _matrix(ri[4][-1], np.float32)
        out["range_images"][name] = ris
    # Frame.laser_labels = 6 {box=1, type=3, id=4,
    #   detection_difficulty_level=5, tracking_difficulty_level=6,
    #   num_lidar_points_in_box=7}
    for lab in f.get(6, []):
        m = parse_fields(lab)
        box = {}
        if 1 in m:
            b = parse_fields(m[1][-1])
            # Box {center_x=1 y=2 z=3 length=4 width=5 height=6 heading=7}
            box = {k: _double(b.get(i, []))
                   for k, i in (("cx", 1), ("cy", 2), ("cz", 3),
                                ("l", 4), ("w", 5), ("h", 6), ("ry", 7))}
        out["labels"].append({
            "box": box,
            "type": int(m.get(3, [0])[-1]),
            "id": m.get(4, [b""])[-1].decode("utf-8", "replace"),
            "detection_difficulty_level": int(m.get(5, [0])[-1]),
            "tracking_difficulty_level": int(m.get(6, [0])[-1]),
            "num_lidar_points_in_box": int(m.get(7, [0])[-1]),
        })
    return out


# ---------------------------------------------------------------------------
# 3. range image -> point cloud (official math, numpy)
# ---------------------------------------------------------------------------

def _rotation_zyx(roll, pitch, yaw):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) — transform_utils.get_rotation_
    matrix. Inputs broadcast; returns (..., 3, 3)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    o = np.ones_like(cr)
    z = np.zeros_like(cr)
    rx = np.stack([o, z, z, z, cr, -sr, z, sr, cr],
                  -1).reshape(cr.shape + (3, 3))
    ry = np.stack([cp, z, sp, z, o, z, -sp, z, cp],
                  -1).reshape(cr.shape + (3, 3))
    rz = np.stack([cy, -sy, z, sy, cy, z, z, z, o],
                  -1).reshape(cr.shape + (3, 3))
    return rz @ ry @ rx


def range_image_to_points(range_image, extrinsic, beam_inclinations=None,
                          beam_inclination_min=None,
                          beam_inclination_max=None,
                          pixel_pose=None, frame_pose=None):
    """(H, W, 4) [range, intensity, elongation, NLZ] -> (N, 6) rows
    [x y z intensity elongation NLZ] in the VEHICLE frame.

    Official pipeline (range_image_utils.py): uniform azimuth sweep over
    [pi, -pi) corrected by the extrinsic yaw; inclinations either given
    (reversed: row 0 = top beam) or uniform min..max; spherical ->
    sensor -> vehicle via extrinsic; TOP lidar additionally vehicle ->
    global via the per-pixel pose and back via inverse frame pose."""
    H, W = range_image.shape[:2]
    r = range_image[..., 0]
    if beam_inclinations is None or len(beam_inclinations) == 0:
        # compute_inclination: uniform, row index from the BOTTOM beam
        rel = (np.arange(H, dtype=np.float64) + 0.5) / H
        incl = rel * (beam_inclination_max - beam_inclination_min) \
            + beam_inclination_min
    else:
        incl = np.asarray(beam_inclinations, np.float64)
    incl = incl[::-1]  # row 0 = top beam

    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (np.arange(W, 0, -1, dtype=np.float64) - 0.5) / W
    azimuth = (ratios * 2 - 1) * np.pi - az_correction

    cos_az = np.cos(azimuth)[None, :]
    sin_az = np.sin(azimuth)[None, :]
    cos_in = np.cos(incl)[:, None]
    sin_in = np.sin(incl)[:, None]
    x = cos_az * cos_in * r
    y = sin_az * cos_in * r
    z = sin_in * r
    pts = np.stack([x, y, z], -1)                       # (H, W, 3) sensor
    pts = pts @ extrinsic[:3, :3].T + extrinsic[:3, 3]  # vehicle

    if pixel_pose is not None:
        rot = _rotation_zyx(pixel_pose[..., 0], pixel_pose[..., 1],
                            pixel_pose[..., 2])          # (H, W, 3, 3)
        trans = pixel_pose[..., 3:6]
        world = np.einsum("hwij,hwj->hwi", rot, pts) + trans
        fp = np.asarray(frame_pose, np.float64)
        pts = (world - fp[:3, 3]) @ fp[:3, :3]           # R^T (w - t)

    mask = r > 0
    return np.concatenate([
        pts[mask],
        range_image[..., 1][mask][:, None],
        range_image[..., 2][mask][:, None],
        range_image[..., 3][mask][:, None],
    ], -1).astype(np.float32)


def frame_points(frame, use_two_returns=True):
    """All lasers' points in the vehicle frame, per-laser counts.
    Mirrors save_lidar_points (waymo_utils.py:161-184): lasers sorted by
    name, returns (first, second) concatenated per laser."""
    counts = []
    chunks = []
    for name in sorted(frame["range_images"]):
        cal = frame["laser_calib"].get(name, {})
        per_laser = []
        ris = frame["range_images"][name]
        for ri_idx in range(2 if use_two_returns else 1):
            ri = ris[ri_idx] if ri_idx < len(ris) else None
            if ri is None:
                continue
            per_laser.append(range_image_to_points(
                np.asarray(ri, np.float32),
                cal.get("extrinsic") if cal.get("extrinsic") is not None
                else np.eye(4),
                beam_inclinations=cal.get("beam_inclinations"),
                beam_inclination_min=cal.get("beam_inclination_min", 0.0),
                beam_inclination_max=cal.get("beam_inclination_max", 0.0),
                # per-pixel pose applies to BOTH returns of the TOP laser
                # (reference convert_range_image_to_point_cloud passes
                # range_image_top_pose for every ri_index) — gating it on
                # the first return would leave second-return points
                # uncompensated for ego motion
                pixel_pose=(frame["top_pose"]
                            if name == LASER_TOP
                            and frame["top_pose"] is not None else None),
                frame_pose=frame["pose"],
            ))
        pc = (np.concatenate(per_laser, 0) if per_laser
              else np.zeros((0, 6), np.float32))
        counts.append(len(pc))
        chunks.append(pc)
    pts = (np.concatenate(chunks, 0) if chunks
           else np.zeros((0, 6), np.float32))
    return pts, counts


def _image_shapes(camera_hw, sequence_name):
    """image_shape_%d keyed by LIST POSITION, mirroring the reference's
    frame.context.camera_calibrations[j] indexing; a frame without the
    usual 5 cameras gets a loud warning instead of silent zeros."""
    if len(camera_hw) != 5:
        print(f"Warning: {sequence_name}: expected 5 camera calibrations, "
              f"got {len(camera_hw)}")
    return {f"image_shape_{j}": (camera_hw[j] if j < len(camera_hw)
                                 else (0, 0))
            for j in range(5)}


def generate_labels(frame):
    """Label extraction (parity: waymo_utils.generate_labels :23-62);
    drops 'unknown'."""
    keep = [l for l in frame["labels"] if l["type"] != 0 and l["box"]]
    name = np.asarray([_WAYMO_CLASSES[l["type"]] for l in keep])
    ann = {
        "name": name,
        "difficulty": np.asarray(
            [l["detection_difficulty_level"] for l in keep], np.int64),
        "dimensions": np.asarray(
            [[l["box"]["l"], l["box"]["w"], l["box"]["h"]] for l in keep],
            np.float64).reshape(-1, 3),
        "location": np.asarray(
            [[l["box"]["cx"], l["box"]["cy"], l["box"]["cz"]]
             for l in keep], np.float64).reshape(-1, 3),
        "heading_angles": np.asarray(
            [l["box"]["ry"] for l in keep], np.float64),
        "obj_ids": np.asarray([l["id"] for l in keep]),
        "tracking_difficulty": np.asarray(
            [l["tracking_difficulty_level"] for l in keep], np.int64),
        "num_points_in_gt": np.asarray(
            [l["num_lidar_points_in_box"] for l in keep], np.int64),
    }
    ann["gt_boxes_lidar"] = (np.concatenate([
        ann["location"], ann["dimensions"],
        ann["heading_angles"][:, None]], 1)
        if len(keep) else np.zeros((0, 7)))
    return ann


def process_single_sequence(sequence_file, save_path, sampled_interval=1,
                            has_label=True, use_two_returns=True):
    """tfrecord -> <save>/<seq>/%04d.npy + <seq>.pkl; returns the info
    list (parity: waymo_utils.process_single_sequence :184-246)."""
    sequence_file = Path(sequence_file)
    sequence_name = sequence_file.stem
    if not sequence_file.exists():
        print(f"NotFoundError: {sequence_file}")
        return []
    cur_save_dir = Path(save_path) / sequence_name
    cur_save_dir.mkdir(parents=True, exist_ok=True)
    pkl_file = cur_save_dir / f"{sequence_name}.pkl"
    if pkl_file.exists():
        with open(pkl_file, "rb") as f:
            return pickle.load(f)

    infos = []
    for cnt, payload in enumerate(read_tfrecord(sequence_file)):
        if cnt % sampled_interval != 0:
            continue
        frame = decode_frame(payload)
        info = {
            "point_cloud": {"num_features": 5,
                            "lidar_sequence": sequence_name,
                            "sample_idx": cnt},
            "frame_id": sequence_name + ("_%03d" % cnt),
            "metadata": {"context_name": frame["context_name"],
                         "timestamp_micros": frame["timestamp_micros"]},
            "image": _image_shapes(frame["camera_hw"], sequence_name),
            "pose": frame["pose"].astype(np.float32),
        }
        if has_label:
            info["annos"] = generate_labels(frame)
        pts, counts = frame_points(frame, use_two_returns=use_two_returns)
        np.save(cur_save_dir / ("%04d.npy" % cnt), pts)
        info["num_points_of_each_lidar"] = counts
        infos.append(info)
    with open(pkl_file, "wb") as f:
        pickle.dump(infos, f)
    print(f"Infos are saved to {pkl_file}")
    return infos
