"""A synthetic KITTI root in the real on-disk layout, for runs where no
KITTI data is at hand (the smoke run, rehearsals):

    python -m tsm_det_pointcloud_tpu_torch.datasets.kitti.synthetic ROOT \\
        [--train 48] [--val 48] [--points 120000] [--seed 0]

writes ROOT/ImageSets/{train,val}.txt and, per frame, training/velodyne/*.bin
(float32 x, y, z, intensity), label_2/*.txt (the KITTI label format),
calib/*.txt and planes/*.txt, with the calibration of
tests/test_kitti_pipeline.py's `make_kitti_root` (P2 focal 700 px, principal
point (600, 200); R0 the identity; camera x = -lidar y, y = -lidar z,
z = lidar x) and no image_2, so that the dataset takes KITTI's 375 x 1242
image. A scan holds `points` points over 360 degrees: a ground ring at
-1.73 m whose density falls with range out to 70 m, scattered clutter, and
inside each object's box points of its own: four cars, two pedestrians and
two cyclists a frame, resting on the ground, all in the camera's field of
view between 8 and 26 m, untruncated and unoccluded (each 2D box at least
40 px tall: KITTI's easy tier), and one DontCare region. About a fifth of a
scan lies in the field of view: ~24k points at 120k.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ...ops.boxes import boxes3d_kitti_camera_to_imageboxes, boxes3d_lidar_to_kitti_camera
from .calibration_kitti import Calibration

CALIB_TXT = (
    "P0: 700 0 600 0 0 700 200 0 0 0 1 0\n"
    "P1: 700 0 600 0 0 700 200 0 0 0 1 0\n"
    "P2: 700 0 600 0 0 700 200 0 0 0 1 0\n"
    "P3: 700 0 600 0 0 700 200 0 0 0 1 0\n"
    "R0_rect: 1 0 0 0 1 0 0 0 1\n"
    "Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0\n"
)
GROUND_Z = -1.73
IMAGE_SHAPE = (375, 1242)
# (class, (dx, dy, dz) in lidar axes, points inside, count a frame)
OBJECTS = (("Car", (3.9, 1.6, 1.56), 300, 4), ("Pedestrian", (0.8, 0.6, 1.73), 80, 2),
           ("Cyclist", (1.76, 0.6, 1.73), 100, 2))
# candidate (x, y) slots of the objects, 6 m apart, inside the field of view
SLOTS = np.array([(x, y) for x in (9.0, 15.0, 21.0) for y in (-6.0, 0.0, 6.0)]
                 + [(25.0, -12.0), (25.0, 12.0)])


def _frame(rng, n_points, calib):
    boxes, names = [], []
    slots = SLOTS[rng.permutation(len(SLOTS))]
    k = 0
    for name, size, _, count in OBJECTS:
        for _ in range(count):
            x, y = slots[k] + rng.uniform(-0.5, 0.5, 2)
            k += 1
            boxes.append([x, y, GROUND_Z + size[2] / 2, *size, rng.uniform(-np.pi, np.pi)])
            names.append(name)
    boxes = np.asarray(boxes)
    obj_pts = []
    for box, (_, _, n_in, count) in zip(boxes, [o for o in OBJECTS for _ in range(o[3])]):
        local = rng.uniform(-0.48, 0.48, (n_in, 3)) * box[3:6]
        c, s = np.cos(box[6]), np.sin(box[6])
        obj_pts.append(np.stack([box[0] + local[:, 0] * c - local[:, 1] * s,
                                 box[1] + local[:, 0] * s + local[:, 1] * c,
                                 box[2] + local[:, 2]], 1))
    obj_pts = np.concatenate(obj_pts)
    n_bg = n_points - len(obj_pts)
    n_ground = int(0.8 * n_bg)
    # lidar rings: range uniform in sqrt, so the density falls with range
    r = 3.0 + 67.0 * rng.uniform(0, 1, n_ground) ** 1.5
    phi = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(phi), r * np.sin(phi),
                       GROUND_Z + rng.normal(0, 0.03, n_ground)], 1)
    n_clutter = n_bg - n_ground
    r = rng.uniform(5, 70, n_clutter)
    phi = rng.uniform(-np.pi, np.pi, n_clutter)
    clutter = np.stack([r * np.cos(phi), r * np.sin(phi),
                        rng.uniform(GROUND_Z, 1.0, n_clutter)], 1)
    xyz = np.concatenate([obj_pts, ground, clutter])
    # the scene's own points inside an object's box stay: the labels count them
    pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1))], 1).astype(np.float32)
    pts = pts[rng.permutation(len(pts))]

    cam = boxes3d_lidar_to_kitti_camera(boxes, calib)
    img = boxes3d_kitti_camera_to_imageboxes(cam, calib, image_shape=IMAGE_SHAPE)
    lines = []
    for name, box, c, b in zip(names, boxes, cam, img):
        alpha = -np.arctan2(-box[1], box[0]) + c[6]
        lines.append(f"{name} 0.00 0 {alpha:.4f} {b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
                     f"{c[4]:.4f} {c[5]:.4f} {c[3]:.4f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f} "
                     f"{c[6]:.4f}\n")
    lines.append("DontCare -1 -1 -10 1100.00 150.00 1200.00 190.00 -1 -1 -1 -1000 -1000 "
                 "-1000 -10\n")
    return pts, "".join(lines)


def write_synthetic_kitti(root, n_train=48, n_val=48, n_points=120000, seed=0):
    """Write the root (see the module docstring); returns (train ids, val ids)."""
    root = Path(root)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    for sub in ("velodyne", "label_2", "calib", "planes"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    ids = [f"{i:06d}" for i in range(n_train + n_val)]
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids[:n_train]) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(ids[n_train:]) + "\n")
    calib = Calibration(str(_write(root / "training" / "calib" / "calib.tmp", CALIB_TXT)))
    (root / "training" / "calib" / "calib.tmp").unlink()
    for i, sid in enumerate(ids):
        pts, label = _frame(np.random.RandomState(seed * 100003 + i), n_points, calib)
        pts.tofile(root / "training" / "velodyne" / f"{sid}.bin")
        _write(root / "training" / "label_2" / f"{sid}.txt", label)
        _write(root / "training" / "calib" / f"{sid}.txt", CALIB_TXT)
        _write(root / "training" / "planes" / f"{sid}.txt",
               f"# Plane\nWidth 4\nHeight 1\n0 -1 0 {-GROUND_Z}\n")
    return ids[:n_train], ids[n_train:]


def _write(path, text):
    path.write_text(text)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--train", type=int, default=48)
    ap.add_argument("--val", type=int, default=48)
    ap.add_argument("--points", type=int, default=120000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    train, val = write_synthetic_kitti(args.root, args.train, args.val, args.points, args.seed)
    print(f"{args.root}: {len(train)} train and {len(val)} val frames of {args.points} points")


if __name__ == "__main__":
    main()
