"""ctypes loader of the host library `csrc/host_ops.cpp` (counterpart of
tsm_det_pointcloud_tpu/ops/host_native.py).

At first use the source is compiled by g++ (OpenMP) into
`tsm_det_pointcloud_tpu_torch/_build/`, keyed by a hash of the source, and
loaded. It gives

  * rotate_iou(boxes_a, boxes_b, criterion)   the rotated 2D IoU grid
  * points_in_boxes(points, boxes)            the first box that holds a point
  * crc32c(data, crc)                         CRC32C of the tfrecord framing

with the semantics of the numpy / Python bodies
`eval.rotate_iou_np._rotate_iou_numpy`, `ops.boxes.points_in_boxes_np_plain`
and `datasets.waymo.waymo_preprocess.crc32c_plain`, which are its plain
versions. A build or load that fails raises: there is no quiet numpy
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / "csrc" / "host_ops.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None


def _compile() -> Path:
    tag = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libtsm_host_ops_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic when several processes build at once
    return out


def load():
    """The loaded library; builds it at the first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_compile()))
            lib.tsm_rotate_iou.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ]
            lib.tsm_points_in_boxes.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.tsm_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
            lib.tsm_crc32c.restype = ctypes.c_uint32
            _LIB = lib
    return _LIB


def _as_c(a):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def rotate_iou(boxes_a: np.ndarray, boxes_b: np.ndarray, criterion=-1) -> np.ndarray:
    """(N, 5) x (M, 5) (cx, cy, w, h, angle) -> (N, M) float32.

    criterion: None raw intersection area, -1 IoU, 0 inter / area_a,
    1 inter / area_b (the rotate_iou_np contract)."""
    lib = load()
    n, m = len(boxes_a), len(boxes_b)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    a, ap = _as_c(boxes_a[:, :5])
    b, bp = _as_c(boxes_b[:, :5])
    out = np.empty((n, m), np.float32)
    crit = -2 if criterion is None else int(criterion)
    lib.tsm_rotate_iou(ap, n, bp, m, crit, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def points_in_boxes(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, >=3) points x (M, 7) boxes -> (N,) int64 first-hit index or -1."""
    lib = load()
    n, m = len(points), len(boxes)
    if m == 0:
        return np.full(n, -1, np.int64)
    p, pp = _as_c(points[:, :3])
    b, bp = _as_c(boxes[:, :7])
    out = np.empty(n, np.int64)
    lib.tsm_points_in_boxes(pp, n, bp, m, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of `data`, continuing from `crc`."""
    return int(load().tsm_crc32c(bytes(data), len(data), crc))
