"""Shared-memory cache of host arrays (counterpart of
tsm_det_pointcloud_tpu/datasets/shared_memory.py; its users are the gt
sampler's `USE_SHARED_MEMORY` route and
`WaymoDataset.load_data_to_shared_memory` / `clean_shared_memory`).

Every loader worker of a host maps one copy of an array: each cached array
is an .npy file under TSM_SHM_DIR (default /dev/shm), written atomically (a
temporary file, then a rename) and opened again with
np.load(mmap_mode="r"), so the page cache backs it with the same physical
pages in every process. The directory is read when a call is made, so a
process may point it elsewhere before it loads data.
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np


def shm_root() -> Path:
    return Path(os.environ.get("TSM_SHM_DIR", "/dev/shm"))


def _path(key: str) -> Path:
    return shm_root() / (re.sub(r"[^\w.\-]", "_", key) + ".npy")


def available() -> bool:
    root = shm_root()
    return root.is_dir() and os.access(root, os.W_OK)


def sa_exists(key: str) -> bool:
    return _path(key).exists()


def sa_create(key: str, arr: np.ndarray) -> None:
    """Publish `arr` under `key` once: a second call (or a racing creator)
    leaves the first copy."""
    dst = _path(key)
    if dst.exists():
        return
    tmp = dst.with_suffix(f".tmp{os.getpid()}.npy")
    np.save(tmp, np.ascontiguousarray(arr))
    os.replace(tmp, dst)


def sa_attach(key: str, copy: bool = True) -> np.ndarray:
    """The cached array: a private writable copy, or (copy=False) the
    read-only map."""
    out = np.load(_path(key), mmap_mode="r")
    return np.array(out) if copy else out


def sa_delete(key: str) -> None:
    _path(key).unlink(missing_ok=True)
