"""Device selection shared by the port's entry points, angle wrapping, the
host pipeline's numpy geometry helpers and the logger (counterpart of
tsm_det_pointcloud_tpu/utils/common_utils.py: limit_period :24,
rotate_points_along_z_np :62, mask_points_by_range_np :72, create_logger
:125, keep_arrays_by_name :175)."""
from __future__ import annotations

import logging
import os

import numpy as np
import torch


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap angles into [-offset * period, (1 - offset) * period); a numpy
    array (the host pipeline's boxes) stays numpy."""
    floor = np.floor if isinstance(val, np.ndarray) else torch.floor
    return val - floor(val / period + offset) * period


def resolve_device(device="cuda"):
    """torch.device for `device`; asking for CUDA without a card raises.
    Entry points default to the card: only an explicit "cpu" runs here."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def rotate_points_along_z_np(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotate (B, N, 3+C) points by (B,) angles about z, CCW."""
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot = np.stack(
        [cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones], axis=-1
    ).reshape(angle.shape + (3, 3))
    xyz = np.einsum("bnd,bdk->bnk", points[..., :3], rot)
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


def mask_points_by_range_np(points: np.ndarray, limit_range) -> np.ndarray:
    """Boolean mask of the points inside the range's xy box (z is not
    checked, as in the reference)."""
    return (
        (points[:, 0] >= limit_range[0])
        & (points[:, 0] <= limit_range[3])
        & (points[:, 1] >= limit_range[1])
        & (points[:, 1] <= limit_range[4])
    )


def keep_arrays_by_name(gt_names, used_classes):
    inds = [i for i, x in enumerate(gt_names) if x in used_classes]
    return np.array(inds, dtype=np.int64)


class _LiveStderrHandler(logging.StreamHandler):
    """A StreamHandler that looks up sys.stderr when it emits: a plain one
    binds the stream once, and `create_logger` caches its handlers on a
    named logger, so a long-lived process (or a test suite that swaps
    sys.stderr) would go on writing to a stale stream."""

    def __init__(self, level=logging.NOTSET):
        logging.Handler.__init__(self, level)

    @property
    def stream(self):
        import sys

        return self._bound_stream if self._bound_stream is not None else sys.stderr

    @stream.setter
    def stream(self, value):
        self._bound_stream = value

    _bound_stream = None


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """The entry points' logger: stderr, and `log_file` when given. The
    logger is one a rank for the process, so a call drops the file handlers
    of earlier calls: an entry point run again in the same process (a
    notebook, a script that evaluates twice) writes to its own log alone,
    not also to every earlier run's."""
    logger = logging.getLogger(__name__ + (".rank%d" % rank))
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    lvl = log_level if rank == 0 else logging.ERROR
    if not any(isinstance(h, _LiveStderrHandler) for h in logger.handlers):
        console = _LiveStderrHandler()
        console.setLevel(lvl)
        console.setFormatter(formatter)
        logger.addHandler(console)
    path = None if log_file is None else os.path.abspath(str(log_file))
    for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)
              and getattr(h, "baseFilename", None) != path]:
        logger.removeHandler(h)
        h.close()
    if log_file is not None:
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == path
                   for h in logger.handlers):
            fh = logging.FileHandler(filename=path)
            fh.setLevel(lvl)
            fh.setFormatter(formatter)
            logger.addHandler(fh)
    return logger
