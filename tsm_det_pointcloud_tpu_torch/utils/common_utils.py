"""Device selection shared by the port's entry points, and angle wrapping
(counterpart of tsm_det_pointcloud_tpu/utils/common_utils.py:24)."""
from __future__ import annotations

import numpy as np
import torch


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap angles into [-offset * period, (1 - offset) * period)."""
    return val - torch.floor(val / period + offset) * period


def resolve_device(device="cuda"):
    """torch.device for `device`; asking for CUDA without a card raises.
    Entry points default to the card: only an explicit "cpu" runs here."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
