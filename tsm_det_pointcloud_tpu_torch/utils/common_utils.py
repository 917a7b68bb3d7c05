"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda"):
    """torch.device for `device`; asking for CUDA without a card raises.
    Entry points default to the card: only an explicit "cpu" runs here."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
