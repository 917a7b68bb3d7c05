"""Training / eval scalar stream (counterpart of
tsm_det_pointcloud_tpu/runtime/metrics.py): one JSON line per logged step,
always; a TensorBoard event file beside it only where a SummaryWriter
imports (tensorboardX or torch.utils.tensorboard)."""
from __future__ import annotations

import json
import math
from pathlib import Path


def _make_summary_writer(log_dir):
    try:
        from tensorboardX import SummaryWriter  # type: ignore
        return SummaryWriter(log_dir=str(log_dir))
    except Exception:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter  # type: ignore
        return SummaryWriter(log_dir=str(log_dir))
    except Exception:
        return None


class MetricsWriter:
    """Append-only scalar stream: `write(step, scalars, prefix="train/")`
    adds one line {"step": step, prefix + key: value, ...} of the scalars
    that convert to float."""

    def __init__(self, log_dir, filename="metrics.jsonl", tensorboard=True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / filename
        self._f = open(self.path, "a", buffering=1)
        self._tb = _make_summary_writer(self.log_dir / "tensorboard") if tensorboard else None

    def write(self, step, scalars, prefix="train/"):
        row = {"step": int(step)}
        for k, v in scalars.items():
            try:
                row[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            # nuScenes' TP errors a class does not define are NaN: the jsonl
            # keeps them, TensorBoard (which warns on each) does not
            for k, v in row.items():
                if k != "step" and math.isfinite(v):
                    self._tb.add_scalar(k, v, int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
