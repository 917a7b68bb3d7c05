"""Where K5's time goes on the card: each by-key conv backward of one
training step of the PyTorch port, recorded, then profiled alone
(torch.profiler, mean device time of each of its kernels over 5 calls).

    python tools/port_k5_breakdown.py [--cfg_file CFG] [--batch B] [--points N]

Defaults to the Waymo training cell (waymo_fast_cpc.yaml, b8 x 122880).
Prints the card, one line a call and the step's sums by part: the
inversion (`invert_kernel` and its memset), dW (`dw_kernel`, the slot sum),
df (`gemm_kernel<..., TableRows>`) and W^T's copy. Exits 1 if a call runs a
kernel that names no part.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the part of K5's call each of its kernels serves, by a piece of the
# kernel's name: the table's fill (a memset) and inversion, dW's kernel and
# its slot sum, df's gather-GEMM (K4's kernel on the table's rows), and the
# wrapper's copy of W^T
ROLES = (("invert", ("invert_kernel", "Memset")), ("dW", ("dw_kernel", "sum_slots_kernel")),
         ("df", ("TableRows",)), ("W^T copy", ("elementwise_kernel",)))


def role(name):
    """The part `name` serves; exits on a kernel that names no part or
    several, so that a renamed or added kernel cannot go uncounted."""
    parts = [r for r, keys in ROLES if any(k in name for k in keys)]
    if len(parts) != 1:
        sys.exit(f"K5's call ran a kernel that names {len(parts)} parts: {name}")
    return parts[0]


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from tsm_det_pointcloud_tpu_torch.infer import self_device_us
    from tsm_det_pointcloud_tpu_torch.ops import spconv
    from tsm_det_pointcloud_tpu_torch.runtime.train_state import train_step
    from tsm_det_pointcloud_tpu_torch.train import build_trainer, synth_train_batch

    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg_file", default=str(ROOT / "tools/cfgs/waymo_models/waymo_fast_cpc.yaml"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=122880)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this probe measures the card: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    _, model, opt = build_trainer(args.cfg_file, dev, seed=0, n_points=args.points,
                                  total_steps=2)
    meta = model.dataset_meta
    batch = synth_train_batch(args.batch, args.points, 0, dev, meta.point_cloud_range,
                              meta.num_point_features)
    rec = chip_smoke.record_kernels(("spconv_bykey_bwd",))
    train_step(model, opt, batch)
    torch.cuda.synchronize()
    rec.restore()
    del model, opt, batch
    torch.cuda.empty_cache()

    reps = 5
    step = {}
    for i, call in enumerate(rec.calls["spconv_bykey_bwd"]):
        spconv.gather_matmul_bykey_bwd(*call)   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                spconv.gather_matmul_bykey_bwd(*call)
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and self_device_us(e) > 0:
                r = role(e.key)
                per[r] = per.get(r, 0.0) + self_device_us(e) / reps / 1e3
        for r, ms in per.items():
            step[r] = step.get(r, 0.0) + ms
        f, _, _, w = call[:4]
        print(f"call {i}: f {tuple(f.shape)} w {tuple(w.shape)}: "
              + ", ".join(f"{r} {ms:.4f} ms" for r, ms in sorted(per.items())))
    print("a step: " + ", ".join(f"{r} {ms:.4f} ms" for r, ms in sorted(step.items()))
          + f"; all {sum(step.values()):.4f} ms")


if __name__ == "__main__":
    main()
