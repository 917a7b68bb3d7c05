#!/usr/bin/env bash
# The PyTorch port's KITTI data path over a run longer than chip_smoke.py's
# phases 22-24, on one card: a synthetic KITTI root of N train and N val
# frames of 120000 points (datasets/kitti/synthetic.py) in a temporary
# directory, its infos and gt database, then for each loader worker count
# (4, then 0: the loader inside the training process) `train --data_root`
# for 2 epochs of fast_cpc.yaml at b16 and `evaluate` over the val split,
# each in a fresh process. Prints the card's name and power limit, and each
# run's train scans/s, eval scans/s and loader waits.
#
#   tools/port_kitti_data.sh [N] [OUT_DIR]
#
# N defaults to 256; OUT_DIR (default chiprun_out/kitti_data) gets one log a
# run. The root itself (about 1 GB at N = 256) lives under TMPDIR and goes
# at the end.
set -eu
n=${1:-256}
out=$(mkdir -p "${2:-chiprun_out/kitti_data}" && cd "${2:-chiprun_out/kitti_data}" && pwd)
root=$(mktemp -d)
trap 'rm -rf "$root"' EXIT
cfg=tools/cfgs/kitti_models/fast_cpc.yaml
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

t0=$(date +%s)
python -m tsm_det_pointcloud_tpu_torch.datasets.kitti.synthetic "$root/kitti" \
    --train "$n" --val "$n" > "$out/synthetic.log" 2>&1
python -m tsm_det_pointcloud_tpu_torch.datasets.kitti.kitti_dataset create_kitti_infos \
    tools/cfgs/dataset_configs/kitti_dataset.yaml "$root/kitti" > "$out/infos.log" 2>&1
echo "root of $n + $n frames and its infos: $(( $(date +%s) - t0 )) s"

for w in 4 0; do
  python -m tsm_det_pointcloud_tpu_torch.train --cfg_file "$cfg" --data_root "$root/kitti" \
      --epochs 2 --workers "$w" --output_dir "$root/out_w$w" > "$out/train_w$w.log" 2>&1
  python -m tsm_det_pointcloud_tpu_torch.evaluate --cfg_file "$cfg" --data_root "$root/kitti" \
      --workers "$w" --output_dir "$root/out_w$w" > "$out/eval_w$w.log" 2>&1
  echo "workers $w:"
  grep -h "train scans/s" "$out/train_w$w.log"
  grep -h "scans/s on" "$out/eval_w$w.log"
done
