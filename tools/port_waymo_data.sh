#!/usr/bin/env bash
# The PyTorch port's Waymo data path over a run longer than chip_smoke.py's
# phases 25-27, on one card: a synthetic Waymo root of raw tfrecords, S train
# and S val sequences of 8 frames (datasets/waymo/synthetic.py, ~195k points
# a frame) in a temporary directory, `create_waymo_infos` with 8 processes,
# then for each loader worker count (4, then 0: the loader inside the
# training process) `train --data_root` for 2 epochs of waymo_fast_cpc.yaml
# at b8 (120000 points a scan; SAMPLED_INTERVAL.train cut from 5 to 1, so
# that every train frame is a sample) and `evaluate` over the val split (b8,
# 163840 points a scan), each in a fresh process. Prints the card's name and
# power limit, and each run's train scans/s, eval scans/s and loader waits.
#
#   tools/port_waymo_data.sh [S] [OUT_DIR]
#
# S defaults to 8 (64 + 64 frames); OUT_DIR (default chiprun_out/waymo_data)
# gets one log a run. The root itself (about 0.6 GB at S = 8) lives under
# TMPDIR and goes at the end.
set -eu
s=${1:-8}
out=$(mkdir -p "${2:-chiprun_out/waymo_data}" && cd "${2:-chiprun_out/waymo_data}" && pwd)
root=$(mktemp -d)
trap 'rm -rf "$root"' EXIT
cfg=tools/cfgs/waymo_models/waymo_fast_cpc.yaml
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

t0=$(date +%s)
python -m tsm_det_pointcloud_tpu_torch.datasets.waymo.synthetic "$root/waymo" \
    --train "$s" --val "$s" --frames 8 --workers 8 > "$out/synthetic.log" 2>&1
python -m tsm_det_pointcloud_tpu_torch.datasets.waymo.waymo_dataset create_waymo_infos \
    tools/cfgs/dataset_configs/waymo_dataset.yaml "$root/waymo" 8 > "$out/infos.log" 2>&1
echo "root of $s + $s sequences of 8 frames and its infos: $(( $(date +%s) - t0 )) s"

for w in 4 0; do
  python -m tsm_det_pointcloud_tpu_torch.train --cfg_file "$cfg" --data_root "$root/waymo" \
      --epochs 2 --workers "$w" --output_dir "$root/out_w$w" \
      --set DATA_CONFIG.SAMPLED_INTERVAL.train 1 > "$out/train_w$w.log" 2>&1
  python -m tsm_det_pointcloud_tpu_torch.evaluate --cfg_file "$cfg" --data_root "$root/waymo" \
      --workers "$w" --output_dir "$root/out_w$w" > "$out/eval_w$w.log" 2>&1
  echo "workers $w:"
  grep -h "train scans/s" "$out/train_w$w.log"
  grep -h "scans/s on" "$out/eval_w$w.log"
done
