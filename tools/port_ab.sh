#!/usr/bin/env bash
# Alternating end-to-end A/B of two checkouts of the PyTorch port on one
# card: each round runs chip_smoke.py (all five paths: KITTI eval / train,
# Waymo eval / train, SECOND eval, with their peak device memory), then the
# Waymo eval and training entry points, each in a fresh process, the parent
# and the change in turns P C C P, so that drift over the run falls on both.
#
#   tools/port_ab.sh PARENT_DIR CHANGE_DIR [OUT_DIR]
#
# PARENT_DIR and CHANGE_DIR are checkouts (e.g. a `git archive` of each
# commit unpacked into a directory that .gitignore lists); each builds its
# own kernels. Logs go to OUT_DIR (default chiprun_out/ab), one a run, and
# the scans/s and peak-memory lines of every run are printed at the end.
set -u
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
out=$(mkdir -p "${3:-chiprun_out/ab}" && cd "${3:-chiprun_out/ab}" && pwd)
waymo=(--cfg_file tools/cfgs/waymo_models/waymo_fast_cpc.yaml --batch 8 --points 122880)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

run() {  # run LABEL DIR WHAT: one fresh process of WHAT in DIR
  local log="$out/$1_$3.log" t0
  t0=$(date +%s)
  case $3 in
    smoke) (cd "$2" && python3 chip_smoke.py) > "$log" 2>&1 ;;
    infer) (cd "$2" && python -m tsm_det_pointcloud_tpu_torch.infer "${waymo[@]}" --iters 10) \
             > "$log" 2>&1 ;;
    train) (cd "$2" && python -m tsm_det_pointcloud_tpu_torch.train "${waymo[@]}" --steps 6) \
             > "$log" 2>&1 ;;
  esac
  echo "$1 $3 rc $? in $(( $(date +%s) - t0 )) s"
}

for what in smoke infer train; do
  run P1 "$parent" $what
  run C1 "$change" $what
  run C2 "$change" $what
  run P2 "$parent" $what
done
for log in "$out"/*.log; do
  echo "== $(basename "$log")"
  grep -E "scans/s|peak memory|GiB" "$log" | grep -v "^  "
done
