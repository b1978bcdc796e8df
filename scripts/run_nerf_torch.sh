#!/bin/bash
# Instant-NGP training on a transforms.json scene with nerfnav_tpu_torch on a
# CUDA card; the flags of scripts/run_nerf.sh (reference scripts/run_nerf.sh).
# Usage: scripts/run_nerf_torch.sh <data_path> [workspace]
DATA=${1:-data/nerf_synthetic/lego}
WS=${2:-trial_nerf}
python -m nerfnav_tpu_torch.cli.main_nerf "$DATA" --workspace "$WS" -O \
    --bound 1.0 --scale 0.8 --dt_gamma 0
