#!/bin/bash
# Interactive training + web viewer with nerfnav_tpu_torch on a CUDA card
# (reference scripts/run_gui_nerf.sh; the dearpygui desktop window becomes a
# local web viewer on 127.0.0.1:7860 — forward the port over SSH when the
# card's host is remote). The flags of scripts/run_gui_nerf.sh.
# Usage: scripts/run_gui_nerf_torch.sh <data_path> [workspace]
DATA=${1:-data/nerf_synthetic/lego}
WS=${2:-trial_nerf_gui}
python -m nerfnav_tpu_torch.cli.main_nerf "$DATA" --workspace "$WS" -O \
    --bound 1.0 --scale 0.8 --dt_gamma 0 --gui
