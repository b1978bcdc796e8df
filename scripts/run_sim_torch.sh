#!/bin/bash
# Full navigation loop on a trained scene with nerfnav_tpu_torch on a CUDA card
# (reference README "Simulating"): plan -> act -> observe -> estimate ->
# replan. Stonehenge defaults; the flags of scripts/run_sim.sh.
# Usage: scripts/run_sim_torch.sh <data_path> [workspace]
DATA=${1:-data/stonehenge}
WS=${2:-trial_sim}
python -m nerfnav_tpu_torch.cli.simulate "$DATA" --workspace "$WS" -O \
    --bound 2.0 --scale 1.0 --dt_gamma 0
