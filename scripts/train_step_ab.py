"""A/B the eval frame and the train step of two checkouts on one CUDA card.

    git archive 5858305 | tar -x -C build/parent
    python3 scripts/train_step_ab.py parent=build/parent now=.

Each NAME=DIR is a checkout of the repo. In turns (every checkout, then
again in reverse order, so drift shows), a fresh process in DIR runs that
checkout's chip_smoke.py set-up, kernel phase, slice phase and training
phase exactly as its main() does, and stops before any later phase. The
frame, profiled-frame, train-timing and profiled-step lines it prints are
gathered into one JSON line per checkout and turn.
"""

import json
import subprocess
import sys

RUN = """
import subprocess, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from nerfnav_tpu_torch import kernels
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.manual_seed(0)
device = torch.device("cuda")
sizes = {"hw": 800, "grid": 128, "log2": 17, "frames": 3, "mlp_n": 32768, "rays": 4096}
card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip()
cs.log(card)
kernels.build_all()
cs.kernel_phase(device, sizes["mlp_n"], cs.Timer(device))
cs.slice_phase(device, sizes, card)
cs.training_phase(device, sizes, card)
"""
KEEP = ("frame:", "profiled frame:", "train timing:", "profiled train step:")


def run(name, path, turn):
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=path, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        sys.exit(f"{name} failed (turn {turn}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    out = {"name": name, "turn": turn, "card": lines[0]}
    for line in lines:
        for key in KEEP:
            if line.startswith(key):
                out[key.rstrip(":")] = json.loads(line[len(key):])
    print(json.dumps(out), flush=True)


def main():
    checkouts = [a.split("=", 1) for a in sys.argv[1:]]
    if not checkouts or any(len(c) != 2 for c in checkouts):
        sys.exit(__doc__)
    for turn, (name, path) in enumerate(checkouts + checkouts[::-1]):
        run(name, path, turn)


if __name__ == "__main__":
    main()
