"""A/B sources of the fused-MLP kernel on one CUDA card.

    git show d45cee1:nerfnav_tpu_torch/csrc/fused_mlp.cu > build/ab/pr1.cu
    python3 scripts/fused_mlp_ab.py pr1=build/ab/pr1.cu \\
        now=nerfnav_tpu_torch/csrc/fused_mlp.cu

Each NAME=SOURCE must export the port's C interface
(`nerfnav_fused_mlp_forward`). All are built at once with the port's nvcc
flags, and each build's ptxas register and spill lines are printed. Then,
in turns (every source, then again in reverse order, so drift shows), each
is loaded in place of the port's kernel, held against the plain version at
chip_smoke.py's main-path shapes (sigma and color, atol = rtol = 2e-2) and
timed with chip_smoke.py's Timer at N = 32,768 and 8 x N: one JSON line per
source and turn, in microseconds.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nerfnav_tpu_torch import kernels  # noqa: E402
from nerfnav_tpu_torch.ops import fused_mlp as fm  # noqa: E402


def build(sources):
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(out_dir / f"{name}.so"), src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lines = [l.strip() for l in log.splitlines()
                 if "registers" in l or "spill" in l or "Compiling entry" in l]
        print(f"built {name}:\n  " + "\n  ".join(lines), flush=True)
        lib = ctypes.CDLL(os.path.abspath(out_dir / f"{name}.so"))
        for fn, argtypes in kernels._SIGNATURES["fused_mlp"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("fused_mlp_ab: no CUDA card")
    sources = dict(arg.split("=", 1) for arg in sys.argv[1:])
    if not sources:
        sys.exit(__doc__)
    libs = build(sources)
    device = torch.device("cuda")
    timer = cs.Timer(device)
    gen = torch.Generator().manual_seed(3)
    cases = []
    for n in (32768, 8 * 32768):
        for shape, dims in cs.MLP_SHAPES.items():
            ws = [w.to(torch.bfloat16) for w in cs.mlp_weights(dims, gen, device)]
            x = torch.randn((n, dims[0]), generator=gen).to(device)
            cases.append((f"{shape}_{n}", x, ws, fm.fused_mlp_reference(x, ws)))
    names = list(libs)
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            kernels._loaded["fused_mlp"] = libs[name]
            row = {}
            for key, x, ws, want in cases:
                got = fm.fused_mlp(x, ws)
                if not torch.allclose(got, want, rtol=cs.MLP_TOL, atol=cs.MLP_TOL):
                    sys.exit(f"{name} {key}: max |kernel - plain| = "
                             f"{float((got - want).abs().max())}")
                row[key] = timer(lambda x=x, ws=ws: fm.fused_mlp(x, ws)) * 1e3
            print(json.dumps({"turn": turn, "source": name, "us": row}), flush=True)


if __name__ == "__main__":
    main()
