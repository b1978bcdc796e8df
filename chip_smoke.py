"""Chip smoke test of nerfnav_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes on the CPU, plain versions
    python3 chip_smoke.py --kernels-only   # set-up and kernel phase, then exit

1. Set-up: prints the card's name and power limit (nvidia-smi) and builds
   every CUDA kernel of the port from csrc/ (one nvcc per source, started
   together).
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes (the eval round's, a grid train step's and a
   dense train step's, 4096 rays x 512 samples; the background net's
   24-64-3 at one 4096-ray chunk and one ragged N; the sigma net at save_mesh's
   2^16-point chunk with f32 weights), ragged ones and the edges
   of the kernel's contract (fused MLP: atol = rtol = 2e-2, the bound
   tests/test_fused_mlp.py uses; hidden activations are re-rounded to bf16, so a different f32
   summation order can move one by a bf16 step), then timed with CUDA events
   beside the plain version and a library call, at the main path's N and at
   8 x N, the background net's at N = 4096 and the sigma net's at save_mesh's
   N = 2^16 (f32 weights, cast per call). Then the hash-grid encode
   (csrc/hashgrid.cu) against the plain encode at the benchmark's grid
   (16 x 2 at 2^19), forward and table gradient, at a dense step's N and
   the grid budget's largest (196,608), the backward alone on a graph built
   once, each timed beside the plain version by CUDA events and by the
   device time of its kernels under the profiler, with its byte bound (the
   log line also gives the time its corner rows would take from HBM). The
   kernels line's hashgrid entry adds the kernel's launches on each main
   path below (frame, train step, sweep, nav: 0, quickstart). With
   --kernels-only the
   script stops here, with no result line.
   Then the cascade check (C2): at every float32 x in [1, 64] (the cascades
   from dt of any bound up to 64; the port's configs use bound <= 2), the
   march's cascade choice on this device against the CPU: the raw
   ceil(log2(x)) and ops/marching.py::mip_level itself (pos 0, dt = x / 64
   as a tensor). Prints each count and its first values, and where the
   CPU's float32 log2 misses the exact exponent; any mip_level disagreement
   fails the run.
3. Slice phase: the -O --ff eval render, Trainer.render_full of one 800x800
   frame of the flagship field (cell hash grid 4x8 @ 2^17, fused MLPs,
   bound 2, K 32, bf16 tables, AUTO beam) over the synthetic shell + floor
   occupancy of bench.py, from random weights (seed 0), in bench.py's
   on-axis framing. Checks a finite image with 0 < mean < 1 and that the
   main path launched every kernel; times warm frames and profiles one.
   Then, on a side view of the field at density_scale 30 (translucent, so
   chunks shade several rounds and compacted ones): re-renders the chunk
   that shades the most rounds with the plain MLP, and renders a 64x64 crop
   there on the CPU port and on the card and compares them.
4. Training phase: the -O --ff training path (cell hash grid 4x8 @ 2^17,
   fused MLPs, bf16 MLP compute, bound 2, grid 128, K 64, 16 segments with
   3 anchors, 4096 rays a step) from a fresh Trainer (seed 0) on four
   800x800 target frames made from the seed. Trainer.train runs 48 steps
   (occupancy sweeps at steps 0, 16 and 32, the point budget picked from the
   mean count); the losses must be finite and fall, the fused kernel must
   launch in the steps and in the sweeps, the trained occupancy must be
   partly occupied and a 64x64 crop of the trained field finite. On one step
   from the same state and draws: the gradients with the kernel against
   those with the plain MLP (GRAD_TOL, relative L2 per param tensor); one
   step at the CPU tests' size with the xla fp32 field on the card against
   the CPU port (loss 1e-5, gradients 1e-4 relative L2). A checkpoint
   written and loaded into a new Trainer renders the same crop (1e-6).
   Times 32 warm steps, one full and one partial sweep, and profiles one
   step. Its checkpoint (EMA params + occupancy) is kept for phase 5.
5. Nav phase, the nav stack at full width (nav runs the xla MLP chain, so
   the fused kernel must launch 0 times here):
   (a) the closed-loop mission of `simulate --analytic` (textured sphere,
       bound 1) through cli/simulate.py's build_mission and simulate:
       800x800 observations at focal 800, 128 dense samples, GN filter at
       batch 1024 / Jacobian batch 256 / 15 LM iterations / pool 16,384,
       planner T = 20 at dt 0.1 with the 10x10x5 body cloud, native A* on
       100^3 pooled to 20^3 at 0.3, 250-epoch replans, FusedMPC ticks. Cut
       in depth: learn_init 500 epochs (of 2500) and 6 of the 20 steps (5
       closed loop, 1 open loop). Start and goal are simulate.py's turned 90
       degrees about the vertical, so the camera (body +x) faces the sphere.
       The filter starts NAV_X0_ERR (4 cm, 1.5 degrees) off the true start.
       Checks: A* finds a path on the native build, the learn_init loss
       falls, the plan stays outside the sphere, every estimate is finite
       within NAV_SIZES' pos_err of the truth, the first update keeps less
       than half of the initial position and rotation error (a filter that
       returned its prediction would keep all of it), and tick 1 equals the
       unfused sequence (estimate_state, update_state, learn_update,
       get_next_action) from the same state and draws, at
       tests/test_nav_fused.py's tolerances. Prints each tick's position
       and rotation error beside its prediction's, the native A*'s first
       call (g++ build and load), A* and learn_init ms,
       every tick's ms and front-end ms, each fused tick's filter and
       replan ms from CUDA events around them (not on ticks 2 and 3),
       tick 1's front end / filter / replan split on the unfused sequence
       (host clock), a card-only profile of tick 2 (kernels, idle share,
       top kernels) and tick 3's host syncs by call site.
   (a') one Agent.step with backend="blender" through a stand-in for
       Blender that the script writes under build/ (its shebang this
       Python, which has cv2): it reads pose.json and writes an RGBA PNG
       whose pixels depend on the pose. The observation must equal the PNG
       composited on white; the step's state, this device against the CPU
       port's agent, within 1e-5; get_img at one fixed pose the same uint8
       image on both.
   (b) the trained flagship field loaded as cli/simulate.py loads a trainer
       checkpoint (`-O`: cell 4x8 @ 2^17, xla bf16 MLPs, bound 2): an
       800x800 observation from the training orbit; the filter's dense,
       frozen and grid renders at the true pose and at the update's start
       (the dense one must reproduce the observation within NAV_TRUTH_MSE;
       the frozen lattice must shade as the grid render does, 1e-5); the
       residual Jacobian at full width on the filter's Jacobian batch, the
       card against the CPU port loaded from the same checkpoint, with the
       nav path's bf16 MLPs and with float32 MLPs (NAV_JAC_BF16_TOL,
       NAV_JAC_F32_TOL); one GN update on the
       dense path and one on the frozen path (the march on the trained
       occupancy), each with its position and rotation error; one
       250-epoch replan from straight-line waypoints (no A*: a 48-step
       field guarantees no free path). Checks also: finite, the LM loss
       never rises, the replan loss falls; then one GN update at the CPU
       tests' size on the card against the CPU port (x 1e-4, the posterior
       covariance 1e-3, relative to their largest entry).
   The filter's keypoints need cv2: the nav phase fails early without it.
6. Reference phase, the reference-exact configuration through
   cli/main_nerf.py at full width (corner hash grid 16x2 @ 2^19, vertex
   convention, sigma 32-64-16 and color 31-64-64-3 fused MLPs, f32 masters,
   bound 1, 4096 rays): make_synthetic_scene writes 8 train and 2 val views
   of the analytic sphere at 800x800 (seed REF_SCENE_SEED) under build/.
   First the hash grid at bound 1.5 on 2^16 points next to cell faces, the
   card against the CPU port (every cell equal, features 1e-6). The grid run
   (`--cuda_ray --ff`, the default dt_gamma 1/128: the static gamma ladder)
   trains REF_SIZES' steps through main_nerf.main and must gain
   REF_PSNR_GAIN dB of val PSNR over the untrained field; its eval march of
   a 64x64 crop, card against CPU from the same rays, keeps equal valid
   rows on REF_MARCH_RAYS_EQUAL of the rays and z / dt within
   REF_MARCH_ZDT_TOL, the crop's image within 5e-3; `--test` then writes
   the frames, depth maps and the video (or logs why not). The dense run
   (`--ff`, 512 samples a ray) trains a few steps through the CLI's Trainer
   (the loss of one fixed batch must fall), one dense step at 256 rays with
   xla fp32 MLPs is held card against CPU on three batches (loss 1e-5,
   gradients 1e-4; the first batch runs twice on the card), and
   `--test` writes its frames. Each run must launch the fused kernel.
   Prints both paths' ms per step (with a profiled step's idle share) and
   per 800x800 frame, their fused launches per step and per frame, and the
   phase-A candidates per ray of the gamma ladder and the dt_gamma=0 one.
7. Background phase, the background network for unbounded scenes through
   cli/main_nerf.py at full width (`--cuda_ray --ff --bg_radius 32
   --grid_coord_convention ngp`: the reference-exact network on torch-ngp's
   lattice, f32 masters, bound 1, 4096 rays, grid 128, dt_gamma 1/128, and
   the bg net's 2-D grid 4x2 @ 2^19 with its 24-64-3 fused MLP). The script
   writes its own RGB scene under build/ (the analytic sphere in front of an
   analytic sky painted on the radius-32 sphere, 8 train and 1 val views at
   800x800); main_nerf.main trains 200 steps. Checks: the val PSNR gains
   BG_PSNR_GAIN dB over the untrained field and beats the same render with
   the bg net swapped for white by BG_WHITE_GAIN dB; 3 fused launches a
   step, 1 of them the bg net's; card vs CPU from CPU-made rays:
   sph_from_ray (1e-6 where |z| / R <= 0.9; nearer a pole, whose
   coordinates are ill-conditioned in float32, 16 ulps of the acos and atan2
   inputs times their slopes), the bg grid's features and the bg net's colour
   (1e-5), one dense step with the bg net at 256 rays with xla fp32 MLPs
   (loss 1e-5, gradients 1e-4); the trained checkpoint out through
   scripts/export_torch_ckpt.py and back through scripts/import_torch_ckpt.py
   (params bit-equal, bitfields and blocks equal, a 64x64 crop within 1e-6).
   Prints step ms (with a profiled step's idle share), the 800x800 frame's
   ms, the fused and bg launches per step and per frame, the phase's s.
8. Options phase, the remaining march and occupancy options and the mesh
   export, on the training phase's trained field in the flagship eval
   configuration (cell 4x8 @ 2^17, fused MLPs, bound 2, grid 128, K 32,
   bf16 tables, AUTO beam) at 800x800 from yaw 0: one timed and one
   profiled frame for each of OPT_SETTINGS (the rounds render, first_k,
   proxy, both, a0_segments 6, eval_frame_phase_a), each finite with 0 <
   mean < 1, through the block marcher, launching the fused kernel, with
   its ms, shaded rounds, fused launches and PSNR against the baseline
   frame. Checks: the frame-level phase A renders the baseline image bit for
   bit, and each chunk's march from it equals the chunk's own march; on a
   central 64x64 crop from CPU-made rays, the march under first_k, proxy,
   a0 and a depth window card against CPU port (the reference phase's bars,
   the crop's image within 5e-3), the byte two-phase and single-phase
   marchers with the block tables stripped (valid masks equal) and
   march_segments; a whole frame on the byte bitfields, timed;
   autotune_march_shape on 4096 rays with 3 candidates returns one of them;
   occ_debounce, two sweeps card against CPU (bitfield, blocks, pending
   equal); save_mesh at 256^3 writes a PLY with faces in 256 fused launches,
   and extract_geometry at 64^3 with xla fp32 MLPs card against CPU (equal
   counts, vertices within 1e-4). Prints the frame's eval march by stage
   (stop_after "phase_a" and "phase_b_occ") and the phase's s.
9. Training-options phase, the remaining training paths (budget ~90 s):
   (a) data parallel: a one-rank mesh (parallel.make_mesh over an NCCL
       process group with a file:// store under build/; gloo in the
       rehearsal) trains the -O --ff configuration MESH_STEPS steps beside a
       plain trainer from the same state and draws, both in torch's
       deterministic mode; params and a 64x64 crop of render_full within
       MESH_TOL; fused launches per mesh step and per sharded sweep; step ms
       of both; then one step at the CPU tests' size packed in GROUPS blocks
       (sample_groups) card vs CPU at the bars above.
   (b) CLIP: a tower at openai/clip-vit-base-patch16's widths (hidden 768,
       12 layers, 12 heads, patch 16, image 224, projection 512) with seeded
       weights, written as an .npz under Hugging Face's key names and loaded
       by make_clip_loss_fn with a seeded text embedding, card vs CPU on one
       image (TOWER_TOL, relative L2); one poseless step's loss and gradients
       card vs CPU at the CPU tests' size (loss 1e-5, gradients 1e-4) and
       kernel vs plain MLP on the trained field (loss 2e-2, GRAD_TOL);
       rand_pose 0 on the training phase's trained
       field CLIP_STEPS steps at 800x800 / 4096 rays (64x64 frames): finite
       losses whose last 5 average below the first, the fused kernel launched
       in every poseless step; rand_pose 3 HYBRID_STEPS steps, both kinds
       taken; ms of a poseless step and of the tower forward and backward.
   (c) LPIPS: LPIPSMeter at AlexNet widths with seeded weights on two
       800x800 frames, card vs CPU (TOWER_TOL) and LPIPS(x, x) = 0.
   (d) profiling: utils/profiling.device_timer around a 256x256 frame and a
       trace of one poseless step written, with fused-MLP kernels in it.
10. Viewer phase, the interactive viewer (gui/viewer.py) at the full width
   of `main_nerf --gui`: the defaults of cli/flags.py (1920x1080, radius 5,
   fovy 50, max_spp 64; the rehearsal's 96x64), on the training phase's
   trained field (its full checkpoint, loaded into the -O --ff training
   configuration) and its four 800x800 targets:
   (3) first, Trainer.test_gui at 64x64, downscale 0.5, a crop box and a
       Halton offset on this device against the CPU port loaded from the
       same checkpoint (the slice phase's crop bar);
   (1) VIEW_CHUNKS train chunks through NeRFGUI.train_step (the first of
       16 steps, then as the 500 ms budget sizes them): finite losses, 2
       fused launches a step (the sweeps' counted apart), steps/s and the
       next chunk's steps;
   (2) from a fresh camera, render_frame's passes: the fast pass at 0.25
       (480x270), the refinements at 0.5 and 1.0, one Halton-jittered pass
       at 1920x1080, each (1080, 1920, 3), finite, 0 < mean < 1, launching
       the fused kernel, with its ms and launches and the downscale the
       200 ms budget picks after the fast pass; the jittered pass must equal
       (previous + jittered render) / 2; one profiled fast pass (idle share);
   (4) NeRFGUI.serve on a free port of 127.0.0.1 in a thread: GET /, POST
       /orbit and GET /frame (a JPEG decoding to the frame's shape), POST
       /set bg_color 0 and /frame, POST /set dt_gamma 1/128 and /frame (its
       train chunk must march at 1/128: the training march config cached at
       0 is dropped), POST /save_ckpt and POST /save_mesh (256^3 on the
       card: 256 fused launches, a PLY written); each request's round trip
       ms and bytes.
   matplotlib is not on the card's machine: nav/viz.py and render_viz are
   held by CPU tests only (tests/test_torch_viz.py), as are the dataset
   converters and the Blender scripts, which have no card path.
11. Quickstart phase: examples/quickstart_torch.py's main in this process at
   its defaults (QS_ARGS: the five stages of examples/quickstart.py at its
   widths and step counts, the -O --ff MLPs): the val PSNR must be finite,
   the orbit render 2 frames, the planner's loss must fall, and the fused
   kernel must launch in training and in the renders. Prints the seconds
   and the fused launches of each stage.
12. Prints one {"kernels": [...]} line and, last, {"ok": true, "device": ...}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

import argparse
import contextlib
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor cores, H100 SXM data sheet
MLP_TOL = 2e-2
ACTIVATIONS = ["relu", "none", "exp", "sigmoid", "sine", "squareplus", "softplus"]
MLP_SHAPES = {"sigma": [32, 64, 16], "color": [31, 64, 64, 3], "bg": [24, 64, 3]}
# the shapes one shaded eval round launches (the fused_mlp entry's times);
# the background net runs once per 4096-ray chunk or train step instead
ROUND_SHAPES = ("sigma", "color")
BG_N = 4096
MESH_N = 2**16      # extract_geometry's chunk of lattice points
# edges of the fused MLP's contract (1-8 layers, widths 1-256, any N):
# name -> (dims, rows); plus the color net at COLOR_EDGE_ROWS rows
MLP_EDGES = {"8x128": ([128] * 9, 1000), "3-256-256-1": ([3, 256, 256, 1], 1000),
             "1-16-1": ([1, 16, 1], 1000)}
COLOR_EDGE_ROWS = (1, 127, 128, 129, 8192, 32768)
TRAIN_STEPS = 48    # sweeps at steps 0, 16 and 32
NAV_WS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_nav")
TIMED_STEPS = 32
# the gradients of one step with the kernel against those with the plain
# MLP, relative L2 norm per param tensor: the plain MLP differentiates in
# f32 where the kernel's backward rounds every dh and dW to bf16 (a bf16
# step is 2^-8 = 0.4%); tests/test_torch_train.py holds the fused step
# against JAX within 2e-2 of each tensor's largest entry
GRAD_TOL = 2e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(*msg):
    print(*msg, flush=True)


class Timer:
    """Milliseconds per call. On the card: `iters` calls captured in one CUDA
    graph, whose replays are timed with CUDA events, so the number is device
    time and not the host's cost of issuing the calls. On the CPU: the host
    clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn, iters=20, reps=5):
        fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(iters * reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / (iters * reps)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up outside the capture
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * reps)


def mlp_weights(dims, gen, device, scale=None):
    """torch.nn.Linear-style init (or a fixed scale), (in, out) layout."""
    ws = []
    for a, b in zip(dims[:-1], dims[1:]):
        lim = scale if scale is not None else 1.0 / math.sqrt(a)
        ws.append((torch.rand((a, b), generator=gen) * 2 * lim - lim).to(device))
    return ws


def mlp_bound_ms(n, dims, f32=False):
    """Least time for one fused-MLP call: f32 input and output once, the
    weights once (bf16, or f32 with f32=True), against the dense bf16 peak."""
    bytes_ = n * (dims[0] + dims[-1]) * 4 + sum(
        a * b * (4 if f32 else 2) for a, b in zip(dims[:-1], dims[1:]))
    flops = 2 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(device, n_full, n_dense, timer):
    """Fused MLP vs its plain version; returns the kernels-line entry fields."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(1)
    max_err = 0.0

    def compare(x, ws, act, out_act, what):
        nonlocal max_err
        got = fm.fused_mlp(x, ws, act, out_act)
        want = fm.fused_mlp_reference(x, ws, act, out_act)
        check(got.shape == want.shape and got.dtype == torch.float32,
              f"{what}: shape {tuple(got.shape)} dtype {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        ok = bool(torch.allclose(got, want, rtol=MLP_TOL, atol=MLP_TOL))
        check(ok, f"{what}: max |kernel - plain| = {err}")
        max_err = max(max_err, err)

    # a full round (chunk x 8 samples), a compacted one (a quarter of the
    # chunk's rays), and ragged sizes
    for name, dims in MLP_SHAPES.items():
        ws = mlp_weights(dims, gen, device)
        for n in (n_full, n_full // 4, 1, 1000, 1025):
            x = torch.randn((n, dims[0]), generator=gen).to(device)
            compare(x, ws, "relu", "none", f"{name} N={n}")
        # a dense train step's N (4096 rays x 64 samples at full size), with
        # the f32 master weights the step passes
        x = torch.randn((8 * n_full, dims[0]), generator=gen).to(device)
        compare(x, ws, "relu", "none", f"{name} N={8 * n_full}, f32 weights")
        # a dense step's N (4096 rays x 512 samples at full size)
        x = torch.randn((n_dense, dims[0]), generator=gen).to(device)
        compare(x, ws, "relu", "none", f"{name} N={n_dense} (dense step), f32 weights")
    # save_mesh's chunk of 2^16 lattice points through the sigma net, with
    # the f32 EMA weights it passes
    dims = MLP_SHAPES["sigma"]
    ws = mlp_weights(dims, gen, device)
    x = torch.randn((MESH_N, dims[0]), generator=gen).to(device)
    compare(x, ws, "relu", "none", f"sigma N={MESH_N} (mesh chunk), f32 weights")
    # the background net's N: one 4096-ray chunk or train step, and a ragged
    # one, with the bf16 weights of the eval cast and the f32 masters
    dims = MLP_SHAPES["bg"]
    ws = mlp_weights(dims, gen, device)
    for n in (BG_N, BG_N + 1):
        x = torch.randn((n, dims[0]), generator=gen).to(device)
        compare(x, ws, "relu", "none", f"bg N={n}, f32 weights")
        compare(x, [w.to(torch.bfloat16) for w in ws], "relu", "none", f"bg N={n}, bf16 weights")
    # the contract's edges: depth, width, narrow nets, ragged tiles, and x
    # that starts one row (124 bytes) into its buffer
    for name, (dims, n) in MLP_EDGES.items():
        ws = mlp_weights(dims, gen, device)
        x = torch.randn((n, dims[0]), generator=gen).to(device)
        compare(x, ws, "relu", "none", f"{name} N={n}")
    dims = MLP_SHAPES["color"]
    ws = mlp_weights(dims, gen, device)
    for n in COLOR_EDGE_ROWS:
        x = torch.randn((n, dims[0]), generator=gen).to(device)
        compare(x, ws, "relu", "none", f"color N={n}")
    buf = torch.randn((1001, dims[0]), generator=gen).to(device)
    compare(buf[1:], ws, "relu", "none", "color, x one row into its buffer")
    dims = MLP_SHAPES["color"]
    ws = mlp_weights(dims, gen, device, scale=0.05)
    x = torch.randn((4096, dims[0]), generator=gen).to(device)
    for act in ACTIVATIONS:
        compare(x, ws, act, act, f"activation {act}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"kernel phase: fused_mlp matches its plain version, max |err| = {max_err:.3g}")

    # one shaded round of a full chunk launches the sigma and the color MLP
    # at N = chunk x round width; time that pair there, and at 8 x N, where
    # the launch and the first loads no longer dominate
    per_shape = time_shapes(n_full, gen, device, timer)
    big = time_shapes(8 * n_full, gen, device, timer)
    bg = time_shapes(BG_N, gen, device, timer, ("bg",))["bg"]
    mesh = time_shapes(MESH_N, gen, device, timer, ("sigma",), f32=True)["sigma"]
    for n, shapes in ((n_full, per_shape), (8 * n_full, big), (BG_N, {"bg": bg}),
                      (MESH_N, {"sigma, f32 weights (save_mesh)": mesh})):
        log("fused_mlp per shape at N =", n, json.dumps(shapes))
    total = {k: sum(v[k] for v in per_shape.values())
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bound_by = {mlp_bound_ms(n_full, MLP_SHAPES[k])[1] for k in ROUND_SHAPES}
    return {**total, "max_abs_err": max_err,
            "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
            **{f"bg_{k}": bg[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "bg_bound_by": mlp_bound_ms(BG_N, MLP_SHAPES["bg"])[1],
            **{f"mesh_{k}": mesh[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "mesh_bound_by": mlp_bound_ms(MESH_N, MLP_SHAPES["sigma"], f32=True)[1]}


def time_shapes(n, gen, device, timer, names=ROUND_SHAPES, f32=False):
    """Kernel, plain version and bf16 torch.matmul chain at N = n rows for
    each named shape; with the bound and the kernel's share of it. The
    kernel gets bf16 weights, as Trainer._cast_eval_tables hands them over,
    or with f32=True the f32 masters (save_mesh's EMA params), which it
    casts per call; the chain gets bf16 ones."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    out = {}
    for name in names:
        dims = MLP_SHAPES[name]
        ws = mlp_weights(dims, gen, device)
        wk = ws if f32 else [w.to(torch.bfloat16) for w in ws]
        wb = [w.to(torch.bfloat16) for w in ws]
        x = torch.randn((n, dims[0]), generator=gen).to(device)

        def library(x=x, wb=wb):
            h = x.to(torch.bfloat16)
            for i, w in enumerate(wb):
                h = h @ w
                if i < len(wb) - 1:
                    h = torch.relu(h)
            return h.float()

        t = {"ms": timer(lambda x=x, wk=wk: fm.fused_mlp(x, wk)),
             "plain_ms": timer(lambda x=x, wk=wk: fm.fused_mlp_reference(x, wk)),
             "library_ms": timer(library),
             "bound_ms": mlp_bound_ms(n, dims, f32=f32)[0]}
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        out[name] = t
    return out


# the benchmark's hash grid (16 levels x 2 features at 2^19 rows, 16 to 2048)
ENCODE_GRID = dict(num_levels=16, level_dim=2, base_resolution=16, log2_hashmap_size=19,
                   desired_resolution=2048)
ENCODE_FWD_TOL = 1e-6   # tests/test_torch_hashgrid_kernel.py's, of the largest entry
ENCODE_GRAD_TOL = 1e-5


def encode_bound_ms(n, cfg):
    """(least ms, sector ms) of one encode call, forward or table gradient,
    at HBM bandwidth. Least: x and the features (or their gradient) once and
    the f32 tables (or their gradient) once. Sector: x and the features, and
    one 32-byte sector (or the row, if wider) per corner row gathered or
    added to: the time if every corner row came from HBM and none from L2."""
    corner_rows = n * cfg.num_levels * (1 if cfg.layout == "cell" else 2**cfg.input_dim)
    io = n * (cfg.input_dim + cfg.output_dim) * 4
    least = io + cfg.total_params * cfg.row_dim * 4
    sector = io + corner_rows * max(32, cfg.row_dim * 4)
    return least / H100_BYTES_PER_S * 1e3, sector / H100_BYTES_PER_S * 1e3


def event_ms(fn, device, iters=10):
    """ms per call of fn between CUDA events around `iters` calls after a
    warm one: what a caller waits, host gaps included (the host clock on the
    CPU)."""
    fn()
    if device.type != "cuda":
        return timed_ms(fn, device, iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def busy_ms(fn, device, iters=3):
    """Device ms per call of fn: the summed durations of its kernels under
    torch.profiler over `iters` calls after a warm one, without the host's
    gaps between them (None on the CPU, or if the profiler saw no kernel)."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    return ns / 1e6 / iters if ns else None


def encode_phase(device, n_dense, n_grid):
    """The hash-grid kernels against the plain encode, forward and table
    gradient, at the benchmark's grid and a dense step's N and the grid
    budget's largest fraction. Each is timed beside the plain version by
    CUDA events (`*_ms`) and by its kernels' device time (`*_busy_ms`); the
    backward alone, on a graph built once. Returns the kernels-line entry
    fields: what was measured, and the byte bound."""
    from dataclasses import replace

    from nerfnav_tpu_torch.ops import hashgrid as hg

    cfg = hg.HashGridConfig(**ENCODE_GRID)
    plain = replace(cfg, backend="xla")
    gen = torch.Generator().manual_seed(2)
    tables = [(torch.rand((s, cfg.row_dim), generator=gen) * 2e-4 - 1e-4).to(device)
              for s in cfg.level_sizes]
    per_call = 2 if device.type == "cuda" else 0
    out = {}
    for what, n in (("dense", n_dense), ("grid", n_grid)):
        x = (torch.rand((n, 3), generator=gen) * 2 - 1).to(device)
        g = torch.randn((n, cfg.output_dim), generator=gen).to(device)
        ts = [t.clone().requires_grad_() for t in tables]
        before = hg.hash_grid_encode.launches
        got = hg.hash_grid_encode(ts, x, cfg)
        dk = torch.autograd.grad(got, ts, g)
        check(hg.hash_grid_encode.launches == before + per_call,
              f"encode {what}: {hg.hash_grid_encode.launches - before} launches, "
              f"{per_call} expected")
        want = hg.hash_grid_encode(ts, x, plain)
        dp = torch.autograd.grad(want, ts, g)
        fwd_err = float((got - want).abs().max() / want.abs().max())
        grad_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(dk, dp))
        check(fwd_err <= ENCODE_FWD_TOL, f"encode {what}: forward {fwd_err:.3g} of the largest")
        check(grad_err <= ENCODE_GRAD_TOL,
              f"encode {what}: table gradient {grad_err:.3g} of the largest")
        del got, want, dk, dp
        t = {"n": n, "fwd_err": fwd_err, "grad_err": grad_err}
        for name, c, iters in (("", cfg, 10), ("plain_", plain, 3)):
            def fwd(c=c):
                return hg.hash_grid_encode(tables, x, c)

            t[f"{name}ms"] = event_ms(fwd, device, iters)
            t[f"{name}busy_ms"] = busy_ms(fwd, device)
            # the table gradient alone, through one graph kept for every call
            y = hg.hash_grid_encode(ts, x, c)

            def bwd(y=y):
                return torch.autograd.grad(y, ts, g, retain_graph=True)

            t[f"{name}bwd_ms"] = event_ms(bwd, device, iters)
            t[f"{name}bwd_busy_ms"] = busy_ms(bwd, device)
            del y, bwd
        bound, sector = encode_bound_ms(n, cfg)
        t["bound_ms"] = bound
        out[what] = t
        log(f"hash-grid encode at N = {n} ({what}): {json.dumps(t)}; all-from-HBM "
            f"sector_ms {sector:.4f}, bound_ms / ms {bound / t['ms']:.3f}")
    return out


# the hash-grid kernel launches of each main path chip_smoke.py drives (the
# hashgrid entry of the kernels line): filled by the phases
GRID_LAUNCHES = {}


# [1, 2^6]: the cascades from dt of every bound up to 64 (7 cascades); the
# port's configs use bound <= 2 (2 cascades, [1, 2])
C2_OCTAVES = 6
C2_SHOW = 5


def cascade_phase(device, octaves=C2_OCTAVES):
    """C2: the cascade the march picks from dt, this device against the CPU,
    at every float32 x = dt * grid_size * 0.5 in [1, 2^octaves]: the raw
    `ceil(log2(x))`, and `ops/marching.py::mip_level` itself (pos at 0, dt
    a tensor), which must agree everywhere. Also counts where the CPU's
    float32 `log2` loses the exact answer (the exponent, from frexp)."""
    from nerfnav_tpu_torch.ops.marching import MarchConfig, mip_level

    t0 = time.perf_counter()
    cfg = MarchConfig(bound=2.0**octaves, grid_size=128)
    check(cfg.cascades == octaves + 1, f"cascades {cfg.cascades}")
    to_dt = 2.0 / cfg.grid_size  # a power of two: dt * grid_size * 0.5 is x again
    lo = int(np.float32(1.0).view(np.int32))
    hi = int(np.float32(2.0**octaves).view(np.int32))
    diff = {"log2": [], "mip_level": [], "cpu_vs_exact": []}
    n = 0
    for start in range(lo, hi + 1, 2**23):
        x = torch.arange(start, min(start + 2**23, hi + 1), dtype=torch.int32).view(torch.float32)
        xd = x.to(device)
        n += x.numel()
        m, e = torch.frexp(x)
        exact = (e - (m == 0.5).int()).long()
        raw = torch.ceil(torch.log2(x)).long()
        pos = torch.zeros((x.numel(), 3))
        got = {"log2": torch.ceil(torch.log2(xd)).long().cpu(),
               "mip_level": mip_level(pos.to(device), xd * to_dt, cfg).cpu()}
        want = {"log2": raw, "mip_level": mip_level(pos, x * to_dt, cfg)}
        for k in got:
            diff[k].append(x[got[k] != want[k]])
        diff["cpu_vs_exact"].append(x[raw != exact])
    diff = {k: torch.cat(v) for k, v in diff.items()}
    for k, v in diff.items():
        log(f"C2 {k}: {v.numel()} of {n} float32 in [1, {2**octaves}] disagree"
            f"{' (this device vs CPU)' if k != 'cpu_vs_exact' else ''}; first "
            f"{[float(f) for f in v[:C2_SHOW]]}")
    log(f"C2 phase: {time.perf_counter() - t0:.1f} s")
    check(diff["mip_level"].numel() == 0,
          f"mip_level picks another cascade on {device} than on the CPU at "
          f"{diff['mip_level'].numel()} values")
    return {k: v.numel() for k, v in diff.items()}


def shell_occupancy(bound, grid_size, coarse_factor, device):
    """bench.py's synthetic occupancy: a shell + floor in cascade 0, a ball
    in the outer cascades, packed by the port's packers."""
    from nerfnav_tpu_torch.models.occupancy import OccupancyConfig
    from nerfnav_tpu_torch.ops.morton import pack_blocks, packbits

    cascades = OccupancyConfig(bound=bound, grid_size=grid_size).cascades
    h, f = grid_size, coarse_factor
    hc = h // f
    idx = np.arange(h**3)
    c = (np.stack([idx // (h * h), (idx // h) % h, idx % h], -1) + 0.5) / h * 2 - 1
    r = np.linalg.norm(c, axis=-1)
    occ0 = ((r > 0.35) & (r < 0.5)) | (np.abs(c[:, 2] + 0.8) < 0.05)
    occs = np.stack([occ0] + [r < 0.3] * (cascades - 1))
    occ_c = occs.reshape(-1, hc, f, hc, f, hc, f).max(axis=(2, 4, 6)).reshape(cascades, -1)
    occ_t = torch.as_tensor(occs, device=device)
    occ_ct = torch.as_tensor(occ_c, device=device)
    return {
        "bitfield": packbits(occ_t),
        "bitfield_coarse": packbits(occ_ct),
        "blocks": pack_blocks(occ_t, h),
        "blocks_coarse": pack_blocks(occ_ct, hc, block=8 if hc % 8 == 0 else 4),
    }


def make_trainer(device, sizes, params=None, occupancy=None, density_scale=300.0):
    from nerfnav_tpu_torch.models.network import NetworkConfig, init_network
    from nerfnav_tpu_torch.models.occupancy import OccupancyConfig
    from nerfnav_tpu_torch.models.renderer import RenderConfig
    from nerfnav_tpu_torch.ops.marching import MarchConfig
    from nerfnav_tpu_torch.training.trainer import Trainer, TrainerOptions

    bound = 2.0
    cfg = NetworkConfig(bound=bound, grid_layout="cell", grid_levels=4,
                        grid_level_dim=8, grid_log2_hashmap_size=sizes["log2"],
                        mlp_backend="fused", density_scale=density_scale)
    mcfg = MarchConfig(bound=bound, grid_size=sizes["grid"], max_steps=1024,
                       samples_per_ray=32, min_near=0.2, coarse_segments=12,
                       coarse_anchors=2)
    if params is None:
        params = init_network(torch.Generator().manual_seed(0), cfg, device=device)
    if occupancy is None:
        occupancy = shell_occupancy(bound, sizes["grid"], mcfg.coarse_factor, device)
    return Trainer(cfg, RenderConfig(max_ray_batch=4096),
                   # the options phase's save_mesh logs under its own directory
                   TrainerOptions(eval_table_dtype="bfloat16", workspace=OPT_DIR),
                   params=params,
                   occupancy_cfg=OccupancyConfig(bound=bound, grid_size=sizes["grid"]),
                   march_cfg=mcfg, occupancy=occupancy, device=device)


def profile_call(fn, unprofiled_ms, what, host_ops=True):
    """One warm call under torch.profiler: the device time of every kernel,
    its share of the unprofiled call's time, and the kernels that take most.
    host_ops=False traces the card only, for calls of ~10^5 kernels whose
    host-op trace takes minutes to process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    # the raw trace: building the profiler's FunctionEvent tree for ~10^5
    # kernels takes half a minute of host time per call
    for e in prof.profiler.kineto_results.events():
        # record_function ranges (the optimizer's step) also show on the
        # device timeline; only kernels count as device time
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    if not by_name:
        log(f"{what}: the profiler recorded no device time (not measured)")
        return None
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    fused = [v for k, v in by_name.items() if "fused_mlp_kernel" in k]
    out = {
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "kernel_launches": sum(n for _, n in by_name.values()),
        "device_idle_share_of_unprofiled_call": 1.0 - busy_ms / unprofiled_ms,
        "fused_mlp_kernel_ms_count": [sum(ms for ms, _ in fused), sum(n for _, n in fused)],
        "top_kernels_ms_count": [[k[:70], round(ms, 3), n] for k, (ms, n) in top],
    }
    log(f"{what}:", json.dumps(out))
    return out


def yaw_pose(deg):
    """bench.py's camera: distance 1.8 from the origin, turned about y."""
    th = np.radians(deg)
    c, s = np.cos(th), np.sin(th)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [-1.8 * s, 0.0, -1.8 * c]
    return pose


def slice_phase(device, sizes, card):
    """The main path (bench.py's on-axis frame), then the checks that need a
    silhouette on a side view. Returns the main path's fused launches."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm
    from nerfnav_tpu_torch.ops import hashgrid as hg

    hw = sizes["hw"]
    tr = make_trainer(device, sizes)
    pose = yaw_pose(0.0)
    intr = np.asarray([1000.0 * hw / 800, 1000.0 * hw / 800, hw / 2, hw / 2], np.float32)

    fm.fused_mlp.launches = hg.hash_grid_encode.launches = 0
    t0 = time.perf_counter()
    image, depth = tr.render_full(tr.params, pose, intr, hw, hw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fm.fused_mlp.launches
    GRID_LAUNCHES["launches_per_frame"] = hg.hash_grid_encode.launches
    mean_image = check_frame(image, depth, hw)
    if device.type == "cuda":
        check(launches > 0, "the render never launched the fused-MLP kernel")
        check(GRID_LAUNCHES["launches_per_frame"] > 0,
              "the render never launched the hash-grid kernel")
    log(f"slice phase: {hw}x{hw} frame, mean_image {mean_image:.4f}, "
        f"first frame {first_s:.3f} s, fused_mlp launches {launches}, "
        f"hash-grid launches {GRID_LAUNCHES['launches_per_frame']}, "
        f"planned ladder t_a0 {tr._ladder_plan[1]}")

    n_frames = sizes["frames"]
    t0 = time.perf_counter()
    for _ in range(n_frames):
        tr.render_full(tr.params, pose, intr, hw, hw)
        if device.type == "cuda":
            torch.cuda.synchronize()
    frame_s = (time.perf_counter() - t0) / n_frames
    frame = {"card": card, "hw": hw, "frame_ms": frame_s * 1e3,
             "rays_per_s": hw * hw / frame_s, "mean_image": mean_image,
             "fused_mlp_launches_per_frame": launches}
    log("frame:", json.dumps(frame))
    if device.type == "cuda":
        profile_call(lambda: tr.render_full(tr.params, pose, intr, hw, hw), frame_s * 1e3,
                     "profiled frame")
    # at density_scale 300 every ray of this scene ends in its first round;
    # a translucent field (density_scale 30) seen from the side shades all
    # the rounds, and its silhouettes the compacted ones
    tr_side = make_trainer(device, sizes, params=tr.params, occupancy=tr.occupancy,
                           density_scale=30.0)
    silhouette_checks(tr_side, yaw_pose(90.0), intr, hw, sizes)
    return launches


def check_frame(image, depth, hw):
    """Shapes, finiteness and 0 < mean < 1; returns the mean."""
    check(tuple(image.shape) == (hw, hw, 3) and tuple(depth.shape) == (hw, hw),
          f"frame shapes {tuple(image.shape)} / {tuple(depth.shape)}")
    check(bool(torch.isfinite(image).all() and torch.isfinite(depth).all()),
          "non-finite frame")
    mean_image = float(image.mean())
    check(0.0 < mean_image < 1.0, f"mean_image {mean_image} outside (0, 1)")
    return mean_image


def silhouette_checks(tr, pose, intr, hw, sizes):
    """The chunk that shades the most rounds, with the kernel and with the
    plain MLP; then a 64x64 crop at that chunk on this device and on the
    CPU port."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    image, depth = tr.render_full(tr.params, pose, intr, hw, hw)
    mean_image = check_frame(image, depth, hw)
    chunk = tr.rcfg.max_ray_batch
    with torch.no_grad():
        ro, rd, _ = tr._frame_rays(pose, intr, hw, hw, chunk, None)
        mcfg, occ = tr._frame_march(intr, hw, hw, rd)
        params = tr._cast_eval_tables(tr.params)
        render_chunk = tr._chunk_renderer(mcfg)
        per_chunk = []
        for i in range(0, ro.shape[0], chunk):
            before = fm.fused_mlp.launches
            render_chunk(params, occ, ro[i : i + chunk], rd[i : i + chunk], 1.0)
            per_chunk.append(fm.fused_mlp.launches - before)
        ci = int(np.argmax(per_chunk))
        sl = slice(ci * chunk, (ci + 1) * chunk)
        got = render_chunk(params, occ, ro[sl], rd[sl], 1.0)["image"]
        with plain_mlp():
            want = render_chunk(params, occ, ro[sl], rd[sl], 1.0)["image"]
    chunk_err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=MLP_TOL, atol=MLP_TOL)),
          f"chunk {ci}: max |kernel - plain| = {chunk_err}")
    log(f"side view, density_scale {tr.cfg.density_scale}: mean_image "
        f"{mean_image:.4f}; fused_mlp launches per chunk "
        f"(2 per shaded round) as a histogram "
        f"{json.dumps(np.bincount(per_chunk).tolist())}; chunk {ci} "
        f"({per_chunk[ci]} launches): max |kernel - plain MLP| = {chunk_err:.3g}")

    # the full 64x64 tile holding that chunk's first pixel
    first = int(tr._tile_layout(hw, hw, chunk)["perm"][min(ci * chunk, hw * hw - 1)])
    nt = hw // 64
    ty, tx = min(first // hw // 64, nt - 1), min(first % hw // 64, nt - 1)
    crop_intr = intr.copy()
    crop_intr[2:] = [intr[2] - 64 * tx, intr[3] - 64 * ty]
    crop_dev, _ = tr.render_full(tr.params, pose, crop_intr, 64, 64)
    cpu = torch.device("cpu")
    tr_cpu = make_trainer(
        cpu, sizes,
        params={k: [t.to(cpu) for t in v] for k, v in tr.params.items()},
        occupancy={k: v.to(cpu) for k, v in tr.occupancy.items()},
        density_scale=tr.cfg.density_scale)
    crop_cpu, _ = tr_cpu.render_full(tr_cpu.params, pose, crop_intr, 64, 64)
    diff = (crop_dev.cpu() - crop_cpu).abs()
    crop = {"tile": [int(tx), int(ty)], "mean_abs": float(diff.mean()),
            "max_abs": float(diff.max()),
            "frac_over_5e-2": float((diff > 5e-2).float().mean()),
            "crop_mean": float(crop_cpu.mean())}
    log("crop 64x64, this device vs the CPU port:", json.dumps(crop))
    # a sample on a cell boundary can flip between devices (FMA contraction
    # in cuBLAS and the kernels), so masks are not demanded equal: the mean
    # error must stay under 5e-3 and at most 1% of pixels may differ by 5e-2
    check(crop["mean_abs"] <= 5e-3 and crop["frac_over_5e-2"] <= 0.01,
          f"crop mismatch {crop}")


class FrameSet:
    """An in-memory dataset, what Trainer.train reads."""

    def __init__(self, poses, images, intrinsics):
        self.poses, self.images, self.intrinsics = poses, images, intrinsics
        self.H, self.W = images.shape[1:3]

    def __len__(self):
        return len(self.poses)

    def as_arrays(self):
        return {"poses": self.poses, "images": self.images, "intrinsics": self.intrinsics}


def target_frames(hw, seed=0):
    """Four smooth RGB frames at yaw 0/90/180/270 whose mean color (about
    (0.8, 0.3, 0.15)) sits far from the grey an untrained field renders."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    frames = []
    for _ in range(4):
        ph = rng.uniform(0, 2 * np.pi, 3)
        frames.append(np.stack([0.8 + 0.15 * np.sin(2 * np.pi * x + ph[0]),
                                0.3 + 0.2 * np.cos(2 * np.pi * y + ph[1]),
                                0.15 + 0.1 * np.sin(2 * np.pi * (x + y) + ph[2])], -1))
    poses = np.stack([yaw_pose(a) for a in (0.0, 90.0, 180.0, 270.0)])
    intr = np.asarray([1000.0 * hw / 800, 1000.0 * hw / 800, hw / 2, hw / 2], np.float32)
    return FrameSet(poses, np.stack(frames).astype(np.float32), intr)


def train_trainer(device, sizes, workspace, params=None, small=False, mesh=None,
                  sample_groups=1):
    """A fresh port Trainer in the -O --ff training configuration; small=True
    is the CPU tests' configuration with the xla fp32 field; mesh: a
    parallel.make_mesh mesh to train over; sample_groups: a single
    process's packing groups."""
    from nerfnav_tpu_torch.models.network import NetworkConfig
    from nerfnav_tpu_torch.models.occupancy import OccupancyConfig
    from nerfnav_tpu_torch.models.renderer import RenderConfig
    from nerfnav_tpu_torch.ops.marching import MarchConfig
    from nerfnav_tpu_torch.training.trainer import Trainer, TrainerOptions

    if small:
        cfg = NetworkConfig(bound=2.0, grid_levels=2, grid_level_dim=8,
                            grid_log2_hashmap_size=10, grid_max_resolution=32,
                            grid_layout="cell", density_scale=10.0)
        grid, rays, k = 32, 256, 16
    else:
        cfg = NetworkConfig(bound=2.0, mlp_dtype="bfloat16", mlp_backend="fused",
                            grid_levels=4, grid_level_dim=8,
                            grid_log2_hashmap_size=sizes["log2"], grid_layout="cell")
        grid, rays, k = sizes["grid"], sizes["rays"], 64
    occ_cfg = OccupancyConfig(bound=2.0, density_thresh=10.0, min_near=0.2, grid_size=grid)
    mcfg = MarchConfig(bound=2.0, max_steps=1024, samples_per_ray=k, min_near=0.2,
                       grid_size=grid, coarse_segments=16, coarse_anchors=3)
    opt = TrainerOptions(name="smoke", workspace=workspace, num_rays=rays,
                         use_checkpoint="scratch")
    return Trainer(cfg, RenderConfig(max_ray_batch=4096), opt, params=params,
                   occupancy_cfg=occ_cfg, march_cfg=mcfg, mesh=mesh, device=device,
                   sample_groups=sample_groups)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


def crop_intrinsics(ds, size=64):
    intr = ds.intrinsics.copy()
    intr[2:] -= (ds.H - size) / 2
    return intr


def training_phase(device, sizes, card):
    """The -O --ff training path on the card (see the module docstring).
    Returns the fused launches per train step."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm
    from nerfnav_tpu_torch.ops import hashgrid as hg
    from nerfnav_tpu_torch.ops.morton import unpackbits
    from nerfnav_tpu_torch.training import checkpoint as ckpt_lib

    workspace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "chip_smoke_train")
    shutil.rmtree(workspace, ignore_errors=True)
    ds = target_frames(sizes["hw"])
    tr = train_trainer(device, sizes, workspace)

    # count the fused and hash-grid launches of the sweeps and keep every
    # step's loss
    sweep = {"launches": 0, "grid_launches": 0, "count": 0}
    losses = []
    update, step = tr._maybe_update_occupancy, tr.train_step

    def counted_update():
        before, iters = fm.fused_mlp.launches, int(tr.occupancy["iter_density"])
        grid_before = hg.hash_grid_encode.launches
        update()
        sweep["launches"] += fm.fused_mlp.launches - before
        sweep["grid_launches"] += hg.hash_grid_encode.launches - grid_before
        sweep["count"] += int(tr.occupancy["iter_density"]) - iters

    def kept_step(*a):
        loss = step(*a)
        losses.append(loss)
        return loss

    tr._maybe_update_occupancy, tr.train_step = counted_update, kept_step
    fm.fused_mlp.launches = hg.hash_grid_encode.launches = 0
    t0 = time.perf_counter()
    tr.train(ds, max_epochs=1, steps_per_epoch=TRAIN_STEPS)
    sync(device)
    train_s = time.perf_counter() - t0
    total = fm.fused_mlp.launches
    grid_steps = hg.hash_grid_encode.launches - sweep["grid_launches"]
    del tr._maybe_update_occupancy, tr.train_step
    losses = torch.stack(losses).cpu()
    step_launches = total - sweep["launches"]
    GRID_LAUNCHES["launches_per_train_step"] = grid_steps / TRAIN_STEPS
    GRID_LAUNCHES["launches_per_sweep"] = sweep["grid_launches"] / max(sweep["count"], 1)
    occ_share = float(unpackbits(tr.occupancy["bitfield"]).float().mean())
    log("training:", json.dumps({
        "steps": len(losses), "first_run_s": train_s, "sweeps": sweep["count"],
        "loss_first8": float(losses[:8].mean()), "loss_last8": float(losses[-8:].mean()),
        "fused_launches_in_steps": step_launches,
        "fused_launches_in_sweeps": sweep["launches"], "grid_launches_in_steps": grid_steps,
        "grid_launches_in_sweeps": sweep["grid_launches"], "occupied_share": occ_share,
        "occupancy_sha1": hashlib.sha1(tr.occupancy["bitfield"].cpu().numpy().tobytes())
        .hexdigest()[:12],
        "mean_count": float(tr.state.mean_count), "budget": tr._current_budget()}))
    check(len(losses) == TRAIN_STEPS and bool(torch.isfinite(losses).all()),
          "a non-finite training loss")
    check(losses[-8:].mean() < losses[:8].mean(), "the training loss did not fall")
    check(sweep["count"] == 3, f"{sweep['count']} occupancy sweeps, expected 3")
    if device.type == "cuda":
        check(step_launches > 0, "the train steps never launched the fused-MLP kernel")
        check(sweep["launches"] > 0, "the occupancy sweeps never launched the fused-MLP kernel")
        check(grid_steps > 0 and sweep["grid_launches"] > 0,
              f"the train steps or sweeps never launched the hash-grid kernel: {grid_steps} in "
              f"the steps, {sweep['grid_launches']} in the sweeps")
    check(0.0 < occ_share < 1.0, f"occupied share {occ_share} outside (0, 1)")
    intr64 = crop_intrinsics(ds)
    crop, _ = tr.render_full(tr.state.ema_params, ds.poses[0], intr64, 64, 64)
    check(bool(torch.isfinite(crop).all()), "non-finite crop of the trained field")

    arrays = tr._device_arrays(ds)
    H, W = ds.H, ds.W
    kernel_vs_plain_step(tr, arrays, H, W)
    card_vs_cpu_step(device, sizes)

    # checkpoint round trip into a new Trainer
    tr.save_checkpoint(full=True)
    tr2 = train_trainer(device, sizes, workspace + "_load")
    tr2.load_checkpoint(ckpt_lib.latest_checkpoint(tr.ckpt_dir, "smoke"))
    crop2, _ = tr2.render_full(tr2.state.ema_params, ds.poses[0], intr64, 64, 64)
    ck_err = float((crop2 - crop).abs().max())
    log(f"checkpoint round trip: 64x64 crop max |diff| {ck_err:.3g}")
    check(ck_err <= 1e-6, f"the reloaded field renders {ck_err} away")
    del tr2
    shutil.rmtree(workspace + "_load", ignore_errors=True)
    # the nav phase flies through this trained field: keep its checkpoint
    # (EMA params + occupancy) where cli/simulate.py's loader looks, and
    # for the options phase
    nav_ckpt = os.path.join(NAV_WS, "checkpoints", "ngp_ep0001.npz")
    shutil.rmtree(NAV_WS, ignore_errors=True)
    shutil.rmtree(OPT_DIR, ignore_errors=True)
    os.makedirs(os.path.dirname(nav_ckpt))
    os.makedirs(OPT_DIR)
    shutil.copy(ckpt_lib.latest_checkpoint(tr.ckpt_dir, "smoke"), nav_ckpt)
    shutil.copy(nav_ckpt, OPT_CKPT)

    time_training(tr, arrays, H, W, device, card, step_launches / TRAIN_STEPS)
    shutil.rmtree(workspace, ignore_errors=True)
    return step_launches / TRAIN_STEPS


@contextlib.contextmanager
def plain_mlp():
    """The fused-MLP wrapper swapped for its plain version within the block
    (no launch is counted there)."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    kernel_fn = fm.fused_mlp
    fm.fused_mlp = lambda x, w, a="relu", o="none": fm.fused_mlp_reference(x, w, a, o)
    try:
        yield
    finally:
        fm.fused_mlp = kernel_fn


def kernel_vs_plain_step(tr, arrays, H, W):
    """loss_and_grads from one state and draws with the kernel and with the
    plain MLP swapped in."""
    draws = tr.draw_step(tr.state, 0, H, W)
    got = tr.loss_and_grads(tr.state, arrays, draws)
    with plain_mlp():
        want = tr.loss_and_grads(tr.state, arrays, draws)
    loss_rel = abs(float(got.loss) - float(want.loss)) / abs(float(want.loss))
    errs = [rel_l2(a, b) for a, b in zip(got.grads, want.grads)]
    log("one step, kernel vs plain MLP:", json.dumps({
        "budget": tr._current_budget(), "loss_rel": loss_rel,
        "grad_rel_l2_max": max(errs), "grad_rel_l2": errs, "bound": GRAD_TOL}))
    check(loss_rel <= 2e-2, f"loss with the kernel {loss_rel} away from the plain MLP's")
    check(max(errs) <= GRAD_TOL, f"gradients with the kernel {max(errs)} away (L2)")


def card_vs_cpu_step(device, sizes, groups=1):
    """One step at the CPU tests' size, xla fp32 field: this device against
    the CPU port, from the same params, occupancy and draws. groups > 1
    packs the step in that many blocks (sample_groups, a mesh's packing) at
    a point budget of about half the valid samples; returns the record."""
    cpu = torch.device("cpu")
    ds = target_frames(24, seed=3)
    ws = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_small")
    tr_cpu = train_trainer(cpu, sizes, ws, small=True, sample_groups=groups)
    tr_dev = train_trainer(device, sizes, ws, small=True, sample_groups=groups, params={
        k: [t.detach() for t in v] for k, v in tr_cpu.params.items()})
    occ = shell_occupancy(2.0, 32, 4, cpu)
    tr_cpu.set_occupancy({**tr_cpu.occupancy, **occ})
    tr_dev.set_occupancy({**tr_dev.occupancy, **{k: v.to(device) for k, v in occ.items()}})
    draws = tr_cpu.draw_step(tr_cpu.state, 1, ds.H, ds.W)
    to_dev = lambda t: t.to(device)  # noqa: E731
    draws_dev = draws._replace(rays=draws.rays._replace(inds=to_dev(draws.rays.inds)),
                               bg=to_dev(draws.bg),
                               march=draws.march._replace(u=to_dev(draws.march.u),
                                                          phase=to_dev(draws.march.phase)))
    if groups > 1:
        n_valid = int(tr_cpu.loss_and_grads(tr_cpu.state, tr_cpu._device_arrays(ds),
                                            draws).n_samples)
        for tr in (tr_cpu, tr_dev):
            tr._mean_count_host = 0.5 * n_valid / tr.opt.point_budget_margin
    want = tr_cpu.loss_and_grads(tr_cpu.state, tr_cpu._device_arrays(ds), draws)
    got = tr_dev.loss_and_grads(tr_dev.state, tr_dev._device_arrays(ds), draws_dev)
    loss_rel = abs(float(got.loss) - float(want.loss)) / abs(float(want.loss))
    errs = [rel_l2(a.cpu(), b) for a, b in zip(got.grads, want.grads)]
    out = {"n_samples": [int(got.n_samples), int(want.n_samples)], "loss_rel": loss_rel,
           "grad_rel_l2_max": max(errs)}
    if groups > 1:
        out.update(sample_groups=groups, budget=tr_dev._current_budget())
        check(out["budget"] is not None and out["budget"] < int(want.n_samples),
              f"the grouped step packs no tail: {out}")
    log("one step at the CPU tests' size, this device vs the CPU port:", json.dumps(out))
    check(loss_rel <= 1e-5, f"loss {loss_rel} away from the CPU port's")
    check(max(errs) <= 1e-4, f"gradients {max(errs)} away from the CPU port's (L2)")
    return out


def time_training(tr, arrays, H, W, device, card, launches_per_step):
    """Steps/s over TIMED_STEPS warm steps, one full and one partial sweep,
    and one profiled step."""
    from nerfnav_tpu_torch.models.occupancy import draw_update, update_extra_state
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    sync(device)
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        tr.train_step(tr.state, arrays, tr.draw_step(tr.state, i % 4, H, W))
    sync(device)
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    occ, ocfg = tr.occupancy, tr.occupancy_cfg
    sweeps = {}
    for name, it in (("full", 0), ("partial", ocfg.n_full_updates)):
        st = {**occ, "iter_density": torch.full_like(occ["iter_density"], it)}
        draws = draw_update(tr.gen, st, ocfg)
        sync(device)
        before = fm.fused_mlp.launches
        t0 = time.perf_counter()
        update_extra_state(st, ocfg, tr.params, tr.cfg, draws)
        sync(device)
        sweeps[f"{name}_sweep_ms"] = (time.perf_counter() - t0) * 1e3
        sweeps[f"{name}_sweep_fused_launches"] = fm.fused_mlp.launches - before
    log("train timing:", json.dumps({
        "card": card, "steps_per_s": 1.0 / step_s, "step_ms": step_s * 1e3,
        "budget": tr._current_budget(), "fused_launches_per_step": launches_per_step,
        **sweeps}))
    if device.type == "cuda":
        draws = tr.draw_step(tr.state, 0, H, W)
        profile_call(lambda: tr.train_step(tr.state, arrays, draws), step_s * 1e3,
                     "profiled train step")


# ------------------------------------------------------------------ nav phase
NAV_TICKS, NAV_OPEN_LOOP = 6, 1  # of the 20-step mission: 5 closed loop, 1 open
NAV_HOVER = np.asarray([10.0, 0.0, 0.0, 0.0], np.float32)  # thrust m g
# the mission's filter starts this far off the true start state (position
# in metres, rotation vector in radians): its first update must remove most
# of the error, which a filter that returned its prediction would keep
# the filter's dense render (128 samples) at the true pose against the
# agent's uint8 observation (192 samples) of the trained field, MSE: 8-bit
# rounding alone is (1/255)^2 / 12 = 1.3e-6
NAV_TRUTH_MSE = 1e-4
# the render's Jacobian through the trained flagship field along the
# filter's ray derivatives, from the same rays, the card against the CPU
# port, relative to its largest entry (the image: absolute): with float32
# MLPs the bound tests/test_torch_nav_estimator.py holds float32 Jacobians
# to against JAX, with the nav path's bf16 MLPs the one it holds bf16 ones to
NAV_JAC_F32_TOL = 1e-4
NAV_JAC_BF16_TOL = 3e-2
NAV_X0_ERR = np.asarray([0.03, -0.02, 0.02, 0, 0, 0, 0.02, -0.015, 0.01, 0, 0, 0], np.float32)
# the nav stack's full width on the card, toy sizes for the rehearsal; pos_err:
# the bound on the filter's position error (metres) over the closed-loop
# ticks under simulate.py's default process noise (2e-3 on every state dim)
NAV_SIZES = {
    "card": {"obs": 800, "batch": 1024, "jac": 256, "gn_iters": 15, "pool": 16384,
             "epochs_init": 500, "epochs_update": 250, "astar_fine": 100, "pos_err": 0.02},
    "rehearsal": {"obs": 96, "batch": 256, "jac": 64, "gn_iters": 8, "pool": 2048,
                  "epochs_init": 20, "epochs_update": 5, "astar_fine": 40, "pos_err": 0.1},
}


def nav_front_end():
    """The filter's keypoint detector is find_poi, which needs cv2: fail
    early, and say so, where it cannot be imported."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("the nav phase needs cv2 for the filter's keypoint detector "
                           "(nav/estimator.py::find_poi); it cannot be imported") from e
    log(f"nav front end: find_poi with cv2 {cv2.__version__}")


def nav_opt(nav, device, *extra):
    from nerfnav_tpu_torch.cli import simulate as sim

    return sim.build_sim_parser().parse_args([
        "chip_smoke", "--device", str(device), "--workspace", NAV_WS, "--seed", "0",
        "--obs_res", str(nav["obs"]), "--obs_focal", str(nav["obs"]),
        "--estimator_batch", str(nav["batch"]), "--epochs_init", str(nav["epochs_init"]),
        "--epochs_update", str(nav["epochs_update"]), *extra])


def nav_mission_objects(opt, nav, device):
    """simulate.build_mission, with the rehearsal's toy filter and A* sizes
    (on the card these are the defaults)."""
    import dataclasses

    from nerfnav_tpu_torch.cli import simulate as sim

    traj, agent, filt, fused = sim.build_mission(opt, device)
    filt.cfg.gn_jac_batch, filt.cfg.gn_iters = nav["jac"], nav["gn_iters"]
    filt.cfg.pool_size = nav["pool"]
    traj.cfg = dataclasses.replace(traj.cfg, astar_fine=nav["astar_fine"])
    return traj, agent, filt, fused


def count_syncs(fn):
    """fn() under torch.cuda's sync debug mode: (result, {call site: host
    syncs})."""
    import collections
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    return out, dict(sites)


class TickProbe:
    """Stands in for the FusedMPC in simulate(): runs its ticks, times each
    (synchronized), and on chosen ticks also holds the tick against the
    unfused sequence (timing its front end, filter and replan), profiles it,
    or counts its host syncs."""

    CHECK, PROFILE, SYNCS = 1, 2, 3

    def __init__(self, fused, device):
        self.fused, self.device = fused, device
        self.tick_ms, self.front_end_ms, self.stage_ms = [], [], []
        self.x_pred = []  # each tick's prediction, the filter's prior
        self.split = self.profile = self.syncs = None

    def _stage_events(self):
        """For one tick, wraps the filter's gn_fused and the planner's
        run_epochs so that each records a CUDA event before and after it:
        no host read, so the tick runs as it would. The card idles most of
        the tick, so the span between two events is close to the host's
        time for the stage."""
        f, t = self.fused.filt, self.fused.traj
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

        def timed(fn, start, end):
            def call(*a, **k):
                start.record()
                out = fn(*a, **k)
                end.record()
                return out
            return call

        f.gn_fused = timed(f.gn_fused, ev[0], ev[1])
        t.run_epochs = timed(t.run_epochs, ev[2], ev[3])
        return ev

    def _drop_stage_events(self):
        del self.fused.filt.gn_fused, self.fused.traj.run_epochs  # the class methods again

    def _snapshot(self):
        f, t = self.fused.filt, self.fused.traj
        return (f.xt.clone(), f.sig.clone(), f.iteration, f.gen.get_state(), t.states.clone(),
                t.initial_accel.clone(), t.active, t.start_state.clone(), t.epoch)

    def _restore(self, snap):
        f, t = self.fused.filt, self.fused.traj
        (f.xt, f.sig, f.iteration, gen, t.states, t.initial_accel, t.active, t.start_state,
         t.epoch) = snap
        f.gen.set_state(gen)

    def _unfused(self, img, action):
        """The four-stage sequence from the same state and draws, timed."""
        f, t = self.fused.filt, self.fused.traj
        t0 = time.perf_counter()
        x = f.estimate_state(img, None, action)
        filt_ms = (time.perf_counter() - t0) * 1e3
        t.update_state(x)
        t0 = time.perf_counter()
        t.learn_update(0)
        replan_ms = (time.perf_counter() - t0) * 1e3
        act = t.get_next_action().cpu()
        front_ms = sum(v for k, v in f.last_timings.items() if k != "solve_ms"
                       and k != "artifacts_ms")
        self.split = {"front_end_ms": front_ms, "filter_ms": filt_ms - front_ms,
                      "filter_front_end_parts_ms": f.last_timings, "replan_ms": replan_ms}
        return x, f.sig.cpu(), t.states.cpu(), t.active, act

    def step(self, img, action):
        i = len(self.tick_ms)
        f = self.fused.filt
        self.x_pred.append(f._predict(f.xt, torch.as_tensor(
            action, dtype=torch.float32, device=self.device))[0].cpu().numpy())
        if i == self.CHECK:
            snap = self._snapshot()
            want = self._unfused(img, action)
            self._restore(snap)
        cuda = self.device.type == "cuda"
        ev = self._stage_events() if cuda and i not in (self.PROFILE, self.SYNCS) else None
        sync(self.device)
        t0 = time.perf_counter()
        try:
            if i == self.PROFILE and cuda:
                box = []
                self.profile = profile_call(lambda: box.append(self.fused.step(img, action)),
                                            self.tick_ms[-1], "profiled nav tick",
                                            host_ops=False)
                x, act = box[0]
            elif i == self.SYNCS and cuda:
                (x, act), self.syncs = count_syncs(lambda: self.fused.step(img, action))
            else:
                x, act = self.fused.step(img, action)
            sync(self.device)
        finally:
            if ev is not None:
                self._drop_stage_events()
        self.tick_ms.append((time.perf_counter() - t0) * 1e3)
        check(self.fused.last_losses is not None and self.fused.last_timings is not None,
              f"nav tick {i} took the no-keypoint fallback")
        self.front_end_ms.append(sum(self.fused.last_timings.values()))
        self.stage_ms.append(ev and {"filter_ms": ev[0].elapsed_time(ev[1]),
                                     "replan_ms": ev[2].elapsed_time(ev[3])})
        if i == self.CHECK:
            f, t = self.fused.filt, self.fused.traj
            got = (x.cpu(), f.sig.cpu(), t.states.cpu(), t.active, act.cpu())
            xw, sigw, stw, aw, actw = want
            ok = (torch.allclose(got[0], torch.as_tensor(xw), rtol=2e-4, atol=2e-5)
                  and torch.allclose(got[1], sigw, rtol=2e-3, atol=2e-4)
                  and got[3] == aw
                  and torch.allclose(got[2], stw, rtol=2e-4, atol=2e-5)
                  and torch.allclose(got[4], actw, rtol=2e-3, atol=2e-4))
            diffs = {"x": float((got[0] - torch.as_tensor(xw)).abs().max()),
                     "sig": float((got[1] - sigw).abs().max()),
                     "states": float((got[2] - stw).abs().max()),
                     "action": float((got[4] - actw).abs().max())}
            log("nav tick", i, "fused vs unfused sequence, max |diff|:", json.dumps(diffs))
            check(ok, f"the fused tick differs from the unfused sequence: {diffs}")
        return x, act


def nav_mission(device, nav, card):
    """Part (a): the closed-loop mission on the analytic scene through
    simulate.build_mission and simulate.simulate with FusedMPC ticks."""
    from nerfnav_tpu_torch import native
    from nerfnav_tpu_torch.cli import simulate as sim

    # simulate.py's start and goal turned 90 degrees about the vertical axis
    # (the scene is a sphere at the origin): the camera looks along body +x,
    # and from the defaults themselves it sees an empty frame, no keypoints
    start, goal = ["-0.67", "-0.39", "0.2"], ["0.55", "0.4", "0.16"]
    opt = nav_opt(nav, device, "--analytic", "--start", *start, "--goal", *goal)
    traj, agent, filt, fused = nav_mission_objects(opt, nav, device)
    filt.set_initial_state(filt.xt.cpu().numpy() + NAV_X0_ERR)
    # the first native call builds astar.cpp with g++ (in a fresh checkout)
    # and loads it: kept out of the timed search
    t0 = time.perf_counter()
    native.astar_native(np.zeros((2, 2, 2), bool), (0, 0, 0), (1, 1, 1))
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    path = traj.a_star_init()
    astar_ms = (time.perf_counter() - t0) * 1e3
    check(path is not None and len(path) > 1, "A* found no path")
    check(native._lib is not None, "A* did not run the native build")
    t0 = time.perf_counter()
    losses = np.asarray(traj.learn_init())
    init_ms = (time.perf_counter() - t0) * 1e3
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"learn_init loss {losses[0]} -> {losses[-1]} did not fall")
    r_min = float(traj.get_full_states()["pos"].norm(dim=-1).min())
    check(r_min > 0.5, f"the plan enters the sphere (radius 0.5): min |pos| {r_min}")
    log("nav plan:", json.dumps({
        "card": card, "astar_build_and_load_ms": native_ms, "astar_ms": astar_ms,
        "astar_cells": len(path), "learn_init_ms": init_ms,
        "epochs_init": len(losses), "ms_per_epoch": init_ms / len(losses),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]), "min_radius": r_min}))

    probe = TickProbe(fused, device)
    t0 = time.perf_counter()
    history = sim.simulate(traj, agent, filt, steps=NAV_TICKS, open_loop_steps=NAV_OPEN_LOOP,
                           noise_std=opt.mpc_noise_std, seed=opt.seed, fused=probe)
    mission_s = time.perf_counter() - t0
    closed = NAV_TICKS - NAV_OPEN_LOOP
    check(len(history) == NAV_TICKS and len(probe.tick_ms) == closed,
          f"{len(history)} steps, {len(probe.tick_ms)} fused ticks")
    check(all(np.isfinite(e).all() for _, e in history), "a non-finite estimate")
    post = [state_err(e, t) for t, e in history[:closed]]
    prior = [state_err(p, t) for p, (t, _) in zip(probe.x_pred, history)]
    errs, prior_errs = [e[0] for e in post], [e[0] for e in prior]
    log("nav mission:", json.dumps({
        "card": card, "ticks": NAV_TICKS, "closed_loop": closed, "mission_s": mission_s,
        "tick_ms": probe.tick_ms, "front_end_ms": probe.front_end_ms,
        "filter_replan_ms_by_events": probe.stage_ms, "split_of_tick_1": probe.split,
        "kernels_per_tick": probe.profile and probe.profile["kernel_launches"],
        "idle_share": probe.profile and probe.profile["device_idle_share_of_unprofiled_call"],
        "host_syncs_per_tick": probe.syncs and sum(probe.syncs.values()),
        "host_sync_sites": probe.syncs, "pos_err_m": errs, "pos_err_of_prediction_m": prior_errs,
        "rot_err_deg": [e[1] for e in post], "rot_err_of_prediction_deg": [e[1] for e in prior],
        "final_lm_loss": float(fused.last_losses[-1]),
        "replan_loss": [float(fused.last_plan_losses[0]), float(fused.last_plan_losses[-1])]}))
    check(max(errs) < nav["pos_err"], f"filter position errors {errs} m, bound {nav['pos_err']}")
    check(errs[0] < 0.5 * prior_errs[0] and post[0][1] < 0.5 * prior[0][1],
          f"the first update kept more than half of the initial error: position {errs[0]} "
          f"of {prior_errs[0]} m, rotation {post[0][1]} of {prior[0][1]} deg")


def state_err(x, truth):
    """(position error in metres, rotation error in degrees) of a 12-dim
    state against the true one."""
    from nerfnav_tpu_torch.nav.math_utils import calc_so3_err, vec_to_rot_matrix

    R = vec_to_rot_matrix(torch.as_tensor(np.stack([x[6:9], truth[6:9]]), dtype=torch.float32))
    return float(np.linalg.norm(x[0:3] - truth[0:3])), calc_so3_err(R[0].numpy(), R[1].numpy())


def camera_state(pose):
    """The 12-dim hover state whose camera pose (BODY_TO_CAM) is `pose`."""
    from nerfnav_tpu_torch.nav.agent import BODY_TO_CAM
    from nerfnav_tpu_torch.nav.math_utils import rot_matrix_to_vec

    x = np.zeros(12, np.float32)
    x[0:3] = pose[:3, 3]
    R_body = torch.as_tensor(pose[:3, :3] @ BODY_TO_CAM.T)
    x[6:9] = rot_matrix_to_vec(R_body).numpy()
    return x


def nav_network(device, sizes, nav, card):
    """Part (b): the trained flagship field (the training phase's EMA params
    and occupancy, loaded as cli/simulate.py loads a trainer checkpoint):
    the filter's renders at the true pose, one GN update on the dense path
    and one on the frozen path from a pose on the training orbit, and one
    replan through the field's density."""
    from nerfnav_tpu_torch.nav.agent import body_state_to_camera_pose

    x_true = camera_state(yaw_pose(45.0))
    pose = body_state_to_camera_pose(torch.as_tensor(x_true)).numpy()
    dx = np.zeros(12, np.float32)
    dx[0:3], dx[6:9] = [0.01, -0.008, 0.006], [0.004, -0.006, 0.003]
    base = ("-O", "--grid_hashmap_log2", str(sizes["log2"]), "--grid_size", str(sizes["grid"]))
    out = {"card": card}
    img, filts = None, {}
    for mode in ("dense", "frozen", "grid"):
        opt = nav_opt(nav, device, *base, "--filter_render", mode)
        traj_m, agent, filts[mode], _ = nav_mission_objects(opt, nav, device)
        if mode == "dense":
            traj = traj_m
            sync(device)
            t0 = time.perf_counter()
            img = agent.get_img(pose)
            out["observation_ms"] = (time.perf_counter() - t0) * 1e3
            out["observation_mean"] = float(img.mean())
    check(filts["frozen"].march_fn is not None and filts["dense"].march_fn is None,
          "--filter_render frozen did not get the trained occupancy")
    out["renders_at_truth"] = renders_at_truth(filts, img, x_true, dx, nav["batch"], device)
    # the same checkpoint with float32 MLPs: -O's flagship grid flag by flag
    f32 = ("--grid_levels", "4", "--grid_level_dim", "8", "--grid_layout", "cell",
           "--grid_hashmap_log2", str(sizes["log2"]), "--grid_size", str(sizes["grid"]),
           "--filter_render", "dense")
    cpu = torch.device("cpu")

    def filt_on(dev, *args):
        return nav_mission_objects(nav_opt(nav, dev, *args), nav, dev)[2]

    jacobian_card_vs_cpu(
        {"bfloat16": (filts["dense"], filt_on(cpu, *base, "--filter_render", "dense")),
         "float32": (filt_on(device, *f32), filt_on(cpu, *f32))},
        img, x_true + dx, nav["jac"])
    for mode in ("dense", "frozen"):
        filt = filts[mode]
        filt.set_initial_state(x_true + dx)
        t0 = time.perf_counter()
        x = filt.estimate_state(img, pose, NAV_HOVER)
        ms = (time.perf_counter() - t0) * 1e3
        check(filt.last_losses is not None, f"{mode}: the update found no keypoints")
        lm = filt.last_losses.cpu().numpy()
        check(np.isfinite(x).all() and np.isfinite(lm).all(), f"{mode}: non-finite update")
        check((np.diff(lm) <= 0).all(), f"{mode}: the LM loss rose {lm.tolist()}")
        before, after = state_err(x_true + dx, x_true), state_err(x, x_true)
        out[mode] = {"update_ms": ms, "lm_loss_first_last": [float(lm[0]), float(lm[-1])],
                     "pos_err_before_after": [before[0], after[0]],
                     "rot_err_deg_before_after": [before[1], after[1]]}
    # straight-line waypoints (A* is skipped: a 48-step field guarantees no
    # free path between the endpoints)
    t0 = time.perf_counter()
    losses = np.asarray(traj.learn_update(0))
    out["replan_ms"] = (time.perf_counter() - t0) * 1e3
    out["replan_loss_first_last"] = [float(losses[0]), float(losses[-1])]
    log("nav on the trained field:", json.dumps(out))
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"the replan loss {losses[0]} -> {losses[-1]} did not fall")
    if device.type == "cuda":
        nav_card_vs_cpu(device)


def renders_at_truth(filts, img, x_true, dx, n, device):
    """The filter's renders of its first n pool pixels at the true pose and
    at the update's start (x_true + dx), against the observation: the
    photometric MSE of each path, the frozen lattice's shade against the
    grid render (the same march and shade, so equal), and the share of
    valid samples in that march. Checks that the dense render at the truth
    reproduces the observation (NAV_TRUTH_MSE) and that the frozen render
    equals the grid render."""
    from nerfnav_tpu_torch.nav.agent import body_state_to_camera_pose

    dense, frozen = filts["dense"], filts["frozen"]
    _, _, pool, gt, _ = dense._front_end(img)
    check(pool is not None, "no keypoints in the trained field's observation")
    inds, gt = pool[:n], gt[:n]
    res = {}
    with torch.no_grad():
        for name, x in (("truth", x_true), ("start", x_true + dx)):
            ro, rd = dense._rays(body_state_to_camera_pose(torch.as_tensor(x, device=device)),
                                 inds)
            d_img = dense.render_fn(ro, rd)["image"]
            m = frozen.march_fn(ro, rd)
            f_img = frozen.render_frozen_fn(ro, rd, m["z"], m["dt"], m["valid"])["image"]
            res[f"mse_dense_at_{name}"] = float(((d_img - gt) ** 2).mean())
            res[f"mse_frozen_at_{name}"] = float(((f_img - gt) ** 2).mean())
            if name == "truth":
                g_img = filts["grid"].render_fn(ro, rd)["image"]
                res["frozen_vs_grid_max_abs"] = float((f_img - g_img).abs().max())
                res["frozen_vs_dense_mean_abs"] = float((f_img - d_img).abs().mean())
                res["march_valid_share"] = float(m["valid"].float().mean())
                res["rays_with_samples_share"] = float(m["valid"].any(dim=1).float().mean())
    log("nav filter renders at the truth, trained field:", json.dumps(res))
    check(res["mse_dense_at_truth"] <= NAV_TRUTH_MSE,
          f"the dense render at the truth is {res['mse_dense_at_truth']} (MSE) away from "
          f"the observation, bound {NAV_TRUTH_MSE}")
    check(res["frozen_vs_grid_max_abs"] <= 1e-5,
          f"the frozen render differs from the grid render: {res['frozen_vs_grid_max_abs']}")
    return res


def jacobian_card_vs_cpu(pairs, img, x, n):
    """The filter's 12-column forward-mode Jacobian of its rendered pixels
    at x, on its first n pool pixels (its Jacobian batch), through the
    trained flagship field at full width: for each MLP dtype, the card's
    filter against the CPU port's loaded from the same checkpoint. pairs:
    {"bfloat16" | "float32": (card filter, CPU filter)}.

    The field is piecewise trilinear in position (the hash grid) with ReLU
    MLPs, so its derivative jumps where a sample crosses a cell boundary: a
    pose that differs in its last bits (the card's sin/cos and matmuls round
    differently) moves J by percents. So the check follows the chain rule
    of the filter's J: the rays and their derivatives with respect to x,
    card against CPU (smooth, so NAV_JAC_F32_TOL entry by entry); then the
    render's Jacobian along the CPU's ray derivatives, from the CPU's
    float32 rays on both devices, so that the samples lie on the same side
    of every boundary (NAV_JAC_F32_TOL, NAV_JAC_BF16_TOL, relative to the
    largest entry; the image within the same, absolute). Also reports the
    filter's own J(x) card against CPU and the CPU's J(x) against J at x
    shifted by 1e-7, which show the jumps."""
    from torch.func import jacfwd

    card_f, cpu_f = pairs["float32"]
    _, _, pool, gt, _ = cpu_f._front_end(img)
    inds, gt = pool[:n].cpu(), gt[:n].cpu()

    def rays_of(v, f):
        ro, rd = f._rays(f.state_to_pose(v), inds.to(f.device))
        return torch.cat([ro, rd], -1)

    ray_pairs = []
    for f in (card_f, cpu_f):
        xt = torch.as_tensor(x, device=f.device)
        with torch.no_grad():  # (n, 6), (n, 6, 12)
            ray_pairs.append((rays_of(xt, f).cpu(), jacfwd(rays_of)(xt, f).cpu()))
    rays, d_rays = ray_pairs[1]
    J, img_at = {}, {}
    for dtype, pair in pairs.items():
        for where, f in zip(("card", "cpu"), pair):
            r0, dr = rays.to(f.device), d_rays.to(f.device)

            def image(v, f=f, r0=r0, dr=dr):
                rr = r0 + dr @ v  # == r0 at v = 0
                out = f.render_fn(rr[:, :3], rr[:, 3:])["image"].reshape(-1)
                return out, out

            with torch.no_grad():
                J[dtype, where], img_at[dtype, where] = (
                    t.cpu().double() for t in jacfwd(image, has_aux=True)(
                        torch.zeros(12, device=f.device)))

    def max_rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def frob_rel(a, b):
        return float((a - b).norm() / b.norm())

    res = {"rays": n, "J_max": float(J["float32", "cpu"].abs().max()),
           "rays_max_abs_rel": max_rel(ray_pairs[0][0].double(), rays.double()),
           "ray_derivatives_max_abs_rel": max_rel(ray_pairs[0][1].double(), d_rays.double())}
    for dtype in pairs:
        a, b = J[dtype, "card"], J[dtype, "cpu"]
        res[dtype] = {"J_max_abs_rel": max_rel(a, b), "J_frobenius_rel": frob_rel(a, b),
                      "image_max_abs": float((img_at[dtype, "card"]
                                              - img_at[dtype, "cpu"]).abs().max())}
    res["bfloat16_vs_float32_cpu_J_max_abs_rel"] = max_rel(J["bfloat16", "cpu"],
                                                           J["float32", "cpu"])

    # the filter's own J(x), float32 MLPs: card vs CPU, and CPU vs CPU at x + shift
    shift = np.zeros(12, np.float32)
    shift[[0, 1, 2, 6, 7, 8]] = np.random.default_rng(0).choice([-1e-7, 1e-7], 6)
    e2e = {}
    for where, f, xx in (("card", pairs["float32"][0], x), ("cpu", cpu_f, x),
                         ("cpu_shifted", cpu_f, x + shift)):
        i, g, xp = inds.to(f.device), gt.to(f.device), torch.as_tensor(x, device=f.device)

        def res_of(v, f=f, i=i, g=g, xp=xp):
            return f.residuals_of(v, i, g, xp, torch.eye(12, device=f.device))[:3 * n]

        with torch.no_grad():
            e2e[where] = jacfwd(res_of)(torch.as_tensor(xx, device=f.device)).cpu().double()
    res["filter_J_of_x_card_vs_cpu"] = {"max_abs_rel": max_rel(e2e["card"], e2e["cpu"]),
                                        "frobenius_rel": frob_rel(e2e["card"], e2e["cpu"])}
    res["filter_J_of_x_cpu_shifted_1e-7_vs_cpu"] = {
        "max_abs_rel": max_rel(e2e["cpu_shifted"], e2e["cpu"]),
        "frobenius_rel": frob_rel(e2e["cpu_shifted"], e2e["cpu"])}
    res["bounds"] = {"float32": NAV_JAC_F32_TOL, "bfloat16": NAV_JAC_BF16_TOL}
    log("render Jacobian through the trained field, this device vs the CPU port:",
        json.dumps(res))
    check(max(res["rays_max_abs_rel"], res["ray_derivatives_max_abs_rel"]) <= NAV_JAC_F32_TOL,
          f"the rays (their derivatives) {res['rays_max_abs_rel']} "
          f"({res['ray_derivatives_max_abs_rel']}) away from the CPU port's, "
          f"bound {NAV_JAC_F32_TOL}")
    for dtype, tol in (("float32", NAV_JAC_F32_TOL), ("bfloat16", NAV_JAC_BF16_TOL)):
        check(res[dtype]["J_max_abs_rel"] <= tol and res[dtype]["image_max_abs"] <= tol,
              f"{dtype} MLPs: the render Jacobian (image) {res[dtype]['J_max_abs_rel']} "
              f"({res[dtype]['image_max_abs']}) away from the CPU port's, bound {tol}")


def nav_card_vs_cpu(device):
    """One GN update at the CPU tests' size (32x32 observation of the
    textured sphere, the small xla fp32 network field, batch 64): the card
    against the CPU port from the same state and draws."""
    from nerfnav_tpu_torch.data.rays import get_all_rays, get_rays_at
    from nerfnav_tpu_torch.data.synthetic import textured_sphere_field
    from nerfnav_tpu_torch.models.network import NetworkConfig, init_network
    from nerfnav_tpu_torch.models.renderer import RenderConfig, make_field, render_rays
    from nerfnav_tpu_torch.nav.agent import Agent, AgentConfig, body_state_to_camera_pose
    from nerfnav_tpu_torch.nav.dynamics import DynamicsConfig
    from nerfnav_tpu_torch.nav.estimator import Estimator, EstimatorConfig

    hw, cpu = 32, torch.device("cpu")
    x0 = np.zeros(12, np.float32)
    x0[0:3], x0[6:9] = [0.0, -1.6, 0.0], [0.0, 0.0, np.pi / 2]
    obs = Agent(x0, AgentConfig(H=hw, W=hw, focal=float(hw)), field=textured_sphere_field(),
                device=cpu).get_img(body_state_to_camera_pose(torch.as_tensor(x0)).numpy())
    # the plain encode, as nav's configs take it: the filter's jacfwd needs
    # forward mode, which the hash-grid kernel lacks
    cfg = NetworkConfig(bound=1.0, grid_levels=2, grid_level_dim=8, grid_log2_hashmap_size=10,
                        grid_max_resolution=32, grid_layout="cell", density_scale=10.0,
                        grid_backend="xla")
    params = init_network(torch.Generator().manual_seed(5), cfg, device=cpu)
    rcfg = RenderConfig(num_steps=32, upsample_steps=0, min_near=0.05)
    ecfg = EstimatorConfig(gn_iters=4, gn_jac_batch=32, batch_size=64, pool_size=256)
    outs = []
    for dev in (cpu, device):
        field = make_field({k: [t.to(dev) for t in v] for k, v in params.items()}, cfg)
        intr = torch.tensor([hw, hw, hw / 2, hw / 2], dtype=torch.float32, device=dev)
        filt = Estimator(
            ecfg, DynamicsConfig(dt=0.2),
            lambda o, d, f=field: render_rays(f, rcfg, o, d, bg_color=1.0),
            lambda p, i=intr: get_all_rays(p, i, hw, hw), body_state_to_camera_pose,
            get_rays_at_fn=lambda p, n, i=intr: get_rays_at(p, i, hw, n), device=dev)
        _, _, pool, gt, _ = filt._front_end(obs)
        check(pool is not None, "no keypoints in the 32x32 observation")
        sel = torch.randint(0, 256, (64,), generator=torch.Generator().manual_seed(3))
        xt = torch.as_tensor(x0 + np.r_[0.02, -0.01, 0.01, 0, 0, 0, 0.01, 0, -0.02, 0, 0, 0]
                             .astype(np.float32), device=dev)
        outs.append([t.cpu() for t in filt.gn_fused(
            xt, torch.as_tensor(NAV_HOVER, device=dev), torch.eye(12, device=dev) * 0.5,
            pool, gt, sel.to(dev))])
    (_, _, x_c, sig_c, l_c), (_, _, x_d, sig_d, l_d) = outs
    x_rel = float((x_d - x_c).abs().max() / x_c.abs().max())
    sig_rel = float((sig_d - sig_c).abs().max() / sig_c.abs().max())
    log("one GN update at the CPU tests' size, this device vs the CPU port:", json.dumps({
        "x_rel": x_rel, "sig_post_rel": sig_rel,
        "lm_loss_rel": float(((l_d - l_c).abs() / l_c.abs()).max())}))
    check(x_rel <= 1e-4, f"x {x_rel} away from the CPU port's")
    check(sig_rel <= 1e-3, f"sig_post {sig_rel} away from the CPU port's")


BLENDER_STAND_IN = """#!{python}
# Blender stand-in: blender -b <blend> -P <script> -- pose.json out.png
import json, sys
import cv2
import numpy as np

argv = sys.argv[sys.argv.index("--") + 1:]
with open(argv[0]) as f:
    req = json.load(f)
t = np.round(np.asarray(req["pose"])[:3, 3] * 100.0)
h, w = req["res_y"], req["res_x"]
y, x = np.mgrid[0:h, 0:w]
rgba = np.zeros((h, w, 4), np.uint8)
rgba[..., 0] = (x * 37 + 3 * t[0]) % 256
rgba[..., 1] = (y * 11 + 5 * t[1]) % 256
rgba[..., 2] = 40
rgba[..., 3] = (x * 5 + y * 29 + 2 * t[2]) % 256
cv2.imwrite(argv[1], cv2.cvtColor(rgba, cv2.COLOR_RGBA2BGRA))
"""


def nav_blender(device, nav):
    """Part (a'): one Agent.step under the Blender backend, through a
    stand-in for Blender written under build/ (run by this Python, which has
    cv2: it answers the request with an RGBA PNG whose pixels depend on the
    pose), on this device and on the CPU port: the observation is the PNG
    composited on white, the states agree at the nav tests' 1e-5, and
    get_img at one fixed pose returns the same image on both."""
    import cv2

    from nerfnav_tpu_torch.nav.agent import Agent, AgentConfig, body_state_to_camera_pose
    from nerfnav_tpu_torch.nav.dynamics import DynamicsConfig

    stand_in = os.path.join(NAV_WS, "blender_stand_in")
    os.makedirs(NAV_WS, exist_ok=True)
    with open(stand_in, "w") as f:
        f.write(BLENDER_STAND_IN.format(python=sys.executable))
    os.chmod(stand_in, 0o755)
    x0 = camera_state(yaw_pose(0.0))
    agents = {}
    for name, dev in (("dev", device), ("cpu", torch.device("cpu"))):
        cfg = AgentConfig(dyn=DynamicsConfig(dt=0.1), H=nav["obs"], W=nav["obs"],
                          focal=float(nav["obs"]), backend="blender", blend_file="scene.blend",
                          blender_cmd=stand_in, cache_dir=os.path.join(NAV_WS, f"blender_{name}"))
        agents[name] = Agent(x0, cfg, device=dev)
    action = NAV_HOVER + np.asarray([0.6, 0.05, -0.04, 0.02], np.float32)
    t0 = time.perf_counter()
    img, state, pose = agents["dev"].step(action)
    step_ms = (time.perf_counter() - t0) * 1e3
    _, state_cpu, _ = agents["cpu"].step(action)
    png = cv2.imread(os.path.join(NAV_WS, "blender_dev", "obs.png"), cv2.IMREAD_UNCHANGED)
    rgba = cv2.cvtColor(png, cv2.COLOR_BGRA2RGBA).astype(np.float32) / 255.0
    want = (np.clip(rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:]), 0, 1) * 255).astype(
        np.uint8)
    fixed = body_state_to_camera_pose(torch.as_tensor(x0)).numpy()
    fixed_imgs = [a.get_img(fixed) for a in agents.values()]
    out = {"step_ms": step_ms, "state_max_abs_vs_cpu": float(np.abs(state - state_cpu).max()),
           "moved": float(np.abs(state - x0).max()), "image": list(img.shape),
           "image_mean": float(img.mean())}
    log("nav blender backend (stand-in), this device vs the CPU port:", json.dumps(out))
    check(img.shape == (nav["obs"], nav["obs"], 3) and np.array_equal(img, want),
          "the Blender observation is not the stand-in's PNG composited on white")
    check(out["state_max_abs_vs_cpu"] <= 1e-5 and out["moved"] > 1e-4,
          f"the Blender agent's step: {out}")
    check(np.array_equal(*fixed_imgs),
          "the Blender observation at one pose differs between this device's agent and the CPU's")
    check(np.abs(pose - body_state_to_camera_pose(torch.as_tensor(state)).numpy()).max() == 0,
          "the step's pose is not its state's")
    return out


def nav_phase(device, sizes, card):
    """Both parts of the nav phase; returns the fused-MLP launches in it
    (nav forces the xla MLP and the plain encode, so 0)."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm
    from nerfnav_tpu_torch.ops import hashgrid as hg

    nav = sizes["nav"]
    nav_front_end()
    fm.fused_mlp.launches = hg.hash_grid_encode.launches = 0
    nav_mission(device, nav, card)
    nav_blender(device, nav)
    nav_network(device, sizes, nav, card)
    launches = fm.fused_mlp.launches
    GRID_LAUNCHES["nav_launches"] = hg.hash_grid_encode.launches
    log(f"nav phase: fused_mlp launches {launches}, hash-grid launches "
        f"{GRID_LAUNCHES['nav_launches']} (nav runs the xla MLP chain and the plain encode)")
    check(launches == 0, f"the nav path launched the fused MLP {launches} times")
    check(GRID_LAUNCHES["nav_launches"] == 0,
          f"the nav path launched the hash-grid kernel {GRID_LAUNCHES['nav_launches']} times")
    shutil.rmtree(NAV_WS, ignore_errors=True)
    return launches


# ------------------------------------------------------------ reference phase
REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ref")
# the val PSNR the grid run must gain over the untrained field, in dB (the
# bar tests/test_trainer_e2e.py sets for the JAX trainer)
REF_PSNR_GAIN = 4.0
# card vs CPU march of a 64x64 crop from the same rays: the share of rays
# whose valid row must be equal, and the z / dt bound where both are valid
REF_MARCH_RAYS_EQUAL = 0.999
REF_MARCH_ZDT_TOL = 1e-6
# the synthetic scene's seed: rand_poses puts seed 19's two val cameras
# within 11.3 and 10.7 degrees of a train camera (seed 0's within 43 and
# 44: those views see a side of the sphere no train view does, and the val
# PSNR would measure that, not the trainer)
REF_SCENE_SEED = 19
# the reference-exact network at full width on the card (the CLI's defaults
# without -O: corner 16x2 @ 2^19, sigma 32-64-16, color 31-64-64-3, f32
# masters, 4096 rays, 512 dense samples), toy widths for the rehearsal;
# depth is cut in steps only: 200 grid steps (the six 800x800 grid frames
# of the run and its --test take 11-15 s each and most of the phase)
REF_SIZES = {
    "card": {"hw": 800, "grid_iters": 200, "dense_steps": 16, "timed_grid": 16,
             "timed_dense": 4, "flags": []},
    "rehearsal": {"hw": 32, "grid_iters": 200, "dense_steps": 8, "timed_grid": 2,
                  "timed_dense": 1,
                  "flags": ["--grid_levels", "4", "--grid_hashmap_log2", "12",
                            "--grid_max_resolution", "64", "--grid_size", "32",
                            "--num_rays", "256", "--num_steps", "32",
                            "--max_ray_batch", "1024", "--min_near", "0.05"]},
}


def ref_args(ref, ws, device, *mode, root=REF_DIR):
    """main_nerf's argv for the synthetic scene under root (REF_DIR)."""
    return [os.path.join(root, "scene"), *mode, "--bound", "1.0", "--scale", "1.0",
            "--workspace", os.path.join(root, ws), "--device", str(device),
            *ref["flags"]]


def ref_trainer(argv):
    """The Trainer main_nerf builds for an argv, and the scene's val split."""
    from nerfnav_tpu_torch.cli import flags, main_nerf

    tr, ds_opt = main_nerf.make_trainer(flags.build_parser("chip_smoke").parse_args(argv))
    return tr, ref_split("val", os.path.dirname(ds_opt.path))


def ref_split(split, root=REF_DIR):
    from nerfnav_tpu_torch.data.provider import DatasetOptions, NeRFDataset

    return NeRFDataset(DatasetOptions(path=os.path.join(root, "scene"), scale=1.0), split)


def timed_steps(tr, ds, n, device):
    """ms per train step over n warm steps, the fused launches per step, and
    one profiled step's device idle share."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    arrays = tr._device_arrays(ds)
    tr.train_step(tr.state, arrays, tr.draw_step(tr.state, 0, ds.H, ds.W))
    sync(device)
    before = fm.fused_mlp.launches
    t0 = time.perf_counter()
    for i in range(n):
        tr.train_step(tr.state, arrays, tr.draw_step(tr.state, i % len(ds), ds.H, ds.W))
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3 / n
    out = {"step_ms": ms, "fused_launches_per_step": (fm.fused_mlp.launches - before) / n}
    if device.type == "cuda":
        draws = tr.draw_step(tr.state, 0, ds.H, ds.W)
        prof = profile_call(lambda: tr.train_step(tr.state, arrays, draws), ms,
                            "profiled step")
        out["device_idle_share"] = prof and prof["device_idle_share_of_unprofiled_call"]
    return out


class FrameClock:
    """Inside the block, times every Trainer.render_full call (between two
    synchronizations; the callers read the frame back anyway) and counts
    its fused launches, and the background net's where a BgLaunches
    counter is given."""

    def __init__(self, device, bg=None):
        self.device, self.ms, self.launches = device, [], []
        self.bg, self.bg_launches = bg, []

    def __enter__(self):
        from nerfnav_tpu_torch.ops import fused_mlp as fm
        from nerfnav_tpu_torch.training.trainer import Trainer

        render_full = self._render_full = Trainer.render_full

        def timed(tr, *a, **k):
            sync(self.device)
            bg_before = self.bg.launches if self.bg else 0
            before, t0 = fm.fused_mlp.launches, time.perf_counter()
            out = render_full(tr, *a, **k)
            sync(self.device)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.launches.append(fm.fused_mlp.launches - before)
            if self.bg:
                self.bg_launches.append(self.bg.launches - bg_before)
            return out

        Trainer.render_full = timed
        return self

    def __exit__(self, *exc):
        from nerfnav_tpu_torch.training.trainer import Trainer

        Trainer.render_full = self._render_full

    def summary(self):
        out = {"frame_ms": self.ms, "fused_launches_per_frame": self.launches}
        if self.bg:
            out["bg_launches_per_frame"] = self.bg_launches
        return out


class BgLaunches:
    """Inside the block, counts the fused launches made inside
    models/network.py::background, the background net's."""

    def __enter__(self):
        from nerfnav_tpu_torch.models import network as net
        from nerfnav_tpu_torch.ops import fused_mlp as fm

        self.launches = 0
        background = self._background = net.background

        def counted(*a, **k):
            before = fm.fused_mlp.launches
            out = background(*a, **k)
            self.launches += fm.fused_mlp.launches - before
            return out

        net.background = counted
        return self

    def __exit__(self, *exc):
        from nerfnav_tpu_torch.models import network as net

        net.background = self._background


def results_written(ws):
    """--test's outputs: frames, depth maps, and the video or the log line
    that says why there is none. Returns whether the video was written."""
    out = set(os.listdir(os.path.join(REF_DIR, ws, "results")))
    with open(os.path.join(REF_DIR, ws, "log_ngp.txt")) as f:
        logged = "no mp4 writer opened" in f.read()
    check({"ngp_0000.png", "ngp_0000_depth.png", "ngp_0001.png"} <= out,
          f"{ws}: --test wrote {sorted(out)}")
    check("ngp.mp4" in out or logged, f"{ws}: no video and no logged reason")
    return "ngp.mp4" in out


def gamma_ladders(tr):
    """Phase-A candidates per ray of the eval march: the gamma ladder (auto
    and on the planned span) beside the dt_gamma=0 normalized ladder (auto
    and occupancy-planned) on the same occupancy."""
    import dataclasses

    from nerfnav_tpu_torch.ops import marching as tm

    ecfg = tr._eval_march_cfg()
    span = tr._planned_ladder(tr.occupancy)
    occ = np.unpackbits(tr.occupancy["bitfield"].cpu().numpy(), axis=-1, bitorder="little")
    flat = dataclasses.replace(ecfg, dt_gamma=0.0)
    return {"gamma_auto": len(ecfg.coarse_gamma_ladder[0]), "gamma_planned_span": span,
            "gamma_planned": len(tr._apply_ladder_plan(ecfg, span).coarse_gamma_ladder[0]),
            "dt0_auto": tm.full_ladder_steps(flat),
            "dt0_planned": tm.plan_occupied_ladder(occ, flat)}


def crop_march_vs_cpu(tr, ds, ref, device):
    """The eval march of a 64x64 crop of val view 0 on this device and on
    the CPU port from the same rays (made on the CPU) and occupancy; then
    the crop's image rendered on each. Each march is set up as render_full
    sets it up (Trainer._frame_march)."""
    from nerfnav_tpu_torch.ops.marching import march

    cpu = torch.device("cpu")
    tr_cpu, _ = ref_trainer(ref_args(ref, "crop_cpu", cpu, "--cuda_ray", "--ff"))
    tr_cpu.set_occupancy({k: v.to(cpu) for k, v in tr.occupancy.items()})
    params_cpu = {k: [t.to(cpu) for t in v] for k, v in tr.state.ema_params.items()}
    intr = crop_intrinsics(ds)
    ms = []
    with torch.no_grad():
        ro, rd, _ = tr_cpu._frame_rays(ds.poses[0], intr, 64, 64, 4096, None)
        for t in (tr, tr_cpu):
            mcfg, occ = t._frame_march(intr, 64, 64, rd)
            m = march(ro.to(t.device), rd.to(t.device), occ, mcfg)
            ms.append({k: v.cpu() for k, v in m.items()})
    md, mc = ms
    same = (md["valid"] == mc["valid"]).all(dim=1)
    both = mc["valid"] & same[:, None]
    zdt = max(float((md[k] - mc[k])[both].abs().max()) if both.any() else 0.0
              for k in ("z", "dt"))
    img_d, _ = tr.render_full(tr.state.ema_params, ds.poses[0], intr, 64, 64)
    img_c, _ = tr_cpu.render_full(params_cpu, ds.poses[0], intr, 64, 64)
    res = {"rays": int(same.numel()), "rays_valid_differ": int((~same).sum()),
           "valid_samples": int(mc["valid"].sum()), "z_dt_max_abs": zdt,
           "image_mean_abs": float((img_d.cpu() - img_c).abs().mean()),
           "gamma_span": mcfg.gamma_span, "beam": mcfg.beam}
    log("gamma march of a 64x64 crop, this device vs the CPU port:", json.dumps(res))
    check(res["valid_samples"] > 0, "the crop's march kept no sample")
    check(float(same.float().mean()) >= REF_MARCH_RAYS_EQUAL,
          f"{res['rays_valid_differ']} rays' valid rows differ")
    check(zdt <= REF_MARCH_ZDT_TOL, f"z/dt {zdt} apart where both are valid")
    check(res["image_mean_abs"] <= 5e-3, f"crop image mean |diff| {res['image_mean_abs']}")


# the train images whose batches the dense card-vs-CPU step check draws
REF_DENSE_CHECK_IMAGES = (1, 4, 6)


def dense_step_vs_cpu(ref, device, root=REF_DIR, extra=(), images=REF_DENSE_CHECK_IMAGES):
    """One dense train step of the reference network at 256 rays with xla
    fp32 MLPs, this device against the CPU port from the same params (the
    seed's), targets, draws and rays, on the train images `images` (the
    scene under root, with the extra flags); the first batch runs twice on
    this device, so its own run-to-run spread (the atomic adds of
    index_add_) prints beside the CPU's. The rays, and a background
    network's sphere coordinates, are made on the CPU for both: a ray one
    float32 step off (the card's 3x3 matmul in get_rays) moves the fine hash
    levels' table gradients by 1e-3 to 7e-3 relative (measured on the CPU),
    because a trilinear weight moves by the level's resolution times the
    shift, and the background grid's finest level has 2048 cells a side
    (the card's atan2 and acos may end an ulp off the CPU's;
    sph_vs_cpu holds them within 1e-6)."""
    from nerfnav_tpu_torch.models import renderer as renderer_mod
    from nerfnav_tpu_torch.training import trainer as trainer_mod

    cpu = torch.device("cpu")
    argv = ("--num_rays", "256", "--ckpt", "scratch", *extra)
    tr_c, _ = ref_trainer(ref_args(ref, "step_cpu", cpu, *argv, root=root))
    tr_d, _ = ref_trainer(ref_args(ref, "step_dev", device, *argv, root=root))
    # the gradients' order: the params' sorted keys (trainer._leaves)
    names = [f"{k}[{i}]" for k in sorted(tr_c.state.params)
             for i in range(len(tr_c.state.params[k]))]
    ds = ref_split("train", root)
    arrays_c, arrays_d = tr_c._device_arrays(ds), tr_d._device_arrays(ds)
    to = lambda t: None if t is None else t.to(device)  # noqa: E731
    get_rays, sph_from_ray = trainer_mod.get_rays, renderer_mod.sph_from_ray

    def cpu_sph(rays_o, rays_d, radius):
        return sph_from_ray(rays_o.cpu(), rays_d.cpu(), radius).to(rays_o.device)

    rows, loss_rels, grad_rels = [], [], []
    for b, img in enumerate(images):
        draws = tr_c.draw_step(tr_c.state, img, ds.H, ds.W)
        draws_d = draws._replace(rays=draws.rays._replace(inds=to(draws.rays.inds)),
                                 bg=to(draws.bg), jitter=to(draws.jitter), u=to(draws.u))
        want = tr_c.loss_and_grads(tr_c.state, arrays_c, draws)

        def cpu_rays(pose, intrinsics, H, W, d, error_map=None, rays=draws.rays):
            r = get_rays(pose.cpu(), intrinsics.cpu(), H, W, rays, None)
            return {k: v.to(pose.device) for k, v in r.items()}

        trainer_mod.get_rays, renderer_mod.sph_from_ray = cpu_rays, cpu_sph
        try:
            got = [tr_d.loss_and_grads(tr_d.state, arrays_d, draws_d)
                   for _ in range(2 if b == 0 else 1)]
        finally:
            trainer_mod.get_rays, renderer_mod.sph_from_ray = get_rays, sph_from_ray
        loss_rel = abs(float(got[0].loss) - float(want.loss)) / abs(float(want.loss))
        errs = [rel_l2(a.cpu(), w) for a, w in zip(got[0].grads, want.grads)]
        worst = int(np.argmax(errs))
        row = {"image": img, "loss_rel": loss_rel, "grad_rel_l2_max": errs[worst],
               "worst_leaf": names[worst], "grad_rel_l2": errs,
               "grad_norms": [float(w.norm()) for w in want.grads]}
        if len(got) == 2:
            row["device_rerun_grad_rel_l2_max"] = max(
                rel_l2(a.cpu(), g.cpu()) for a, g in zip(got[0].grads, got[1].grads))
            row["device_rerun_loss_equal"] = float(got[0].loss) == float(got[1].loss)
        rows.append(row)
        loss_rels.append(loss_rel)
        grad_rels.append(errs[worst])
    log(f"one dense step at 256 rays ({os.path.basename(root)}, xla fp32 MLPs), this "
        "device vs the CPU port:", json.dumps({
            "samples_per_ray": tr_c.rcfg.num_steps, "leaves": names,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "loss_rel_max": max(loss_rels), "grad_rel_l2_max": max(grad_rels),
            "batches": rows}))
    check(max(loss_rels) <= 1e-5, f"dense loss {max(loss_rels)} away from the CPU port's")
    check(max(grad_rels) <= 1e-4,
          f"dense gradients {max(grad_rels)} away from the CPU port's (L2)")


def faces_points(bound, resolutions, n, seed=0):
    """n float32 points on, and one float32 step either side of, the cell
    faces of the resolutions' lattices over [-bound, bound]."""
    rng = np.random.default_rng(seed)
    r = np.asarray(resolutions)[rng.integers(0, len(resolutions), (n, 1))]
    x = (rng.integers(0, r + 1, (n, 3)) / r * 2.0 * bound - bound).astype(np.float32)
    step = rng.integers(-1, 2, (n, 3))
    x = np.where(step > 0, np.nextafter(x, np.float32(np.inf)),
                 np.where(step < 0, np.nextafter(x, np.float32(-np.inf)), x))
    return np.clip(x, -bound, bound).astype(np.float32)


def encode_bound_check(device, bound=1.5, n=2**16):
    """The reference-exact hash grid at a bound that is not a power of two,
    this device against the CPU port on points next to cell faces: the cell
    of every point at every level equal, the features within 1e-6."""
    from nerfnav_tpu_torch.ops.hashgrid import HashGridConfig, hash_grid_encode, unit_coords

    cfg = HashGridConfig(desired_resolution=int(2048 * bound))
    gen = torch.Generator().manual_seed(2)
    tables = [torch.rand((s, cfg.row_dim), generator=gen) * 2 - 1 for s in cfg.level_sizes]
    x = torch.as_tensor(faces_points(bound, cfg.resolutions, n))
    cells, feats = [], []
    with torch.no_grad():
        for dev in (torch.device("cpu"), device):
            x01 = unit_coords(x.to(dev), bound)
            cells.append(torch.stack([torch.floor(x01 * r) for r in cfg.resolutions]).cpu())
            feats.append(hash_grid_encode([t.to(dev) for t in tables], x.to(dev), cfg,
                                          bound=bound).cpu())
    differ = int((cells[0] != cells[1]).any(dim=-1).sum())
    err = float((feats[0] - feats[1]).abs().max())
    log(f"hash grid at bound {bound}, {n} points next to cell faces, this device vs the "
        f"CPU port: point-levels in another cell {differ}, features max |diff| {err:.3g}")
    check(differ == 0, f"{differ} point-levels fall in another cell than on the CPU")
    check(err <= 1e-6, f"features {err} away from the CPU port's")


def reference_phase(device, sizes, card):
    """The reference-exact configuration through main_nerf on a synthetic
    scene (see the module docstring). Returns the fused launches per step
    and per frame of both paths."""
    from nerfnav_tpu_torch.cli import main_nerf
    from nerfnav_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    ref = sizes["ref"]
    hw = ref["hw"]
    shutil.rmtree(REF_DIR, ignore_errors=True)
    phase_t0 = t0 = time.perf_counter()
    make_synthetic_scene(os.path.join(REF_DIR, "scene"), n_train=8, n_val=2, H=hw, W=hw,
                         seed=REF_SCENE_SEED, device=device)
    sync(device)
    log(f"reference phase: scene of 8 + 2 views at {hw}x{hw} written in "
        f"{time.perf_counter() - t0:.1f} s")
    encode_bound_check(device)
    train_ds = ref_split("train")

    # the grid run: --cuda_ray --ff at the default dt_gamma 1/128, from the
    # untrained field's val PSNR, then --test
    grid = ref_args(ref, "grid", device, "--cuda_ray", "--ff", "--iters",
                    str(ref["grid_iters"]))
    tr0, val = ref_trainer(ref_args(ref, "untrained", device, "--cuda_ray", "--ff"))
    psnr0 = tr0.evaluate(val)
    del tr0
    fm.fused_mlp.launches = 0
    t0 = time.perf_counter()
    tr = main_nerf.main(grid)
    sync(device)
    grid_s, grid_launches = time.perf_counter() - t0, fm.fused_mlp.launches
    psnr = tr.stats["results"][-1]
    log("reference grid run:", json.dumps({
        "card": card, "steps": tr.global_step, "run_s": grid_s, "val_psnr_untrained": psnr0,
        "val_psnr": psnr, "loss_per_epoch": tr.stats["loss"], "fused_launches": grid_launches,
        "dt_gamma": tr.march_cfg.dt_gamma,
        "grid": [tr.cfg.grid_levels, tr.cfg.grid_level_dim, tr.cfg.grid_log2_hashmap_size,
                 tr.cfg.grid_layout]}))
    check(psnr >= psnr0 + REF_PSNR_GAIN,
          f"val PSNR {psnr:.3f} is not {REF_PSNR_GAIN} dB over the untrained {psnr0:.3f}")
    if device.type == "cuda":
        check(grid_launches > 0, "the grid run never launched the fused-MLP kernel")
    log("phase-A candidates per ray:", json.dumps(gamma_ladders(tr)))
    crop_march_vs_cpu(tr, val, ref, device)
    t0 = time.perf_counter()
    with FrameClock(device) as frames:
        tt = main_nerf.main(grid + ["--test"])
    log(f"grid --test: {time.perf_counter() - t0:.1f} s, val PSNR "
        f"{tt.stats['results'][-1]:.4f}, video written {results_written('grid')}")
    check(abs(tt.stats["results"][-1] - psnr) <= 1e-3, "--test's PSNR is not the run's")
    grid_t = {"card": card, **timed_steps(tr, train_ds, ref["timed_grid"], device),
              **frames.summary()}
    log("reference grid timing (the frames are --test's):", json.dumps(grid_t))
    del tr, tt

    # the dense run: --ff without an occupancy grid, 512 samples a ray; a few
    # steps through the CLI's Trainer, then --test
    # the loss is read on one fixed batch (pixels, backgrounds, jitter)
    # before and after: a step's own loss swings with its random backgrounds
    dense = ref_args(ref, "dense", device, "--ff")
    tr, _ = ref_trainer(dense)
    arrays = tr._device_arrays(train_ds)
    probe = tr.draw_step(tr.state, 0, train_ds.H, train_ds.W)
    loss0 = float(tr.loss_and_grads(tr.state, arrays, probe).loss)
    fm.fused_mlp.launches = 0
    t0 = time.perf_counter()
    tr.train(train_ds, max_epochs=1, steps_per_epoch=ref["dense_steps"])
    sync(device)
    dense_s, dense_launches = time.perf_counter() - t0, fm.fused_mlp.launches
    loss1 = float(tr.loss_and_grads(tr.state, arrays, probe).loss)
    del arrays
    log("reference dense run:", json.dumps({
        "card": card, "steps": tr.global_step, "run_s": dense_s,
        "fixed_batch_loss_before_after": [loss0, loss1], "loss_per_epoch": tr.stats["loss"],
        "fused_launches": dense_launches, "samples_per_ray": tr.rcfg.num_steps}))
    check(math.isfinite(loss1) and loss1 < loss0, "the dense loss did not fall")
    if device.type == "cuda":
        check(dense_launches > 0, "the dense run never launched the fused-MLP kernel")
    dense_step_vs_cpu(ref, device)
    t0 = time.perf_counter()
    with FrameClock(device) as frames:
        tt = main_nerf.main(dense + ["--test"])
    log(f"dense --test: {time.perf_counter() - t0:.1f} s, val PSNR "
        f"{tt.stats['results'][-1]:.4f}, video written {results_written('dense')}")
    dense_t = {"card": card, **timed_steps(tr, train_ds, ref["timed_dense"], device),
               **frames.summary()}
    log("reference dense timing (the frames are --test's):", json.dumps(dense_t))
    shutil.rmtree(REF_DIR, ignore_errors=True)
    log(f"reference phase: {time.perf_counter() - phase_t0:.1f} s")
    return {"ref_grid_launches_per_step": grid_t["fused_launches_per_step"],
            "ref_grid_launches_per_frame": grid_t["fused_launches_per_frame"],
            "ref_dense_launches_per_step": dense_t["fused_launches_per_step"],
            "ref_dense_launches_per_frame": dense_t["fused_launches_per_frame"]}


# ----------------------------------------------------------- background phase
BG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_bg")
BG_RADIUS = 32.0
# the val PSNR the run must gain over the untrained field (whose random bg
# net paints a grey sky), and the trained render's margin over the same
# render with its bg net swapped for white, in dB
BG_PSNR_GAIN = 4.0
BG_WHITE_GAIN = 2.0
# the reference-exact network with torch-ngp's lattice at full width on the
# card, toy widths for the rehearsal; depth is cut in steps only
BG_SIZES = {"card": {"hw": 800, "iters": 200, "timed": 8, "flags": []},
            "rehearsal": {"hw": 32, "iters": 200, "timed": 2,
                          "flags": REF_SIZES["rehearsal"]["flags"]}}
BG_MODE = ("--cuda_ray", "--ff", "--bg_radius", str(BG_RADIUS),
           "--grid_coord_convention", "ngp")


def sky(sph, d):
    """The scene's sky, painted on the background sphere: a blue far from
    the grey an untrained bg net paints, smooth in the sphere coordinates
    (u, v) in [-1, 1]^2, continuous across the azimuth seam (u = +-1) and at
    the poles (v = +-1)."""
    u, v = sph[:, 0] * math.pi, sph[:, 1] * math.pi
    return torch.stack([0.2 + 0.15 * torch.sin(u) * torch.cos(0.5 * v),
                        0.5 + 0.2 * torch.cos(v),
                        0.85 + 0.1 * torch.cos(u) * torch.cos(0.5 * v)], dim=-1)


def write_bg_scene(root, hw, device):
    """A blender-layout RGB scene (3-channel PNGs, no alpha) under
    root/scene: the analytic sphere of make_synthetic_scene in front of
    `sky` on the sphere of radius BG_RADIUS, rendered by the dense
    render_rays (128 samples), 8 train and 1 val views on make_synthetic_scene's
    orbit (radius 1.8, fov 0.9, seed REF_SCENE_SEED)."""
    from nerfnav_tpu_torch.data.provider import ngp_to_nerf_matrix, rand_poses, write_image
    from nerfnav_tpu_torch.data.rays import get_padded_rays
    from nerfnav_tpu_torch.data.synthetic import sphere_field
    from nerfnav_tpu_torch.models.renderer import RenderConfig, render_rays

    field = sphere_field()._replace(bg_fn=sky, bg_radius=BG_RADIUS)
    fov_x = 0.9
    fx = hw / (2 * np.tan(fov_x / 2))
    intr = torch.tensor([fx, fx, hw / 2, hw / 2], dtype=torch.float32, device=device)
    rcfg = RenderConfig(num_steps=128, upsample_steps=0, min_near=0.05)
    rng = np.random.default_rng(REF_SCENE_SEED)
    chunk = min(hw * hw, 65536)
    scene = os.path.join(root, "scene")
    os.makedirs(scene)
    for split, n in (("train", 8), ("val", 1)):
        frames = []
        for i, pose in enumerate(rand_poses(rng, n, radius=1.8)):
            with torch.no_grad():
                ro, rd = get_padded_rays(torch.as_tensor(pose, device=device), intr, hw, hw,
                                         chunk)
                img = torch.cat([render_rays(field, rcfg, ro[j:j + chunk],
                                             rd[j:j + chunk])["image"]
                                 for j in range(0, ro.shape[0], chunk)])[:hw * hw]
            fname = f"{split}_{i:03d}.png"
            write_image(os.path.join(scene, fname),
                        (np.clip(img.reshape(hw, hw, 3).cpu().numpy(), 0, 1) * 255)
                        .astype(np.uint8))
            frames.append({"file_path": fname,
                           "transform_matrix": ngp_to_nerf_matrix(pose, 1.0).tolist()})
        with open(os.path.join(scene, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fov_x, "frames": frames, "h": hw, "w": hw}, f)


def white_bg_psnr(tr, ds):
    """The val PSNR of the trained field's EMA params with its bg net
    swapped for white (Field._replace(bg_fn=None), bg_color 1)."""
    from nerfnav_tpu_torch.training import trainer as trainer_mod
    from nerfnav_tpu_torch.training.metrics import PSNRMeter

    make_field = trainer_mod.make_field
    trainer_mod.make_field = lambda p, c: make_field(p, c)._replace(bg_fn=None)
    meter, arrays = PSNRMeter(), ds.as_arrays()
    try:
        for i in range(len(ds)):
            img, _ = tr.render_full(tr.state.ema_params, arrays["poses"][i],
                                    arrays["intrinsics"], ds.H, ds.W, bg_color=1.0)
            meter.update(img.cpu().numpy(), np.asarray(arrays["images"][i])[..., :3])
    finally:
        trainer_mod.make_field = make_field
    return meter.measure()


# sph_from_ray card vs CPU: 1e-6 where both coordinates are well
# conditioned (|z| / R <= SPH_WELL_CONDITIONED); nearer a pole, where acos and
# atan2 have unbounded slopes, 1e-6 plus SPH_ULPS float32 ulps of their
# inputs times those slopes
SPH_WELL_CONDITIONED = 0.9
SPH_ULPS = 16


def sph_bound(ro, rd, radius):
    """Per-ray bounds (N, 2) on |u_a - u_b| and |v_a - v_b| of two float32
    evaluations of sph_from_ray, from the float64 exit point p: the acos
    input x = p_z / R moves v by (2 / pi) / sqrt(1 - x^2) per unit, and the
    atan2 angle moves by 1 / r per unit of p / R off axis, r = |p_xy| / R,
    so u by (1 / pi) / r. An input near 1 has a float32 ulp of 2^-24 (the
    ulp of one side of 1, the smaller)."""
    o, d = ro.double(), rd.double()
    b, c = (o * d).sum(-1), (o * o).sum(-1) - radius * radius
    d2 = (d * d).sum(-1)
    p = (o + ((-b + torch.sqrt(b * b - d2 * c)) / d2)[:, None] * d) / radius
    x = p[:, 2].clamp(-1.0, 1.0)
    r = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2).clamp(min=2.0**-24)
    ulps = SPH_ULPS * 2.0**-24
    du = ulps / (math.pi * r)
    dv = 2.0 / math.pi * ulps / torch.sqrt((1.0 - x * x).clamp(min=2.0**-48))
    return 1e-6 + torch.stack([du, dv], dim=-1), x.abs() <= SPH_WELL_CONDITIONED


def sph_vs_cpu(tr, ds, device):
    """Every ray of val view 0 (made on the CPU; it sees the zenith) plus
    rays that leave the sphere at the azimuth seam and the poles:
    sph_from_ray on this device against the CPU port (sph_bound); then, from
    the CPU's coordinates, the trained bg grid's features and the bg net's
    colour with xla fp32 MLPs (1e-5)."""
    import dataclasses

    from nerfnav_tpu_torch.data.rays import get_padded_rays
    from nerfnav_tpu_torch.models import network as net
    from nerfnav_tpu_torch.models.renderer import sph_from_ray
    from nerfnav_tpu_torch.ops.hashgrid import hash_grid_encode

    cpu = torch.device("cpu")
    ro, rd = get_padded_rays(torch.as_tensor(ds.poses[0]), torch.as_tensor(ds.intrinsics),
                             ds.H, ds.W, 4096)
    edge_o = torch.tensor([[0.0, 0.0, 0.0]] * 4 + [[0.3, 1e-7, 0.1], [0.3, -1e-7, 0.1]])
    edge_d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [-1.0, 0.0, 0.2],
                           [-1.0, -0.0, -0.2], [-1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    ro, rd = torch.cat([ro, edge_o]), torch.cat([rd, edge_d])
    cfg = dataclasses.replace(tr.cfg, mlp_backend="xla", mlp_dtype="float32")
    params = {k: [t.detach() for t in tr.state.ema_params[k]] for k in ("bg_encoder", "bg_net")}
    with torch.no_grad():
        sph = [sph_from_ray(ro.to(dev), rd.to(dev), BG_RADIUS).cpu() for dev in (cpu, device)]
        outs = []
        for dev in (cpu, device):
            p = {k: [t.to(dev) for t in v] for k, v in params.items()}
            outs.append([hash_grid_encode(p["bg_encoder"], sph[0].to(dev), cfg.bg_grid).cpu(),
                         net.background(p, sph[0].to(dev), rd.to(dev), cfg).cpu()])
    bound, well = sph_bound(ro, rd, BG_RADIUS)
    diff = (sph[1] - sph[0]).abs().double()
    res = {"rays": int(ro.shape[0]), "rays_well_conditioned": int(well.sum()),
           "sph_max_abs_well_conditioned": float(diff[well].max()),
           "sph_max_abs": float(diff.max()),
           "sph_max_share_of_bound": float((diff / bound).max()),
           "sph_rays_differ": int((diff > 0).any(dim=-1).sum()),
           "features_max_abs": float((outs[1][0] - outs[0][0]).abs().max()),
           "colour_max_abs": float((outs[1][1] - outs[0][1]).abs().max()),
           "edge_sph": sph[1][-6:].tolist()}
    log("sph_from_ray and the bg net, this device vs the CPU port:", json.dumps(res))
    check(res["sph_max_abs_well_conditioned"] <= 1e-6,
          f"sph {res['sph_max_abs_well_conditioned']} away from the CPU port's")
    check(res["sph_max_share_of_bound"] <= 1.0,
          f"sph near a pole {res['sph_max_share_of_bound']} x its conditioning bound")
    check(res["features_max_abs"] <= 1e-5, f"bg features {res['features_max_abs']} away")
    check(res["colour_max_abs"] <= 1e-5, f"bg colour {res['colour_max_abs']} away")


def ngp_round_trip(tr, bg, ds, device):
    """The trained checkpoint (EMA params, density grid) out through
    scripts/export_torch_ckpt.py and back through scripts/import_torch_ckpt.py:
    params bit-equal, the rebuilt bitfields and block tables equal, and a
    64x64 crop rendered from the imported file within 1e-6."""
    from nerfnav_tpu_torch.scripts import export_torch_ckpt, import_torch_ckpt
    from nerfnav_tpu_torch.training import checkpoint as ckpt_lib

    cfg, ocfg = tr.cfg, tr.occupancy_cfg
    src = ckpt_lib.latest_checkpoint(tr.ckpt_dir, tr.opt.name)
    pth = os.path.join(BG_DIR, "ngp.pth")
    npz = os.path.join(BG_DIR, "imported", "checkpoints", "ngp_ep0001.npz")
    export_torch_ckpt.main([src, "--out", pth, "--grid_size", str(ocfg.grid_size)])
    import_torch_ckpt.main([
        pth, "--out", npz, "--bound", str(cfg.bound), "--grid_size", str(ocfg.grid_size),
        "--log2_hashmap_size", str(cfg.grid_log2_hashmap_size),
        "--desired_resolution", str(int(cfg.grid_max_resolution * cfg.bound)),
        "--density_thresh", str(ocfg.density_thresh), "--device", str(device)])
    got = ckpt_lib.load_checkpoint_npz(npz, device)
    ema = tr.state.ema_params
    params_equal = sorted(got["ema_params"]) == sorted(ema) and all(
        torch.equal(a, b) for k in ema for a, b in zip(got["ema_params"][k], ema[k]))
    occ_equal = {k: bool(torch.equal(got["occupancy"][k], tr.occupancy[k]))
                 for k in ("bitfield", "bitfield_coarse", "blocks", "blocks_coarse")}
    tr2, _ = ref_trainer(ref_args(bg, "imported", device, *BG_MODE, "--ckpt", npz, root=BG_DIR))
    tr2._maybe_resume()
    intr = crop_intrinsics(ds)
    a, _ = tr.render_full(ema, ds.poses[0], intr, 64, 64)
    b, _ = tr2.render_full(tr2.state.ema_params, ds.poses[0], intr, 64, 64)
    err = float((a - b).abs().max())
    log("torch-ngp round trip:", json.dumps({
        "pth_mb": os.path.getsize(pth) / 2**20, "params_bit_equal": params_equal,
        "occupancy_equal": occ_equal, "crop_max_abs": err}))
    check(params_equal, "the imported params differ from the exported ones")
    check(all(occ_equal.values()), f"rebuilt occupancy differs: {occ_equal}")
    check(err <= 1e-6, f"the imported field renders {err} away")


def bg_phase(device, sizes, card):
    """The background network for unbounded scenes through main_nerf (see
    the module docstring). Returns the bg net's launches per step and per
    frame."""
    from nerfnav_tpu_torch.cli import main_nerf
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    bg = sizes["bg"]
    hw = bg["hw"]
    shutil.rmtree(BG_DIR, ignore_errors=True)
    phase_t0 = t0 = time.perf_counter()
    write_bg_scene(BG_DIR, hw, device)
    sync(device)
    log(f"background phase: scene of 8 + 1 views at {hw}x{hw} written in "
        f"{time.perf_counter() - t0:.1f} s")
    tr0, val = ref_trainer(ref_args(bg, "untrained", device, *BG_MODE, root=BG_DIR))
    psnr0 = tr0.evaluate(val)
    del tr0
    run = ref_args(bg, "run", device, *BG_MODE, "--iters", str(bg["iters"]), root=BG_DIR)
    fm.fused_mlp.launches = 0
    t0 = time.perf_counter()
    with BgLaunches() as run_bg, FrameClock(device, bg=run_bg) as frames:
        tr = main_nerf.main(run)
    sync(device)
    run_s, launches = time.perf_counter() - t0, fm.fused_mlp.launches
    psnr = tr.stats["results"][-1]
    psnr_white = white_bg_psnr(tr, val)
    log("background run:", json.dumps({
        "card": card, "steps": tr.global_step, "run_s": run_s, "val_psnr_untrained": psnr0,
        "val_psnr": psnr, "val_psnr_bg_swapped_for_white": psnr_white,
        "loss_per_epoch": tr.stats["loss"], "fused_launches": launches,
        "bg_net_launches": run_bg.launches, "bg_radius": tr.cfg.bg_radius,
        "grid": [tr.cfg.grid_levels, tr.cfg.grid_level_dim, tr.cfg.grid_log2_hashmap_size,
                 tr.cfg.grid_layout, tr.cfg.grid_coord_convention]}))
    check(psnr >= psnr0 + BG_PSNR_GAIN,
          f"val PSNR {psnr:.3f} is not {BG_PSNR_GAIN} dB over the untrained {psnr0:.3f}")
    check(psnr >= psnr_white + BG_WHITE_GAIN,
          f"val PSNR {psnr:.3f} is not {BG_WHITE_GAIN} dB over the white sky's "
          f"{psnr_white:.3f}")
    if device.type == "cuda":
        check(launches > 0 and run_bg.launches > 0,
              "the background run never launched the fused-MLP kernel for the bg net")
    sph_vs_cpu(tr, val, device)
    dense_step_vs_cpu(bg, device, root=BG_DIR, extra=BG_MODE[2:], images=(1,))
    ngp_round_trip(tr, bg, val, device)
    train_ds = ref_split("train", BG_DIR)
    arrays = tr._device_arrays(train_ds)
    with BgLaunches() as step_bg:
        tr.train_step(tr.state, arrays, tr.draw_step(tr.state, 0, train_ds.H, train_ds.W))
    del arrays
    timing = {"card": card, **timed_steps(tr, train_ds, bg["timed"], device),
              "bg_launches_per_step": step_bg.launches, **frames.summary()}
    log("background timing (the frame is the run's last evaluate):", json.dumps(timing))
    if device.type == "cuda":
        check(timing["fused_launches_per_step"] == 3,
              f"{timing['fused_launches_per_step']} fused launches a step, expected 3")
        check(step_bg.launches == 1, f"{step_bg.launches} bg net launches a step, expected 1")
    shutil.rmtree(BG_DIR, ignore_errors=True)
    log(f"background phase: {time.perf_counter() - phase_t0:.1f} s")
    return {"bg_launches_per_step": step_bg.launches,
            "bg_launches_per_frame": timing["bg_launches_per_frame"],
            "bg_grid_launches_per_step": timing["fused_launches_per_step"]}


# ------------------------------------------------------------- options phase
OPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_opts")
OPT_CKPT = os.path.join(OPT_DIR, "trained.npz")
# the settings each rendered as one timed and one profiled frame: name ->
# (TrainerOptions fields, MarchConfig fields); eval_beam stays AUTO
OPT_SETTINGS = {
    "baseline": ({}, {}),
    "first_k": ({"eval_first_k": True}, {}),
    "proxy": ({"eval_proxy": True}, {}),
    "first_k+proxy": ({"eval_first_k": True, "eval_proxy": True}, {}),
    "a0_segments_6": ({}, {"a0_segments": 6}),
    "frame_phase_a": ({"eval_frame_phase_a": True}, {}),
}
# the depth window of the card-vs-CPU crop check: around the origin, where
# the trained field is, from the camera 1.8 away
OPT_Z_WINDOW = (1.4, 2.2)


def options_trainer(device, sizes):
    """The flagship eval configuration (make_trainer: cell 4x8, fused MLPs,
    bound 2, K 32, bf16 tables, AUTO beam) on the training phase's trained
    field (its EMA params and occupancy; density_scale 1, as trained)."""
    from nerfnav_tpu_torch.training.checkpoint import load_checkpoint_npz

    loaded = load_checkpoint_npz(OPT_CKPT, device)
    return make_trainer(device, sizes, params=loaded["ema_params"],
                        occupancy=loaded["occupancy"], density_scale=1.0)


def set_options(tr, opt_kw, mcfg_kw, base):
    """tr's TrainerOptions and MarchConfig set to base (the pair of
    defaults) with the fields given, and its render caches dropped."""
    import dataclasses

    tr.opt = dataclasses.replace(base[0], **opt_kw)
    tr.march_cfg = dataclasses.replace(base[1], **mcfg_kw)
    tr.invalidate_render_cache()


def marcher_calls(fn):
    """fn() and the names of the marchers march() took in it."""
    from nerfnav_tpu_torch.ops import marching as tm

    before = dict(tm.march.calls)
    out = fn()
    return out, {k for k, v in tm.march.calls.items() if v != before[k]}


def psnr_vs(img, ref):
    mse = float(((img.float() - ref.float()) ** 2).mean())
    return math.inf if mse == 0.0 else -10.0 * math.log10(mse)


def option_frames(tr, pose, intr, hw, device):
    """One timed frame per OPT_SETTINGS entry and one on the byte bitfields
    (the block tables stripped: the two-phase marcher), then one profiled
    frame per setting (a profile leaves the host slower for a while, so no
    timed frame follows one); returns ({name: frame record}, {name:
    image})."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    base = (tr.opt, tr.march_cfg)
    frames, images = {}, {}
    for name, (opt_kw, mcfg_kw) in OPT_SETTINGS.items():
        set_options(tr, opt_kw, mcfg_kw, base)
        fm.fused_mlp.launches = 0
        sync(device)
        t0 = time.perf_counter()
        (image, depth), took = marcher_calls(
            lambda: tr.render_full(tr.params, pose, intr, hw, hw))
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        launches = fm.fused_mlp.launches
        mean = check_frame(image, depth, hw)
        check(took == {"block"}, f"{name}: the frame took the marchers {took}")
        if device.type == "cuda":
            check(launches > 0, f"{name}: the frame never launched the fused-MLP kernel")
        images[name] = image
        frames[name] = {"frame_ms": ms, "shaded_rounds": launches // 2,
                        "fused_launches": launches, "mean_image": mean,
                        "psnr_vs_baseline": psnr_vs(image, images["baseline"])}
    set_options(tr, {}, {}, base)
    # a whole frame on the byte bitfields (the block tables stripped)
    occ = tr.occupancy
    tr.set_occupancy({k: v for k, v in occ.items() if not k.startswith("blocks")})
    fm.fused_mlp.launches = 0
    sync(device)
    t0 = time.perf_counter()
    (image, depth), took = marcher_calls(lambda: tr.render_full(tr.params, pose, intr, hw, hw))
    sync(device)
    byte = {"frame_ms": (time.perf_counter() - t0) * 1e3, "marchers": sorted(took),
            "fused_launches": fm.fused_mlp.launches, "mean_image": check_frame(image, depth, hw),
            "psnr_vs_baseline": psnr_vs(image, images["baseline"])}
    log("frame without block tables:", json.dumps(byte))
    check(took == {"two_phase"}, f"the block-less frame took the marchers {took}")
    tr.set_occupancy(occ)
    frames["byte_bitfields"] = byte
    for name, (opt_kw, mcfg_kw) in OPT_SETTINGS.items():
        rec = frames[name]
        if device.type == "cuda":
            set_options(tr, opt_kw, mcfg_kw, base)
            prof = profile_call(lambda: tr.render_full(tr.params, pose, intr, hw, hw),
                                rec["frame_ms"], f"profiled frame, {name}", host_ops=False)
            rec["device_busy_ms"] = prof and prof["device_busy_ms"]
            rec["device_idle_share"] = prof and prof["device_idle_share_of_unprofiled_call"]
        log(f"options frame {name}:", json.dumps(rec))
    set_options(tr, {}, {}, base)
    return frames, images


def frame_split_check(tr, pose, intr, hw):
    """The frame-level phase A against the per-chunk march on this device:
    each chunk's slice of the frame-wide phase A equals its own phase A, and
    the chunk's march from that slice equals its whole march, bit for bit.
    Returns the number of chunks checked."""
    from nerfnav_tpu_torch.ops.marching import march

    tr.opt.eval_frame_phase_a = True
    chunk = tr.rcfg.max_ray_batch
    with torch.no_grad():
        ro, rd, _ = tr._frame_rays(pose, intr, hw, hw, chunk, None)
        mcfg, occ = tr._frame_march(intr, hw, hw, rd)
        split = tr._frame_phase_a(ro, rd, occ, mcfg, None)
        check(split is not None, "eval_frame_phase_a gave no frame-level phase A")
        differ = []
        for i in range(0, ro.shape[0], chunk):
            sl = slice(i, i + chunk)
            pa = {k: v[sl] for k, v in split.items()}
            own = march(ro[sl], rd[sl], occ, mcfg, stop_after="phase_a")
            whole = march(ro[sl], rd[sl], occ, mcfg)
            from_split = march(ro[sl], rd[sl], occ, mcfg, phase_a=pa)
            if not (all(torch.equal(own[k], pa[k]) for k in pa)
                    and all(torch.equal(whole[k], from_split[k]) for k in ("z", "dt", "valid"))):
                differ.append(i // chunk)
    tr.opt.eval_frame_phase_a = False
    n = -(-ro.shape[0] // chunk)
    log(f"frame-level phase A (beam {mcfg.beam}): {n - len(differ)} of {n} chunks' marches "
        f"equal the per-chunk march bit for bit")
    check(not differ, f"chunks {differ[:10]} march differently from the frame-level phase A")
    return n


def crop_vs_cpu(tr, tr_cpu, pose, intr, hw, device):
    """On a central 64x64 crop, from rays made on the CPU: the eval march
    under first_k, proxy, a0 and a depth window on this device and on the CPU
    port (REF_MARCH_RAYS_EQUAL of the rows, z / dt within REF_MARCH_ZDT_TOL,
    the crop's image within 5e-3); with the block tables stripped, the
    two-phase and the single-phase marchers (valid masks equal); and
    march_segments."""
    from nerfnav_tpu_torch.models.renderer import make_field, render_rays_grid_rounds
    from nerfnav_tpu_torch.ops import marching as tm

    cpu = torch.device("cpu")
    intr64 = intr.copy()
    intr64[2:] -= (hw - 64) / 2
    base = [(t.opt, t.march_cfg) for t in (tr, tr_cpu)]
    cases = {"first_k": ({"eval_first_k": True}, {}, None),
             "proxy": ({"eval_proxy": True}, {}, None),
             "a0_segments_6": ({}, {"a0_segments": 6}, None),
             "z_window": ({}, {}, OPT_Z_WINDOW),
             "two_phase": ({}, {}, None), "single": ({}, {}, None)}
    out = {}
    with torch.no_grad():
        ro, rd, _ = tr_cpu._frame_rays(pose, intr64, 64, 64, 4096, None)
        for name, (opt_kw, mcfg_kw, zw) in cases.items():
            ms, imgs = [], []
            for t, b in zip((tr, tr_cpu), base):
                set_options(t, opt_kw, mcfg_kw, b)
                mcfg, occ = t._frame_march(intr64, 64, 64, rd)
                if name in ("two_phase", "single"):
                    occ = {k: v for k, v in occ.items() if not k.startswith("blocks")
                           and (name == "two_phase" or k != "bitfield_coarse")}
                o, d = ro.to(t.device), rd.to(t.device)
                m, took = marcher_calls(lambda: tm.march(o, d, occ, mcfg, z_window=zw))
                check(took == {"block" if name not in ("two_phase", "single") else name},
                      f"{name}: the march took {took}")
                ms.append({k: v.cpu() for k, v in m.items()})
                if zw is not None:
                    params = t._cast_eval_tables(t.params)
                    imgs.append(render_rays_grid_rounds(
                        make_field(params, t.cfg), occ, mcfg, o, d, z_window=zw)["image"].cpu())
                elif name not in ("two_phase", "single"):
                    imgs.append(t.render_full(t.params, pose, intr64, 64, 64)[0].cpu())
            md, mc = ms
            same = (md["valid"] == mc["valid"]).all(dim=1)
            both = mc["valid"] & same[:, None]
            zdt = max(float((md[k] - mc[k])[both].abs().max()) if both.any() else 0.0
                      for k in ("z", "dt"))
            res = {"rays_valid_differ": int((~same).sum()), "valid_samples": int(mc["valid"].sum()),
                   "z_dt_max_abs": zdt, "beam": mcfg.beam}
            if imgs:
                res["image_mean_abs"] = float((imgs[0] - imgs[1]).abs().mean())
            out[name] = res
            check(res["valid_samples"] > 0, f"{name}: the crop's march kept no sample")
            if name in ("two_phase", "single"):
                check(bool(same.all()),
                      f"{name}: {res['rays_valid_differ']} rays' valid rows differ")
            else:
                check(float(same.float().mean()) >= REF_MARCH_RAYS_EQUAL,
                      f"{name}: {res['rays_valid_differ']} rays' valid rows differ")
            check(zdt <= REF_MARCH_ZDT_TOL, f"{name}: z/dt {zdt} apart where both are valid")
            check(res.get("image_mean_abs", 0.0) <= 5e-3, f"{name}: crop image {res}")
        for t, b in zip((tr, tr_cpu), base):
            set_options(t, {}, {}, b)
        mcfg, _ = tr._frame_march(intr64, 64, 64, rd)
        segs = [tm.march_segments(ro.to(t.device), rd.to(t.device), t.occupancy, mcfg)
                for t in (tr, tr_cpu)]
    hit = segs[1]["hit"]
    check(torch.equal(segs[0]["hit"].cpu(), hit), "march_segments: hit differs")
    seg_err = max(float((segs[0][k].cpu() - segs[1][k])[hit].abs().max()) if hit.any() else 0.0
                  for k in ("z_first", "z_last"))
    out["march_segments"] = {"hit": int(hit.sum()), "z_max_abs": seg_err}
    check(seg_err <= REF_MARCH_ZDT_TOL, f"march_segments: z {seg_err} apart")
    log("options on a 64x64 crop, this device vs the CPU port:", json.dumps(out))
    return out


def march_stage_split(tr, pose, intr, hw, device):
    """The frame's eval march (as render_full sets it up) by stage, every
    chunk marched to stop_after="phase_a", to "phase_b_occ" and whole:
    phase A, phase B's occupancy test and the compaction, in ms of the host
    clock around synchronized passes (the least of three each)."""
    from nerfnav_tpu_torch.ops.marching import march

    chunk = tr.rcfg.max_ray_batch
    totals = {}
    with torch.no_grad():
        ro, rd, _ = tr._frame_rays(pose, intr, hw, hw, chunk, None)
        mcfg, occ = tr._frame_march(intr, hw, hw, rd)
        for stop in ("phase_a", "phase_b_occ", ""):
            passes = []
            for _ in range(3):
                sync(device)
                t0 = time.perf_counter()
                for i in range(0, ro.shape[0], chunk):
                    march(ro[i : i + chunk], rd[i : i + chunk], occ, mcfg, stop_after=stop)
                sync(device)
                passes.append((time.perf_counter() - t0) * 1e3)
            totals[stop or "whole"] = min(passes)
    split = {"phase_a_ms": totals["phase_a"],
             "phase_b_occupancy_ms": totals["phase_b_occ"] - totals["phase_a"],
             "compaction_ms": totals["whole"] - totals["phase_b_occ"],
             "march_ms": totals["whole"], "chunks": -(-ro.shape[0] // chunk),
             "beam": mcfg.beam, "t_a0_steps": mcfg.t_a0_steps}
    log("eval march by stage (baseline frame):", json.dumps(split))
    return split


def autotune_check(tr, pose, intr, hw):
    """autotune_march_shape on the frame's first 4096 tile-ordered rays with
    three candidates: the ladders of 8, 9 and 10 anchor runs over the
    planned ladder; it must return one of them."""
    from nerfnav_tpu_torch.ops import marching as tm

    with torch.no_grad():
        ro, rd, _ = tr._frame_rays(pose, intr, hw, hw, tr.rcfg.max_ray_batch, None)
        mcfg, occ = tr._frame_march(intr, hw, hw, rd)
        t_base = mcfg.t_a0_steps or tm.full_ladder_steps(mcfg)
        cands = [(max(2, -(-t_base // r)), r * max(2, -(-t_base // r))) for r in (8, 9, 10)]
        best, res = tm.autotune_march_shape(occ, mcfg, ro, rd, chunk=4096, iters=3,
                                            candidates=cands)
    out = {"candidates_g_a_t_a0_ms": res, "best": [best.phase_a_group, best.t_a0_steps]}
    log("autotune_march_shape, 4096 rays:", json.dumps(out))
    check((best.phase_a_group, best.t_a0_steps) in cands, f"autotune returned {out['best']}")
    return out


def debounce_vs_cpu(tr, device):
    """Two sweeps of _finish_update under occ_debounce on this device and on
    the CPU from the same grid, pending plane and sweep values: bitfield,
    block tables and pending plane equal. The values sit on a 1/16 lattice
    with a mean over density_thresh, so the carve bar is density_thresh
    itself on both devices (a mean summed in another order would move it)."""
    import dataclasses

    from nerfnav_tpu_torch.models.occupancy import _finish_update
    from nerfnav_tpu_torch.ops.morton import packbits, unpackbits

    cfg = dataclasses.replace(tr.occupancy_cfg, occ_debounce=True)
    rng = np.random.default_rng(8)
    shape = tuple(tr.occupancy["density_grid"].shape)

    def lattice(scale):
        v = (np.round(rng.exponential(scale, shape) * 16) / 16).astype(np.float32)
        return torch.as_tensor(v)

    grid = lattice(16.0)
    grid[torch.as_tensor(rng.random(shape) < 0.05)] = -1.0
    state = {"density_grid": grid, "bitfield": packbits(grid > cfg.density_thresh),
             "pending": torch.as_tensor(rng.random(shape) < 0.3),
             "iter_density": torch.zeros((), dtype=torch.int64)}
    states = {"cpu": state, "dev": {k: v.to(device) for k, v in state.items()}}
    out = []
    for sweep in range(2):
        tmp = lattice(16.0)
        tmp[torch.as_tensor(rng.random(shape) < 0.5)] = -1.0
        for k, st in states.items():
            t = tmp.to(st["density_grid"].device)
            states[k] = _finish_update(st, cfg, st["density_grid"], t)
        c, d = states["cpu"], {k: v.cpu() for k, v in states["dev"].items()}
        rec = {"sweep": sweep + 1, "mean_density": [float(d["mean_density"]),
                                                    float(c["mean_density"])],
               "occupied": int(unpackbits(c["bitfield"]).sum()),
               "pending": int(c["pending"].sum()),
               # cells over the bar that the filter keeps off
               "held_back": int((c["density_grid"] > cfg.density_thresh).sum())
               - int(unpackbits(c["bitfield"]).sum())}
        for k in ("bitfield", "bitfield_coarse", "blocks", "blocks_coarse", "pending"):
            check(torch.equal(d[k], c[k]), f"debounce sweep {sweep + 1}: {k} differs")
        check(min(rec["mean_density"]) > cfg.density_thresh,
              f"the carve bar is not pinned: {rec['mean_density']}")
        out.append(rec)
    log("occ_debounce, two sweeps, this device vs the CPU:", json.dumps(out))
    return out


def mesh_checks(tr, device, sizes):
    """save_mesh at sizes["mesh_res"] on the trained field (the fused
    kernel, one launch per 2^16 lattice points) at the level of its 99.9th
    percentile on the 64^3 lattice, and
    extract_geometry at resolution 64 with xla fp32 MLPs on this device and
    on the CPU: equal vertex and face counts, vertices within 1e-4. The
    latter's level sits in the widest gap between the CPU lattice's values
    in their 99.0-99.8th percentiles, so no lattice value is within float32
    noise of it; "flips" counts the lattice points the two devices put on
    different sides."""
    import dataclasses

    from nerfnav_tpu_torch.models.network import density
    from nerfnav_tpu_torch.ops import fused_mlp as fm
    from nerfnav_tpu_torch.utils.mesh import extract_geometry

    res = sizes["mesh_res"]
    cpu = torch.device("cpu")
    cfg32 = dataclasses.replace(tr.cfg, mlp_backend="xla", mlp_dtype="float32")
    params = {k: [t.detach() for t in v] for k, v in tr.state.ema_params.items()}
    params_cpu = {k: [t.cpu() for t in v] for k, v in params.items()}
    fns = {"dev": (lambda x: density(params, x, cfg32)["sigma"], device),
           "cpu": (lambda x: density(params_cpu, x, cfg32)["sigma"], cpu)}
    _, _, field = extract_geometry(fns["cpu"][0], tr.cfg.bound, resolution=64,
                                   threshold=0.0, device=cpu)
    # a level over which the densest 0.1% of the 64^3 lattice lies: a few
    # blobs of the briefly trained field, not a surface through its noise
    level = float(np.quantile(field, 0.999))
    fm.fused_mlp.launches = 0
    sync(device)
    t0 = time.perf_counter()
    path = tr.save_mesh(os.path.join(OPT_DIR, "mesh.ply"), resolution=res, threshold=level)
    mesh_s = time.perf_counter() - t0
    launches = fm.fused_mlp.launches
    with open(path) as f:
        head = f.read(400).split("end_header")[0].split()
    n_v, n_f = int(head[head.index("vertex") + 1]), int(head[head.index("face") + 1])
    out = {"resolution": res, "level": level, "save_mesh_s": mesh_s, "vertices": n_v,
           "faces": n_f, "fused_launches": launches, "ply_bytes": os.path.getsize(path)}
    check(n_v > 0 and n_f > 0, f"save_mesh wrote {n_v} vertices and {n_f} faces")
    if device.type == "cuda":
        want = -(-res**3 // MESH_N)
        check(launches == want, f"save_mesh launched the fused MLP {launches} times, not {want}")

    v = np.sort(field.ravel())
    band = v[len(v) * 990 // 1000 : len(v) * 998 // 1000]
    gi = int(np.argmax(np.diff(band)))
    level64 = float((band[gi] + band[gi + 1]) / 2)
    got = {k: extract_geometry(fn, tr.cfg.bound, resolution=64, threshold=level64, device=dv)
           for k, (fn, dv) in fns.items()}
    (vd, fd, gd), (vc, fc, gc) = got["dev"], got["cpu"]
    out["extract_64"] = {"level": level64, "margin": float(band[gi + 1] - band[gi]) / 2,
                         "field_max_abs": float(np.abs(gd - gc).max()),
                         "flips": int(((gd > level64) != (gc > level64)).sum()),
                         "vertices": [len(vd), len(vc)], "faces": [len(fd), len(fc)]}
    check(len(vd) == len(vc) > 0 and len(fd) == len(fc),
          f"extract_geometry at 64: {out['extract_64']}")
    out["extract_64"]["vertices_max_abs"] = float(np.abs(vd - vc).max())
    log("mesh:", json.dumps(out))
    check(out["extract_64"]["vertices_max_abs"] <= 1e-4, f"vertices {out['extract_64']}")
    return out


def options_phase(device, sizes, card):
    """The remaining march and occupancy options and the mesh export on the
    training phase's trained field (see the module docstring). Returns the
    fields the kernels line carries."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    phase_t0 = time.perf_counter()
    took_s = {}

    def stamp(what):
        took_s[what] = time.perf_counter() - phase_t0 - sum(took_s.values())

    hw = sizes["hw"]
    tr = options_trainer(device, sizes)
    pose = yaw_pose(0.0)
    intr = np.asarray([1000.0 * hw / 800, 1000.0 * hw / 800, hw / 2, hw / 2], np.float32)
    frames, images = option_frames(tr, pose, intr, hw, device)
    stamp("frames")
    check(torch.equal(images["frame_phase_a"], images["baseline"]),
          "the frame-level phase A renders another image than the per-chunk march")
    frame_split_check(tr, pose, intr, hw)
    stamp("frame_split")
    cpu = torch.device("cpu")
    tr_cpu = make_trainer(cpu, sizes,
                          params={k: [t.detach().cpu() for t in v] for k, v in tr.params.items()},
                          occupancy={k: v.cpu() for k, v in tr.occupancy.items()},
                          density_scale=1.0)
    crop_vs_cpu(tr, tr_cpu, pose, intr, hw, device)
    del tr_cpu
    stamp("crop_vs_cpu")
    stages = march_stage_split(tr, pose, intr, hw, device)
    stamp("stage_split")
    autotune_check(tr, pose, intr, hw)
    stamp("autotune")
    debounce_vs_cpu(tr, device)
    stamp("debounce")
    mesh = mesh_checks(tr, device, sizes)
    stamp("mesh")
    log(f"options phase: {time.perf_counter() - phase_t0:.1f} s ({card}); s by step",
        json.dumps(took_s))
    return {"options_launches_per_frame": {k: v["fused_launches"] for k, v in frames.items()},
            "mesh_launches": mesh["fused_launches"], "march_stages_ms": stages}


# ------------------------------------------------- training-options phase
TO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_trainopts")
MESH_STEPS = 16     # mesh and plain trainer, from the same state and draws
MESH_TOL = 1e-6
GROUPS = 8          # the sample_groups step card vs CPU
CLIP_STEPS = 30     # rand_pose 0 on the trained field
HYBRID_STEPS = 16   # rand_pose 3: steps 3, 7, 11 and 15 are poseless
TOWER_TOL = 1e-4    # tower and LPIPS, card vs CPU, relative
# openai/clip-vit-base-patch16's vision tower and projection
CLIP_WIDTHS = {"card": dict(hidden=768, layers=12, heads=12, patch=16, image=224, proj=512,
                            inter=3072),
               "rehearsal": dict(hidden=64, layers=2, heads=4, patch=16, image=64, proj=32,
                                 inter=128)}
# lpips.LPIPS(net='alex'): conv (out, in, kernel) by AlexNet `features` index
ALEX = {0: (64, 3, 11), 3: (192, 64, 5), 6: (384, 192, 3), 8: (256, 384, 3), 10: (256, 256, 3)}


def write_clip_npz(path, w, seed=0):
    """A CLIPVisionModelWithProjection state_dict at the widths w of seeded
    arrays under Hugging Face's key names, as an .npz: linear and conv
    weights normal over sqrt(fan-in), biases and embeddings normal at 0.02,
    layer norms 1 and 0."""
    rng = np.random.default_rng(seed)
    h, p, inter = w["hidden"], w["patch"], w["inter"]
    nrm = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    sd = {"vision_model.embeddings.patch_embedding.weight": nrm(h, 3, p, p) / math.sqrt(3 * p * p),
          "vision_model.embeddings.class_embedding": nrm(h) * 0.02,
          "vision_model.embeddings.position_embedding.weight":
              nrm((w["image"] // p) ** 2 + 1, h) * 0.02,
          "visual_projection.weight": nrm(w["proj"], h) / math.sqrt(h)}
    for ln in ("vision_model.pre_layrnorm", "vision_model.post_layernorm"):
        sd[ln + ".weight"], sd[ln + ".bias"] = np.ones(h, np.float32), np.zeros(h, np.float32)
    for i in range(w["layers"]):
        pre = f"vision_model.encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[pre + ln + ".weight"] = np.ones(h, np.float32)
            sd[pre + ln + ".bias"] = np.zeros(h, np.float32)
        for name, (o, n) in {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h),
                             "self_attn.v_proj": (h, h), "self_attn.out_proj": (h, h),
                             "mlp.fc1": (inter, h), "mlp.fc2": (h, inter)}.items():
            sd[pre + name + ".weight"] = nrm(o, n) / math.sqrt(n)
            sd[pre + name + ".bias"] = nrm(o) * 0.02
    np.savez(path, **sd)
    return path


def write_lpips_npz(path, seed=0):
    """An lpips.LPIPS(net='alex') state_dict of seeded arrays as an .npz:
    convs normal over sqrt(fan-in / 2), heads |normal| x 0.1."""
    rng = np.random.default_rng(seed)
    sd = {}
    for n, (idx, (o, i, k)) in enumerate(ALEX.items()):
        sd[f"net.slice{n + 1}.{idx}.weight"] = (rng.normal(size=(o, i, k, k))
                                                * np.sqrt(2.0 / (i * k * k))).astype(np.float32)
        sd[f"net.slice{n + 1}.{idx}.bias"] = (rng.normal(size=o) * 0.01).astype(np.float32)
        sd[f"lin{n}.model.1.weight"] = np.abs(rng.normal(size=(1, o, 1, 1)) * 0.1).astype(
            np.float32)
    np.savez(path, **sd)
    return path


def params_max_diff(a, b):
    return max(float((x.detach() - y.detach()).abs().max()) for k in a for x, y in zip(a[k], b[k]))


def timed_ms(fn, device, n):
    """Host ms per call of fn over n synchronised calls, after one warm call."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / n


def data_parallel_checks(device, sizes):
    """(a) of the training-options phase: a one-rank mesh (NCCL on the card,
    gloo on the CPU) against a plain trainer, the sharded sweep, and a
    sample_groups step card vs CPU."""
    import torch.distributed as dist

    from nerfnav_tpu_torch.parallel import make_mesh

    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{os.path.join(TO_DIR, 'store')}",
                            rank=0, world_size=1)
    # the hash tables' gradients are index_add_ sums, whose atomic order on
    # the card changes between runs; Adam turns a rounding of a tiny
    # gradient into lr, so the two trainers are held in deterministic mode
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as nondet:
            warnings.simplefilter("always")
            mesh = make_mesh(1, device_type=device.type)
            check(dist.get_backend() == backend, f"the mesh runs {dist.get_backend()}")
            out, trs, ds = mesh_vs_plain(device, sizes, mesh)
        # timed as they train: deterministic index_add_ takes ~15x longer
        torch.use_deterministic_algorithms(False)
        out.update(mesh_timing(trs, ds, device, mesh))
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    out.update(backend=backend, nondeterministic_ops=sorted(
        {str(w.message)[:80] for w in nondet if "determinis" in str(w.message)}))
    log("data parallel:", json.dumps(out))
    check(out["params_max_abs"] <= MESH_TOL, f"mesh params {out['params_max_abs']} off")
    check(out["crop_max_abs"] <= MESH_TOL, f"mesh crop {out['crop_max_abs']} off")
    if device.type == "cuda":
        check(out["fused_launches_per_mesh_step"] > 0,
              "the mesh step never launched the fused-MLP kernel")
        check(out["fused_launches_per_sharded_sweep"] > 0,
              "the sharded sweep never launched the fused-MLP kernel")
    out["grouped_step"] = card_vs_cpu_step(device, sizes, groups=GROUPS)
    return out


def mesh_vs_plain(device, sizes, mesh):
    """MESH_STEPS of Trainer.train on the mesh and without it from one
    state (both draw from generators seeded alike): their params and a 64x64
    crop; returns (record, trainers, dataset)."""
    ds = target_frames(sizes["hw"])
    trs = {"plain": train_trainer(device, sizes, os.path.join(TO_DIR, "plain")),
           "mesh": train_trainer(device, sizes, os.path.join(TO_DIR, "mesh"), mesh=mesh)}
    run_s = {}
    for name, tr in trs.items():
        sync(device)
        t0 = time.perf_counter()
        tr.train(ds, max_epochs=1, steps_per_epoch=MESH_STEPS)
        sync(device)
        run_s[name] = time.perf_counter() - t0
    plain, meshed = trs["plain"], trs["mesh"]
    params_diff = params_max_diff(meshed.params, plain.params)
    intr64 = crop_intrinsics(ds)
    crops = {k: tr.render_full(tr.state.ema_params, ds.poses[0], intr64, 64, 64)[0]
             for k, tr in trs.items()}
    return {"world": 1, "steps": MESH_STEPS, "deterministic_run_s": run_s,
            "params_max_abs": params_diff,
            "crop_max_abs": float((crops["mesh"] - crops["plain"]).abs().max())}, trs, ds


def mesh_timing(trs, ds, device, mesh):
    """Step ms of the plain and the mesh trainer in turns (plain, mesh,
    mesh, plain; 8 steps each), and the fused launches of a mesh step and
    of a sweep sharded over the mesh."""
    from nerfnav_tpu_torch.models.occupancy import draw_update, update_extra_state
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    meshed = trs["mesh"]
    arrays = meshed._device_arrays(ds)
    H, W = ds.H, ds.W
    step_ms = {"plain": [], "mesh": []}
    for k in ("plain", "mesh", "mesh", "plain"):
        tr = trs[k]
        step_ms[k].append(timed_ms(lambda: tr.train_step(
            tr.state, arrays, tr.draw_step(tr.state, 0, H, W)), device, 8))
    fm.fused_mlp.launches = 0
    meshed.train_step(meshed.state, arrays, meshed.draw_step(meshed.state, 1, H, W))
    step_launches = fm.fused_mlp.launches
    occ, ocfg = meshed.occupancy, meshed.occupancy_cfg
    fm.fused_mlp.launches = 0
    update_extra_state(occ, ocfg, meshed.params, meshed.cfg, draw_update(meshed.gen, occ, ocfg),
                       mesh=mesh)
    return {"step_ms": step_ms, "fused_launches_per_mesh_step": step_launches,
            "fused_launches_per_sharded_sweep": fm.fused_mlp.launches,
            "sharded_sweep": ("partial" if int(occ["iter_density"]) >= ocfg.n_full_updates
                              else "full")}


def clip_checks(device, sizes):
    """(b): the CLIP tower at sizes["clip"] widths card vs CPU, then
    rand_pose 0 and 3 on the training phase's trained field. Returns the
    record and the trainer."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm
    from nerfnav_tpu_torch.training.clip_tower import make_clip_loss_fn, preprocess

    w = sizes["clip"]
    path = write_clip_npz(os.path.join(TO_DIR, "clip_tower.npz"), w)
    gen = torch.Generator().manual_seed(1)
    text = torch.randn((w["proj"],), generator=gen).numpy()
    loss_fns = {"dev": make_clip_loss_fn(path, text, w["heads"], device),
                "cpu": make_clip_loss_fn(path, text, w["heads"], "cpu")}
    loss_fn, tower = loss_fns["dev"], loss_fns["dev"].tower
    check(tower.cfg == {"hidden": w["hidden"], "patch": w["patch"], "image_size": w["image"],
                        "heads": w["heads"]} and len(tower.weights["layers"]) == w["layers"],
          f"the tower loaded as {tower.cfg}, {len(tower.weights['layers'])} layers")
    px = preprocess(torch.rand((64, 64, 3), generator=gen), w["image"])
    with torch.no_grad():
        emb_cpu = loss_fns["cpu"].tower(px)
        emb_dev = tower(px.to(device))
    out = {"widths": w, "tower_rel_l2": rel_l2(emb_dev.cpu(), emb_cpu)}
    check(out["tower_rel_l2"] <= TOWER_TOL, f"tower card vs CPU {out['tower_rel_l2']}")
    out["poseless_card_vs_cpu"] = poseless_card_vs_cpu(device, sizes, loss_fns)

    tr = train_trainer(device, sizes, os.path.join(TO_DIR, "clip"))
    tr.load_checkpoint(OPT_CKPT)
    tr.clip_loss_fn = loss_fn
    ds = target_frames(sizes["hw"])
    out["poseless_kernel_vs_plain"] = poseless_kernel_vs_plain(tr, ds)
    steps = {"clip": [], "rays": 0}
    clip_step, train_step = tr.clip_step, tr.train_step

    def counted_clip(*a, **k):
        before = fm.fused_mlp.launches
        loss = clip_step(*a, **k)
        steps["clip"].append((float(loss), fm.fused_mlp.launches - before))
        return loss

    def counted_rays(*a, **k):
        steps["rays"] += 1
        return train_step(*a, **k)

    tr.clip_step, tr.train_step = counted_clip, counted_rays
    runs = {}
    for rp, n in ((0, CLIP_STEPS), (3, HYBRID_STEPS)):
        tr.opt.rand_pose = rp
        steps["clip"], steps["rays"] = [], 0
        sync(device)
        t0 = time.perf_counter()
        tr.train(ds, max_epochs=1, steps_per_epoch=n)
        sync(device)
        runs[rp] = {"s": time.perf_counter() - t0, "clip_steps": len(steps["clip"]),
                    "ray_steps": steps["rays"], "losses": [l for l, _ in steps["clip"]],
                    "fused_launches": [k for _, k in steps["clip"]]}
    del tr.clip_step, tr.train_step
    losses = runs[0]["losses"]
    out.update(frame=list(tr.clip_frame(ds.H, ds.W)), runs=runs,
               loss_first=losses[0], loss_last5=float(np.mean(losses[-5:])))
    H, W = ds.H, ds.W
    pose = yaw_pose(30.0)
    out["clip_step_ms"] = timed_ms(lambda: tr.clip_step(tr.state, pose, ds.intrinsics, H, W),
                                   device, 5)
    x = preprocess(torch.rand((64, 64, 3), generator=gen).to(device), w["image"])
    with torch.no_grad():
        out["tower_forward_ms"] = timed_ms(lambda: tower(x), device, 5)
    xg = x.clone().requires_grad_()

    def tower_fb():
        return torch.autograd.grad(loss_fn.tower(xg) @ loss_fn.text, xg)

    out["tower_forward_backward_ms"] = timed_ms(tower_fb, device, 5)
    log("clip:", json.dumps(out))
    if device.type == "cuda":
        profile_call(lambda: tr.clip_step(tr.state, pose, ds.intrinsics, H, W),
                     out["clip_step_ms"], "profiled poseless step")
        profile_call(tower_fb, out["tower_forward_backward_ms"],
                     "profiled tower forward and backward")
    check(runs[0]["clip_steps"] == CLIP_STEPS and runs[0]["ray_steps"] == 0,
          f"rand_pose 0 took {runs[0]['clip_steps']} poseless and {runs[0]['ray_steps']} "
          "supervised steps")
    check(runs[3]["clip_steps"] == HYBRID_STEPS // 4
          and runs[3]["ray_steps"] == HYBRID_STEPS - HYBRID_STEPS // 4,
          f"rand_pose 3 took {runs[3]['clip_steps']} poseless and {runs[3]['ray_steps']} "
          "supervised steps")
    check(all(math.isfinite(v) for r in runs.values() for v in r["losses"]),
          "a non-finite CLIP loss")
    check(out["loss_last5"] < out["loss_first"], "the CLIP loss did not fall")
    if device.type == "cuda":
        check(all(k > 0 for r in runs.values() for k in r["fused_launches"]),
              "a CLIP step launched no fused-MLP kernel")
    return out, tr


def poseless_card_vs_cpu(device, sizes, loss_fns):
    """clip_loss_and_grads at the CPU tests' size, xla fp32 field: this
    device against the CPU port from the same params, occupancy and draws,
    each scored by its own copy of the tower (loss_fns "dev" and "cpu"), at
    card_vs_cpu_step's bars."""
    from torch.utils._pytree import tree_map_only

    cpu = torch.device("cpu")
    ds = target_frames(24, seed=3)
    ws = os.path.join(TO_DIR, "small")
    tr_cpu = train_trainer(cpu, sizes, ws, small=True)
    tr_dev = train_trainer(device, sizes, ws, small=True, params={
        k: [t.detach() for t in v] for k, v in tr_cpu.params.items()})
    occ = shell_occupancy(2.0, 32, 4, cpu)
    tr_cpu.set_occupancy({**tr_cpu.occupancy, **occ})
    tr_dev.set_occupancy({**tr_dev.occupancy, **{k: v.to(device) for k, v in occ.items()}})
    tr_cpu.clip_loss_fn, tr_dev.clip_loss_fn = loss_fns["cpu"], loss_fns["dev"]
    _, rH, rW = tr_cpu.clip_frame(ds.H, ds.W)
    draws = tr_cpu.draw_clip(rH * rW)
    args = (ds.poses[0], ds.intrinsics, ds.H, ds.W)
    want = tr_cpu.clip_loss_and_grads(tr_cpu.state, *args, draws)
    got = tr_dev.clip_loss_and_grads(tr_dev.state, *args,
                                     tree_map_only(torch.Tensor, lambda t: t.to(device), draws))
    loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    errs = [rel_l2(a.cpu(), b) for a, b in zip(got[1], want[1])]
    out = {"frame": [rH, rW], "loss": float(want[0]), "loss_rel": loss_rel,
           "grad_rel_l2_max": max(errs),
           "grad_norm": float(torch.stack([g.norm() for g in want[1]]).norm())}
    log("one poseless step at the CPU tests' size, this device vs the CPU port:",
        json.dumps(out))
    check(out["grad_norm"] > 0, "the poseless step's gradient is 0")
    check(loss_rel <= 1e-5, f"poseless loss {loss_rel} away from the CPU port's")
    check(max(errs) <= 1e-4, f"poseless gradients {max(errs)} away from the CPU port's (L2)")
    return out


def poseless_kernel_vs_plain(tr, ds):
    """clip_loss_and_grads of the trained field from one state and draws
    with the kernel and with the plain MLP swapped in, at
    kernel_vs_plain_step's bars."""
    _, rH, rW = tr.clip_frame(ds.H, ds.W)
    draws = tr.draw_clip(rH * rW)
    args = (tr.state, yaw_pose(30.0), ds.intrinsics, ds.H, ds.W, draws)
    got = tr.clip_loss_and_grads(*args)
    with plain_mlp():
        want = tr.clip_loss_and_grads(*args)
    loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    errs = [rel_l2(a, b) for a, b in zip(got[1], want[1])]
    out = {"loss_rel": loss_rel, "grad_rel_l2_max": max(errs), "bound": GRAD_TOL}
    log("one poseless step, kernel vs plain MLP:", json.dumps(out))
    check(loss_rel <= 2e-2, f"poseless loss with the kernel {loss_rel} away from the plain MLP's")
    check(max(errs) <= GRAD_TOL, f"poseless gradients with the kernel {max(errs)} away (L2)")
    return out


def lpips_checks(device, sizes):
    """(c): LPIPSMeter at AlexNet widths with seeded weights on two frames,
    card vs CPU, and LPIPS(x, x) = 0."""
    from nerfnav_tpu_torch.training.metrics import LPIPSMeter

    path = write_lpips_npz(os.path.join(TO_DIR, "lpips_alex.npz"))
    ds = target_frames(sizes["hw"])
    a, b = ds.images[0], ds.images[1]
    meters = {k: LPIPSMeter(weights_path=path, device=dev)
              for k, dev in (("dev", device), ("cpu", torch.device("cpu")))}
    d = {k: m.update(a, b) for k, m in meters.items()}
    same = meters["dev"].update(a, a)
    fn = meters["dev"]._port_fn
    out = {"hw": ds.H, "dev": d["dev"], "cpu": d["cpu"],
           "rel": abs(d["dev"] - d["cpu"]) / abs(d["cpu"]), "same": same,
           "ms": timed_ms(lambda: fn(a, b), device, 3), "report": meters["dev"].report()}
    log("lpips:", json.dumps(out))
    check(d["cpu"] > 0 and out["rel"] <= TOWER_TOL, f"LPIPS card vs CPU {out}")
    check(same == 0.0, f"LPIPS(x, x) = {same}")
    return out


def profiling_checks(tr, device):
    """(d): utils/profiling's device_timer around a 256x256 frame and a
    trace of one CLIP step."""
    from nerfnav_tpu_torch.utils.profiling import device_timer, trace

    times = {}
    intr = np.asarray([320.0, 320.0, 128.0, 128.0], np.float32)
    with device_timer("frame_256", times) as box:
        box["result"] = tr.render_full(tr.state.ema_params, yaw_pose(0.0), intr, 256, 256)
    with trace(os.path.join(TO_DIR, "trace")) as path:
        tr.clip_step(tr.state, yaw_pose(45.0), np.asarray([1000.0, 1000.0, 400.0, 400.0],
                                                           np.float32), 800, 800)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    out = {"frame_256_ms": times["frame_256"] * 1e3, "trace_bytes": os.path.getsize(path),
           "trace_events": len(events), "trace_kernels": len(kernels),
           "trace_fused_kernels": sum("fused_mlp_kernel" in e.get("name", "") for e in kernels)}
    log("profiling:", json.dumps(out))
    check(times["frame_256"] > 0 and out["trace_events"] > 0, f"profiling {out}")
    if device.type == "cuda":
        check(out["trace_fused_kernels"] > 0, f"the trace shows no fused-MLP kernel: {out}")
    return out


def train_options_phase(device, sizes, card):
    """The remaining training paths (see the module docstring). Returns the
    fields the kernels line carries."""
    phase_t0 = time.perf_counter()
    took_s = {}

    def stamp(what):
        took_s[what] = time.perf_counter() - phase_t0 - sum(took_s.values())

    shutil.rmtree(TO_DIR, ignore_errors=True)
    os.makedirs(TO_DIR)
    dp = data_parallel_checks(device, sizes)
    stamp("data_parallel")
    clip, tr = clip_checks(device, sizes)
    stamp("clip")
    lp = lpips_checks(device, sizes)
    stamp("lpips")
    prof = profiling_checks(tr, device)
    stamp("profiling")
    shutil.rmtree(TO_DIR, ignore_errors=True)
    log(f"training-options phase: {time.perf_counter() - phase_t0:.1f} s ({card}); s by step",
        json.dumps(took_s))
    return {"mesh_step_launches": dp["fused_launches_per_mesh_step"],
            "sharded_sweep_launches": dp["fused_launches_per_sharded_sweep"],
            "clip_step_launches": clip["runs"][0]["fused_launches"][-1],
            "clip_step_ms": clip["clip_step_ms"], "lpips_ms": lp["ms"],
            "frame_256_ms": prof["frame_256_ms"]}


# ---------------------------------------------------------------- viewer phase
VIEW_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_viewer")
VIEW_CHUNKS = 3     # train chunks: the first of 16 steps, then as the budget sizes them
VIEW_DT_GAMMA = 1.0 / 128  # the dt_gamma the server's slider sets
# the viewer's size on the card is the --gui defaults of cli/flags.py; the
# rehearsal's is tiny
VIEW_REHEARSAL = {"W": 96, "H": 64}


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(base, method, path, body=None, tries=100):
    """(status, reply bytes, round trip ms) of one request; retries while
    the server thread is not listening yet."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    for _ in range(tries):
        req = urllib.request.Request(base + path, data=data, method=method)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, r.read(), (time.perf_counter() - t0) * 1e3
        except urllib.error.HTTPError as e:
            return e.code, b"", (time.perf_counter() - t0) * 1e3
        except urllib.error.URLError:
            time.sleep(0.05)
    raise RuntimeError(f"chip_smoke: no server answered {method} {path}")


def viewer_card_vs_cpu(device, sizes, flags):
    """(3): Trainer.test_gui at 64x64, downscale 0.5 (a 32x32 render
    resized on the host), inside a crop box and at a Halton offset, from the
    viewer's camera, on this device and on the CPU port loaded from the same
    checkpoint; the bar of the slice phase's 64x64 crop."""
    from nerfnav_tpu_torch.gui.viewer import OrbitCamera, _halton_offset

    cam = OrbitCamera(64, 64, r=flags.radius, fovy=flags.fovy)
    cam.orbit(150, 60)
    kw = dict(downscale=0.5, crop_aabb=[-1.5, -1.0, -1.5, 1.0, 1.5, 1.5],
              pixel_offset=_halton_offset(5))
    imgs = []
    for dev, ws in ((device, VIEW_DIR + "_dev"), (torch.device("cpu"), VIEW_DIR + "_cpu")):
        t = train_trainer(dev, sizes, ws)
        t.load_checkpoint(OPT_CKPT)
        imgs.append(t.test_gui(cam.pose, cam.intrinsics, 64, 64, **kw)["image"])
        shutil.rmtree(ws, ignore_errors=True)
    diff = np.abs(imgs[0] - imgs[1])
    out = {"mean_abs": float(diff.mean()), "max_abs": float(diff.max()),
           "frac_over_5e-2": float((diff > 5e-2).mean()), "crop_mean": float(imgs[1].mean())}
    log("viewer test_gui 64x64 at downscale 0.5, crop and offset, this device vs the CPU port:",
        json.dumps(out))
    check(imgs[0].shape == (64, 64, 3) and np.isfinite(imgs[0]).all(), "viewer crop not finite")
    check(out["mean_abs"] <= 5e-3 and out["frac_over_5e-2"] <= 0.01,
          f"viewer crop mismatch {out}")
    return out


def viewer_train_chunks(gui, tr):
    """(1): VIEW_CHUNKS train chunks; the fused launches of each chunk's
    steps (the sweeps' counted apart) must be 2 a step."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    sweep = {"launches": 0}
    update = tr._maybe_update_occupancy

    def counted_update():
        before = fm.fused_mlp.launches
        update()
        sweep["launches"] += fm.fused_mlp.launches - before

    tr._maybe_update_occupancy = counted_update
    chunks = []
    try:
        for _ in range(VIEW_CHUNKS):
            steps, sweep["launches"] = gui.train_steps, 0
            before = fm.fused_mlp.launches
            out = gui.train_step()
            chunks.append({"steps": steps, "loss": out["loss"], "s": out["time"],
                           "steps_per_s": out["steps_per_sec"],
                           "fused_launches_in_steps": fm.fused_mlp.launches - before
                           - sweep["launches"], "fused_launches_in_sweeps": sweep["launches"],
                           "next_train_steps": gui.train_steps})
    finally:
        del tr._maybe_update_occupancy
    log("viewer train chunks (the 500 ms budget sizes the next):", json.dumps(chunks))
    check(chunks[0]["steps"] == 16, f"the first chunk took {chunks[0]['steps']} steps")
    check(all(math.isfinite(c["loss"]) for c in chunks), "a non-finite viewer train loss")
    if tr.device.type == "cuda":
        check(all(c["fused_launches_in_steps"] == 2 * c["steps"] for c in chunks),
              "a viewer train step did not launch the fused MLP twice")
    return chunks


def viewer_passes(gui, tr, device, card):
    """(2): from a fresh camera the fast pass at 0.25, the refinements at
    0.5 and 1.0, one Halton-jittered pass at full resolution, each timed
    with its fused launches; the jittered pass must average into the frame."""
    from nerfnav_tpu_torch.gui.viewer import _halton_offset
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    H, W = gui.cam.H, gui.cam.W
    gui.touch()
    seen = []
    test_gui = tr.test_gui
    tr.test_gui = lambda *a, **k: seen.append((k, test_gui(*a, **k))) or seen[-1][1]
    passes, frames = [], []
    try:
        for name in ("fast", "refine 0.5", "refine 1.0", "spp 2"):
            before, prev = fm.fused_mlp.launches, gui._acc
            sync(device)
            t0 = time.perf_counter()
            frame = gui.render_frame()
            sync(device)
            kw, out = seen[-1]
            rh, rw = max(int(H * kw["downscale"]), 8), max(int(W * kw["downscale"]), 8)
            passes.append({"pass": name, "downscale": kw["downscale"], "render": [rw, rh],
                           "ms": (time.perf_counter() - t0) * 1e3, "test_gui_ms": out["time"] * 1e3,
                           "fused_launches": fm.fused_mlp.launches - before, "spp": gui.spp,
                           "pixel_offset": kw.get("pixel_offset"),
                           "downscale_after": gui.downscale, "mean": float(frame.mean())})
            frames.append((prev, frame, out["image"]))
            check(frame.shape == (H, W, 3) and np.isfinite(frame).all(),
                  f"viewer pass {name}: {frame.shape}, finite {np.isfinite(frame).all()}")
            check(0.0 < float(frame.mean()) < 1.0, f"viewer pass {name}: mean {frame.mean()}")
    finally:
        del tr.test_gui
    log("viewer passes at", f"{W}x{H} ({card}):", json.dumps(passes))
    check([p["downscale"] for p in passes] == [0.25, 0.5, 1.0, 1.0]
          and passes[3]["pixel_offset"] == _halton_offset(1) and gui.spp == 2,
          f"the viewer's passes ran as {passes}")
    prev, frame, jittered = frames[3]
    check(np.array_equal(frame, (prev + jittered) / 2),
          "the jittered pass is not the mean of the frame and its render")
    check(float(np.abs(jittered - prev).mean()) > 0, "the Halton offset moved no pixel")
    if device.type == "cuda":
        cam = gui.cam
        prof = profile_call(lambda: tr.test_gui(cam.pose, cam.intrinsics, W, H, downscale=0.25),
                            passes[0]["test_gui_ms"], "profiled viewer fast pass")
        if prof:
            passes[0]["idle_share"] = prof["device_idle_share_of_unprofiled_call"]
        for p in passes:
            check(p["fused_launches"] > 0, f"viewer pass {p['pass']} launched no fused MLP")
    return passes


def viewer_server(gui, tr, device, sizes):
    """(4): the web server on a free port of 127.0.0.1 in a thread: the page,
    /orbit and /frame, /set bg_color and /frame, /set dt_gamma and /frame
    (which trains a chunk first), /save_ckpt and /save_mesh."""
    import threading

    import cv2

    from nerfnav_tpu_torch.ops import fused_mlp as fm
    from nerfnav_tpu_torch.training import trainer as trainer_mod

    if device.type != "cuda":  # the mesh at the rehearsal's lattice
        save_mesh = tr.save_mesh
        tr.save_mesh = lambda: save_mesh(resolution=sizes["mesh_res"])
    march_dt = []
    render_grid = trainer_mod.render_rays_grid
    trainer_mod.render_rays_grid = lambda f, occ, mcfg, *a, **k: march_dt.append(
        mcfg.dt_gamma) or render_grid(f, occ, mcfg, *a, **k)
    H, W = gui.cam.H, gui.cam.W
    script = [("GET", "/", None), ("POST", "/orbit", {"dx": 120, "dy": 40}),
              ("GET", "/frame", None), ("POST", "/set", {"bg_color": 0}),
              ("GET", "/frame", None), ("POST", "/set", {"dt_gamma": VIEW_DT_GAMMA}),
              ("GET", "/frame", None), ("POST", "/save_ckpt", {}), ("POST", "/save_mesh", {})]
    port = free_port()
    server = threading.Thread(target=gui.serve, kwargs={"port": port, "steps": len(script)})
    server.start()
    replies, page = [], b""
    try:
        for method, path, body in script:
            before, steps_before, march_dt[:] = fm.fused_mlp.launches, tr.global_step, []
            status, data, ms = http_call(f"http://127.0.0.1:{port}", method, path, body)
            rec = {"request": f"{method} {path}", "status": status, "ms": ms, "bytes": len(data),
                   "fused_launches": fm.fused_mlp.launches - before,
                   "train_steps": tr.global_step - steps_before}
            if path == "/frame":
                dec = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
                check(data[:2] == b"\xff\xd8" and dec is not None and dec.shape == (H, W, 3),
                      f"/frame sent no {W}x{H} JPEG: {data[:4]}")
                rec.update(downscale=gui._acc_scale, march_dt_gamma=sorted(set(march_dt)))
            elif path == "/":
                page = data
            else:
                rec["reply"] = json.loads(data)
            replies.append(rec)
            check(status == 200, f"{method} {path} answered {status}")
    finally:
        server.join(timeout=900)
        trainer_mod.render_rays_grid = render_grid
        if device.type != "cuda":
            del tr.save_mesh
    log("viewer server:", json.dumps(replies))
    check(not server.is_alive(), "the viewer server did not stop")
    check(b"<script>" in page, "GET / sent no page")
    check(gui.bg_color == 0.0 and gui.cam.azimuth != 0.0, "the widgets did not apply")
    check(tr.march_cfg.dt_gamma == VIEW_DT_GAMMA
          and tr._train_march_cfg().dt_gamma == VIEW_DT_GAMMA
          and replies[6]["march_dt_gamma"] == [VIEW_DT_GAMMA] and replies[6]["train_steps"] > 0,
          f"the dt_gamma slider did not reach the next train chunk: {replies[6]}")
    check(replies[2]["march_dt_gamma"] == [0.0], f"the first chunk marched at {replies[2]}")
    ckpts = os.listdir(os.path.join(VIEW_DIR, "checkpoints"))
    check(replies[7]["reply"]["status"] == "checkpoint saved" and ckpts, "no checkpoint saved")
    mesh_path = replies[8]["reply"]["status"].split("mesh saved: ", 1)[-1]
    check(os.path.exists(mesh_path), f"no mesh written: {replies[8]}")
    if device.type == "cuda":
        want = -(-256**3 // MESH_N)
        check(replies[8]["fused_launches"] == want,
              f"/save_mesh launched the fused MLP {replies[8]['fused_launches']} times, not {want}")
    return replies


def viewer_phase(device, sizes, card):
    """The interactive viewer at the --gui defaults on the training phase's
    trained field (see the module docstring). Returns the fields the kernels
    line carries."""
    from nerfnav_tpu_torch.cli.flags import build_parser
    from nerfnav_tpu_torch.gui import NeRFGUI

    phase_t0 = time.perf_counter()
    took_s = {}

    def stamp(what):
        took_s[what] = time.perf_counter() - phase_t0 - sum(took_s.values())

    flags = build_parser("chip_smoke").parse_args(["scene"])
    W, H = (flags.W, flags.H) if device.type == "cuda" else (VIEW_REHEARSAL["W"],
                                                             VIEW_REHEARSAL["H"])
    shutil.rmtree(VIEW_DIR, ignore_errors=True)
    crop = viewer_card_vs_cpu(device, sizes, flags)
    stamp("card_vs_cpu")
    tr = train_trainer(device, sizes, VIEW_DIR)
    tr.load_checkpoint(OPT_CKPT)
    gui = NeRFGUI(tr, target_frames(sizes["hw"]), W=W, H=H, radius=flags.radius,
                  fovy=flags.fovy, max_spp=flags.max_spp)
    chunks = viewer_train_chunks(gui, tr)
    stamp("train_chunks")
    passes = viewer_passes(gui, tr, device, card)
    stamp("passes")
    server = viewer_server(gui, tr, device, sizes)
    stamp("server")
    shutil.rmtree(VIEW_DIR, ignore_errors=True)
    shutil.rmtree(OPT_DIR, ignore_errors=True)
    log(f"viewer phase: {time.perf_counter() - phase_t0:.1f} s ({card}); s by step",
        json.dumps(took_s))
    return {"viewer_launches_per_train_step": [c["fused_launches_in_steps"] / c["steps"]
                                               for c in chunks],
            "viewer_pass_launches": {p["pass"]: p["fused_launches"] for p in passes},
            "viewer_pass_ms": {p["pass"]: p["ms"] for p in passes},
            "viewer_frame_round_trip_ms": [r["ms"] for r in server if r["request"] == "GET /frame"],
            "viewer_mesh_launches": server[8]["fused_launches"],
            "viewer_crop_mean_abs": crop["mean_abs"]}


QS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_quickstart")
# the card runs examples/quickstart_torch.py at its defaults (300 steps at
# 40x40, a 300-epoch plan), the rehearsal at the CPU test's sizes
QS_ARGS = {"card": [], "rehearsal": ["--steps", "6", "--hw", "16", "--plan_epochs", "20"]}


def quickstart_phase(device, sizes, card):
    """examples/quickstart_torch.py's main, in this process, on this device:
    the five stages must finish with a finite val PSNR, a planner loss that
    fell and, on the card, the fused-MLP kernel launched in training and in
    the renders. Returns the fields the kernels line carries."""
    import importlib.util

    from nerfnav_tpu_torch.ops import fused_mlp as fm
    from nerfnav_tpu_torch.ops import hashgrid as hg

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "examples", "quickstart_torch.py"))
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    shutil.rmtree(QS_DIR, ignore_errors=True)
    fm.fused_mlp.launches = hg.hash_grid_encode.launches = 0
    t0 = time.perf_counter()
    out = quickstart.main(["--device", str(device), *sizes["quickstart"], "--out", QS_DIR])
    took = time.perf_counter() - t0
    launches = fm.fused_mlp.launches
    GRID_LAUNCHES["quickstart_launches"] = hg.hash_grid_encode.launches
    check(math.isfinite(out["psnr"]), f"quickstart val PSNR {out['psnr']}")
    check(out["frames"] == 2, f"quickstart rendered {out['frames']} frames")
    check(out["losses"][-1] < out["losses"][0],
          f"the quickstart planner's loss did not fall: {out['losses'][0]} -> {out['losses'][-1]}")
    if device.type == "cuda":
        check(launches > 0 and out["launches"]["train"] > 0 and out["launches"]["render"] > 0,
              f"the quickstart did not launch the fused-MLP kernel: {out['launches']}")
        check(GRID_LAUNCHES["quickstart_launches"] > 0,
              "the quickstart never launched the hash-grid kernel")
    shutil.rmtree(QS_DIR, ignore_errors=True)
    log(f"quickstart phase: {took:.1f} s ({card}), val PSNR {out['psnr']:.3f} dB, planner "
        f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, clearance "
        f"{out['clearance']:.3f}, fused launches {launches}, hash-grid launches "
        f"{GRID_LAUNCHES['quickstart_launches']}; by stage",
        json.dumps({"s": out["seconds"], "launches": out["launches"]}))
    return {"quickstart_launches": launches, "quickstart_stage_launches": out["launches"],
            "quickstart_stage_s": out["seconds"], "quickstart_psnr": out["psnr"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase at tiny sizes on the CPU with the plain "
                         "versions (never reports a GPU)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="set-up and the kernel phase only, then exit without "
                         "the result lines (for iterating on a kernel)")
    args = ap.parse_args()
    if args.cpu_rehearsal:
        device = torch.device("cpu")
        sizes = {"hw": 128, "grid": 32, "log2": 12, "frames": 1, "mlp_n": 2048,
                 "rays": 512, "nav": NAV_SIZES["rehearsal"], "ref": REF_SIZES["rehearsal"],
                 "bg": BG_SIZES["rehearsal"], "dense_n": 256 * 32, "grid_n": 1536,
                 "mesh_res": 32,
                 "clip": CLIP_WIDTHS["rehearsal"], "quickstart": QS_ARGS["rehearsal"]}
    else:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: torch.cuda.is_available() is False; no result")
        device = torch.device("cuda")
        sizes = {"hw": 800, "grid": 128, "log2": 17, "frames": 3, "mlp_n": 32768,
                 "rays": 4096, "nav": NAV_SIZES["card"], "ref": REF_SIZES["card"],
                 "bg": BG_SIZES["card"], "dense_n": 4096 * 512,
                 # the grid path's largest point budget, 0.75 x 4096 rays x 64
                 "grid_n": 196608, "mesh_res": 256,
                 "clip": CLIP_WIDTHS["card"], "quickstart": QS_ARGS["card"]}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    card = "cpu rehearsal"

    from nerfnav_tpu_torch import kernels

    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, check=True)
        card = smi.stdout.strip()
        log(card)
        t0 = time.perf_counter()
        for name, out in kernels.build_all().items():
            log(f"built {name} ({time.perf_counter() - t0:.1f} s):\n{out.strip()}")
    timer = Timer(device)
    mlp = kernel_phase(device, sizes["mlp_n"], sizes["dense_n"], timer)
    encode = encode_phase(device, sizes["dense_n"], sizes["grid_n"])
    if args.kernels_only:
        return
    cascade = cascade_phase(device)
    launches = slice_phase(device, sizes, card)
    train_launches = training_phase(device, sizes, card)
    nav_launches = nav_phase(device, sizes, card)
    ref_launches = reference_phase(device, sizes, card)
    bg_launches = bg_phase(device, sizes, card)
    opt_out = options_phase(device, sizes, card)
    train_opt_out = train_options_phase(device, sizes, card)
    viewer_out = viewer_phase(device, sizes, card)
    quickstart_out = quickstart_phase(device, sizes, card)
    entry = {"name": "fused_mlp", "route": "cuda",
             "source": "nerfnav_tpu_torch/csrc/fused_mlp.cu",
             "replaces": "nerfnav_tpu/ops/fused_mlp.py:58",
             "launches": launches, "max_abs_err": mlp["max_abs_err"],
             "ms": mlp["ms"], "plain_ms": mlp["plain_ms"],
             "bound_ms": mlp["bound_ms"], "bound_by": mlp["bound_by"],
             "library_ms": mlp["library_ms"], "train_launches_per_step": train_launches,
             "nav_launches": nav_launches, "cascade_disagreements": cascade, **ref_launches,
             **{k: v for k, v in mlp.items() if k.startswith(("bg_", "mesh_"))},
             **bg_launches, **opt_out, **train_opt_out, **viewer_out, **quickstart_out}
    hashgrid = {"name": "hashgrid", "route": "cuda",
                "source": "nerfnav_tpu_torch/csrc/hashgrid.cu", "replaces": None,
                **{f"{what}_{k}": v for what, t in encode.items() for k, v in t.items()},
                **GRID_LAUNCHES}
    log(json.dumps({"kernels": [entry, hashgrid]}))
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(0)
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                               "count": torch.cuda.device_count()}}))
    else:
        log(json.dumps({"ok": True, "device": {"platform": "cpu",
                                               "kind": "cpu rehearsal", "count": 0}}))


if __name__ == "__main__":
    main()
