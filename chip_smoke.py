"""Chip smoke test of nerfnav_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes on the CPU, plain versions
    python3 chip_smoke.py --kernels-only   # set-up and kernel phase, then exit

1. Set-up: prints the card's name and power limit (nvidia-smi) and builds
   every CUDA kernel of the port from csrc/ (one nvcc per source, started
   together).
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes (the eval round's and a dense train step's),
   ragged ones and the edges of the kernel's contract (fused MLP: atol = rtol = 2e-2, the bound tests/test_fused_mlp.py
   uses; hidden activations are re-rounded to bf16, so a different f32
   summation order can move one by a bf16 step), then timed with CUDA events
   beside the plain version and a library call, at the main path's N and at
   8 x N. With --kernels-only the script stops here, with no result line.
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
   step.
5. Prints one {"kernels": [...]} line and, last, {"ok": true, "device": ...}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor cores, H100 SXM data sheet
MLP_TOL = 2e-2
ACTIVATIONS = ["relu", "none", "exp", "sigmoid", "sine", "squareplus", "softplus"]
MLP_SHAPES = {"sigma": [32, 64, 16], "color": [31, 64, 64, 3]}
# edges of the fused MLP's contract (1-8 layers, widths 1-256, any N):
# name -> (dims, rows); plus the color net at COLOR_EDGE_ROWS rows
MLP_EDGES = {"8x128": ([128] * 9, 1000), "3-256-256-1": ([3, 256, 256, 1], 1000),
             "1-16-1": ([1, 16, 1], 1000)}
COLOR_EDGE_ROWS = (1, 127, 128, 129, 8192, 32768)
TRAIN_STEPS = 48    # sweeps at steps 0, 16 and 32
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


def mlp_bound_ms(n, dims):
    """Least time for one fused-MLP call: f32 input and output once, bf16
    weights once, against the dense bf16 peak."""
    bytes_ = n * (dims[0] + dims[-1]) * 4 + sum(
        a * b * 2 for a, b in zip(dims[:-1], dims[1:]))
    flops = 2 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(device, n_full, timer):
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
    for n, shapes in ((n_full, per_shape), (8 * n_full, big)):
        log("fused_mlp per shape at N =", n, json.dumps(shapes))
    total = {k: sum(v[k] for v in per_shape.values())
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bound_by = {mlp_bound_ms(n_full, d)[1] for d in MLP_SHAPES.values()}
    return {**total, "max_abs_err": max_err,
            "bound_by": "bytes" if bound_by == {"bytes"} else "operations"}


def time_shapes(n, gen, device, timer):
    """Kernel, plain version and bf16 torch.matmul chain at N = n rows for
    each main-path shape; with the bound and the kernel's share of it."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    out = {}
    for name, dims in MLP_SHAPES.items():
        # bf16 weights, as Trainer._cast_eval_tables hands them to the kernel
        wb = [w.to(torch.bfloat16) for w in mlp_weights(dims, gen, device)]
        x = torch.randn((n, dims[0]), generator=gen).to(device)

        def library(x=x, wb=wb):
            h = x.to(torch.bfloat16)
            for i, w in enumerate(wb):
                h = h @ w
                if i < len(wb) - 1:
                    h = torch.relu(h)
            return h.float()

        t = {"ms": timer(lambda x=x, wb=wb: fm.fused_mlp(x, wb)),
             "plain_ms": timer(lambda x=x, wb=wb: fm.fused_mlp_reference(x, wb)),
             "library_ms": timer(library),
             "bound_ms": mlp_bound_ms(n, dims)[0]}
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        out[name] = t
    return out


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
                   TrainerOptions(eval_table_dtype="bfloat16"), params=params,
                   occupancy_cfg=OccupancyConfig(bound=bound, grid_size=sizes["grid"]),
                   march_cfg=mcfg, occupancy=occupancy, device=device)


def profile_call(fn, unprofiled_ms, what):
    """One warm call under torch.profiler: the device time of every kernel,
    its share of the unprofiled call's time, and the kernels that take most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        # record_function ranges (the optimizer's step) also show on the
        # device timeline; only kernels count as device time
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        log(f"{what}: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    fused = [v for k, v in by_name.items() if "fused_mlp_kernel" in k]
    log(f"{what}:", json.dumps({
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "kernel_launches": sum(n for _, n in by_name.values()),
        "device_idle_share_of_unprofiled_call": 1.0 - busy_ms / unprofiled_ms,
        "fused_mlp_kernel_ms_count": [sum(ms for ms, _ in fused), sum(n for _, n in fused)],
        "top_kernels_ms_count": [[k[:70], round(ms, 3), n] for k, (ms, n) in top],
    }))


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

    hw = sizes["hw"]
    tr = make_trainer(device, sizes)
    pose = yaw_pose(0.0)
    intr = np.asarray([1000.0 * hw / 800, 1000.0 * hw / 800, hw / 2, hw / 2], np.float32)

    fm.fused_mlp.launches = 0
    t0 = time.perf_counter()
    image, depth = tr.render_full(tr.params, pose, intr, hw, hw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fm.fused_mlp.launches
    mean_image = check_frame(image, depth, hw)
    if device.type == "cuda":
        check(launches > 0, "the render never launched the fused-MLP kernel")
    log(f"slice phase: {hw}x{hw} frame, mean_image {mean_image:.4f}, "
        f"first frame {first_s:.3f} s, fused_mlp launches {launches}, "
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
        bm = tr._frame_beam(intr, hw, hw, rd)
        occ = tr._beamed_occupancy(tr.occupancy) if bm > 1 else tr.occupancy
        params = tr._cast_eval_tables(tr.params)
        render_chunk = tr._chunk_renderer(tr._planned_ladder(tr.occupancy), bm)
        per_chunk = []
        for i in range(0, ro.shape[0], chunk):
            before = fm.fused_mlp.launches
            render_chunk(params, occ, ro[i : i + chunk], rd[i : i + chunk], 1.0)
            per_chunk.append(fm.fused_mlp.launches - before)
        ci = int(np.argmax(per_chunk))
        sl = slice(ci * chunk, (ci + 1) * chunk)
        got = render_chunk(params, occ, ro[sl], rd[sl], 1.0)["image"]
        kernel_fn = fm.fused_mlp
        fm.fused_mlp = lambda x, w, a="relu", o="none": fm.fused_mlp_reference(x, w, a, o)
        try:
            want = render_chunk(params, occ, ro[sl], rd[sl], 1.0)["image"]
        finally:
            fm.fused_mlp = kernel_fn
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


def train_trainer(device, sizes, workspace, params=None, small=False):
    """A fresh port Trainer in the -O --ff training configuration; small=True
    is the CPU tests' configuration with the xla fp32 field."""
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
                   occupancy_cfg=occ_cfg, march_cfg=mcfg, device=device)


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
    from nerfnav_tpu_torch.ops.morton import unpackbits
    from nerfnav_tpu_torch.training import checkpoint as ckpt_lib

    workspace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "chip_smoke_train")
    shutil.rmtree(workspace, ignore_errors=True)
    ds = target_frames(sizes["hw"])
    tr = train_trainer(device, sizes, workspace)

    # count the fused launches of the sweeps and keep every step's loss
    sweep = {"launches": 0, "count": 0}
    losses = []
    update, step = tr._maybe_update_occupancy, tr.train_step

    def counted_update():
        before, iters = fm.fused_mlp.launches, int(tr.occupancy["iter_density"])
        update()
        sweep["launches"] += fm.fused_mlp.launches - before
        sweep["count"] += int(tr.occupancy["iter_density"]) - iters

    def kept_step(*a):
        loss = step(*a)
        losses.append(loss)
        return loss

    tr._maybe_update_occupancy, tr.train_step = counted_update, kept_step
    fm.fused_mlp.launches = 0
    t0 = time.perf_counter()
    tr.train(ds, max_epochs=1, steps_per_epoch=TRAIN_STEPS)
    sync(device)
    train_s = time.perf_counter() - t0
    total = fm.fused_mlp.launches
    del tr._maybe_update_occupancy, tr.train_step
    losses = torch.stack(losses).cpu()
    step_launches = total - sweep["launches"]
    occ_share = float(unpackbits(tr.occupancy["bitfield"]).float().mean())
    log("training:", json.dumps({
        "steps": len(losses), "first_run_s": train_s, "sweeps": sweep["count"],
        "loss_first8": float(losses[:8].mean()), "loss_last8": float(losses[-8:].mean()),
        "fused_launches_in_steps": step_launches,
        "fused_launches_in_sweeps": sweep["launches"], "occupied_share": occ_share,
        "mean_count": float(tr.state.mean_count), "budget": tr._current_budget()}))
    check(len(losses) == TRAIN_STEPS and bool(torch.isfinite(losses).all()),
          "a non-finite training loss")
    check(losses[-8:].mean() < losses[:8].mean(), "the training loss did not fall")
    check(sweep["count"] == 3, f"{sweep['count']} occupancy sweeps, expected 3")
    if device.type == "cuda":
        check(step_launches > 0, "the train steps never launched the fused-MLP kernel")
        check(sweep["launches"] > 0, "the occupancy sweeps never launched the fused-MLP kernel")
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

    time_training(tr, arrays, H, W, device, card, step_launches / TRAIN_STEPS)
    shutil.rmtree(workspace, ignore_errors=True)
    return step_launches / TRAIN_STEPS


def kernel_vs_plain_step(tr, arrays, H, W):
    """loss_and_grads from one state and draws with the kernel and with the
    plain MLP swapped in."""
    from nerfnav_tpu_torch.ops import fused_mlp as fm

    draws = tr.draw_step(tr.state, 0, H, W)
    got = tr.loss_and_grads(tr.state, arrays, draws)
    kernel_fn = fm.fused_mlp
    fm.fused_mlp = lambda x, w, a="relu", o="none": fm.fused_mlp_reference(x, w, a, o)
    try:
        want = tr.loss_and_grads(tr.state, arrays, draws)
    finally:
        fm.fused_mlp = kernel_fn
    loss_rel = abs(float(got.loss) - float(want.loss)) / abs(float(want.loss))
    errs = [rel_l2(a, b) for a, b in zip(got.grads, want.grads)]
    log("one step, kernel vs plain MLP:", json.dumps({
        "budget": tr._current_budget(), "loss_rel": loss_rel,
        "grad_rel_l2_max": max(errs), "grad_rel_l2": errs, "bound": GRAD_TOL}))
    check(loss_rel <= 2e-2, f"loss with the kernel {loss_rel} away from the plain MLP's")
    check(max(errs) <= GRAD_TOL, f"gradients with the kernel {max(errs)} away (L2)")


def card_vs_cpu_step(device, sizes):
    """One step at the CPU tests' size, xla fp32 field: this device against
    the CPU port, from the same params, occupancy and draws."""
    cpu = torch.device("cpu")
    ds = target_frames(24, seed=3)
    ws = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_small")
    tr_cpu = train_trainer(cpu, sizes, ws, small=True)
    tr_dev = train_trainer(device, sizes, ws, small=True, params={
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
    want = tr_cpu.loss_and_grads(tr_cpu.state, tr_cpu._device_arrays(ds), draws)
    got = tr_dev.loss_and_grads(tr_dev.state, tr_dev._device_arrays(ds), draws_dev)
    loss_rel = abs(float(got.loss) - float(want.loss)) / abs(float(want.loss))
    errs = [rel_l2(a.cpu(), b) for a, b in zip(got.grads, want.grads)]
    log("one step at the CPU tests' size, this device vs the CPU port:", json.dumps({
        "n_samples": [int(got.n_samples), int(want.n_samples)], "loss_rel": loss_rel,
        "grad_rel_l2_max": max(errs)}))
    check(loss_rel <= 1e-5, f"loss {loss_rel} away from the CPU port's")
    check(max(errs) <= 1e-4, f"gradients {max(errs)} away from the CPU port's (L2)")


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
                 "rays": 512}
    else:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: torch.cuda.is_available() is False; no result")
        device = torch.device("cuda")
        sizes = {"hw": 800, "grid": 128, "log2": 17, "frames": 3, "mlp_n": 32768,
                 "rays": 4096}
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
    mlp = kernel_phase(device, sizes["mlp_n"], timer)
    if args.kernels_only:
        return
    launches = slice_phase(device, sizes, card)
    train_launches = training_phase(device, sizes, card)
    entry = {"name": "fused_mlp", "route": "cuda",
             "source": "nerfnav_tpu_torch/csrc/fused_mlp.cu",
             "replaces": "nerfnav_tpu/ops/fused_mlp.py:58",
             "launches": launches, "max_abs_err": mlp["max_abs_err"],
             "ms": mlp["ms"], "plain_ms": mlp["plain_ms"],
             "bound_ms": mlp["bound_ms"], "bound_by": mlp["bound_by"],
             "library_ms": mlp["library_ms"], "train_launches_per_step": train_launches}
    log(json.dumps({"kernels": [entry]}))
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(0)
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                               "count": torch.cuda.device_count()}}))
    else:
        log(json.dumps({"ok": True, "device": {"platform": "cpu",
                                               "kind": "cpu rehearsal", "count": 0}}))


if __name__ == "__main__":
    main()
