"""Chip smoke test of nerfnav_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes on the CPU, plain versions
    python3 chip_smoke.py --kernels-only   # set-up and kernel phase, then exit

1. Set-up: prints the card's name and power limit (nvidia-smi) and builds
   every CUDA kernel of the port from csrc/ (one nvcc per source, started
   together).
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the main path's shapes, ragged ones and the edges of the kernel's
   contract (fused MLP: atol = rtol = 2e-2, the bound tests/test_fused_mlp.py
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
4. Prints one {"kernels": [...]} line and, last, {"ok": true, "device": ...}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

import argparse
import json
import math
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


def profile_frame(tr, pose, intr, hw, frame_ms):
    """One warm frame under torch.profiler: the device time of every kernel,
    its share of the unprofiled frame time, and the kernels that take most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.render_full(tr.params, pose, intr, hw, hw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        log("profiled frame: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    fused = [v for k, v in by_name.items() if "fused_mlp_kernel" in k]
    log("profiled frame:", json.dumps({
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "kernel_launches": sum(n for _, n in by_name.values()),
        "device_idle_share_of_unprofiled_frame": 1.0 - busy_ms / frame_ms,
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
        profile_frame(tr, pose, intr, hw, frame_s * 1e3)
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
        sizes = {"hw": 128, "grid": 32, "log2": 12, "frames": 1, "mlp_n": 2048}
    else:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: torch.cuda.is_available() is False; no result")
        device = torch.device("cuda")
        sizes = {"hw": 800, "grid": 128, "log2": 17, "frames": 3, "mlp_n": 32768}
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
    entry = {"name": "fused_mlp", "route": "cuda",
             "source": "nerfnav_tpu_torch/csrc/fused_mlp.cu",
             "replaces": "nerfnav_tpu/ops/fused_mlp.py:58",
             "launches": launches, "max_abs_err": mlp["max_abs_err"],
             "ms": mlp["ms"], "plain_ms": mlp["plain_ms"],
             "bound_ms": mlp["bound_ms"], "bound_by": mlp["bound_by"],
             "library_ms": mlp["library_ms"]}
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
