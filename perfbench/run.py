"""The benchmark of nerfnav_tpu_torch on NVIDIA GPUs.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json and the program.
The workload names a configuration (`perfbench/configs/<config>.json`) and
a traffic mix (`perfbench/traffic/<traffic>.json`); the mix names its driver
(`perfbench/drivers/<driver>.py`), whose `Cell` makes the inputs and weights
from the seed, builds the program, warms it up, runs the measured window and
checks what the window's path produced against the plain reference
(`perfbench/reference/`). With --trace 0 the result carries the cell's
end-to-end metrics; with --trace 1 a sub-window runs under torch.profiler
and each per-layer metric of the cell is read by
`perfbench/layer_metrics/<metric>.py` or, without one, by the reader of the
metric's name after its cell prefix (`reader_path`). Each compared number is
printed beside its limit on standard error, and the result is the last line
of standard output.

Exits with 2 and prints no result without as many CUDA devices as the cell
asks for, and with 3 if JAX or the JAX package was loaded.
"""

import os
import time


def _process_start() -> float:
    """The process's start on time.perf_counter's clock (from /proc; the
    interpreter's start-up is part of set-up)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()

import argparse  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from pathlib import Path  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nerfnav_tpu")


@dataclass
class Check:
    """One compared number: the run is correct only if value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Ctx:
    """What a driver's Cell is given."""
    name: str
    config: dict
    traffic: dict
    seed: int
    device: object
    spans: object
    trace: bool
    scratch: Path = field(default_factory=lambda: ROOT / "build" / "perfbench")


@dataclass
class Window:
    """What a Cell's window returns: end-to-end metric values by name, the
    work attempted and failed, and the traced sub-window (with --trace 1)."""
    metrics: dict
    attempted: int
    failed: int
    trace: object = None
    notes: dict = field(default_factory=dict)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str):
    """(workload entry, config dict, traffic dict) of a workload."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(by_name)}")
    w = by_name[workload]
    return (w, load_json(HERE / "configs" / f"{w['config']}.json"),
            load_json(HERE / "traffic" / f"{w['traffic']}.json"))


def metrics_of(bench: dict, workload: str):
    """(end-to-end metric entries, per-layer metric entries) the workload
    reports: those that list it, or list no workloads (a per-layer one then
    for every cell that reports the metric it moves)."""
    def applies(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", []) or
                 ("workloads" not in m and m["moves"] in names)]
    return e2e, per_layer


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: `layer_metrics/<metric>.py`, or,
    where there is none, the reader of the name after its first dot (the
    cell's prefix): `grid.mfu` is read by `layer_metrics/mfu.py` unless
    `layer_metrics/grid.mfu.py` exists."""
    own = HERE / "layer_metrics" / f"{metric}.py"
    if own.is_file() or "." not in metric:
        return own
    return HERE / "layer_metrics" / f"{metric.split('.', 1)[1]}.py"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def program_of_checkout():
    """The program measured is the checkout's own, not an installed copy."""
    import nerfnav_tpu_torch

    where = Path(nerfnav_tpu_torch.__file__).resolve().parent.parent
    if where != ROOT:
        raise RuntimeError(f"nerfnav_tpu_torch comes from {where}, not from the checkout "
                           f"{ROOT}")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_environment():
    """Before torch loads: every build and kernel cache at a fixed path
    inside the checkout (the program builds its CUDA kernels under
    build/kernels of the checkout by itself, nerfnav_tpu_torch.kernels.
    build_dir), and one thread for the host's numeric libraries: the timed
    paths are single-threaded Python issuing kernels, and idle pool threads
    spinning beside it on a shared host only add noise."""
    cache = ROOT / "build" / "perfbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def execute(args, device=None, bench=None, overrides=None):
    """Run one cell; returns (result dict, checks, the window's notes). device: a torch.device
    to run on (the CLI passes the card); bench: the parsed BENCHMARK.json;
    overrides: {"config": {...}, "traffic": {...}} merged into the cell's
    files (the harness's CPU tests run tiny sizes so)."""
    import torch

    from perfbench.trace import Spans, traced

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    program_of_checkout()
    w, config, traffic = cell_spec(bench, args.workload)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    e2e, per_layer = metrics_of(bench, args.workload)
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                         f"perfbench_driver_{traffic['driver']}")
    spans = Spans()
    ctx = Ctx(name=args.workload, config=config, traffic=traffic, seed=args.seed,
              device=device, spans=spans, trace=bool(args.trace))
    cell = driver.Cell(ctx)
    setup_s = time.perf_counter() - T_START
    win = cell.window(args.seconds, (lambda host_ops=True: traced(spans, device, host_ops))
                      if args.trace else None)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    cell.release()
    checks = cell.check()
    correct = all(c.ok for c in checks)

    if args.trace:
        tr = win.trace
        metrics = {}
        for m in per_layer:
            reader = load_module(reader_path(m["name"]),
                                 "perfbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(tr, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {**win.metrics, "setup_s": setup_s}
        missing = [m["name"] for m in e2e if m["name"] not in values]
        if missing:
            raise RuntimeError(f"the driver measured no {missing}")
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in e2e}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": w["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(win.attempted), "failed": int(win.failed),
              "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks, win.notes


def main(argv=None):
    args = parse(argv)
    set_environment()
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    bench = load_json(ROOT / "BENCHMARK.json")
    w, _, _ = cell_spec(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"perfbench: {args.workload} needs {w['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks, notes = execute(args, device=device, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark runs the PyTorch "
              "port alone", file=sys.stderr)
        return 3
    print(f"perfbench: {result['device']['kind']} ({card_limit()})", file=sys.stderr)
    print(f"perfbench: window {json.dumps(notes)}", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
