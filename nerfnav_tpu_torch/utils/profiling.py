"""Profiling helpers: a timer that waits for the device, and a trace.

Counterpart of nerfnav_tpu/utils/profiling.py (`device_timer`, `trace`):
the JAX package blocks on the arrays a block registers and writes a
jax.profiler trace; here the timer synchronises the CUDA devices of the
registered tensors, and the trace is torch.profiler's Chrome trace.
"""

import contextlib
import os
import time

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def device_timer(name: str, out: dict | None = None):
    """Times a block including the device work it queued: the block puts
    what it computed in the yielded dict's "result" (a tensor or nested
    dicts, lists and tuples of them), whose CUDA devices are synchronised
    before the clock stops. Stores the seconds in out[name] and prints
    milliseconds."""
    t0 = time.perf_counter()
    box = {}
    yield box
    leaves = tree_leaves(box.get("result"))
    for dev in {x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if out is not None:
        out[name] = dt
    print(f"[timer] {name}: {dt * 1e3:.2f} ms")


@contextlib.contextmanager
def trace(log_dir: str = "nerfnav_trace"):
    """torch.profiler over the block (the CPU, and CUDA when a card is
    present), written as a Chrome trace to <log_dir>/trace.json (open it in
    Perfetto or chrome://tracing). Yields the trace's path."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)
    print(f"[trace] written to {path}")
