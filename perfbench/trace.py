"""Spans the harness records around its calls into the program, and the
traced sub-window: torch.profiler's raw kineto events reduced to kernel
intervals, their union (the device's busy time) and the idle gaps between
them, each gap labelled by the harness span that was open on the host.

The raw events are read directly (`kineto_results.events()`): building the
profiler's event tree for ~10^5 kernels takes minutes of host time.
"""

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
import time

import torch


class Spans:
    """Named host intervals (perf_counter seconds), recorded always; inside a
    traced sub-window each span is also a profiler range, so the trace can
    say what the host was doing when the device went idle."""

    def __init__(self):
        self.items = []        # (name, start_s, end_s)
        self.profiling = False

    @contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(name) if self.profiling else nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def total(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> float:
        """Seconds spent in spans called `name` that start inside [t0, t1]."""
        return sum(e - s for n, s, e in self.items if n == name and t0 <= s <= t1)


@dataclass
class Trace:
    """What a traced sub-window recorded. Kernel and range times are in
    nanoseconds on the profiler's clock; window_s on the host's."""
    window_s: float = 0.0
    t0: float = 0.0                 # host perf_counter at the window's start
    kernels: list = field(default_factory=list)   # (name, start_ns, end_ns)
    ranges: list = field(default_factory=list)    # host spans: (name, start_ns, end_ns)
    counters: dict = field(default_factory=dict)  # what the driver counted in it

    def busy_intervals(self):
        """The union of the kernel intervals, sorted: [(start_ns, end_ns)]."""
        out = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def n_kernels(self) -> int:
        """Kernel launches: device operations other than copies and fills."""
        return sum(1 for n, _, _ in self.kernels
                   if not n.startswith(("Memcpy", "Memset")))

    def device_seconds(self, match: str) -> float:
        return sum(e - s for n, s, e in self.kernels if match in n) / 1e9

    def top_ops(self, k: int = 10):
        """The device operations that took most time: [[name, seconds]]."""
        by = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s) / 1e9
        return [[n[:120], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """The longest gaps between busy intervals, each labelled by the
        innermost host span open at the gap's start (or "no span"):
        [[label, seconds]]."""
        busy = self.busy_intervals()
        gaps = [(s1 - e0, e0) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0]
        out = []
        for length, at in sorted(gaps, reverse=True)[:k]:
            open_ = [(s, n) for n, s, e in self.ranges if s <= at < e]
            out.append([max(open_)[1] if open_ else "no span", length / 1e9])
        return out


@contextmanager
def traced(spans: Spans, device, host_ops: bool = True):
    """Run the block under torch.profiler and yield the Trace it fills when
    the block ends (after a synchronize). host_ops=False traces the card
    only, for blocks of ~10^5 kernels; the spans then carry no labels. On
    the CPU (the harness's own tests) only host operations are traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] * (host_ops or not card) + [ProfilerActivity.CUDA] * card
    tr = Trace()
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        spans.profiling = host_ops
        tr.t0 = time.perf_counter()
        try:
            yield tr
            sync()
        finally:
            tr.window_s = time.perf_counter() - tr.t0
            spans.profiling = False
    names = {n for n, _, _ in spans.items}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                tr.kernels.append((e.name(), start, end))
        elif e.name() in names:
            tr.ranges.append((e.name(), start, end))
