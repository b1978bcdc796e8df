"""Profiling helpers: a timer that waits for the device, a trace, and the
program's own spans and counters.

Counterpart of nerfnav_tpu/utils/profiling.py (`device_timer`, `trace`):
the JAX package blocks on the arrays a block registers and writes a
jax.profiler trace; here the timer synchronises the CUDA devices of the
registered tensors, and the trace is torch.profiler's Chrome trace.

`span`, `count` and their readers (`counters`, `sync_sites`, `ranges`) have
no JAX twin. They record only while a torch profiler records (`trace()`, or
any `torch.profiler.profile` around the code): a span is then a
`record_function` range named "nerfnav/<name>" in the profiler's trace, on
the clock of its kernels, and every counter and host sync is charged to the
innermost open span. While no profiler records, a span is one attribute
read and a shared object that does nothing, and a count does nothing.
"""

import collections
import contextlib
import json
import os
import time
import warnings

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves

PREFIX = "nerfnav/"
_SYNC_WARNING = "called a synchronizing CUDA operation"
_FOLD = 256       # device values a counter keeps before it sums them

_stack = []       # the names of the open spans, innermost last
_counters = {}    # span -> counter -> [host total, [device values]]
_sites = {}       # span -> "file:line" -> host syncs
_ranges = collections.deque(maxlen=1 << 18)   # closed spans: (name, start_ns, end_ns)


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
    Perfetto or chrome://tracing; the program's spans are the ranges named
    "nerfnav/..."), and the counters of the spans the block ran (`counters()`
    after the block less before it) to <log_dir>/counters.json. Yields the
    trace's path."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    before = counters()
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters_since(before), f, indent=1)
    print(f"[trace] written to {path}")


class _Off:
    """The span while no profiler records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager around one stage of the program. While a torch
    profiler records it opens the range "nerfnav/<name>", counts the span's
    `calls`, and, as the outermost open span, counts host syncs
    (`host_syncs`, charged to the innermost open span) until it closes;
    otherwise it returns a shared object that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, value):
    """Add `value` to the counter `name` of the innermost open span (of
    None outside every span), only while a profiler records. value: a
    number, a 0-d tensor (summed on its device and read only by
    `counters()`, so a count never syncs), or a function returning one,
    called only then (for a value that takes a kernel to make)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if callable(value):
        value = value()
    _add(_stack[-1] if _stack else None, name, value)


def counters() -> dict:
    """{span: {counter: number}}: every count since the process started,
    with each span's `calls` and `host_syncs`. Reads the device values (a
    host sync)."""
    return {s: {k: host + (torch.stack(dev).sum().item() if dev else 0)
                for k, (host, dev) in c.items()} for s, c in _counters.items()}


def counters_since(before: dict) -> dict:
    """`counters()` less an earlier reading of it: the spans whose counters
    moved since, with every counter of theirs."""
    out = {}
    for s, c in counters().items():
        b = before.get(s, {})
        diff = {k: v - b.get(k, 0) for k, v in c.items()}
        if any(diff.values()):
            out[s] = diff
    return out


def sync_sites() -> dict:
    """{span: {"file:line": host syncs}}: where the syncs `counters()`
    charges to each span were issued (the Python line that called into
    torch)."""
    return {s: dict(c) for s, c in _sites.items()}


def ranges() -> list:
    """The spans closed while a profiler recorded, newest last (at most
    2^18): (name, start_ns, end_ns) on the Unix clock in nanoseconds
    (time.time_ns), the clock of the profiler's events."""
    return list(_ranges)


def _add(span_name, name, value):
    c = _counters.setdefault(span_name, {})
    slot = c.get(name)
    if slot is None:
        slot = c[name] = [0, []]
    if isinstance(value, torch.Tensor):
        slot[1].append(value.detach())
        if len(slot[1]) >= _FOLD:
            slot[1] = [torch.stack(slot[1]).sum()]
    else:
        slot[0] += value


class _Span:
    __slots__ = ("name", "_range", "_t0", "_syncs")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._syncs = None if _stack or not torch.cuda.is_initialized() else _SyncCounter()
        _stack.append(self.name)
        _add(self.name, "calls", 1)
        _add(self.name, "host_syncs", 0)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._range.__exit__(*exc)
        _stack.pop()
        _ranges.append((self.name, self._t0, t1))
        if self._syncs is not None:
            self._syncs.close()
        return False


class _SyncCounter:
    """Host syncs while the outermost span is open: torch.cuda's sync debug
    mode warns at each one, and each warning is charged to the innermost
    open span instead of shown. Other warnings pass through."""

    def __init__(self):
        self._mode = torch.cuda.get_sync_debug_mode()
        self._filters = warnings.catch_warnings()
        self._filters.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        self._show = warnings.showwarning
        warnings.showwarning = self._on_warning
        torch.cuda.set_sync_debug_mode("warn")

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith(_SYNC_WARNING):
            self._show(message, category, filename, lineno, file, line)
            return
        name = _stack[-1] if _stack else None
        _add(name, "host_syncs", 1)
        site = f"{os.path.basename(filename)}:{lineno}"
        sites = _sites.setdefault(name, {})
        sites[site] = sites.get(site, 0) + 1

    def close(self):
        torch.cuda.set_sync_debug_mode(self._mode)
        self._filters.__exit__(None, None, None)
