"""The program's own spans and counters in a traced window.

nerfnav_tpu_torch.utils.profiling records them while a torch profiler
runs, and in a run of the benchmark only the traced window runs one: its
`counters()` are the window's, and its `ranges()` are the host intervals of
the program's spans ("nerfnav/<name>" in the profiler's trace) on the clock
of the trace's kernels. Each idle instant of the card in the window (the
window less the union of its kernels, the time `device_idle_share` reads)
is charged to the innermost program span open on the host at that instant,
or to None where none is open.

A program without them gives None here, and its readers then read nothing.
"""

import time


def _profiling():
    from nerfnav_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "ranges") else None


def counters():
    """{span: {counter: number}} the program counted, or None without
    program counters."""
    p = _profiling()
    c = p and p.counters()
    return c or None


def window_ns(trace):
    """The traced window on the kernels' clock (Unix time in ns); the trace
    holds its start on time.perf_counter's."""
    w0 = trace.t0 * 1e9 + (time.time_ns() - time.perf_counter_ns())
    return w0, w0 + trace.window_s * 1e9


def program_ranges(trace):
    """The program's spans that overlap the traced window, (name, start_ns,
    end_ns), or None without them."""
    p = _profiling()
    if p is None:
        return None
    w0, w1 = window_ns(trace)
    return [r for r in p.ranges() if r[2] > w0 and r[1] < w1] or None


def timeline(ranges):
    """The innermost open range at each instant: [(start, end, name)], sorted
    and disjoint, where some range is open. Innermost is the range opened
    last among those open (of two opened at once, the shorter)."""
    ranges = [r for r in ranges if r[2] > r[1]]
    events = [(s, 1, -e, i) for i, (_, s, e) in enumerate(ranges)]
    events += [(e, 0, 0, i) for i, (_, s, e) in enumerate(ranges)]
    events.sort()       # at one instant, ends before starts, outer starts first
    out, open_, t_prev = [], [], None
    for t, starts, _, i in events:
        if open_ and t > t_prev:
            out.append((t_prev, t, ranges[open_[-1]][0]))
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
        t_prev = t
    return out


def idle_intervals(trace):
    """The card's idle intervals in the window, [(start_ns, end_ns)]: the
    gaps between the busy intervals, the lead before the first (from the
    window's start) and the rest of the idle time after the last, so that
    they sum to window_s - busy_s."""
    busy = trace.busy_intervals()
    w0, _ = window_ns(trace)
    total = trace.window_s * 1e9 - sum(e - s for s, e in busy)
    if not busy:
        return [(w0, w0 + total)]
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0]
    edge = total - sum(b - a for a, b in gaps)
    lead = min(max(busy[0][0] - w0, 0.0), max(edge, 0.0))
    first, last = busy[0][0], busy[-1][1]
    return [(first - lead, first)] + gaps + [(last, last + edge - lead)]


def idle_by_span(trace, ranges):
    """{span name or None: idle seconds}: each idle instant charged to the
    innermost program range open then (None where none is). Sums to the
    window's idle seconds."""
    segs = timeline(ranges)
    out = {}
    j = 0
    for a, b in idle_intervals(trace):
        covered = 0.0
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + (hi - lo) / 1e9
                covered += hi - lo
            k += 1
        out[None] = out.get(None, 0.0) + (b - a - covered) / 1e9
        while j < len(segs) and segs[j][1] <= b:
            j += 1
    return out


def idle_in(trace, *spans):
    """Idle seconds of the card charged to the named spans (None: to no
    span), or None without kernels or program ranges."""
    ranges = program_ranges(trace)
    if not trace.kernels or ranges is None:
        return None
    by = idle_by_span(trace, ranges)
    return sum(by.get(s, 0.0) for s in spans)


def idle_share(trace, *spans):
    """idle_in as a share of the traced window (%), or None."""
    idle = idle_in(trace, *spans)
    return None if idle is None else 100.0 * idle / trace.window_s
