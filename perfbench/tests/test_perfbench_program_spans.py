"""The program's spans and counters in a traced window
(perfbench/program_spans.py and its readers): the card's idle time split by
the innermost program span against hand counts on synthetic traces, the
readers' arithmetic, nothing read from a program without spans, and the
harness's own spans and gaps untouched by the program's."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import program_spans, run
from perfbench.trace import Spans, Trace, traced

# busy [0, 20], [30, 40], [60, 70] us; idle [20, 30], [40, 60], [70, 100]
KERNELS = [("k_a", 0, 10_000), ("k_b", 5_000, 20_000), ("k_a", 30_000, 40_000),
           ("Memcpy HtoD", 60_000, 70_000)]
RANGES = [("render.march", 25_000, 45_000), ("train.backward", 50_000, 55_000),
          ("train.step", 15_000, 65_000), ("occupancy.query", 82_000, 85_000),
          ("train.sweep", 80_000, 90_000)]
# by hand: [20, 30] step 5 march 5; [40, 60] march 5 step 5 backward 5 step 5;
# [70, 100] none 10 sweep 2 query 3 sweep 5 none 10
BY_HAND = {"train.step": 15e-6, "render.march": 10e-6, "train.backward": 5e-6,
           "train.sweep": 7e-6, "occupancy.query": 3e-6, None: 20e-6}


def _program(ranges=RANGES, counters=None):
    return SimpleNamespace(ranges=lambda: list(ranges), counters=lambda: dict(counters or {}))


@pytest.fixture
def window(monkeypatch):
    """A trace whose window is [start, 100] us on the kernels' clock, and a
    program with RANGES."""
    def make(start_ns=0, program=_program()):
        tr = Trace(window_s=(100_000 - start_ns) / 1e9, kernels=list(KERNELS))
        monkeypatch.setattr(program_spans, "window_ns", lambda t: (start_ns, 100_000))
        monkeypatch.setattr(program_spans, "_profiling", lambda: program)
        return tr
    return make


def _idle(tr):
    return tr.window_s - tr.busy_s


def test_idle_time_splits_by_the_innermost_range(window):
    tr = window()
    by = program_spans.idle_by_span(tr, RANGES)
    assert by == pytest.approx(BY_HAND)
    assert sum(by.values()) == pytest.approx(_idle(tr))
    # a gap that crosses two ranges is split between them: [40, 60] us
    # gives render.march its last 5 and train.step and train.backward theirs
    assert program_spans.idle_in(tr, "render.march") == pytest.approx(10e-6)
    assert program_spans.idle_in(tr, None) == pytest.approx(20e-6)


def test_idle_before_the_first_kernel_is_charged_too(window):
    tr = window(start_ns=-10_000)
    by = program_spans.idle_by_span(tr, RANGES)
    assert by == pytest.approx({**BY_HAND, None: 30e-6})
    assert sum(by.values()) == pytest.approx(_idle(tr))
    names = [n for n, _, _ in RANGES] + [None]
    assert program_spans.idle_in(tr, *names) == pytest.approx(_idle(tr))


def test_the_timeline_is_the_innermost_open_range():
    assert program_spans.timeline(RANGES) == [
        (15_000, 25_000, "train.step"), (25_000, 45_000, "render.march"),
        (45_000, 50_000, "train.step"), (50_000, 55_000, "train.backward"),
        (55_000, 65_000, "train.step"), (80_000, 82_000, "train.sweep"),
        (82_000, 85_000, "occupancy.query"), (85_000, 90_000, "train.sweep")]
    # opened at one instant: the shorter is inside; closed ones drop out
    assert program_spans.timeline([("a", 0, 10), ("b", 0, 4), ("c", 4, 4)]) == [
        (0, 4, "b"), (4, 10, "a")]


def test_readers_match_hand_counts(window):
    counters = {"train.step": {"calls": 2, "host_syncs": 3},
                "train.sweep": {"calls": 1, "host_syncs": 5},
                "render.shade": {"calls": 2, "host_syncs": 0, "valid_samples": 90,
                                 "shaded_slots": 80, "filled_slots": 60}}
    tr = window(program=_program(counters=counters))
    tr.counters = {"steps": 2}
    ctx = run.Ctx(name="x", config={}, traffic={}, seed=0, device=None, spans=Spans(),
                  trace=True)

    def read(name):
        return run.load_module(run.reader_path(name), name).read(tr, ctx)

    assert read("grid.idle_in_march") == pytest.approx(10.0)
    assert read("grid.idle_in_shade") == 0.0
    assert read("grid.idle_in_composite") == 0.0
    assert read("grid.idle_in_backward") == pytest.approx(5.0)
    assert read("grid.idle_in_apply") == 0.0
    assert read("grid.idle_in_sweep") == pytest.approx(10.0)
    assert read("grid.host_syncs_per_step") == 4.0
    assert read("dense.host_syncs_per_step") == 4.0
    assert read("grid.shade_slot_use") == pytest.approx(75.0)
    # idle in every span and in none is the idle share's whole
    names = [n for n, _, _ in RANGES] + [None]
    assert program_spans.idle_share(tr, *names) == pytest.approx(
        read("grid.device_idle_share"))


@pytest.mark.parametrize("name", ["grid.idle_in_march", "grid.idle_in_sweep",
                                  "grid.host_syncs_per_step", "grid.shade_slot_use"])
def test_without_program_spans_a_reader_reads_nothing(window, name):
    tr = window(program=None)
    tr.counters = {"steps": 2}
    ctx = run.Ctx(name="x", config={}, traffic={}, seed=0, device=None, spans=Spans(),
                  trace=True)
    assert run.load_module(run.reader_path(name), name).read(tr, ctx) is None


def test_without_kernels_the_idle_readers_read_nothing(window):
    tr = window()
    tr.kernels = []
    assert program_spans.idle_share(tr, "render.march") is None


def test_the_harness_spans_and_gaps_ignore_the_programs():
    """A traced window on the CPU: the trace's ranges hold the harness's
    spans alone, and the program's spans come from the program."""
    from nerfnav_tpu_torch.utils import profiling

    spans = Spans()
    with traced(spans, torch.device("cpu")) as tr:
        with spans("step"), profiling.span("train.step"):
            with profiling.span("render.march"):
                torch.ones(64).sum()
    assert {n for n, _, _ in tr.ranges} == {"step"}
    assert tr.idle_gaps() == []
    got = program_spans.program_ranges(tr)
    assert [n for n, _, _ in got] == ["render.march", "train.step"]
    (_, s, e), = tr.ranges
    assert all(s - 1_000_000 <= ps <= pe <= e + 1_000_000 for _, ps, pe in got)
