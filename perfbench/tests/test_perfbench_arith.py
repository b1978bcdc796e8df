"""The yardstick's arithmetic: operations and bytes against hand counts, and
the trace reductions on synthetic event lists."""

import pytest

from perfbench import roofline, run
from perfbench.trace import Spans, Trace

C = {"sigma_net": [32, 64, 16], "color_net": [31, 64, 64, 3]}


def test_mlp_counts_by_hand():
    # sigma: 32*64 + 64*16 = 3072 products a row; colour: 31*64 + 64*64 + 64*3 = 6272
    assert roofline.mlp_flops(10, C["sigma_net"]) == 2 * 10 * 3072
    assert roofline.mlp_flops(10, C["color_net"]) == 2 * 10 * 6272
    # f32 rows in and out, bf16 weights
    assert roofline.mlp_bytes(10, C["sigma_net"]) == 10 * (32 + 16) * 4 + 3072 * 2
    assert roofline.field_flops(5, C, backward=True) == 3 * 2 * 5 * (3072 + 6272)
    assert roofline.field_flops(5, C, backward=False) == 2 * 5 * (3072 + 6272)
    assert roofline.sweep_flops(7, C) == 2 * 7 * 3072


def test_bound_is_the_larger_of_bytes_and_operations():
    n = 2**20
    t_bytes = roofline.mlp_bytes(n, C["sigma_net"]) / 3.35e12
    t_ops = roofline.mlp_flops(n, C["sigma_net"]) / 989e12
    assert roofline.mlp_bound_s(n, C["sigma_net"]) == pytest.approx(max(t_bytes, t_ops))
    assert t_bytes > t_ops  # these widths are bound by bytes
    assert roofline.mlp_bound_s(0, C["sigma_net"]) == 0.0


def test_step_and_sweep_work():
    counters = {"samples": [100, 50], "sweep_points": [5], "sweep_chunk": 2}
    flops, bound = roofline.flops_and_bound(counters, C)
    assert flops == roofline.field_flops(150, C, True) + roofline.sweep_flops(5, C)
    # the sweep runs in calls of 2, 2 and 1 points; each call reads its weights
    want = sum(roofline.mlp_bound_s(k, C["sigma_net"]) + roofline.mlp_bound_s(k, C["color_net"])
               for k in (100, 50))
    want += 2 * roofline.mlp_bound_s(2, C["sigma_net"]) + roofline.mlp_bound_s(1, C["sigma_net"])
    assert bound == pytest.approx(want)


def _trace():
    tr = Trace(window_s=1e-6 * 100)
    # kernels (ns): [0, 10], [5, 20] overlap; [30, 40]; a copy [60, 70]
    tr.kernels = [("k_a", 0, 10_000), ("k_b", 5_000, 20_000), ("k_a", 30_000, 40_000),
                  ("Memcpy HtoD", 60_000, 70_000)]
    tr.ranges = [("step", 0, 50_000), ("sweep", 45_000, 80_000)]
    return tr


def test_busy_union_idle_gaps_and_counts():
    tr = _trace()
    assert tr.busy_intervals() == [[0, 20_000], [30_000, 40_000], [60_000, 70_000]]
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.n_kernels() == 3
    assert tr.device_seconds("k_a") == pytest.approx(20e-6)
    # the gap after 40 us opens inside "step" (the innermost span open then)
    assert tr.idle_gaps() == [["step", pytest.approx(20e-6)], ["step", pytest.approx(10e-6)]]
    assert tr.top_ops()[0] == ["k_a", pytest.approx(20e-6)]


def test_readers_on_a_synthetic_trace():
    tr = _trace()
    tr.counters = {"steps": 2, "samples": [10, 10], "sweep_points": [], "sweep_chunk": 1,
                   "t0": 0.0, "t1": 1.0}
    spans = Spans()
    spans.items = [("sweep", 0.5, 0.50003), ("step", 0.2, 0.3)]
    ctx = run.Ctx(name="x", config=C, traffic={}, seed=0, device=None, spans=spans,
                  trace=True)

    def read(name):
        return run.load_module(run.reader_path(name), name).read(tr, ctx)

    assert read("grid.device_idle_share") == pytest.approx(60.0)
    assert read("grid.kernels_per_step") == 1.5
    assert read("grid.sweep_share") == pytest.approx(100 * 30e-6 / 100e-6)
    assert read("dense.fused_mlp_roofline") is None        # no fused_mlp_kernel
    flops = roofline.field_flops(20, C, True)
    assert read("dense.mfu") == pytest.approx(100 * flops / 100e-6 / 989e12)
    tr.kernels = []
    assert read("grid.device_idle_share") is None and read("dense.mfu") is None
