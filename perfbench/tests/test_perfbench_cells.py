"""Each cell end to end on the CPU at tiny sizes (the driver, the program
and the reference), the result's keys, and the correctness check against a
broken timed path and against the control."""

import argparse

import pytest
import torch

from perfbench import calibrate, run
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")

CPU = torch.device("cpu")
CELLS = ["ngp-train-grid", "ngp-train-dense"]
# the faults each cell can have (step 3 of the correctness rules): a step
# that leaves its state unchanged and half of a batch left out for the
# training cells
FAULTS = [("ngp-train-grid", "unchanged_state"), ("ngp-train-grid", "half_batch"),
          ("ngp-train-dense", "unchanged_state"), ("ngp-train-dense", "half_batch")]


def _args(cell, trace=0, seconds=2.0):
    return run.parse(["--workload", cell, "--seed", "2147483999", "--seconds", str(seconds),
                      "--trace", str(trace)])


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_reports_its_metrics(cell, tiny):
    res, checks, _ = run.execute(_args(cell), device=CPU, bench=BENCH, overrides=tiny[cell])
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e, _ = run.metrics_of(BENCH, cell)
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {c.name for c in checks} == set(res["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_per_layer_metrics(cell, tiny):
    res, _, _ = run.execute(_args(cell, trace=1), device=CPU, bench=BENCH, overrides=tiny[cell])
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    _, per_layer = run.metrics_of(BENCH, cell)
    # on the CPU only the spans' and the program's own counters read
    host = {m["name"] for m in per_layer if m["source"] in ("program_span", "program_counter")}
    assert set(res["metrics"]) == host


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny):
    undo = calibrate.FAULTS[fault]()
    try:
        res, checks, _ = run.execute(_args(cell), device=CPU, bench=BENCH, overrides=tiny[cell])
    finally:
        undo()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, tiny):
    """The reference one precision below the configuration's, in the
    program's place, fails a compared number."""
    _, config, traffic = run.cell_spec(BENCH, cell)
    readings = calibrate.one(argparse.Namespace(workload=cell, seconds=2.0), 2147483001, CPU,
                             BENCH, "control", tiny[cell])
    limits = {**traffic, **tiny[cell]["traffic"]}["limits"]
    assert any(readings[k] > limits[k] for k in readings), readings
