"""A cell on the card at tiny sizes: the kernels build, the trace reads
device time and the run is correct. Skips without a CUDA card."""

import pytest
import torch

from perfbench import run


@pytest.mark.card
@pytest.mark.parametrize("cell", ["ngp-train-grid", "ngp-train-dense"])
def test_a_traced_cell_on_the_card(cell, tiny):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the run needs one")
    args = run.parse(["--workload", cell, "--seed", "2147483998", "--seconds", "2",
                      "--trace", "1"])
    res, _, _ = run.execute(args, device=torch.device("cuda", 0),
                            bench=run.load_json(run.ROOT / "BENCHMARK.json"),
                            overrides=tiny[cell])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert res["device"]["busy_s"] <= res["device"]["window_s"]
