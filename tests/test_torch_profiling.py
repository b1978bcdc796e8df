"""nerfnav_tpu_torch/utils/profiling.py on the CPU: device_timer fills
out[name] (and passes CPU results through: there is no device to wait for),
trace writes a Chrome trace of the block."""

import json
import os

import torch

from nerfnav_tpu_torch.utils.profiling import device_timer, trace

torch.set_num_threads(1)


def test_device_timer_fills_out(capsys):
    out = {}
    with device_timer("matmul", out) as box:
        x = torch.ones((64, 64))
        box["result"] = {"y": x @ x, "rest": [x.sum(), None]}
    assert out["matmul"] > 0.0
    assert "[timer] matmul:" in capsys.readouterr().out
    with device_timer("nothing registered"):
        pass


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as path:
        torch.ones((32, 32)).matmul(torch.ones((32, 32)))
    assert path == os.path.join(str(tmp_path / "tr"), "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
