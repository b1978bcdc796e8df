"""BENCHMARK.json against the files the harness finds by name, the import
rules, and a cell added by new files alone."""

import ast
import json
from pathlib import Path
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_resolves_to_its_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and NAME.match(c["name"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        entry, config, traffic = run.cell_spec(BENCH, w["name"])
        assert entry is w and config["name"] == w["config"]
        assert (run.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
        e2e, per_layer = run.metrics_of(BENCH, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        for m in per_layer:
            assert m["moves"] in names
            assert run.reader_path(m["name"]).is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_a_metric_is_read_by_its_own_file_or_by_its_name_after_the_cell(tmp_path,
                                                                        monkeypatch):
    monkeypatch.setattr(run, "HERE", tmp_path)
    (tmp_path / "layer_metrics").mkdir()
    (tmp_path / "layer_metrics" / "mfu.py").write_text("")
    assert run.reader_path("grid.mfu") == tmp_path / "layer_metrics" / "mfu.py"
    (tmp_path / "layer_metrics" / "grid.mfu.py").write_text("")
    assert run.reader_path("grid.mfu") == tmp_path / "layer_metrics" / "grid.mfu.py"
    assert run.reader_path("mfu") == tmp_path / "layer_metrics" / "mfu.py"


def _imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    files = sorted(run.HERE.rglob("*.py"))
    assert files
    for f in files:
        found = _imports(f) & {"jax", "jaxlib", "flax", "nerfnav_tpu"}
        assert not found, (f, found)
    for f in sorted((run.HERE / "reference").rglob("*.py")):
        assert "nerfnav_tpu_torch" not in _imports(f), f
    # top-level names are compared whole: the port's name begins with the
    # JAX package's
    sys.modules.setdefault("nerfnav_tpu_torch_probe", object())
    assert "nerfnav_tpu_torch_probe" not in run.forbidden_modules()


DUMMY_DRIVER = '''
import time
import torch
from perfbench.run import Check, Window


class Cell:
    def __init__(self, ctx):
        self.ctx, self.calls = ctx, 0

    def window(self, seconds, traced):
        t0 = time.perf_counter()
        trace = None
        while time.perf_counter() - t0 < seconds:
            if traced and trace is None:
                with traced() as trace:
                    torch.ones(8).sum()
                trace.counters = {"calls": 1}
            self.calls += 1
        return Window(metrics={"dummy_calls_per_s": self.calls / seconds},
                      attempted=self.calls, failed=0, trace=trace)

    def release(self):
        pass

    def check(self):
        return [Check("calls", 0.0 if self.calls else 1.0, self.ctx.traffic["limit"])]
'''


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_added_by_new_files_alone(tmp_path, trace):
    ignore = shutil.ignore_patterns("__pycache__", "tests")
    shutil.copytree(run.HERE, tmp_path / "perfbench", ignore=ignore)
    shutil.copytree(ROOT / "nerfnav_tpu_torch", tmp_path / "nerfnav_tpu_torch", ignore=ignore)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "perfbench/configs/dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.count", "config": "dummy", "traffic": "count",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_calls_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy.count"]})
    bench["per_layer"].append({"name": "dummy.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": "dummy_calls_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "perfbench"
    (pb / "configs" / "dummy.json").write_text(json.dumps({"name": "dummy", "reduced": []}))
    (pb / "traffic" / "count.json").write_text(json.dumps({"driver": "count", "limit": 0.0}))
    (pb / "drivers" / "count.py").write_text(DUMMY_DRIVER)
    (pb / "layer_metrics" / "dummy.calls.py").write_text(
        "def read(trace, ctx):\n    return trace.counters['calls']\n")
    code = ("import json, torch\nfrom perfbench import run\n"
            f"args = run.parse(['--workload', 'dummy.count', '--seed', '3000000001', "
            f"'--seconds', '0.2', '--trace', '{trace}'])\n"
            "print(json.dumps(run.execute(args, device=torch.device('cpu'))[0]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0
    want = {"dummy.calls"} if trace else {"dummy_calls_per_s", "setup_s"}
    assert set(res["metrics"]) == want


def test_the_cli_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "ngp-train-grid",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout == ""


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copytree(run.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import torch, sys\nsys.path = [p for p in sys.path if 'repo' not in p]\n"
            "from perfbench import run\n"
            "run.execute(run.parse(['--workload', 'ngp-train-dense', '--seed', '1', "
            "'--seconds', '0.1']), device=torch.device('cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "HOME": str(tmp_path)})
    assert out.returncode != 0 and "nerfnav_tpu_torch" in out.stderr
