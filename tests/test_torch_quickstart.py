"""The port's user entry points: examples/quickstart_torch.py on the CPU at
tiny sizes, its refusal to run on a missing card, and the
scripts/run_*_torch.sh commands against their JAX twins."""

import importlib.util
import re
import shlex
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("val PSNR after", "wrote 2 frames + video under", "planner: loss",
          "trajectory JSON artifacts", "fused-MLP kernel launches", "done.")

torch.set_num_threads(1)


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_the_cpu(tmp_path, capsys):
    """All five stages at --steps 6 --hw 16 (a 10-epoch plan): each prints its
    line and writes its artifacts."""
    out = _quickstart().main(["--device", "cpu", "--steps", "6", "--hw", "16",
                              "--plan_epochs", "10", "--out", str(tmp_path)])
    text = capsys.readouterr().out
    for line in STAGES:
        assert f"[quickstart] {line}" in text, line
    assert len(list((tmp_path / "scene").glob("train_*.png"))) == 8
    assert len(list((tmp_path / "scene").glob("val_*.png"))) == 2
    ws = tmp_path / "ws"
    assert list((ws / "checkpoints").glob("quickstart_ep*.npz"))
    assert len(list((ws / "validation").glob("quickstart_ep0003_*.png"))) == 2
    for i in range(2):
        assert (ws / "results" / f"orbit_{i:04d}.png").exists()
        assert (ws / "results" / f"orbit_{i:04d}_depth.png").exists()
    assert list((tmp_path / "plan" / "init_poses" / "demo").glob("*.json"))
    assert out["frames"] == 2 and out["psnr"] == out["psnr"]  # finite, not NaN
    assert len(out["losses"]) == 10
    assert set(out["seconds"]) == {"scene", "train", "evaluate", "render", "plan"}
    # the plain version runs on the CPU: the kernel never launches
    assert sum(out["launches"].values()) == 0


def test_quickstart_on_a_missing_card_raises(monkeypatch, tmp_path):
    """--device cuda (the default) without a card raises before any stage
    and never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _quickstart().main(["--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def _command(script):
    """The python command of a run script, continuation lines joined."""
    text = (ROOT / "scripts" / script).read_text().replace("\\\n", " ")
    (line,) = [ln for ln in text.splitlines() if ln.startswith("python ")]
    return shlex.split(line)


@pytest.mark.parametrize("name", ["run_nerf", "run_sim", "run_gui_nerf"])
def test_run_scripts_mirror_the_jax_ones(name):
    """Each scripts/<name>_torch.sh runs the port's CLI with its JAX twin's
    flags and defaults, and the port's parser takes them."""
    from nerfnav_tpu_torch.cli.flags import build_parser
    from nerfnav_tpu_torch.cli.simulate import build_sim_parser

    jax_cmd, port_cmd = _command(f"{name}.sh"), _command(f"{name}_torch.sh")
    module = jax_cmd[2].replace("nerfnav_tpu.", "nerfnav_tpu_torch.")
    assert port_cmd[:3] == ["python", "-m", module]
    assert port_cmd[3:] == jax_cmd[3:]
    jax_text = (ROOT / "scripts" / f"{name}.sh").read_text()
    port_text = (ROOT / "scripts" / f"{name}_torch.sh").read_text()
    assert re.findall(r"^\w+=.*$", port_text, re.M) == re.findall(r"^\w+=.*$", jax_text, re.M)
    parser = build_sim_parser() if port_cmd[2].endswith("simulate") else build_parser("")
    parser.parse_args(["scene" if a == "$DATA" else a for a in port_cmd[3:]])
