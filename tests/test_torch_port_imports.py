"""The port imports no JAX and nothing of the JAX package.

Checked on the source with `ast`: the test process has JAX imported already,
so sys.modules proves nothing."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "nerfnav_tpu")
PORT_FILES = sorted((ROOT / "nerfnav_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    mods = list(_imported_modules(ast.parse(path.read_text(), str(path))))
    bad = [m for m in mods if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


NAV_MODULES = ["nav/math_utils.py", "nav/dynamics.py", "nav/astar.py", "nav/planner.py",
               "nav/estimator.py", "nav/fused.py", "nav/agent.py", "native/__init__.py",
               "cli/flags.py", "cli/simulate.py", "data/synthetic.py", "data/provider.py",
               "cli/main_nerf.py", "training/trainer.py", "training/metrics.py",
               "ops/marching.py", "models/renderer.py", "utils/mesh.py",
               "parallel/__init__.py", "parallel/sharding.py", "models/occupancy.py",
               "training/__init__.py", "training/clip_tower.py", "training/lpips_net.py",
               "utils/profiling.py"]
# optional host libraries: imported by the functions that use them only
LAZY = ("cv2", "scipy", "tensorboardX", "lpips")


@pytest.mark.parametrize("rel", NAV_MODULES)
def test_nav_and_cli_modules_are_checked(rel):
    """The nav stack, the dataset, the CLIs and the trainer are among the
    checked files, and import cv2, scipy and tensorboardX only inside the
    functions that use them: the card's machine may lack one."""
    path = ROOT / "nerfnav_tpu_torch" / rel
    assert path in PORT_FILES
    tree = ast.parse(path.read_text(), str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    mods = list(_imported_modules(ast.Module(body=top, type_ignores=[])))
    assert not [m for m in mods if m.split(".")[0] in LAZY]


def test_checker_catches_forbidden_names():
    src = ("import jax.numpy as jnp\nfrom nerfnav_tpu.ops import marching\n"
           "import nerfnav_tpu_torch\nimport importlib\n"
           "importlib.import_module('jaxlib')\n")
    found = [m for m in _imported_modules(ast.parse(src)) if _forbidden(m)]
    assert found == ["jax.numpy", "nerfnav_tpu.ops", "jaxlib"]
