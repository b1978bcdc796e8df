"""nerfnav_tpu_torch as an installed package: the wheel carries the kernel
and A* sources, and the build directory follows the rule of
`kernels.build_dir` (build/ in a source checkout, the user's cache
otherwise). A missing source and a failed build raise."""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from nerfnav_tpu_torch import kernels, native
from nerfnav_tpu_torch.nav.astar import astar

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("nerfnav_tpu_torch/csrc/fused_mlp.cu", "nerfnav_tpu_torch/native/astar.cpp")


def test_checkout_builds_under_build():
    assert kernels.build_dir("kernels") == ROOT / "build" / "kernels"
    assert kernels.library_path("fused_mlp").parent == ROOT / "build" / "kernels"
    assert native.library_path().parent == ROOT / "build" / "native"


@pytest.mark.parametrize("xdg", [True, False], ids=["XDG_CACHE_HOME", "home"])
def test_read_only_parent_builds_in_the_cache(monkeypatch, tmp_path, xdg):
    """A package whose parent cannot be written (an install in a system
    site-packages) builds under $XDG_CACHE_HOME, else ~/.cache."""
    writable = os.access
    monkeypatch.setattr(os, "access", lambda p, mode, **kw: (
        False if Path(p) == ROOT and mode & os.W_OK else writable(p, mode, **kw)))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        cache = tmp_path / "xdg" / "nerfnav_tpu_torch"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        cache = tmp_path / "home" / ".cache" / "nerfnav_tpu_torch"
    assert kernels.build_dir("kernels") == cache / "kernels"
    assert kernels.library_path("fused_mlp").parent == cache / "kernels"
    # the native A* builds there and runs: one g++ of astar.cpp
    monkeypatch.setattr(native, "_lib", None)
    occ = np.zeros((6, 6, 6), bool)
    occ[2:4, :5, :] = True
    path = native.astar_native(occ, (0, 0, 0), (5, 0, 5))
    assert native.library_path().parent == cache / "native"
    assert native.library_path().exists()
    assert path == astar(occ, (0, 0, 0), (5, 0, 5))


def test_package_without_pyproject_builds_in_the_cache(monkeypatch, tmp_path):
    """A package under a writable site-packages, with no pyproject.toml
    beside it, builds in the cache too, not beside the package."""
    monkeypatch.setattr(kernels, "_PKG", tmp_path / "site-packages" / "nerfnav_tpu_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert kernels.build_dir("native") == tmp_path / "xdg" / "nerfnav_tpu_torch" / "native"


def test_missing_sources_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    monkeypatch.setitem(kernels._loaded, "fused_mlp", None)
    with pytest.raises(FileNotFoundError, match="fused_mlp.cu"):
        kernels.load("fused_mlp")
    monkeypatch.setattr(native, "_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(FileNotFoundError, match="astar.cpp"):
        native.astar_native(np.zeros((2, 2, 2), bool), (0, 0, 0), (1, 1, 1))


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A source g++ refuses raises; there is no Python fallback."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "astar.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_DIR", src)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(kernels, "_PKG", tmp_path / "pkg" / "nerfnav_tpu_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.astar_native(np.zeros((2, 2, 2), bool), (0, 0, 0), (1, 1, 1))
    assert not native.library_path().exists()


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """`pip wheel` of the project, offline (no index, no build isolation,
    no dependencies), on a copy of its packaging file and packages."""
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    skip = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so")
    for name in ("nerfnav_tpu", "nerfnav_tpu_torch"):
        shutil.copytree(ROOT / name, src / name, ignore=skip)
    shutil.copy(ROOT / "pyproject.toml", src)
    out = tmp / "wheels"
    subprocess.run([sys.executable, "-m", "pip", "wheel", ".", "--no-build-isolation",
                    "--no-deps", "--no-index", "-q", "-w", str(out)],
                   cwd=src, check=True, capture_output=True, timeout=120)
    (path,) = out.glob("nerfnav_tpu-*.whl")
    return path


def test_wheel_carries_the_sources(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        for rel in SOURCES:
            assert rel in names, f"{rel} is not in {wheel.name}"
            assert z.read(rel) == (ROOT / rel).read_bytes()


def test_installed_wheel_builds_astar_in_the_cache(wheel, tmp_path):
    """The wheel installed into a bare directory, imported from there: the
    A* builds from the installed astar.cpp into $XDG_CACHE_HOME and runs."""
    site = tmp_path / "site"
    subprocess.run([sys.executable, "-m", "pip", "install", "--no-index", "--no-deps",
                    "-q", "--target", str(site), str(wheel)],
                   check=True, capture_output=True, timeout=120)
    code = ("import numpy as np\n"
            "from nerfnav_tpu_torch import kernels, native\n"
            "print(native.__file__)\n"
            "print(native.astar_native(np.zeros((3, 3, 3), bool), (0, 0, 0), (2, 2, 2)))\n"
            "print(native.library_path())\n")
    env = {**os.environ, "PYTHONPATH": str(site), "XDG_CACHE_HOME": str(tmp_path / "xdg")}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout.splitlines()
    assert out[0].startswith(str(site))
    assert out[1] == str(astar(np.zeros((3, 3, 3), bool), (0, 0, 0), (2, 2, 2)))
    lib = Path(out[2])
    assert lib.parent == tmp_path / "xdg" / "nerfnav_tpu_torch" / "native" and lib.exists()
    assert not (site / "build").exists()
