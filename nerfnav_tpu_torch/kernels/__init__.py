"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exports a plain C interface. It is compiled at first
use by `nvcc` for sm_90a into a shared library under `build_dir("kernels")`,
keyed by a hash of the source and the flags, and loaded with ctypes. Nothing
is built when a module is imported, and a missing source, a missing `nvcc` or
a failed build raises: there is no fallback for a CUDA tensor.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_SIGNATURES = {
    # name -> {C function: argtypes}; every function returns a cudaError_t
    "fused_mlp": {
        "nerfnav_fused_mlp_forward": [
            ctypes.c_void_p,  # x (N, D_in) float32
            ctypes.c_void_p,  # host array of n_layers weight pointers, bf16
            ctypes.c_void_p,  # out (N, D_out) float32
            ctypes.c_int,     # N
            ctypes.c_int,     # n_layers
            ctypes.c_void_p,  # host array of n_layers + 1 widths
            ctypes.c_int,     # hidden activation id
            ctypes.c_int,     # output activation id
            ctypes.c_void_p,  # cudaStream_t
        ],
    },
    "hashgrid": {
        "nerfnav_hashgrid_forward": [
            ctypes.c_void_p,  # x (N, D) float32
            ctypes.c_void_p,  # out (N, L * F) float32
            ctypes.c_int,     # N
            ctypes.c_int,     # D
            ctypes.c_int,     # F
            ctypes.c_int,     # cell layout
            ctypes.c_int,     # bf16 tables
            ctypes.c_int,     # f32 tables rounded to bf16
            ctypes.c_int,     # ngp convention
            ctypes.c_float,   # bound
            ctypes.c_int,     # L
            ctypes.c_int,     # levels per block row
            ctypes.c_void_p,  # host array of L table pointers
            ctypes.c_void_p,  # host array of L float32 position scales
            ctypes.c_void_p,  # host array of 5 L uint32 level parameters
            ctypes.c_void_p,  # cudaStream_t
        ],
        "nerfnav_hashgrid_backward": [
            ctypes.c_void_p,  # x (N, D) float32
            ctypes.c_void_p,  # g (N, L * F) float32
            ctypes.c_int,     # N
            ctypes.c_int,     # D
            ctypes.c_int,     # F
            ctypes.c_int,     # cell layout
            ctypes.c_int,     # ngp convention
            ctypes.c_float,   # bound
            ctypes.c_int,     # L
            ctypes.c_int,     # levels per block row
            ctypes.c_void_p,  # host array of L table-gradient pointers, float32
            ctypes.c_void_p,  # host array of L float32 position scales
            ctypes.c_void_p,  # host array of 5 L uint32 level parameters
            ctypes.c_void_p,  # deterministic route: rows (L, N K) int64, else NULL
            ctypes.c_void_p,  # deterministic route: values (L, N K, W) float32
            ctypes.c_void_p,  # cudaStream_t
        ],
        "nerfnav_hashgrid_dx": [
            ctypes.c_void_p,  # x (N, D) float32
            ctypes.c_void_p,  # g (N, L * F) float32
            ctypes.c_void_p,  # dx (N, D) float32
            ctypes.c_int,     # N
            ctypes.c_int,     # D
            ctypes.c_int,     # F
            ctypes.c_int,     # cell layout
            ctypes.c_int,     # bf16 tables
            ctypes.c_int,     # f32 tables rounded to bf16
            ctypes.c_int,     # ngp convention
            ctypes.c_float,   # bound
            ctypes.c_int,     # L
            ctypes.c_void_p,  # host array of L table pointers
            ctypes.c_void_p,  # host array of L float32 position scales
            ctypes.c_void_p,  # host array of 5 L uint32 level parameters
            ctypes.c_void_p,  # cudaStream_t
        ],
    },
}

_loaded = {}


def build_dir(kind: str) -> Path:
    """The directory the port builds its `kind` libraries into ("kernels"
    here, "native" for the A*).

    From a source checkout (the package's parent holds pyproject.toml and
    can be written): `build/<kind>` at the repository root, which .gitignore
    lists. Otherwise, as for an installed package:
    `$XDG_CACHE_HOME/nerfnav_tpu_torch/<kind>`, or under `~/.cache` when
    XDG_CACHE_HOME is unset."""
    root = _PKG.parent
    if (root / "pyproject.toml").is_file() and os.access(root, os.W_OK):
        return root / "build" / kind
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "nerfnav_tpu_torch" / kind


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir("kernels") / f"{name}-{key}.so"


def _start_build(name: str):
    """Start nvcc for one kernel; returns (Popen or None if built, target)."""
    target = library_path(name)
    if target.exists():
        return None, target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, (target, tmp)


def _finish_build(name: str, proc, paths) -> str:
    target, tmp = paths
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builds race harmlessly
    return out


def build_all() -> dict:
    """Build every kernel with one nvcc each, all started together.
    Returns {name: compiler output} for the kernels built now."""
    started = {n: _start_build(n) for n in _SIGNATURES}
    logs = {}
    for n, (proc, paths) in started.items():
        if proc is not None:
            logs[n] = _finish_build(n, proc, paths)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    proc, paths = _start_build(name)
    if proc is not None:
        _finish_build(name, proc, paths)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib
