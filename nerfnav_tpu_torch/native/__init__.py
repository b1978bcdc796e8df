"""Host-side native code: grid A* (astar.cpp), built with g++ and loaded by ctypes.

The library is compiled at first use into `kernels.build_dir("native")`
(`build/native/` in a source checkout, else the user's cache), keyed by a
hash of the source and the flags, never into the package. A missing source,
a missing compiler or a failed build raises; there is no Python fallback here
(nav/astar.py keeps the Python search as the tests' golden).
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from nerfnav_tpu_torch.kernels import build_dir

_DIR = Path(__file__).resolve().parent
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None


def library_path() -> Path:
    src = (_DIR / "astar.cpp").read_bytes()
    key = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir("native") / f"astar-{key}.so"


def _load():
    global _lib
    if _lib is not None:
        return _lib
    target = library_path()
    if not target.exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_DIR / "astar.cpp")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for astar.cpp:\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: concurrent builds race harmlessly
    lib = ctypes.CDLL(str(target))
    lib.astar3d.restype = ctypes.c_int
    lib.astar3d.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    _lib = lib
    return lib


def astar_native(occupied, start, goal):
    """(H, W, D) bool occupancy, start/goal index triples -> list of index
    triples (inclusive path) or None when unreachable; raises ValueError on an
    occupied or out-of-grid endpoint."""
    occ = np.ascontiguousarray(np.asarray(occupied, np.uint8))
    if occ.ndim != 3:
        raise ValueError(f"occupancy must be 3-D, got shape {occ.shape}")
    nx, ny, nz = occ.shape
    for p in (start, goal):
        if not all(0 <= int(c) < s for c, s in zip(p, occ.shape)):
            raise ValueError(f"A* endpoint {tuple(p)} outside the grid {occ.shape}")
    lib = _load()
    max_len = nx * ny * nz
    out = np.zeros(max_len, np.int32)
    res = lib.astar3d(
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nx, ny, nz,
        int(start[0]), int(start[1]), int(start[2]),
        int(goal[0]), int(goal[1]), int(goal[2]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_len,
    )
    if res == -2:
        raise ValueError("A* start or goal cell is occupied")
    if res < 0:
        return None
    return [(int(i // (ny * nz)), int((i // nz) % ny), int(i % nz)) for i in out[:res]]
