"""Host-side C++ helpers, loaded with ctypes (``ngp_tpu/native``).

``marching_cubes`` extracts an iso-surface by marching tetrahedra, the
JAX package's replacement for the reference's ``mcubes``. The source is
the JAX package's own ``ngp_tpu/native/marching.cpp`` (plain C++, no
JAX); it is compiled here with the host ``g++`` and the flags of that
directory's Makefile, at first use, into ``ops/kernels/build/`` (ignored
by git), named by a hash of the source and flags. The library is built
into a temporary file and renamed into place, so processes that build
at once do not see each other's half-written file. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "ngp_tpu" / "native" / "marching.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "kernels" / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib = None

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libngp_marching_{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed with code {res.returncode}:\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.marching_tets.restype = ctypes.c_int
        lib.marching_tets.argtypes = [
            _FP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(_FP), _IP, ctypes.POINTER(_IP), _IP,
        ]
        lib.marching_free.argtypes = [_FP, _IP]
        _lib = lib
        return lib


def marching_cubes(grid: np.ndarray, iso: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a dense [nx, ny, nz] scalar field: (vertices [n, 3]
    f32 in grid-index coordinates, faces [m, 3] i32). Marching
    tetrahedra: watertight, no case tables."""
    g = np.ascontiguousarray(grid, dtype=np.float32)
    nx, ny, nz = g.shape
    lib = _load()
    vp, tp = _FP(), _IP()
    nv, nt = ctypes.c_int(), ctypes.c_int()
    ret = lib.marching_tets(g.ctypes.data_as(_FP), nx, ny, nz, ctypes.c_float(iso),
                            ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp),
                            ctypes.byref(nt))
    if ret != 0:
        raise RuntimeError("marching_tets failed")
    try:
        if nv.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy()
        return verts, faces
    finally:
        lib.marching_free(vp, tp)
