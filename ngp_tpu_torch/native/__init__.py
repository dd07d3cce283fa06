"""Host-side C++ helpers, loaded with ctypes (``ngp_tpu/native``).

``marching_cubes`` extracts an iso-surface by marching tetrahedra, the
JAX package's replacement for the reference's ``mcubes``; ``MeshSDF`` is
its BVH signed-distance oracle for a triangle mesh, the replacement for
``pysdf``. The sources are the JAX package's own
``ngp_tpu/native/marching.cpp`` and ``sdf_mesh.cpp`` (plain C++, no
JAX); each is compiled here with the host ``g++`` and the flags of that
directory's Makefile, at first use, into ``ops/kernels/build/`` (ignored
by git), named by a hash of the source and flags. A library is built
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

NATIVE_DIR = Path(__file__).resolve().parents[2] / "ngp_tpu" / "native"
SOURCE = NATIVE_DIR / "marching.cpp"
SDF_SOURCE = NATIVE_DIR / "sdf_mesh.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "kernels" / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-std=c++17", "-Wall")

_lock = threading.Lock()
_libs = {}

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    stem = {SOURCE: "marching", SDF_SOURCE: "sdf"}[source]
    return BUILD_DIR / f"libngp_{stem}_{h.hexdigest()[:16]}.so"


def _build(source: Path) -> ctypes.CDLL:
    """The library of ``source``, compiled on its first use in any process."""
    path = library_path(source)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(source)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed with code {res.returncode}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))


def _load(source: Path = SOURCE) -> ctypes.CDLL:
    with _lock:
        if source in _libs:
            return _libs[source]
        lib = _build(source)
        if source == SOURCE:
            lib.marching_tets.restype = ctypes.c_int
            lib.marching_tets.argtypes = [
                _FP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(_FP), _IP, ctypes.POINTER(_IP), _IP,
            ]
            lib.marching_free.argtypes = [_FP, _IP]
        else:
            lib.sdf_build.restype = ctypes.c_void_p
            lib.sdf_build.argtypes = [_FP, ctypes.c_int, _IP, ctypes.c_int]
            lib.sdf_query.restype = None
            lib.sdf_query.argtypes = [ctypes.c_void_p, _FP, ctypes.c_int, _FP]
            lib.sdf_free.argtypes = [ctypes.c_void_p]
        _libs[source] = lib
        return lib


class MeshSDF:
    """Signed distance to a triangle mesh, positive outside (the
    reference negates ``pysdf``'s positive-inside output): BVH closest
    point and the angle-weighted pseudonormal's sign."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        lib = _load(SDF_SOURCE)
        self._lib = lib
        v = np.ascontiguousarray(vertices, dtype=np.float32)
        f = np.ascontiguousarray(faces, dtype=np.int32)
        if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
            raise ValueError(f"expected vertices [n, 3] and faces [m, 3], got {v.shape} and "
                             f"{f.shape}")
        if len(f) and (f.min() < 0 or f.max() >= len(v)):
            raise ValueError("a face names a vertex outside the mesh")
        self._keepalive = (v, f)
        self._handle = ctypes.c_void_p(
            lib.sdf_build(v.ctypes.data_as(_FP), len(v), f.ctypes.data_as(_IP), len(f)))

    def __call__(self, points: np.ndarray) -> np.ndarray:
        p = np.ascontiguousarray(points, dtype=np.float32)
        if p.ndim != 2 or p.shape[1] != 3:
            raise ValueError(f"expected points [n, 3], got {p.shape}")
        out = np.empty(len(p), dtype=np.float32)
        self._lib.sdf_query(self._handle, p.ctypes.data_as(_FP), len(p),
                            out.ctypes.data_as(_FP))
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.sdf_free(self._handle)
            self._handle = None


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
