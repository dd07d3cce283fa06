"""Build the kernel library from ``csrc/*.cu`` and load it with ctypes.

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` builds them in seconds: one ``nvcc -c`` per ``.cu`` source, all
started together, then one link. The library goes into ``build/`` beside
this file (ignored by git), named by a hash of the sources, the headers
they share (``.cuh``) and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is built or loaded until the first kernel launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

CSRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "ngp_cp_density_fwd": [
        _P, _I, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I, _I,
        _P, _P, _I, _I, _I, _I, _P, _P, _P, ctypes.POINTER(_I), _P,
    ],
    "ngp_cp_bwd_banks": [
        _P, _I, _P, _I, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I, _I, _P, _P,
    ],
    "ngp_cp_sigma_rgb": [
        _P, _P, _I, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I, _I,
        _P, _P, _I, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I,
        _I, _P, ctypes.POINTER(_I), _P,
    ],
    "ngp_coarse_lookup_bits": [_P, _I, _P, ctypes.c_longlong, _P, _P],
    "ngp_cp_encode_fwd": [
        _P, _I, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _I, _I, _I, _P, _P,
    ],
    "ngp_fused_mlp": [_P, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P,
                      ctypes.POINTER(_I), _P],
    "ngp_march_turbo": [
        _P, _P, ctypes.POINTER(_L), _I, ctypes.POINTER(_F), _P, _P, _P, _P, _I, _P, _I, _I,
        _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _I, _F, _F,
        _P, _P, _P, _P, _P, _P, _P, _P,
    ],
    "ngp_ray_prepass": [
        _P, _P, ctypes.POINTER(_L), _I, ctypes.POINTER(_F), _P, _P, _I,
        _F, _F, _I, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P, _P,
    ],
    "ngp_grid_encode_fwd": [
        _P, _L, _I, _P, _I, _I, _I, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(_I),
        ctypes.POINTER(_U), ctypes.POINTER(_U), ctypes.POINTER(_I), ctypes.c_float, _I,
        _P, _I, _P,
    ],
    "ngp_grid_encode_bwd": [
        _P, _L, _I, _P, _I, _I, _I, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(_I),
        ctypes.POINTER(_U), ctypes.POINTER(_U), ctypes.POINTER(_I), ctypes.c_float, _I,
        _P, _P,
    ],
    "ngp_grid_encode_bwd_x": [
        _P, _L, _I, _P, _I, _P, _I, _I, _I, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(_I), ctypes.POINTER(_U), ctypes.POINTER(_U), ctypes.POINTER(_I),
        ctypes.c_float, _I, _P, _P,
    ],
    "ngp_scatter_add_rows": [_P, _P, _L, _I, _I, _P, _P],
    "ngp_scatter_add_taps": [_P, _I, _L, _P, _L, _P, _L, _I, _I, _I, _P, _P],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libngp_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the kernels need nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Tuple[Path, str]:
    """Compile the library if it is not built yet.

    Returns (path, compiler report); the report holds ``ptxas -v``'s
    registers, shared memory and spills of each kernel, and is kept
    beside the library for later calls. Raises when nvcc fails.
    """
    path = library_path()
    report = path.with_suffix(".ptxas.txt")
    if path.exists():
        return path, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(_sources(), objs)
    ]
    outs = [p.communicate()[0] for p in procs]
    try:
        for src, p, out in zip(_sources(), procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} with code {p.returncode}:\n{out}")
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {res.returncode}:\n"
                               f"{res.stdout}{res.stderr}")
        report.write_text("".join(outs))
        os.replace(tmp, path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return path, "".join(outs)


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def pointer_array(tensors):
    """ctypes array of the device pointers of ``tensors``."""
    return (_P * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values):
    return (_I * len(values))(*[int(v) for v in values])


# what a launcher returns for a shape its kernel does not take (cudaError
# codes are >= 0)
UNSUPPORTED_SHAPE = -1


def check_launch(name: str, err: int) -> None:
    """Raise ValueError for a shape the kernel does not take, and
    RuntimeError for any other failed launch."""
    if err == UNSUPPORTED_SHAPE:
        raise ValueError(f"{name}: the kernel does not take this shape (it would need more "
                         "shared memory than a block has)")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
