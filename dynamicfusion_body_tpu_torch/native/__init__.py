"""ctypes bindings of the native I/O runtime (``native/dfio.cc``) — the
counterpart of ``dynamicfusion_body_tpu/native/__init__.py``.

The library is built at first use with ``g++ -O2 -shared -fPIC
-std=c++17`` and loaded as the kernels are (``ops/cuda_lib.py``: a name
hashed from the source, an atomic rename, the entries declared below).
A failed build raises. Unlike the JAX package's loader, nothing falls
back to Python here: ``io/sdf_io.py:load_sdf`` and ``io/mesh_io.py``'s
``load_obj``/``save_obj`` take their Python path only when the caller
passes ``native=False``.

Each entry point validates and converts its arrays (C-contiguous float32
/ int32 / float64) before passing pointers, and raises ``OSError`` when
the C side reports a failure (a file it cannot open or a short read).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from ..ops import cuda_lib

SRC = Path(__file__).resolve().parent / "dfio.cc"
BUILD_DIR = cuda_lib.BUILD_DIR
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def _gxx(out: Path) -> str:
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(out)],
                             capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"native I/O: g++ did not run: {exc}") from exc
    if res.returncode != 0:
        raise RuntimeError(f"native I/O: g++ failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def build() -> Path:
    """Compile ``dfio.cc`` unless the library of the current source exists;
    raises RuntimeError with g++'s output when the build fails."""
    return cuda_lib.build_library("dfio", [SRC], CXX_FLAGS, _gxx,
                                  BUILD_DIR)[0]


def _error(name, code, args):
    raise OSError(f"{name}({os.fsdecode(args[0])}) failed with code {code}")


LIB = cuda_lib.Library(build, _error)
_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
# (path, verts, n_verts, normals or null, faces, n_faces, ind or null)
_WRITE_OBJ = LIB.entry("dfio_write_obj", ctypes.c_char_p, _F, ctypes.c_int64,
                       _F, _I32, ctypes.c_int64, _D)
# (path, out n_verts, out n_faces)
_READ_OBJ_COUNTS = LIB.entry("dfio_read_obj_counts", ctypes.c_char_p, _I64,
                             _I64)
# (path, verts, n_verts, faces, n_faces)
_READ_OBJ = LIB.entry("dfio_read_obj", ctypes.c_char_p, _F, ctypes.c_int64,
                      _I32, ctypes.c_int64)
# (path, out res (3,), out b_min (3,), out b_max (3,))
_READ_DIST_HEADER = LIB.entry("dfio_read_dist_header", ctypes.c_char_p, _I32,
                              _D, _D)
# (path, volume, rx, ry, rz)
_READ_DIST = LIB.entry("dfio_read_dist", ctypes.c_char_p, _F, ctypes.c_int32,
                       ctypes.c_int32, ctypes.c_int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def write_obj(path, verts, faces, normals=None, ind=None) -> None:
    """Write an OBJ as ``io/mesh_io.py:save_obj`` does (the same bytes):
    ``verts`` (V, 3), ``faces`` (F, 3) zero-based, optional ``normals``
    (V, 3) and ``ind`` (4, 4) grid→world map (then faces as ``v//vn``)."""
    verts = np.ascontiguousarray(verts, dtype=np.float32).reshape(-1, 3)
    faces = np.ascontiguousarray(faces, dtype=np.int32).reshape(-1, 3)
    nptr = iptr = None
    if normals is not None:
        normals = np.ascontiguousarray(normals, dtype=np.float32)
        if normals.shape != verts.shape:
            raise ValueError(f"write_obj: normals {normals.shape} for "
                             f"vertices {verts.shape}")
        nptr = _ptr(normals, ctypes.c_float)
    if ind is not None:
        ind = np.ascontiguousarray(ind, dtype=np.float64)
        if ind.shape != (4, 4):
            raise ValueError(f"write_obj: ind must be (4, 4), got "
                             f"{ind.shape}")
        iptr = _ptr(ind, ctypes.c_double)
    _WRITE_OBJ(os.fsencode(path), _ptr(verts, ctypes.c_float), len(verts),
               nptr, _ptr(faces, ctypes.c_int32), len(faces), iptr)


def read_obj(path):
    """Parse an OBJ → (verts (V, 3) float32, faces (F, 3) int32,
    zero-based when the file is one-based)."""
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    _READ_OBJ_COUNTS(os.fsencode(path), ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    _READ_OBJ(os.fsencode(path), _ptr(verts, ctypes.c_float), nv.value,
              _ptr(faces, ctypes.c_int32), nf.value)
    return verts, faces


def read_dist(path):
    """Load a ``.dist`` volume → (b_min (3,), b_max (3,), volume
    (rx+1, ry+1, rz+1) float32, x-major)."""
    res = np.empty(3, np.int32)
    b_min, b_max = np.empty(3, np.float64), np.empty(3, np.float64)
    _READ_DIST_HEADER(os.fsencode(path), _ptr(res, ctypes.c_int32),
                      _ptr(b_min, ctypes.c_double),
                      _ptr(b_max, ctypes.c_double))
    rx, ry, rz = (int(r) for r in res)
    if min(rx, ry, rz) < 0:
        raise OSError(f"read_dist({path!s}): bad resolution {res}")
    volume = np.empty((rx + 1, ry + 1, rz + 1), np.float32)
    _READ_DIST(os.fsencode(path), _ptr(volume, ctypes.c_float), rx, ry, rz)
    return b_min, b_max, volume
