"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, which ``ctypes`` loads. The
library is built at first use into ``dynamicfusion_body_tpu_torch/_build/``
(listed in ``.gitignore``) and rebuilt whenever a hash of the sources and
flags changes, so a fresh checkout builds it on its first kernel call.

Each C entry point launches its kernel on the stream it is given (the
caller passes ``torch.cuda.current_stream()``), allocates nothing, and
returns ``cudaGetLastError()``; :func:`check` raises on a nonzero code.

``-fmad=false`` keeps nvcc from contracting a*b+c into one FMA: the
kernels evaluate their arithmetic in the same order as their PyTorch
twins, where every multiply and add is a separate, separately rounded
tensor operation; without contraction the two round alike.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # (vol, out, X, Y, Z, level, stream)
    "dfb_mc_case_cross": (_P, _P, _I, _I, _I, _F, _P),
    # (live, node_dq, cand, sel, selw, lw, mip_mn, mip_mx, use_mip,
    #  tdist, rx, ry, rz, brick, NB, C, k,
    #  vals, valid, wx, wy, wz, stream)
    "dfb_warp_trilerp_cached": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I,
        _F, _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P, _P, _P, _P,
    ),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdfb_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the library for the current sources
    exists. Returns (library path, build seconds, nvcc's output)."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [str(Path(CUDA_HOME) / "bin" / "nvcc"), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, so)
    return so, secs, res.stdout + res.stderr


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    so, _, _ = build()
    handle = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
