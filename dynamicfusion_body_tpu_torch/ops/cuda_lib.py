"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and linked into one
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
    "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    # (vol, out, X, Y, Z, vol's element strides x/y/z, 1 if the storage
    #  holds an element past the view's last one, level, stream)
    "dfb_mc_case_cross": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # (instantiation, out[6]) and (vec, n_views, out[6]): registers, local
    # bytes, threads, CTAs per SM, shared bytes, 0
    "dfb_mc_case_cross_info": (_I, _IP),
    "dfb_fuse_depth_multi_info": (_I, _I, _IP),
    # (live, node_dq, cand, sel, selw, lw, mip_mn, mip_mx, use_mip,
    #  tdist, rx, ry, rz, vy, vz, brick, NB, C, k, M (nodes),
    #  vals, valid, wx, wy, wz (all three null: no coordinates), stream)
    "dfb_warp_trilerp_cached": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I,
        _F, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P, _P, _P, _P,
    ),
    # (live, node_pos, node_w, active (int32), node_dq, cand, lw,
    #  rx, ry, rz, vy, vz, brick, NB, C, k, M (nodes),
    #  vals, valid, wi, wx, wy, wz (all three null: no coordinates), stream)
    "dfb_warp_trilerp_bricks": (
        _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P,
    ),
    # (brick, k, out[6]) and (C, out[6]): registers, local bytes, threads,
    # CTAs per SM, persistent grid, dynamic shared bytes
    "dfb_warp_trilerp_cached_info": (_I, _I, _IP),
    "dfb_warp_trilerp_bricks_info": (_I, _IP),
    # (live, wx, wy, wz, n, rx, ry, rz, vals, valid, stream)
    "dfb_trilerp_bricks": (
        _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P, _P, _P,
    ),
    # (mode, threads, live, wx, wy, wz, n, V (samples a row), rx, ry, rz,
    #  out, row_map (null: none), stream)
    "dfb_trilerp_ablation": (
        _I, _I, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P, _P,
        _P,
    ),
    # (mode, threads, V, out[6]): registers, local bytes, threads, CTAs per
    # SM, persistent grid, dynamic shared bytes
    "dfb_trilerp_ablation_info": (_I, _I, _I, _IP),
    # (vals, wts, depths, projs, kinv_row2, n_views, h, w, X, Y, Z,
    #  tdist, wmax, vals_out, wts_out, cull_out (null: none), stream)
    "dfb_fuse_depth_multi": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _F, _F, _P, _P, _P, _P,
    ),
    # (points, n_points (int32 on the card), P, levels, 1/cell, counts,
    #  codes, ranks, stream)
    "dfb_knn_grid_bin": (_P, _P, _I, _I, _F, _P, _P, _P, _P),
    # (points, n_points, P, offsets, codes, ranks, sorted float4, stream)
    "dfb_knn_grid_scatter": (_P, _P, _I, _P, _P, _P, _P, _P),
    # (queries, n_queries (int32 on the card), Q, sorted, offsets, levels,
    #  cell, k, dists, idx, stream)
    "dfb_knn_grid_query": (_P, _P, _I, _P, _P, _I, _F, _I, _P, _P, _P),
    # (k, out[6]): registers, local bytes, threads, CTAs per SM, static
    # shared bytes, 0
    "dfb_knn_grid_query_info": (_I, _IP),
    # (vals, wts, live, dq, X, Y, Z, rx, ry, rz, x_offset, tdist, wmax,
    #  vals_out, wts_out, vec (4: float4, 1: scalar), stream)
    "dfb_rigid_update": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P, _I, _P,
    ),
    # (vec, out[6]): registers, local bytes, threads, CTAs per SM, static
    # shared bytes, 0
    "dfb_rigid_update_info": (_I, _IP),
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
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s.name, p.returncode, log)
              for s, p, log in zip(srcs, procs, logs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode, logs[-1]))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    os.replace(tmp, so)
    return so, time.perf_counter() - t0, "".join(logs)


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
