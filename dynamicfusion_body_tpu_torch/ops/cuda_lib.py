"""The port's one boundary to foreign code: the shared libraries that
``ctypes`` loads, the C entries declared on them, and the rule by which a
kernel's wrapper takes the kernel or its twin (:func:`wrapper`).

A library is built at first use into ``dynamicfusion_body_tpu_torch/
_build/`` (listed in ``.gitignore``) under a name hashed from its sources
and flags, so a changed source is rebuilt and a stale binary is never
loaded; the build renames a temporary file, so concurrent first uses do
not clash. A failed build raises with the compiler's output.

Each C entry is declared once, in the module that calls it
(:meth:`Library.entry`), and binds at its first call, which loads its
library. The kernels' library, :data:`KERNELS`, links every ``csrc/*.cu``
file, each compiled by its own ``nvcc`` process for ``sm_90a``. Its
entries launch their kernel on the stream they are given (the caller
passes ``torch.cuda.current_stream()``), allocate nothing, and return
``cudaGetLastError()``.

``-fmad=false`` keeps nvcc from contracting a*b+c into one FMA: the
kernels evaluate their arithmetic in the same order as their PyTorch
twins, where every multiply and add is a separate, separately rounded
tensor operation; without contraction the two round alike.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import pkgutil
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

# the argument types of the C entries: pointer, int, float, long long,
# and the six-int buffer of an ``_info`` entry
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
LLONG = ctypes.c_longlong
BUF = ctypes.POINTER(ctypes.c_int)


def build_library(stem: str, sources, flags, compile,
                  build_dir=BUILD_DIR) -> tuple[Path, float, str]:
    """``build_dir/lib<stem>_<hash of flags and sources>.so``, written by
    ``compile(path)`` (which returns the compiler's output or raises
    RuntimeError with it) unless it exists. Returns (library path, build
    seconds, compiler output)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = Path(build_dir) / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, 0.0, ""
    so.parent.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        log = compile(tmp)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, so)
    return so, time.perf_counter() - t0, log


class Library:
    """A library and its declared entries: ``build()`` returns its path,
    ``error(name, code, args)`` raises for an entry that returned
    ``code`` != 0."""

    def __init__(self, build, error):
        self.build, self.error = build, error
        self.entries: dict[str, Entry] = {}

    @functools.cached_property
    def handle(self) -> ctypes.CDLL:
        return ctypes.CDLL(str(self.build()))

    def entry(self, name: str, *argtypes, kernel: str | None = None):
        """Declare the C entry ``name`` (it returns an int), its ctypes
        ``argtypes`` and the ``__global__`` ``kernel`` it launches, if
        any: the name its launches show in a trace."""
        self.entries[name] = Entry(self, name, argtypes, kernel)
        return self.entries[name]


class Entry:
    """A declared C entry. A call raises through the library's ``error``
    on a nonzero return and counts a launch in ``wrapper.launches``."""

    def __init__(self, library: Library, name: str, argtypes: tuple,
                 kernel: str | None):
        self.library, self.name = library, name
        self.argtypes, self.kernel = argtypes, kernel
        self.wrapper = None

    @functools.cached_property
    def fn(self):
        fn = getattr(self.library.handle, self.name)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        return fn

    def __call__(self, *args) -> None:
        code = self.fn(*args)
        if code != 0:
            self.library.error(self.name, code, args)
        if self.wrapper is not None:
            self.wrapper.launches += 1


def _nvcc(out: Path) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [out.with_name(f"{out.name}.{s.stem}.o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s.name, p.returncode, log)
              for s, p, log in zip(srcs, procs, logs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o",
                               str(out), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode, logs[-1]))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    return "".join(logs)


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless the library for the current sources
    exists. Returns (library path, build seconds, nvcc's output)."""
    return build_library("dfb_kernels", sorted(CSRC.glob("*.cu"))
                         + sorted(CSRC.glob("*.cuh")), NVCC_FLAGS, _nvcc)


def _cuda_error(name, code, args):
    raise RuntimeError(f"{name}: CUDA error {code}")


KERNELS = Library(lambda: build()[0], _cuda_error)


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def wrapper(entry: Entry, twin=None, check=None):
    """Make ``fn``, which launches ``entry`` on CUDA tensors, the kernel's
    wrapper: it runs ``check`` (if any) on its arguments, then a CPU first
    argument takes ``twin`` (the plain PyTorch version, same arguments), a
    CUDA one ``fn``, and any other device, or the CPU without a twin,
    raises ValueError. Its ``launches`` counts ``entry``'s launches, also
    those of other functions that call it."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if check is not None:
                check(*args, **kwargs)
            device = args[0].device
            if device.type == "cpu" and twin is not None:
                return twin(*args, **kwargs)
            if device.type != "cuda":
                raise ValueError(f"{fn.__name__}: unsupported device {device}")
            return fn(*args, **kwargs)

        call.launches = 0
        entry.wrapper = call
        return call
    return wrap


def wrappers() -> dict:
    """Every kernel wrapper (the ``*_cuda`` modules of ``ops/`` are
    imported here) → the ``__global__`` kernel its launches run."""
    for mod in pkgutil.iter_modules([str(Path(__file__).parent)]):
        if mod.name.endswith("_cuda"):
            importlib.import_module(f"{__package__}.{mod.name}")
    return {e.wrapper: e.kernel for e in KERNELS.entries.values()
            if e.wrapper is not None}


INFO_KEYS = ("registers", "local_bytes", "threads", "ctas_per_sm")


def info(entry: Entry, *args, last=("static_smem", "grid")) -> dict:
    """What the card makes of one kernel instantiation, from an ``_info``
    entry called with ``args`` and a six-int buffer: registers and local
    (spill) bytes per thread, threads per CTA, CTAs per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), then the fields
    named ``last``. Needs the card."""
    buf = (ctypes.c_int * 6)()
    entry(*args, buf)
    return dict(zip(INFO_KEYS + tuple(last), buf))
