"""Every C entry the port declares (``ops/cuda_lib.py``: the kernels'
entries beside their wrappers in ``ops/*_cuda.py``, the native I/O's in
``native/__init__.py``) matches its ``extern "C"`` definition in
``csrc/*.cu`` or ``native/dfio.cc``: the same names, and per entry the
same count and kinds of arguments (pointer, int, float, long long). A
mismatch would otherwise show only on the card, as a wrong argument
handed to a kernel."""

import ctypes
import re
from pathlib import Path

import pytest

from dynamicfusion_body_tpu_torch import native
from dynamicfusion_body_tpu_torch.ops import cuda_lib

PKG = Path(cuda_lib.__file__).resolve().parent.parent
cuda_lib.wrappers()  # imports the wrapper modules, which declare the entries
LIBRARIES = {"csrc/*.cu": cuda_lib.KERNELS, "native/dfio.cc": native.LIB}
DEFINITION = re.compile(r"\bint\s+((?:dfb|dfio)_\w+)\s*\(([^)]*)\)\s*\{")
C_KINDS = {"int": "int", "int32_t": "int", "float": "float",
           "long long": "long long", "int64_t": "long long"}
CTYPES_KINDS = {ctypes.c_int: "int", ctypes.c_int32: "int",
                ctypes.c_float: "float", ctypes.c_longlong: "long long",
                ctypes.c_int64: "long long"}


def c_kind(param: str) -> str:
    decl = " ".join(param.split())
    if "*" in decl:
        return "pointer"
    return C_KINDS[decl.rsplit(" ", 1)[0].removeprefix("const ")]


def ctypes_kind(t) -> str:
    if t in (ctypes.c_void_p, ctypes.c_char_p) or issubclass(
            t, ctypes._Pointer):
        return "pointer"
    return CTYPES_KINDS[t]


def c_definitions(pattern: str) -> dict:
    """{C name: [argument kinds]} of the int-returning ``dfb_``/``dfio_``
    functions defined in the sources ``pattern`` names."""
    return {m.group(1): [c_kind(p) for p in m.group(2).split(",")]
            for src in sorted(PKG.glob(pattern))
            for m in DEFINITION.finditer(src.read_text())}


DEFINED = {pattern: c_definitions(pattern) for pattern in LIBRARIES}
ENTRIES = [(pattern, name) for pattern, lib in LIBRARIES.items()
           for name in lib.entries]


@pytest.mark.parametrize("pattern", LIBRARIES)
def test_every_c_entry_is_declared_once(pattern):
    assert set(LIBRARIES[pattern].entries) == set(DEFINED[pattern])


@pytest.mark.parametrize("pattern, name", ENTRIES,
                         ids=[name for _, name in ENTRIES])
def test_declared_argtypes_match_the_c_definition(pattern, name):
    declared = LIBRARIES[pattern].entries[name].argtypes
    assert [ctypes_kind(t) for t in declared] == DEFINED[pattern][name]
