"""K1 — fused marching-cubes front end (``csrc/mc_case_cross.cu``).

Counterpart of ``dynamicfusion_body_tpu/ops/mc_pallas.py:mc_case_cross``.
One int32 per lattice cell of an (X,Y,Z) volume:

    bits 0..7   cell case byte (corner bit b at (b&1, b>>1&1, b>>2&1));
                0 on the dead last plane of each axis
    bit 8/9/10  x/y/z edge-crossing flag, 0 on the last plane of its axis

The TPU kernel's shape gate (``mc_frontend_supported``: Z % 128 lanes,
Y % 8 sublanes) has no counterpart: the CUDA kernel takes any X,Y,Z >= 2
and any element strides (the stride-2 extraction hands it
``vol[::2, ::2, ::2]`` as it lies), as long as its offsets fit 32 bits.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .cuda_lib import BUF, FLOAT, INT, PTR


def mc_case_cross_ref(vol: torch.Tensor, level: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (same bit layout)."""
    X, Y, Z = vol.shape
    ins = (vol < level).to(torch.int32)

    def shift1(a, axis):  # a[i+1] along axis, clamped at the last plane
        n = a.shape[axis]
        return torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                         dim=axis)

    dev = vol.device
    vx = (torch.arange(X, device=dev) < X - 1).to(torch.int32)[:, None, None]
    vy = (torch.arange(Y, device=dev) < Y - 1).to(torch.int32)[None, :, None]
    vz = (torch.arange(Z, device=dev) < Z - 1).to(torch.int32)[None, None, :]
    sx = shift1(ins, 0)
    planes = {(0, 0): ins, (1, 0): shift1(ins, 1), (0, 1): shift1(ins, 2)}
    planes[(1, 1)] = shift1(planes[(1, 0)], 2)
    code = torch.zeros_like(ins)
    for b in range(8):
        dx, dy, dz = b & 1, (b >> 1) & 1, (b >> 2) & 1
        corner = planes[(dy, dz)]
        if dx:
            corner = shift1(corner, 0)
        code = code | (corner << b)
    code = code * (vx * vy * vz)
    cross_x = (ins ^ sx) * vx
    cross_y = (ins ^ planes[(1, 0)]) * vy
    cross_z = (ins ^ planes[(0, 1)]) * vz
    return code | (cross_x << 8) | (cross_y << 9) | (cross_z << 10)


# the kernel's index math is 32-bit
MAX_OFFSET = 2**31 - 1


def check_args(vol: torch.Tensor) -> int:
    """Raise ValueError unless the kernel takes ``vol``: an (X,Y,Z) float32
    volume, every extent >= 2, whose cells and whose largest element
    offset (through its strides) fit 32-bit indices. Returns that
    offset."""
    if vol.dtype != torch.float32 or vol.dim() != 3 or min(vol.shape) < 2:
        raise ValueError(
            f"mc_case_cross: need a (X,Y,Z) float32 volume with every extent"
            f" >= 2, got {tuple(vol.shape)} {vol.dtype}"
        )
    last = sum((n - 1) * s for n, s in zip(vol.shape, vol.stride()))
    if vol.numel() > MAX_OFFSET or last + 1 > MAX_OFFSET:
        raise ValueError(
            f"mc_case_cross: {tuple(vol.shape)} with strides {vol.stride()} "
            f"reaches element {last}: the kernel indexes at most "
            f"{MAX_OFFSET} with 32 bits")
    return last


# (vol, out, X, Y, Z, vol's element strides x/y/z, 1 if the storage holds
#  an element past the view's last one, level, stream)
_LAUNCH = cuda_lib.KERNELS.entry(
    "dfb_mc_case_cross", PTR, PTR, INT, INT, INT, INT, INT, INT, INT, FLOAT,
    PTR, kernel="mc_case_cross_kernel")
# (instantiation, out[6])
_INFO = cuda_lib.KERNELS.entry("dfb_mc_case_cross_info", INT, BUF)


@cuda_lib.wrapper(_LAUNCH, twin=mc_case_cross_ref)
def mc_case_cross(vol: torch.Tensor, level: float) -> torch.Tensor:
    """(X,Y,Z) f32 → (X,Y,Z) int32 case/crossing lattice. The kernel reads
    a strided view where it lies."""
    last = check_args(vol)
    out = torch.empty(vol.shape, dtype=torch.int32, device=vol.device)
    X, Y, Z = vol.shape
    strides = vol.stride()
    # does the storage hold an element past the view's last one (the
    # stride-2 loads read it)
    tail = int(strides[2] == 2 and vol.untyped_storage().nbytes()
               > (vol.storage_offset() + last + 1) * vol.element_size())
    _LAUNCH(vol.data_ptr(), out.data_ptr(), X, Y, Z, *strides, tail,
            float(level), cuda_lib.stream_ptr(vol.device))
    return out


# K1's instantiations, in the order of csrc/mc_case_cross.cu:Mode
KERNELS = ("vec4", "stride2", "scalar")


def kernel_info() -> dict:
    """What the card makes of each of K1's instantiations (``vec4``:
    16-byte loads and stores; ``stride2``: two 16-byte loads a run of the
    stride-2 view; ``scalar``: element loads and stores), as
    :func:`cuda_lib.info` reads it, with static shared bytes. Needs the
    card."""
    return {name: cuda_lib.info(_INFO, which)
            for which, name in enumerate(KERNELS)}
