"""K1 — fused marching-cubes front end (``csrc/mc_case_cross.cu``).

Counterpart of ``dynamicfusion_body_tpu/ops/mc_pallas.py:mc_case_cross``.
One int32 per lattice cell of an (X,Y,Z) volume:

    bits 0..7   cell case byte (corner bit b at (b&1, b>>1&1, b>>2&1));
                0 on the dead last plane of each axis
    bit 8/9/10  x/y/z edge-crossing flag, 0 on the last plane of its axis

The TPU kernel's shape gate (``mc_frontend_supported``: Z % 128 lanes,
Y % 8 sublanes) has no counterpart: the CUDA kernel takes any X,Y,Z >= 2.
"""

from __future__ import annotations

import torch

from . import cuda_lib


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


def mc_case_cross(vol: torch.Tensor, level: float) -> torch.Tensor:
    """(X,Y,Z) f32 → (X,Y,Z) int32 case/crossing lattice.

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (a strided view is made contiguous first) or raises."""
    if vol.device.type == "cpu":
        return mc_case_cross_ref(vol, level)
    if vol.device.type != "cuda":
        raise ValueError(f"mc_case_cross: unsupported device {vol.device}")
    if vol.dtype != torch.float32 or vol.dim() != 3 or min(vol.shape) < 2:
        raise ValueError(
            f"mc_case_cross: need a (X,Y,Z) float32 volume with every extent"
            f" >= 2, got {tuple(vol.shape)} {vol.dtype}"
        )
    vol = vol.contiguous()
    out = torch.empty(vol.shape, dtype=torch.int32, device=vol.device)
    X, Y, Z = vol.shape
    err = cuda_lib.lib().dfb_mc_case_cross(
        vol.data_ptr(), out.data_ptr(), X, Y, Z, float(level),
        cuda_lib.stream_ptr(vol.device),
    )
    cuda_lib.check("mc_case_cross", err)
    mc_case_cross.launches += 1
    return out


mc_case_cross.launches = 0
