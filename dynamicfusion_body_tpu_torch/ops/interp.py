"""Trilinear TSDF interpolation — counterpart of
``dynamicfusion_body_tpu/ops/interp.py:trilinear``.

Reference semantics core/util.py:102-137: floor/ceil corner gather, lerp
over x then y then z, invalid when the query is outside ``[0, res-1]³``.
Returns a ``(value, valid)`` pair; values at invalid positions come from
clamped indices and must be masked by the caller.
"""

from __future__ import annotations

import torch


def trilinear(volume: torch.Tensor, pos: torch.Tensor):
    """Interpolate ``volume`` (X,Y,Z) at ``pos`` (...,3) →
    (values (...,), valid (...,) bool)."""
    return trilinear_c(volume, pos[..., 0], pos[..., 1], pos[..., 2])


def trilinear_c(volume: torch.Tensor, px, py, pz):
    """:func:`trilinear` on separate coordinate tensors of one shape —
    counterpart of ``models/warp_field.py:_trilinear_c`` in the JAX
    package, and the formula the K2 kernel evaluates."""
    rx, ry, rz = volume.shape
    fx = torch.clamp(px, 0.0, rx - 1.0)
    fy = torch.clamp(py, 0.0, ry - 1.0)
    fz = torch.clamp(pz, 0.0, rz - 1.0)
    valid = ((px >= 0.0) & (px <= rx - 1.0) & (py >= 0.0) & (py <= ry - 1.0)
             & (pz >= 0.0) & (pz <= rz - 1.0))
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    z0 = torch.floor(fz).long()
    x1 = torch.clamp_max(x0 + 1, rx - 1)
    y1 = torch.clamp_max(y0 + 1, ry - 1)
    z1 = torch.clamp_max(z0 + 1, rz - 1)
    xd = fx - x0
    yd = fy - y0
    zd = fz - z0
    flat = volume.reshape(-1)

    def g(ix, iy, iz):
        return flat[(ix * ry + iy) * rz + iz]

    c00 = g(x0, y0, z0) * (1 - xd) + g(x1, y0, z0) * xd
    c01 = g(x0, y1, z0) * (1 - xd) + g(x1, y1, z0) * xd
    c10 = g(x0, y0, z1) * (1 - xd) + g(x1, y0, z1) * xd
    c11 = g(x0, y1, z1) * (1 - xd) + g(x1, y1, z1) * xd
    c0 = c00 * (1 - yd) + c01 * yd
    c1 = c10 * (1 - yd) + c11 * yd
    return c0 * (1 - zd) + c1 * zd, valid
