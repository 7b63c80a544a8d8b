"""The scene's analytic surface: a sphere with angular bumps, the stand-in
for a deforming body of the repository's frame bench (``bench.py:54-63``):

    sdf(p) = r - (radius + amp · sin(freq·θ + phase) · cos(freq·φ + phase))

with r, θ, φ the spherical coordinates of p about ``center`` (r offset by
1e-6). The benchmark samples it to make its volumes; the reference
evaluates it at any point to judge a warp.
"""

from __future__ import annotations

import torch


def bumpy_sdf_at(points, center, radius, amp, freq, phase,
                 dtype=torch.float64):
    """sdf at ``points`` (..., 3), computed in ``dtype``."""
    p = points.to(dtype)
    c = torch.as_tensor(center, dtype=dtype, device=p.device)
    d = p - c
    r = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2) + 1e-6
    theta = torch.arccos(torch.clamp(d[..., 2] / r, -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    bump = amp * torch.sin(freq * theta + phase) * torch.cos(freq * phi
                                                              + phase)
    return r - (radius + bump)
