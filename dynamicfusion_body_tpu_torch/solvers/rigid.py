"""Rigid pose estimation — counterpart of
``dynamicfusion_body_tpu/solvers/rigid.py:solve_rigid``.

Point-to-plane Gauss-Newton over a free 8-component dual quaternion
applied unnormalized through the sandwich product, as the reference
parameterizes it (core/fusion_dm.py:264-297, core/fusion.py:350-364);
analytic Jacobians (``torch.func.jacfwd``) and an 8×8 normal system.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..ops.dualquat import dq_transform_normal, dq_transform_point


def p2s_residuals(lw_dq, pts, normals, corrs, mask):
    """r_i = n_i(x)·(p_i(x) − c_i), masked (core/fusion_dm.py:285-297)."""
    p = dq_transform_point(lw_dq, pts)
    n = dq_transform_normal(lw_dq, normals)
    r = torch.sum(n * (p - corrs), dim=-1)
    return torch.where(mask, r, torch.zeros_like(r))


def solve_rigid(lw_dq, pts, normals, corrs, mask, iterations: int = 10,
                damping: float = 1e-6):
    """GN on the 8-dof DQ pose; a step is kept only when it does not
    raise the energy. Returns (lw_dq, cost = 0.5·Σr²)."""

    def resid(x):
        return p2s_residuals(x, pts, normals, corrs, mask)

    eye = torch.eye(8, dtype=lw_dq.dtype, device=lw_dq.device)
    x = lw_dq
    for _ in range(iterations):
        r = resid(x)
        J = jacfwd(resid)(x)                                  # (V, 8)
        JtJ = J.T @ J
        Jtr = J.T @ r
        A = JtJ + damping * eye * (torch.trace(JtJ) / 8.0 + 1e-12)
        x_new = x + torch.linalg.solve(A, -Jtr)
        better = torch.sum(resid(x_new) ** 2) <= torch.sum(r ** 2)
        x = torch.where(better, x_new, x)
    return x, 0.5 * torch.sum(resid(x) ** 2)
