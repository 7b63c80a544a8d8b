"""Rigid pose estimation — counterpart of
``dynamicfusion_body_tpu/solvers/rigid.py`` (``solve_rigid``,
``solve_rigid_core``).

Point-to-plane Gauss-Newton over a free 8-component dual quaternion
applied unnormalized through the sandwich product, as the reference
parameterizes it (core/fusion_dm.py:264-297, core/fusion.py:350-364);
analytic Jacobians (``torch.func.jacfwd``) and an 8×8 normal system.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..ops.dualquat import dq_transform_normal, dq_transform_point
from ..utils.profiling import host_read, traced


def p2s_residuals(lw_dq, pts, normals, corrs, mask):
    """r_i = n_i(x)·(p_i(x) − c_i), masked (core/fusion_dm.py:285-297)."""
    p = dq_transform_point(lw_dq, pts)
    n = dq_transform_normal(lw_dq, normals)
    r = torch.sum(n * (p - corrs), dim=-1)
    return torch.where(mask, r, torch.zeros_like(r))


def _ident(x):
    return x


def solve_rigid_core(lw_dq, pts, normals, corrs, mask, iterations: int = 10,
                     damping: float = 1e-6, reduce=_ident):
    """GN on the 8-dof DQ pose; a step is kept only when it does not
    raise the energy. Returns (lw_dq, cost = 0.5·Σr²).

    ``reduce`` is applied to every reduction over the points (JᵀJ, Jᵀr
    and the energies): the identity on one device, the all-reduce over
    the ranks' vertex shards in ``parallel/frame_sharded.py``, where the
    pose and its 8×8 system stay replicated."""

    def resid(x):
        return p2s_residuals(x, pts, normals, corrs, mask)

    eye = torch.eye(8, dtype=lw_dq.dtype, device=lw_dq.device)
    x = lw_dq
    for _ in range(iterations):
        r = resid(x)
        J = jacfwd(resid)(x)                                  # (V, 8)
        JtJ = reduce(J.T @ J)
        Jtr = reduce(J.T @ r)
        A = JtJ + damping * eye * (torch.trace(JtJ) / 8.0 + 1e-12)
        with host_read():  # the solve reads its error code on the host
            x_new = x + torch.linalg.solve(A, -Jtr)
        better = (reduce(torch.sum(resid(x_new) ** 2))
                  <= reduce(torch.sum(r ** 2)))
        x = torch.where(better, x_new, x)
    return x, 0.5 * reduce(torch.sum(resid(x) ** 2))


@traced("rigid")
def solve_rigid(lw_dq, pts, normals, corrs, mask, iterations: int = 10,
                damping: float = 1e-6):
    """The single-device entry: :func:`solve_rigid_core` with the identity
    reduction. Returns (lw_dq, cost = 0.5·Σr²)."""
    return solve_rigid_core(lw_dq, pts, normals, corrs, mask, iterations,
                            damping)
