"""Rigid pose estimation — counterpart of
``dynamicfusion_body_tpu/solvers/rigid.py`` (``solve_rigid``,
``solve_rigid_core``).

Point-to-plane Gauss-Newton over a free 8-component dual quaternion
applied unnormalized through the sandwich product, as the reference
parameterizes it (core/fusion_dm.py:264-297, core/fusion.py:350-364);
analytic Jacobians (``torch.func.jacfwd``) and an 8×8 normal system.

:func:`solve_rigid_rows` is the same solve for millions of rows (the ICP
ingest's meshes at 512³): the sandwich of a point is M·p + t and of a
normal M·n, with M (3×3) and t (3,) quadratic in the DQ, so a residual
is the dot product of a fixed 21-vector of its row with a 21-vector
w(x); one pass over the rows sums their products (21×21, float64), and
each step is then 21×21 algebra, whatever the number of rows, with no
read on the host.
"""

from __future__ import annotations

import functools

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


def pose_maps(x):
    """(M (3,3), t (3,)) of the DQ x = (a, b): its sandwich moves a point p
    to M·p + t (M = the map v ↦ a·v·a*, t = 2·vec(b·a*)) and turns a normal
    n to M·n. Both are quadratic in x."""
    w, i, j, k = x[0], x[1], x[2], x[3]
    b0, bi, bj, bk = x[4], x[5], x[6], x[7]
    M = torch.stack([
        torch.stack([w * w + i * i - j * j - k * k, 2 * (i * j - w * k),
                     2 * (i * k + w * j)]),
        torch.stack([2 * (i * j + w * k), w * w - i * i + j * j - k * k,
                     2 * (j * k - w * i)]),
        torch.stack([2 * (i * k - w * j), 2 * (j * k + w * i),
                     w * w - i * i - j * j + k * k])])
    t = 2 * torch.stack([w * bi - b0 * i + (j * bk - k * bj),
                         w * bj - b0 * j + (k * bi - i * bk),
                         w * bk - b0 * k + (i * bj - j * bi)])
    return M, t


@functools.cache
def _forms(device, dtype):
    """(12, 8, 8) symmetric C with (M.flatten(), t) = xᵀ·C·x, read off
    :func:`pose_maps` at the unit vectors and their pairwise sums (its
    coefficients are small integers: exact)."""
    e = torch.eye(8, dtype=torch.float64)

    def f(v):
        M, t = pose_maps(v)
        return torch.cat([M.reshape(9), t])

    C = torch.zeros(12, 8, 8, dtype=torch.float64)
    for a in range(8):
        C[:, a, a] = f(e[a])
        for b in range(a):
            C[:, a, b] = C[:, b, a] = (f(e[a] + e[b]) - f(e[a])
                                       - f(e[b])) / 2
    return C.to(device=device, dtype=dtype)


def moments(pts, normals, corrs, mask):
    """S = Σᵢ fᵢ·fᵢᵀ (21,21) in float64 over the masked rows, with
    fᵢ = [vec(nᵢ ⊗ pᵢ), nᵢ, vec(cᵢ ⊗ nᵢ)]: the residual is linear in fᵢ,
    rᵢ(x) = fᵢ·w(x) (:func:`weights`), so Σr², JᵀJ and Jᵀr are quadratic
    forms in S."""
    n, p, c = normals.double(), pts.double(), corrs.double()
    f = torch.cat([(n[:, :, None] * p[:, None, :]).reshape(-1, 9), n,
                   (c[:, :, None] * n[:, None, :]).reshape(-1, 9)], 1)
    f = torch.where(mask[:, None], f, 0.0)
    return f.T @ f


def weights(x):
    """(w (21,), dw/dx (21,8)) of the DQ x (float64): with (M, t) its
    sandwich's map (:func:`pose_maps`), r = (M·n)·(M·p + t − c) =
    nᵀMᵀM·p + nᵀMᵀt − nᵀMᵀc, so w = [vec(MᵀM), Mᵀt, −vec(M)]. M, t
    and their derivatives come from F = C·x: (M, t) = F·x, d/dx = 2F."""
    F = _forms(x.device, x.dtype) @ x                         # (12, 8)
    mt = F @ x
    M, t = mt[:9].reshape(3, 3), mt[9:]
    dM = (2.0 * F[:9]).T.reshape(8, 3, 3)
    dt = (2.0 * F[9:]).T                                      # (8, 3)
    w = torch.cat([(M.T @ M).reshape(9), M.T @ t, -M.reshape(9)])
    a = dM.transpose(1, 2) @ M
    D = torch.cat([(a + a.transpose(1, 2)).reshape(8, 9),
                   dM.transpose(1, 2) @ t + dt @ M,
                   -dM.reshape(8, 9)], 1).T
    return w, D


@traced("rigid")
def solve_rigid_rows(lw_dq, pts, normals, corrs, mask, iterations: int = 10,
                     damping: float = 1e-6):
    """:func:`solve_rigid` for many rows (module docstring): its GN step,
    damping and accept test, with Σr², JᵀJ and Jᵀr the quadratic forms
    of the rows' moments (:func:`moments`, one pass over the rows, in
    float64) in w(x) and its derivative, the steps in float64, the 8×8
    solve by ``solve_ex`` (a singular system gives a non-finite step,
    which the accept test refuses). The accept test thus compares float64
    energies where :func:`solve_rigid_core` compares float32 ones: near
    convergence the two can keep different steps. Returns (lw_dq, cost =
    0.5·Σr²) in ``lw_dq``'s dtype."""
    S = moments(pts, normals, corrs, mask)
    eye = torch.eye(8, dtype=S.dtype, device=S.device)
    x = lw_dq.double()
    for _ in range(iterations):
        w, D = weights(x)
        Sw = S @ w
        JtJ = D.T @ S @ D
        A = JtJ + damping * eye * (torch.trace(JtJ) / 8.0 + 1e-12)
        x_new = x + torch.linalg.solve_ex(A, -(D.T @ Sw))[0]
        w_new = weights(x_new)[0]
        x = torch.where(w_new @ S @ w_new <= w @ Sw, x_new, x)
    w = weights(x)[0]
    return x.to(lw_dq.dtype), (0.5 * (w @ S @ w)).to(lw_dq.dtype)
