"""The ICP branch of the multi-view ingest, in plain PyTorch: the reference
FusionDM with ``useICP=True`` (nintendops/DynamicFusion_Body
core/fusion_dm.py:95-178 for the per-view branch, 219-316 for
``setupCorrespondences``, ``solve`` and ``updateTSDF``).

Per capture: view 0 is fused alone into a fresh TSDF, which becomes the
canonical volume, and meshed at stride 1 with normals. Each later view is
fused alone into a fresh TSDF, and its pose found from the identity by 3
rounds of: the live mesh at stride 1; each canonical vertex moved by the
pose (its normal turned by the rotation part), its k nearest live
vertices, the one with the least point-to-plane cost |n·(v − p)| if that
is below 1 (else the nearest, at cost 1), kept if the cost is within the
tolerance; then 12 Gauss-Newton steps on the 8 free components of the
dual quaternion, applied unnormalized through the sandwich product, a
step kept only if it does not raise Σr². The canonical volume then takes
the live one rigidly: each voxel centre moved by the pose, the live TSDF
trilinearly sampled there, and folded into the running average with
unit weight (weight capped at ``wmax``) where the sample lies in the
volume and above −tdist.

Departures from the source, each harmless to the result: the live mesh
is extracted once per view (the source extracts the same one in each of
the 3 rounds); the fusion and the rigid update run in slabs of x-planes;
each step moves the rows through the affine map the dual quaternion's
sandwich amounts to (M·p + t, M·n; read off the images of the origin and
the unit vectors), and its Jacobian through that map's derivatives
(forward-mode automatic differentiation on the 8 components); the search is
:mod:`.knn`'s, on the meshes' coordinates in float64; in bfloat16 (the
control) the 8x8 solve runs in float32, which ``torch.linalg`` needs,
and the rigid update samples the live volume at its bfloat16 positions
in float32 (bfloat16 rounds the top index of a 512³ lattice, 511, to
512).

:func:`poses` is the pose chain in the given dtype (float64 for the
check); :func:`chain` the volume the views give under given poses, in
the configuration's float32 by default, with the program's order of
operations so that a program that computes the same thing agrees bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from . import dq as rdq
from . import fuse as ref_fuse
from . import mc as ref_mc
from .knn import knn, sq
from .nonrigid import _trilinear

IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def fuse_view(maps, projs, kinv_row2, i: int, res: int, tdist: float,
              dtype=torch.float32):
    """View ``i`` fused alone into a fresh res³ TSDF: (values, weights)."""
    dev = maps.device
    v0 = torch.full((res,) * 3, tdist, dtype=torch.float32, device=dev)
    return ref_fuse.fuse(v0, torch.zeros_like(v0), maps[i:i + 1],
                         projs[i:i + 1], kinv_row2, tdist, dtype=dtype)


def _move(x, pts):
    """Points (n,3) moved by the DQ x (8,)."""
    return torch.stack(rdq.transform_point(tuple(x), pts.unbind(-1)), -1)


def _turn(x, nrm):
    """Normals (n,3) turned by the real part of x."""
    r = tuple(x[:4]) + (torch.zeros_like(x[0]),) * 4
    return torch.stack(rdq.transform_point(r, nrm.unbind(-1)), -1)


def correspondences(x, verts, normals, live, k: int, tolerance: float,
                    ub=None):
    """(corr (V,3), valid (V,), the k nearest (V,k)) of the canonical
    mesh moved by x against the live vertices. ``ub`` (V,) bounds each
    query's k-th squared distance from above (the previous round's
    neighbours at the moved vertices), which only speeds the search."""
    wv, wn = _move(x, verts), _turn(x, normals)
    _, idx = knn(wv.double(), live.double(), k, ub=ub)
    ok = idx >= 0
    cand = live[idx.clamp_min(0)]                            # (V,k,3)
    cost = torch.abs(((wn[:, None, :] * (wv[:, None, :] - cand)).sum(-1)))
    cost = torch.where(ok, cost, torch.inf)
    best = torch.argmin(cost, 1)
    mc = cost.gather(1, best[:, None])[:, 0]
    use = mc < 1.0
    pick = torch.where(use, best, 0)
    corr = cand.gather(1, pick[:, None, None].expand(-1, 1, 3))[:, 0]
    cost = torch.where(use, mc, torch.ones_like(mc))
    return corr, (cost <= tolerance) & ok[:, 0], idx


def _affine(x):
    """(M (3,3), t (3,)) with the sandwich of x taking a point p to
    M·p + t (read off the images of the origin and the unit vectors); a
    normal n goes to M·n."""
    e = torch.cat([torch.zeros(1, 3, dtype=x.dtype, device=x.device),
                   torch.eye(3, dtype=x.dtype, device=x.device)])
    moved = _move(x, e)
    return (moved[1:] - moved[0]).T, moved[0]


def gauss_newton(x, verts, normals, corr, valid, iters: int,
                 damping: float = 1e-6):
    """The 8-dof GN with its accept test, from x: the residual
    r = (M·n)·(M·p + t − c) and its Jacobian through M and t's
    derivatives."""

    def rows(y, jac):
        M, t = _affine(y)
        n = normals @ M.T
        d = verts @ M.T + t - corr
        r = torch.where(valid, (n * d).sum(-1), torch.zeros_like(d[:, 0]))
        if not jac:
            return r
        dM, dt = jacfwd(_affine)(y)                   # (3,3,8), (3,8)
        J = torch.stack([((normals @ dM[..., c].T) * d).sum(-1)
                         + (n * (verts @ dM[..., c].T + dt[:, c])).sum(-1)
                         for c in range(8)], 1)
        return r, torch.where(valid[:, None], J, torch.zeros_like(J))

    solve_dt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    eye = torch.eye(8, dtype=solve_dt, device=x.device)
    for _ in range(iters):
        r, J = rows(x, True)
        JtJ = (J.T @ J).to(solve_dt)
        Jtr = (J.T @ r).to(solve_dt)
        A = JtJ + damping * eye * (torch.trace(JtJ) / 8.0 + 1e-12)
        step = torch.linalg.solve_ex(A, -Jtr)[0].to(x.dtype)
        x_new = x + step
        keep = (rows(x_new, False) ** 2).sum() <= (r ** 2).sum()
        x = torch.where(keep, x_new, x)
    return x


def poses(maps, projs, kinv_row2, res: int, tdist: float, k: int = 4,
          tolerance: float = 1.0, rounds: int = 3, iters: int = 12,
          dtype=torch.float64):
    """The pose (8,) of each view after the first, as the ICP branch finds
    it, computed in ``dtype`` (the fusions in float32, or in ``dtype``
    when it is narrower)."""
    fdt = dtype if dtype == torch.bfloat16 else torch.float32
    dev = maps.device
    canon, _ = fuse_view(maps, projs, kinv_row2, 0, res, tdist, fdt)
    m = ref_mc.marching_cubes(canon, 0.0, 1, True, dtype=dtype)
    verts, normals = m["verts"], m["normals"]
    del canon, m
    out = []
    for i in range(1, maps.shape[0]):
        live_v, _ = fuse_view(maps, projs, kinv_row2, i, res, tdist, fdt)
        live = ref_mc.marching_cubes(live_v, 0.0, 1, False,
                                     dtype=dtype)["verts"]
        del live_v
        x = torch.tensor(IDENTITY, dtype=dtype, device=dev)
        ub = None
        for _ in range(rounds):
            corr, valid, idx = correspondences(x, verts, normals, live, k,
                                               tolerance, ub)
            x = gauss_newton(x, verts, normals, corr, valid, iters)
            # the k neighbours found bound the next round's search
            d = _move(x, verts).double()[:, None, :] - live.double()[
                idx.clamp_min(0)]
            ub = torch.where((idx >= 0).all(1), sq(d).amax(1), torch.inf)
        out.append(x)
    return out


def update_rigid(values, weights, live, x, tdist: float, wmax: float = 100.0,
                 dtype=torch.float32, slab: int = 16):
    """The rigid TSDF-to-TSDF update of (values, weights) by ``live`` under
    the pose x, in ``dtype``, in x-slabs."""
    X, Y, Z = values.shape
    dev = values.device
    xq = tuple(c.to(dtype) for c in x.unbind(0))
    lv = live.to(dtype)
    out_v, out_w = values.clone(), weights.clone()
    ys = torch.arange(Y, device=dev).to(dtype)[None, :, None]
    zs = torch.arange(Z, device=dev).to(dtype)[None, None, :]
    for x0 in range(0, X, slab):
        xs = torch.arange(x0, min(x0 + slab, X), device=dev).to(dtype)[
            :, None, None]
        px, py, pz = (t.reshape(-1) for t in torch.broadcast_tensors(xs, ys,
                                                                     zs))
        wx, wy, wz = rdq.transform_point(xq, (px, py, pz))
        if dtype == torch.bfloat16:  # it cannot hold the lattice's top index
            wx, wy, wz = wx.float(), wy.float(), wz.float()
        s, ok = _trilinear(lv, wx, wy, wz)
        s = s.to(dtype)
        v = out_v[x0:x0 + slab].reshape(-1).to(dtype)
        w = out_w[x0:x0 + slab].reshape(-1).to(dtype)
        upd = ok & (s > -tdist)
        nw = w + 1.0
        nv = (v * w + torch.clamp_max(s, tdist) * 1.0) / nw
        shape = out_v[x0:x0 + slab].shape
        out_v[x0:x0 + slab] = torch.where(upd, nv, v).reshape(shape).to(
            values.dtype)
        out_w[x0:x0 + slab] = torch.where(upd, torch.clamp_max(nw, wmax),
                                          w).reshape(shape).to(weights.dtype)
    return out_v, out_w


def chain(maps, projs, kinv_row2, res: int, tdist: float, xs,
          dtype=torch.float32):
    """The capture's volume (values, weights) under the given poses of
    views 1.., in ``dtype``."""
    v, w = fuse_view(maps, projs, kinv_row2, 0, res, tdist, dtype)
    for i, x in enumerate(xs, start=1):
        live, _ = fuse_view(maps, projs, kinv_row2, i, res, tdist, dtype)
        v, w = update_rigid(v, w, live, x, tdist, dtype=dtype)
    return v, w


def pose_gap(prog, ref, res: int) -> float:
    """The widest displacement of the res³ volume's 8 corners between two
    lists of poses, in voxels (float64); +inf for a missing pose or a
    non-finite one."""
    if len(prog) != len(ref):
        return float("inf")
    dev = ref[0].device if ref else "cpu"
    c = torch.tensor([[a, b, d] for a in (0, res) for b in (0, res)
                      for d in (0, res)], dtype=torch.float64, device=dev)
    gap = 0.0
    for p, r in zip(prog, ref):
        d = _move(p.to(dev).double(), c) - _move(r.double(), c)
        g = float(torch.sqrt((d * d).sum(-1)).max())
        gap = max(gap, g if np.isfinite(g) else float("inf"))
    return gap
