"""Multi-view projective TSDF fusion, in plain PyTorch: the reference
FusionDM (core/fusion_dm.py:95-178, its OpenCL kernel ``fuse_depth`` at
630-673).

:func:`alignment` is the grid calibration (110-141): every nonzero depth
pixel back-projected to the world, the mean of the per-view means as the
centre and the mean of the per-view component standard deviations as the
spread; the grid spans 8 spreads. :func:`fuse` runs the kernel's formula
for each view in order: project the voxel through K·lw·IND, sample the
negative depth map bilinearly (inside [0, w-1) × [0, h-1) only), turn it
into a signed distance along the ray with row 2 of K⁻¹ (a missing or too
near depth carves free space at -tdist), and fold it into the running
average with unit weight, the weight capped at ``wmax``, wherever the
distance is below tdist.
"""

from __future__ import annotations

import numpy as np
import torch


def alignment(depths, K, lws, dtype=torch.float64):
    """(centre (3,), spread) of depth maps (n,H,W) taken with extrinsics
    lws (n,3,4), in ``dtype``."""
    n, h, w = depths.shape
    dev = depths.device
    d = depths.to(dtype)
    kinv = torch.linalg.inv(torch.as_tensor(K, dtype=torch.float64)).to(
        dtype).to(dev)
    u = torch.arange(w, dtype=dtype, device=dev)[None, :].expand(h, w)
    v = torch.arange(h, dtype=dtype, device=dev)[:, None].expand(h, w)
    uv1 = torch.stack([u, v, torch.ones_like(u)], -1)
    lw = torch.as_tensor(np.asarray(lws), dtype=dtype, device=dev)
    means, stds = [], []
    for i in range(n):
        m = d[i] != 0
        cam = (-d[i][m])[:, None] * uv1[m]
        cam = cam @ kinv.T
        world = (cam - lw[i, :, 3]) @ lw[i, :, :3]        # R⁻¹ = Rᵀ
        mu = world.mean(0)
        means.append(mu)
        stds.append(torch.sqrt(((world - mu) ** 2).mean(0)).mean())
    return torch.stack(means).mean(0), torch.stack(stds).mean()


def ind_matrix(res: int, centre, spread, factor: float = 8.0):
    """Grid index → world, 4x4 float64 numpy: scale factor·spread/res,
    origin centre − scale·res/2."""
    scale = factor * float(spread) / res
    ind = np.eye(4)
    ind[0, 0] = ind[1, 1] = ind[2, 2] = scale
    ind[:3, 3] = centre.double().cpu().numpy() - scale * res / 2.0
    return ind


def projections(K, lws, ind):
    """K·lw·IND per view, float32 numpy (n,3,4), each product in float32."""
    K = np.asarray(K, np.float32)
    ind = np.asarray(ind, np.float32)
    out = []
    for lw in lws:
        lw4 = np.eye(4, dtype=np.float32)
        lw4[:3] = np.asarray(lw, np.float32)
        out.append(K @ lw4[:3] @ ind)
    return np.stack(out).astype(np.float32)


def fuse(values, weights, depths, projs, kinv_row2, tdist: float,
         wmax: float = 100.0, dtype=torch.float32, counts: bool = False,
         slab: int = 32):
    """Fuse views ``depths`` (n,H,W) into (values, weights) (X,Y,Z), in
    x-slabs of ``slab`` planes. Returns (values', weights') and with
    ``counts`` also the in-image voxel-views and the updates."""
    X, Y, Z = values.shape
    dev = values.device
    n, h, w = depths.shape
    P = torch.as_tensor(projs, device=dev).to(dtype)
    kr = torch.as_tensor(kinv_row2, device=dev).to(dtype)
    dep = depths.to(dtype)
    out_v, out_w = values.clone(), weights.clone()
    ys = torch.arange(Y, device=dev).to(dtype)[None, :, None]
    zs = torch.arange(Z, device=dev).to(dtype)[None, None, :]
    n_inb = n_upd = 0
    for x0 in range(0, X, slab):
        xs = torch.arange(x0, min(x0 + slab, X), device=dev).to(dtype)[
            :, None, None]
        v = out_v[x0:x0 + slab].to(dtype)
        wt = out_w[x0:x0 + slab].to(dtype)
        for i in range(n):
            p = P[i]
            u = p[0, 0] * xs + p[0, 1] * ys + p[0, 2] * zs + p[0, 3]
            vv = p[1, 0] * xs + p[1, 1] * ys + p[1, 2] * zs + p[1, 3]
            pw = p[2, 0] * xs + p[2, 1] * ys + p[2, 2] * zs + p[2, 3]
            px, py = u / pw, vv / pw
            inb = (px >= 0) & (py >= 0) & (px < w - 1) & (py < h - 1)
            pxc = torch.where(inb, px, 0.0)
            pyc = torch.where(inb, py, 0.0)
            ix, iy = torch.floor(pxc).long(), torch.floor(pyc).long()
            fx, fy = pxc - ix.to(dtype), pyc - iy.to(dtype)
            flat = dep[i].reshape(-1)

            def g(a, b):
                return flat[a * w + b]

            up = g(iy, ix) * (1 - fx) + g(iy, ix + 1) * fx
            bot = g(iy + 1, ix) * (1 - fx) + g(iy + 1, ix + 1) * fx
            pz = -(up * (1 - fy) + bot * fy)
            dz = -(kr[0] * (px * pz - u) + kr[1] * (py * pz - vv)
                   + kr[2] * (pz - pw))
            dz = torch.where(pz <= tdist, torch.full_like(dz, -tdist), dz)
            upd = inb & (dz < tdist)
            nw = torch.clamp_max(1.0 + wt, wmax)
            nv = ((nw - 1.0) * v + torch.clamp_min(dz, -tdist)) / nw
            v = torch.where(upd, nv, v)
            wt = torch.where(upd, nw, wt)
            if counts:
                n_inb += int(torch.sum(inb))
                n_upd += int(torch.sum(upd))
        out_v[x0:x0 + slab] = v.to(values.dtype)
        out_w[x0:x0 + slab] = wt.to(weights.dtype)
    if counts:
        return out_v, out_w, n_inb, n_upd
    return out_v, out_w
