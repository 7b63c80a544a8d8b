"""The non-rigid TSDF update and the warp's fit, in plain PyTorch.

:func:`update_tsdf` is the reference DynamicFusion's canonical fusion
(core/fusion.py:153-198) with the node selection the program documents:
per 8³ brick, the 16 candidate nodes nearest the brick centre among the
192 nodes nearest the centre of its 16³ super-brick (the whole pool when
the bricks do not tile by two); per voxel, the 3 nearest candidates,
ties to the earlier one. The voxel centre is moved by the normalized DQ
blend of those nodes (Gaussian weights exp(-(d/2w)²)) and by the global
pose, the live TSDF is sampled there by trilinear interpolation (inside
[0, r-1]³ only), and the running average takes wi = the mean distance of
the selected nodes, with an empty voxel's weight taken as wi and an
update only where the sample is above -tdist. Distances are direct
differences throughout.

:func:`surface_fit` measures how well a warp carries the canonical
surface onto the live one: the canonical zero set (marching cubes of the
canonical volume), moved by the DQ blend of its 3 nearest nodes and the
global pose, then the live surface's signed distance function at each
moved vertex.
"""

from __future__ import annotations

import torch

from . import dq as DQ
from .mc import marching_cubes
from .surface import bumpy_sdf_at

BIG = 3.4e38


def _centres(n3, size, dev):
    axes = [torch.arange(n, dtype=torch.float32, device=dev) * size
            + (size - 1) / 2.0 for n in n3]
    g = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([c.reshape(-1) for c in g], -1)


def _sqdist(a, b):
    """(A,3), (B,3) → (A,B) squared distances by direct differences."""
    d = a[:, None, :] - b[None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _smallest(d2, k):
    """Indices of the k smallest entries per row, ascending, ties to the
    lower index."""
    return torch.sort(d2, dim=1, stable=True)[1][:, :k]


def brick_candidates(node_pos, active, shape, brick=8, C=16, s=2,
                     n_super=192):
    """(NB, C) candidate node ids per brick, bricks x-major."""
    dev = node_pos.device
    nb = [d // brick for d in shape]
    if any(n % s for n in nb) or n_super > node_pos.shape[0]:
        d2 = _sqdist(_centres(nb, brick, dev), node_pos)
        return _smallest(torch.where(active[None, :], d2, BIG), C)
    ns = [n // s for n in nb]
    sb = brick * s
    cs = _centres(ns, sb, dev)
    d2s = torch.where(active[None, :], _sqdist(cs, node_pos), BIG)
    pool = _smallest(d2s, n_super)                          # (NS, n_super)
    inner = _centres((s, s, s), brick, dev)
    bc = (cs - (sb - 1) / 2.0)[:, None, :] + inner[None]    # (NS, s³, 3)
    pp = node_pos[pool]                                     # (NS, P, 3)
    d = bc[:, :, None, :] - pp[:, None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(active[pool][:, None, :], d2, BIG)
    local = torch.sort(d2, dim=2, stable=True)[1][..., :C]
    cand = torch.gather(pool[:, None, :].expand(-1, s ** 3, -1), 2, local)
    out = cand.reshape(ns[0], ns[1], ns[2], s, s, s, C)
    return out.permute(0, 3, 1, 4, 2, 5, 6).reshape(-1, C)


def _trilinear(live, px, py, pz):
    rx, ry, rz = live.shape
    valid = ((px >= 0) & (px <= rx - 1) & (py >= 0) & (py <= ry - 1)
             & (pz >= 0) & (pz <= rz - 1))
    fx = torch.clamp(px, 0.0, rx - 1.0)
    fy = torch.clamp(py, 0.0, ry - 1.0)
    fz = torch.clamp(pz, 0.0, rz - 1.0)
    x0, y0, z0 = (torch.floor(f).long() for f in (fx, fy, fz))
    x1 = torch.clamp_max(x0 + 1, rx - 1)
    y1 = torch.clamp_max(y0 + 1, ry - 1)
    z1 = torch.clamp_max(z0 + 1, rz - 1)
    xd, yd, zd = fx - x0, fy - y0, fz - z0
    f = live.reshape(-1)

    def g(ix, iy, iz):
        return f[(ix * ry + iy) * rz + iz]

    c00 = g(x0, y0, z0) * (1 - xd) + g(x1, y0, z0) * xd
    c01 = g(x0, y1, z0) * (1 - xd) + g(x1, y1, z0) * xd
    c10 = g(x0, y0, z1) * (1 - xd) + g(x1, y0, z1) * xd
    c11 = g(x0, y1, z1) * (1 - xd) + g(x1, y1, z1) * xd
    c0 = c00 * (1 - yd) + c01 * yd
    c1 = c10 * (1 - yd) + c11 * yd
    return c0 * (1 - zd) + c1 * zd, valid


def update_tsdf(values, weights, live, node_pos, node_dq, node_w, active,
                lw, k: int, tdist: float, wmax: float = 100.0,
                brick: int = 8, C: int = 16, dtype=torch.float32,
                coords: bool = False):
    """One non-rigid fusion of ``live`` into (values, weights), all
    (X,Y,Z) with extents multiples of ``brick``. Returns (values',
    weights') and, with ``coords``, the warped coordinates (wx, wy, wz)
    and the in-volume mask in brick-row layout (NB, brick³)."""
    X, Y, Z = values.shape
    dev = values.device
    nbx, nby, nbz = X // brick, Y // brick, Z // brick
    nbs = nby * nbz
    V = brick ** 3
    cand = brick_candidates(node_pos, active, (X, Y, Z), brick, C)
    vi = torch.arange(V, device=dev)
    ox = (vi // (brick * brick)).float()
    oy = ((vi // brick) % brick).float()
    oz = (vi % brick).float()
    bi = torch.arange(nbs, device=dev)
    py = ((bi // nbz) * brick).float()[:, None] + oy[None]
    pz = ((bi % nbz) * brick).float()[:, None] + oz[None]
    out_v = values.clone()
    out_w = weights.clone()
    lwc = DQ.split(lw.to(dtype))
    live_c = live.to(dtype)
    cw = [] if coords else None
    for s in range(nbx):
        cidx = cand[s * nbs:(s + 1) * nbs]
        npos = node_pos[cidx]
        px = (s * brick + ox)[None, :].expand(nbs, V)
        dx = px[:, None, :] - npos[:, :, 0, None]
        dy = py[:, None, :] - npos[:, :, 1, None]
        dz = pz[:, None, :] - npos[:, :, 2, None]
        d2 = dx * dx + dy * dy + dz * dz                     # (nbs, C, V)
        d2 = torch.where(active[cidx][:, :, None], d2, BIG)
        acc = None
        wsum = torch.zeros((nbs, V), device=dev, dtype=dtype)
        wcnt = torch.zeros((nbs, V), device=dev)
        for _ in range(k):
            j = torch.argmin(d2, dim=1)                      # (nbs, V)
            best = torch.gather(d2, 1, j[:, None])[:, 0]
            dk = torch.sqrt(torch.clamp_max(best, BIG).to(dtype)).float()
            node = torch.gather(cidx, 1, j)
            finite = active[node] & (best < 1e18)
            wk = torch.where(finite, torch.exp(-((dk / (2.0 * node_w[node]))
                                                 ** 2)), 0.0).to(dtype)
            nd = node_dq[node].to(dtype)
            terms = [wk * nd[..., e] for e in range(8)]
            acc = terms if acc is None else [a + t for a, t in
                                             zip(acc, terms)]
            wsum = wsum + torch.where(finite, dk, 0.0).to(dtype)
            wcnt = wcnt + finite.float()
            d2.scatter_(1, j[:, None, :], BIG)
        wi = (wsum / torch.clamp_min(wcnt, 1.0).to(dtype)).float()
        blend = DQ.normalize(tuple(acc))
        p = DQ.transform_point(blend, (px.to(dtype), py.to(dtype),
                                       pz.to(dtype)))
        wx, wy, wz = DQ.transform_point(lwc, p)
        tl, valid = _trilinear(live_c, wx, wy, wz)
        tl = tl.float()
        vb = out_v[s * brick:(s + 1) * brick].reshape(
            brick, nby, brick, nbz, brick).permute(1, 3, 0, 2, 4).reshape(
            nbs, V)
        wb = out_w[s * brick:(s + 1) * brick].reshape(
            brick, nby, brick, nbz, brick).permute(1, 3, 0, 2, 4).reshape(
            nbs, V)
        wi_t = torch.where(wb == 0.0, wi, wb)
        upd = valid & (tl > -tdist)
        den = torch.clamp_min(wi + wi_t, 1e-30)
        nv = (vb * wi_t + torch.clamp_max(tl, tdist) * wi) / den
        nw = torch.clamp_max(wi + wi_t, wmax)
        nv = torch.where(upd, nv, vb)
        nw = torch.where(upd, nw, wb)

        def back(t):
            return t.reshape(nby, nbz, brick, brick, brick).permute(
                2, 0, 3, 1, 4).reshape(brick, Y, Z)

        out_v[s * brick:(s + 1) * brick] = back(nv)
        out_w[s * brick:(s + 1) * brick] = back(nw)
        if coords:
            cw.append((wx.float(), wy.float(), wz.float(), valid))
    if not coords:
        return out_v, out_w
    return out_v, out_w, tuple(torch.cat([c[i] for c in cw])
                               for i in range(4))


def knn_nodes(points, node_pos, active, k):
    """(n, k) ids of the k nearest active nodes, by direct differences,
    in row chunks."""
    out = []
    for a in range(0, points.shape[0], 4096):
        d2 = _sqdist(points[a:a + 4096], node_pos)
        out.append(_smallest(torch.where(active[None, :], d2, BIG), k))
    return torch.cat(out)


def warp_points(points, node_pos, node_dq, node_w, active, lw, k,
                dtype=torch.float32):
    """Points (n,3) moved by the DQ blend of their k nearest active nodes
    and then by the global pose ``lw``."""
    nbr = knn_nodes(points, node_pos, active, k)
    d = torch.linalg.vector_norm(points[:, None, :] - node_pos[nbr], dim=-1)
    w = torch.where(active[nbr], torch.exp(-((d / (2.0 * node_w[nbr])) ** 2)),
                    0.0).to(dtype)
    nd = node_dq[nbr].to(dtype)
    acc = [torch.sum(w * nd[..., e], dim=1) for e in range(8)]
    blend = DQ.normalize(tuple(acc))
    p = DQ.transform_point(blend, DQ.split(points.to(dtype)))
    p = DQ.transform_point(DQ.split(lw.to(dtype)), p)
    return torch.stack(p, -1).double()


def surface_fit(canonical, node_pos, node_dq, node_w, active, lw, k: int,
                live_params: dict, mc_step: int, dtype=torch.float32):
    """|live SDF| (voxels, float64) at every canonical surface vertex
    (marching cubes of ``canonical`` every ``mc_step`` voxels) moved by the
    warp."""
    verts = marching_cubes(canonical, 0.0, mc_step, with_normals=False)[
        "verts"]
    moved = warp_points(verts, node_pos, node_dq, node_w, active, lw, k,
                        dtype)
    return torch.abs(bumpy_sdf_at(moved, **live_params))
