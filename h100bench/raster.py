"""The capture renderer: a frozen copy of the port's sample-scatter
rasterizer (``render/raster.py:render_depth``), so that the benchmark's
inputs cannot move with the program. Every triangle gets an S×S
pixel-space sample grid over its screen bounding box; samples inside the
triangle are fragments, which scatter-min a depth key quantized to
1/1024 per pixel. The map is negative depth, 0 where nothing projects.
"""

from __future__ import annotations

import torch

_BIG = 2**31 - 1


def _fragments(px, py, h: int, w: int, S: int):
    """Per-triangle S×S bbox sample grid → (pix (F,S²) int64, bary
    (F,S²,3), inside (F,S²))."""
    xmin = torch.clamp(torch.floor(torch.amin(px, dim=1)), 0, w - 1)
    xmax = torch.clamp(torch.ceil(torch.amax(px, dim=1)), 0, w - 1)
    ymin = torch.clamp(torch.floor(torch.amin(py, dim=1)), 0, h - 1)
    ymax = torch.clamp(torch.ceil(torch.amax(py, dim=1)), 0, h - 1)
    # exact 1-px steps whenever the bbox fits in S samples (hole-free);
    # uniform stretch beyond that (triangles larger than S px may alias)
    i = torch.arange(S, dtype=torch.float32, device=px.device)
    step_x = torch.clamp_min((xmax - xmin) / (S - 1), 1.0)
    step_y = torch.clamp_min((ymax - ymin) / (S - 1), 1.0)
    sx = torch.minimum(xmin[:, None] + i[None, :] * step_x[:, None],
                       xmax[:, None])
    sy = torch.minimum(ymin[:, None] + i[None, :] * step_y[:, None],
                       ymax[:, None])
    ix = torch.round(sx).long()
    iy = torch.round(sy).long()
    gx = torch.repeat_interleave(ix, S, dim=1)       # (F,S²) x-major
    gy = iy.repeat(1, S)
    fx = gx.float()
    fy = gy.float()

    x0, x1, x2 = px[:, 0:1], px[:, 1:2], px[:, 2:3]
    y0, y1, y2 = py[:, 0:1], py[:, 1:2], py[:, 2:3]
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    ok = torch.abs(denom) > 1e-12
    denom = torch.where(ok, denom, 1.0)
    b0 = ((y1 - y2) * (fx - x2) + (x2 - x1) * (fy - y2)) / denom
    b1 = ((y2 - y0) * (fx - x2) + (x0 - x2) * (fy - y2)) / denom
    b2 = 1.0 - b0 - b1
    eps = -1e-5
    inside = ok & (b0 >= eps) & (b1 >= eps) & (b2 >= eps)
    pix = gy * w + gx
    return pix, torch.stack([b0, b1, b2], dim=-1), inside


def _zmin_scatter(pix, zq, valid, npix: int):
    """Per-pixel minimum of the int32 keys ``zq`` over valid fragments;
    pixels without one hold ``_BIG``. Returns (zbuf (npix,), _BIG)."""
    pixm = torch.where(valid, pix, npix)
    zqm = torch.where(valid, zq, _BIG)
    zbuf = torch.full((npix + 1,), _BIG, dtype=torch.int32, device=pix.device)
    zbuf.scatter_reduce_(0, pixm, zqm, reduce="amin")
    return zbuf[:npix], _BIG


def _triangles(verts, faces):
    return verts[faces.reshape(-1)].reshape(-1, 3, 3)


def render_depth(verts, faces, face_mask, K, lw, h: int, w: int, S: int = 8):
    """Pinhole depth render → NEGATIVE-depth map (h,w): -z_cam at hits, 0
    where nothing projects (the reference's no-measurement value,
    core/fusion_dm.py:196). Perspective-correct z via 1/z interpolation;
    depth is quantized to 1/1024 by the z-buffer key."""
    tri = _triangles(verts, faces)
    cam = torch.einsum("ij,ftj->fti", lw[:, :3], tri) + lw[:, 3]
    z = cam[..., 2]
    proj = torch.einsum("ij,ftj->fti", K, cam)
    zs = torch.where(torch.abs(proj[..., 2]) > 1e-9, proj[..., 2], 1e-9)
    px = proj[..., 0] / zs
    py = proj[..., 1] / zs

    pix, bary, inside = _fragments(px, py, h, w, S)
    inv_z = torch.einsum("fsc,fc->fs", bary, 1.0 / torch.clamp_min(z, 1e-9))
    sz = 1.0 / torch.clamp_min(inv_z, 1e-9)
    front = torch.all(z > 1e-6, dim=-1)[:, None]
    valid = inside & front & face_mask[:, None]

    npix = h * w
    zq = torch.clamp(sz * 1024.0, 0, float(1 << 30)).to(torch.int32)
    zbuf, big = _zmin_scatter(pix.reshape(-1), zq.reshape(-1),
                              valid.reshape(-1), npix)
    depth = torch.where(zbuf == big, 0.0, -(zbuf.float() / 1024.0))
    return depth.reshape(h, w)
