"""The benchmark's inputs, made on the device from a seed: the bumpy
sphere volumes of the tracking cells and the body captures of the ingest
cells. Nothing here comes from the program; the same tensors go to the
program and to the reference."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .raster import render_depth
from .reference.surface import bumpy_sdf_at


def bumpy_volume(res: int, dev, center, radius, amp, freq, phase):
    """(res,)*3 float32 samples of the bumpy sphere's SDF at the lattice
    points, made on ``dev`` one x-plane block at a time."""
    g = torch.arange(res, dtype=torch.float32, device=dev)
    out = torch.empty((res, res, res), dtype=torch.float32, device=dev)
    for x0 in range(0, res, 32):
        xs = g[x0:x0 + 32]
        pts = torch.stack(torch.meshgrid(xs, g, g, indexing="ij"), -1)
        out[x0:x0 + 32] = bumpy_sdf_at(pts, center, radius, amp, freq,
                                       phase, dtype=torch.float32)
    return out


def load_mesh(path: Path):
    """(verts (n,3) float32, faces (m,3) int64) numpy from an .npz."""
    with np.load(path) as z:
        return z["verts"].astype(np.float32), z["faces"].astype(np.int64)


def regularize(verts):
    """Centre the mesh and scale it to 1.8 units tall (the reference's
    core/meshutil.py:62-69)."""
    scale = 1.8 / (verts[:, 1].max() - verts[:, 1].min())
    return (verts - verts.mean(0)) * scale


def make_bend(ref_verts: torch.Tensor):
    """A smooth bend about x through the centroid, blended by height, its
    parameters frozen from ``ref_verts``: the ground-truth motion of the
    repository's suite config 7. Returns ``bend(points, angle)``."""
    c = ref_verts.mean(0)
    y = ref_verts[:, 1] - c[1]
    h = (y.max() - y.min()) + 1e-6

    def bend(pts, angle):
        p = pts - c
        t = 1.0 / (1.0 + torch.exp(-8.0 * (p[:, 1] / h)))
        ca, sa = torch.cos(angle * t), torch.sin(angle * t)
        out = torch.stack([p[:, 0], ca * p[:, 1] - sa * p[:, 2],
                           sa * p[:, 1] + ca * p[:, 2]], 1)
        return out + c

    return bend


def ring_extrinsics(n_views: int, dist: float, yaw0: float):
    """(n,3,4) float32 world→camera extrinsics of ``n_views`` cameras on a
    ring about the y axis at distance ``dist``, the first at yaw ``yaw0``."""
    out = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views + yaw0
        c, s = math.cos(a), math.sin(a)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        out.append(np.concatenate([R, [[0.0], [0.0], [dist]]], 1))
    return np.stack(out).astype(np.float32)


def intrinsics(f: float, img: int):
    return np.array([[f, 0, img / 2], [0, f, img / 2], [0, 0, 1]], np.float32)


def render_capture(verts, faces, K, lws, img: int):
    """The depth maps (n, img, img) of one capture on the device."""
    fmask = torch.ones(faces.shape[0], dtype=torch.bool, device=verts.device)
    tK = torch.as_tensor(K, device=verts.device)
    return torch.stack([render_depth(verts, faces, fmask, tK,
                                     torch.as_tensor(lw, device=verts.device),
                                     img, img, S=8) for lw in lws])
