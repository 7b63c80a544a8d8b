"""The yardstick of the kernels' roofline shares: the card's peaks and the
bytes and f32 operations each launch of K1, K2 and K5 needs.

A bound is the least time the card could take for a launch: the larger of
its bytes over the memory rate and its operations over the f32 rate.
Bytes count each input read once and each output written once; where the
work depends on the data (K2's live taps, K5's in-image voxel-views and
updates), it is counted from the run's own inputs by the benchmark's
code. The operation counts per element are those worked out for the
kernels in the repository's ``chip_smoke.py`` (K1: 8 compares a cell;
K2: 216 a voxel and 40 a trilerped voxel; K5: 22 + 2 divisions a
voxel-view, 29 an in-image voxel-view, 6 + 1 division an update).
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at 700 W
HBM_BPS = 3.35e12
F32_OPS = 67e12

K2_OPS_VOXEL, K2_OPS_TRILERP = 216, 40
K5_OPS_VIEW, K5_DIVS_VIEW, K5_OPS_INB = 22, 2, 29
K5_OPS_UPD, K5_DIVS_UPD = 6, 1


def bound_ms(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BPS, nops / F32_OPS) * 1e3


def k1_bound_ms(shape) -> float:
    """K1 on an (X,Y,Z) volume: each voxel read, each cell's int32 word
    written; 8 compares a cell."""
    n = 1
    for s in shape:
        n *= int(s)
    return bound_ms(8 * n, 8 * n)


def live_mip(live):
    """Per 8³ live brick the min and max over its voxels and a one-voxel
    high-side halo, (nx, ny, nz) each."""
    rx, ry, rz = live.shape
    pad = torch.nn.functional.pad(live[None, None], (0, 1, 0, 1, 0, 1),
                                  mode="replicate")[0, 0]
    mn = -torch.nn.functional.max_pool3d(-pad[None, None], 9, 8)[0, 0]
    mx = torch.nn.functional.max_pool3d(pad[None, None], 9, 8)[0, 0]
    return mn[:rx // 8, :ry // 8, :rz // 8], mx[:rx // 8, :ry // 8, :rz // 8]


def short_bricks(wx, wy, wz, valid, shape, tdist: float, mip):
    """(NB,) bool: bricks whose every sample takes one value K2 can tell
    without reading the live volume: none in the volume, or every sample's
    taps inside a 3×3×3 window of live bricks that are all at or below
    -tdist, or all one value."""
    mn, mx = mip
    nl = [s // 8 for s in shape]
    lo, hi = [], []
    for w, n in zip((wx, wy, wz), nl):
        wlo = torch.where(valid, w, 1e9).amin(1)
        whi = torch.where(valid, w, -1e9).amax(1)
        lo.append(torch.clamp(torch.div(torch.floor(wlo).int(), 8,
                                        rounding_mode="floor"), 0, n - 1))
        hi.append(torch.clamp(torch.div(torch.floor(whi).int(), 8,
                                        rounding_mode="floor"), 0, n - 1))
    covered = ((hi[0] - lo[0] <= 2) & (hi[1] - lo[1] <= 2)
               & (hi[2] - lo[2] <= 2))
    amin = torch.full_like(wx[:, 0], 1e9)
    amax = torch.full_like(wx[:, 0], -1e9)
    for i in range(3):
        for j in range(3):
            for t in range(3):
                xi, yi, zi = lo[0] + i, lo[1] + j, lo[2] + t
                m = (xi <= hi[0]) & (yi <= hi[1]) & (zi <= hi[2])
                xi = torch.clamp_max(xi, nl[0] - 1).long()
                yi = torch.clamp_max(yi, nl[1] - 1).long()
                zi = torch.clamp_max(zi, nl[2] - 1).long()
                amin = torch.where(m, torch.minimum(amin, mn[xi, yi, zi]),
                                   amin)
                amax = torch.where(m, torch.maximum(amax, mx[xi, yi, zi]),
                                   amax)
    return ~valid.any(1) | (covered & (amax <= -tdist)) | (covered
                                                           & (amin == amax))


def live_taps(shape, wx, wy, wz) -> int:
    """Distinct live cells the trilerp at (wx, wy, wz) reads: 8 clamped
    corners each."""
    rx, ry, rz = shape
    lo, hi = [], []
    for c, r in zip((wx, wy, wz), shape):
        f = torch.floor(torch.clamp(c, 0.0, r - 1.0)).long()
        lo.append(f)
        hi.append(torch.clamp(f + 1, max=r - 1))
    tapped = torch.zeros(rx * ry * rz, dtype=torch.bool, device=wx.device)
    for ix in (lo[0], hi[0]):
        for iy in (lo[1], hi[1]):
            for iz in (lo[2], hi[2]):
                tapped[(ix * ry + iy) * rz + iz] = True
    return int(tapped.sum())


def k2_bound_ms(live, wx, wy, wz, valid, tdist: float, n_nodes: int, k: int,
                C: int) -> float:
    """K2 (cached selection, no coordinates out) on one update: the live
    cells its full bricks tap, the node DQs, the candidate table (int32),
    the selection words and weights, the pose and the live mip read; the
    values (f32) and the valid flags (1 byte) written. (NB, V) samples."""
    nb, v = wx.shape
    short = short_bricks(wx, wy, wz, valid, live.shape, tdist, live_mip(live))
    full = ~short
    taps = live_taps(live.shape, wx[full], wy[full], wz[full])
    nl = (live.shape[0] // 8) * (live.shape[1] // 8) * (live.shape[2] // 8)
    nbytes = (4 * taps + 32 * n_nodes + 4 * nb * C + 4 * nb * v
              + 4 * nb * k * v + 32 + 2 * 4 * nl + 4 * nb * v + nb * v)
    nops = nb * v * K2_OPS_VOXEL + int(full.sum()) * v * K2_OPS_TRILERP
    return bound_ms(nbytes, nops)


def k5_bound_ms(shape, n_views: int, h: int, w: int, n_inb: int,
                n_upd: int) -> float:
    """K5 on one capture: values and weights read and written once, the
    depth maps, projections and K⁻¹'s row read once; operations per
    voxel-view, per in-image voxel-view and per update."""
    nvox = int(shape[0]) * int(shape[1]) * int(shape[2])
    nbytes = 16 * nvox + 4 * (n_views * h * w + 12 * n_views + 3)
    nops = (nvox * n_views * (K5_OPS_VIEW + K5_DIVS_VIEW)
            + n_inb * K5_OPS_INB + n_upd * (K5_OPS_UPD + K5_DIVS_UPD))
    return bound_ms(nbytes, nops)
