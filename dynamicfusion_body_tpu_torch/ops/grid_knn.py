"""Grid-hash k-nearest-neighbour search — counterpart of
``dynamicfusion_body_tpu/ops/grid_knn.py``.

Correspondence search only matches nearby points (the point-to-plane
tolerance prunes distant pairs, reference core/fusion.py:273), so this
variant bins the points into ``cell``-sized cubes (a stable sort by cell,
``torch.searchsorted`` for each cell's range), takes the 2×2×2 cell block
covering each query's ±cell/2 neighbourhood and runs an exact top-k over
at most ``cap_per_cell`` points of each of those cells. Queries with no
point in the block are not found.
"""

from __future__ import annotations

import torch

from .knn import BIG


def grid_knn(queries, points, k: int, valid=None, cell: float = 16.0,
             cap_per_cell: int = 256, grid_n: int = 32):
    """Returns (dists (Q,k), idx (Q,k) int64, found (Q,k) bool, overflow
    () bool).

    Coordinates are assumed ≥ 0 (voxel-lattice space) and ``grid_n``
    cells per axis must cover them. Invalid points go to bin grid_n³.
    ``overflow`` is True when some cell holds more than ``cap_per_cell``
    points: its excess points (the last in sorted order) were not
    candidates, so a true nearest neighbour may have been missed. The
    block starts at ``floor((q − cell/2)/cell)`` clipped to [0, grid_n−2].
    The k picks are the first minima over the 8 cells' candidates taken
    cell-major in (dx, dy, dz) order: on equal distances the earlier cell
    wins, then the lower lane, as the JAX package's running insertion
    (which takes a candidate only on a strict <) orders them. Slots not
    found hold index 0 and distance sqrt(3.4e38)."""
    dev = queries.device
    n_q, npts = queries.shape[0], points.shape[0]
    if valid is None:
        valid = torch.ones(npts, dtype=torch.bool, device=dev)

    c = torch.clamp((points / cell).to(torch.int32), 0, grid_n - 1).long()
    pcell = (c[:, 0] * grid_n + c[:, 1]) * grid_n + c[:, 2]
    pcell = torch.where(valid, pcell, grid_n ** 3)
    sorted_cell, order = torch.sort(pcell, stable=True)
    cells = torch.arange(grid_n ** 3, device=dev)
    starts = torch.searchsorted(sorted_cell, cells)
    ends = torch.searchsorted(sorted_cell, cells, right=True)
    ps = points[order]

    qc = torch.clamp(torch.floor((queries - cell / 2.0) / cell).to(
        torch.int32), 0, grid_n - 2).long()
    lane = torch.arange(cap_per_cell, device=dev)
    d2s, poss = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cid = ((qc[:, 0] + dx) * grid_n + qc[:, 1] + dy) * grid_n + (
                    qc[:, 2] + dz)
                s, e = starts[cid][:, None], ends[cid][:, None]
                pos = torch.clamp_max(s + lane, npts - 1)       # (Q, CAP)
                in_cell = (s + lane) < torch.minimum(e, s + cap_per_cell)
                cand = ps[pos]                                  # (Q, CAP, 3)
                ddx = cand[..., 0] - queries[:, 0:1]
                ddy = cand[..., 1] - queries[:, 1:2]
                ddz = cand[..., 2] - queries[:, 2:3]
                d2 = ddx * ddx + ddy * ddy + ddz * ddz
                d2s.append(torch.where(in_cell, d2, BIG))
                poss.append(pos)
    d2 = torch.cat(d2s, dim=1)                                  # (Q, 8·CAP)
    pos = torch.cat(poss, dim=1)
    best_d, best_p = [], []
    for _ in range(k):
        am = torch.argmin(d2, dim=1, keepdim=True)
        best_d.append(torch.gather(d2, 1, am)[:, 0])
        best_p.append(torch.gather(pos, 1, am)[:, 0])
        d2.scatter_(1, am, BIG)
    d = torch.stack(best_d, dim=1)
    found = d < BIG
    idx = torch.where(found, order[torch.stack(best_p, dim=1)], 0)
    overflow = torch.any((ends - starts) > cap_per_cell)
    return torch.sqrt(torch.where(found, d, BIG)), idx, found, overflow
