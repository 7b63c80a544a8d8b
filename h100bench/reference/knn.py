"""Exact k nearest neighbours in plain PyTorch, for the ICP reference.

:func:`knn` returns, for each query, the k points nearest by squared
distance (ties to the lower point index), ascending, computed in the
dtype of its inputs (float64 in the reference). It is a cell search with
a blocked exhaustive tail, written apart from the program's search (no
code of the program, another cell layout and another order of work):

* the points are binned into cubic cells of ``LEAF`` lattice units, and
  again into cells twice as wide, and so on up to a coarsest level of a
  few cells a side; a cell is named by its linear index at its level, its
  box is the cube it covers;
* each block of queries starts from every non-empty coarsest cell. At
  each level a query keeps the cells whose box lies within an upper bound
  of its k-th distance (the farthest corner of any of its cells that
  holds k points, the least of those so far), then steps to their
  non-empty sub-cells;
* the points of the leaf cells that survive are compared exhaustively.

A point among the k nearest lies within that bound at every level, so
its cell is never dropped: the result is the exhaustive search's.
"""

from __future__ import annotations

import torch

BIG = torch.iinfo(torch.int64).max
LEAF = 1.0          # lattice units a finest cell spans
COARSE = 4          # cells a side at the coarsest level, at most
BLOCK = 1 << 17     # queries searched at a time


def _levels(points, leaf: float, coarse: int):
    """Per level (finest first): (cell index of each point, the non-empty
    cells' indices, counts, box corners lo (n,3)), cell width and grid
    size per axis."""
    lo_all = torch.floor(points.min(0).values / leaf) * leaf
    out = []
    w = leaf
    while True:
        c = torch.floor((points - lo_all) / w).long()
        n = int(c.max()) + 1
        lin = (c[:, 0] * n + c[:, 1]) * n + c[:, 2]
        cells, inv, cnt = torch.unique(lin, return_inverse=True,
                                       return_counts=True)
        ijk = torch.stack([cells // (n * n), (cells // n) % n, cells % n], 1)
        out.append({"of_point": inv, "cells": cells, "count": cnt,
                    "lo": lo_all + ijk.to(points.dtype) * w, "w": w, "n": n,
                    "ijk": ijk})
        if n <= coarse:
            return out
        w *= 2.0


def _children(fine, coarse):
    """For each cell of the coarse level, the range of its sub-cells in
    ``fine``'s cell order sorted by parent: (order, start, count)."""
    n = coarse["n"]
    pijk = fine["ijk"] // 2
    parent_lin = (pijk[:, 0] * n + pijk[:, 1]) * n + pijk[:, 2]
    parent = torch.searchsorted(coarse["cells"], parent_lin)
    order = torch.argsort(parent, stable=True)
    count = torch.bincount(parent, minlength=coarse["cells"].numel())
    start = torch.cumsum(count, 0) - count
    return order, start, count


def sq(v):
    """Squared norms of (..., 3) rows, summed in one fixed order."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) \
        + v[..., 2] * v[..., 2]


def _spread(rows, start, count):
    """(which row, which item) for rows each owning count[r] items from
    start[r]."""
    c = count[rows]
    rep = torch.repeat_interleave(torch.arange(rows.numel(),
                                               device=rows.device), c)
    first = torch.cumsum(c, 0) - c
    item = start[rows][rep] + torch.arange(rep.numel(), device=rows.device) \
        - first[rep]
    return rep, item


def knn(queries, points, k: int, ub=None):
    """(d2 (Q,k), idx (Q,k) int64) of the k points nearest each query,
    ascending by squared distance, then index; slots beyond the number of
    points get +inf and -1. ``ub`` (Q,), if given, is at least each
    query's k-th squared distance as :func:`sq` computes it (e.g. the
    largest over k points already known); it only prunes sooner."""
    dev, dt = queries.device, queries.dtype
    Q, P = queries.shape[0], points.shape[0]
    d2_out = torch.full((Q, k), torch.inf, dtype=dt, device=dev)
    i_out = torch.full((Q, k), -1, dtype=torch.long, device=dev)
    if Q == 0 or P == 0:
        return d2_out, i_out
    ub_all = ub
    lv = _levels(points, LEAF, COARSE)
    kids = [_children(lv[j - 1], lv[j]) for j in range(1, len(lv))]
    leaf_lv = lv[0]
    by_leaf = torch.argsort(leaf_lv["of_point"], stable=True)
    leaf_start = torch.cumsum(leaf_lv["count"], 0) - leaf_lv["count"]
    top = lv[-1]
    n_top = top["cells"].numel()
    for b0 in range(0, Q, BLOCK):
        q = queries[b0:b0 + BLOCK]
        nb = q.shape[0]
        qi = torch.arange(nb, device=dev).repeat_interleave(n_top)
        cell = torch.arange(n_top, device=dev).repeat(nb)
        ub = (torch.full((nb,), torch.inf, dtype=dt, device=dev)
              if ub_all is None else ub_all[b0:b0 + nb].to(dt).clone())
        for j in range(len(lv) - 1, -1, -1):
            L = lv[j]
            lo = L["lo"][cell]
            hi = lo + L["w"]
            qq = q[qi]
            near = sq(torch.clamp_min(lo - qq, 0)
                      + torch.clamp_min(qq - hi, 0))
            far = sq(torch.maximum((qq - lo).abs(), (qq - hi).abs()))
            full = L["count"][cell] >= k
            ub = ub.scatter_reduce(0, qi[full], far[full], "amin")
            keep = near <= ub[qi]
            qi, cell = qi[keep], cell[keep]
            if j:
                order, start, count = kids[j - 1]
                rep, item = _spread(cell, start, count)
                qi, cell = qi[rep], order[item]
        rep, item = _spread(cell, leaf_start, leaf_lv["count"])
        qi, pid = qi[rep], by_leaf[item]
        d2 = sq(q[qi] - points[pid])
        taken = torch.zeros_like(d2, dtype=torch.bool)
        for s in range(k):
            dd = torch.where(taken, torch.inf, d2)
            m = torch.full((nb,), torch.inf, dtype=dt, device=dev)
            m = m.scatter_reduce(0, qi, dd, "amin")
            cand = torch.where((dd == m[qi]) & ~taken, pid, BIG)
            best = torch.full((nb,), BIG, dtype=torch.long, device=dev)
            best = best.scatter_reduce(0, qi, cand, "amin")
            got = best < BIG
            d2_out[b0:b0 + nb][got, s] = m[got]
            i_out[b0:b0 + nb][got, s] = best[got]
            taken |= pid == best[qi]
    return d2_out, i_out
