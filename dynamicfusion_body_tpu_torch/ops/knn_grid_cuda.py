"""K7 — exact k-nearest-neighbour search on the voxel lattice
(``csrc/knn_grid.cu``).

Replaces no TPU kernel: the JAX package's rigid ICP runs the flat search
(``ops/knn.py:knn``), every query against every point slot, which at a
512³ view's millions of mesh vertices is ~10^13 pairs a search. This
search returns what ``knn(queries[:n_q], points, k, valid=slots < n_p)``
selects, exactly, without scaling as queries × points:

* the k valid points nearest each valid query row by the float32 squared
  distance ``(dx·dx + dy·dy) + dz·dz`` (direct differences), ascending,
  equal distances to the lower point index; ``dists`` are their square
  roots. The flat search selects on the expanded form ‖q‖² − 2q·p + ‖p‖²,
  whose rounding can order near-equal neighbours otherwise;
* the valid rows are the first ``n_q`` queries and the first ``n_p``
  points, both counts read on the device (0-d integer tensors, as the
  marching cubes return them): no host read;
* every other row, and every query that is not finite, gets (+inf, 0) in
  each slot, as do the slots of a query left without k points.

The points are counted into cells of ``cell`` voxels on a 2^L-a-side
grid in Morton order (the octree of cell blocks, each node one range of
the sorted points); the kernel walks that tree depth first per query and
skips every node whose box lies beyond the current k-th distance
(``csrc/knn_grid.cu`` has why that is exact). :func:`knn_grid_ref` is the
plain twin for CPU tensors: the same cells, codes and tree, each node's
box drawn tight around its points, walked level by level for all queries
at once (a node is dropped once its box lies beyond an upper bound of the
query's k-th distance: the farthest corner of a node holding k points),
the survivors' points ranked exhaustively. Both are exact, so they agree
bit for bit.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from .cuda_lib import BUF, FLOAT, INT, PTR

MAX_K = 8          # csrc/knn_grid.cu:kMaxK
MAX_LEVELS = 9     # csrc/knn_grid.cu:kMaxLevels: at most 512 cells a side
# cells a side of the grid: 8-voxel cells at the ICP ingest's 512³ meshes
# searched fastest of 1, 2, 4 and 8 (tools/profile_knn_grid.py --cell)
SIDE = 64
INT64_MAX = 2**63 - 1


def leaf_cell(extent: float) -> float:
    """The voxels a leaf cell spans on a lattice of ``extent``: the least
    power of two with SIDE cells covering it."""
    return 2.0 ** math.ceil(math.log2(max(extent, 1.0) / SIDE))


def grid_levels(extent: float, cell: float) -> int:
    """The octree's depth L: the least with 2^L cells of ``cell`` voxels
    covering [0, extent) (at least 1, at most MAX_LEVELS; points beyond
    fall into the faces' cells, which the search keeps exact)."""
    need = max(1, math.ceil(extent / cell))
    return min(MAX_LEVELS, max(1, math.ceil(math.log2(need))))


def _spread3(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def cell_codes(points: torch.Tensor, levels: int, cell: float):
    """(P,) int64 Morton codes of the points' cells, clamped to the grid
    (a non-finite coordinate lands on a face), as the kernel bins them."""
    g = (1 << levels) - 1
    c = torch.floor(torch.nan_to_num(points, nan=0.0) * (1.0 / cell))
    c = torch.clamp(c, 0.0, float(g)).long()
    return (_spread3(c[:, 0]) | (_spread3(c[:, 1]) << 1)
            | (_spread3(c[:, 2]) << 2))


def _keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordering (d2 >= 0 in float32, idx) lexicographically."""
    return (d2.contiguous().view(torch.int32).long() << 32) | idx


def _box_d2(q, lo, hi):
    """Squared distance from q (n,3) to the boxes [lo, hi] (n,3), in the
    kernel's order of operations."""
    g = torch.clamp_min(lo - q, 0.0) + torch.clamp_min(q - hi, 0.0)
    return (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + g[:, 2] * g[:, 2]


def _far_d2(q, lo, hi):
    g = torch.maximum(torch.abs(q - lo), torch.abs(q - hi))
    return (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + g[:, 2] * g[:, 2]


def _expand(parent, start, count):
    """Rows ``parent`` (n,) each repeated count[parent] times, with the
    children's indices start[parent] + 0..count-1."""
    c = count[parent]
    rep = torch.repeat_interleave(torch.arange(parent.numel(),
                                               device=parent.device), c)
    first = torch.cumsum(c, 0) - c
    child = start[parent][rep] + (torch.arange(rep.numel(),
                                               device=parent.device)
                                  - first[rep])
    return rep, child


def knn_grid_ref(queries, points, k: int, n_q, n_p, levels: int,
                 cell: float, block: int = 1 << 16):
    """Plain PyTorch twin of the kernel (module docstring): (dists (Q,k)
    f32, idx (Q,k) int64). ``block`` queries are walked at a time."""
    dev = queries.device
    Q = queries.shape[0]
    nq, npt = int(n_q), int(n_p)
    nq, npt = min(max(nq, 0), Q), min(max(npt, 0), points.shape[0])
    dists = torch.full((Q, k), torch.inf, dtype=torch.float32, device=dev)
    idx = torch.zeros((Q, k), dtype=torch.int64, device=dev)
    if nq == 0 or npt == 0:
        return dists, idx
    pts = points[:npt].float()
    code, order = torch.sort(cell_codes(pts, levels, cell), stable=True)
    sp = pts[order]
    # the octree's non-empty nodes, level by level (level 0: the cells),
    # each with its tight box and its range of the sorted points
    nodes = []
    for lev in range(levels + 1):
        key, cnt = torch.unique_consecutive(code >> (3 * lev),
                                            return_counts=True)
        first = torch.cumsum(cnt, 0) - cnt
        owner = torch.repeat_interleave(torch.arange(key.numel(), device=dev),
                                        cnt)
        lo = torch.full((key.numel(), 3), torch.inf, device=dev)
        hi = torch.full((key.numel(), 3), -torch.inf, device=dev)
        lo = lo.scatter_reduce(0, owner[:, None].expand(-1, 3), sp, "amin")
        hi = hi.scatter_reduce(0, owner[:, None].expand(-1, 3), sp, "amax")
        nodes.append((key, cnt, first, lo, hi))
    # children of each node: a range of the next level's nodes
    kids = []
    for lev in range(levels, 0, -1):
        key, below = nodes[lev][0], nodes[lev - 1][0]
        start = torch.searchsorted(below, key << 3)
        kids.append((start, torch.searchsorted(below, (key + 1) << 3) - start))
    q_all = queries.float()
    for b0 in range(0, nq, block):
        rows = torch.arange(b0, min(b0 + block, nq), device=dev)
        q = q_all[rows]
        ok = torch.isfinite(q).all(1)
        rows, q = rows[ok], q[ok]
        nb = rows.numel()
        ub = torch.full((nb,), torch.inf, device=dev)
        qi = torch.arange(nb, device=dev)
        node = torch.zeros(nb, dtype=torch.long, device=dev)   # the root
        for lev in range(levels, -1, -1):
            _, cnt, _, lo, hi = nodes[lev]
            qq = q[qi]
            near = _box_d2(qq, lo[node], hi[node])
            full = cnt[node] >= k
            if bool(full.any()):
                ub = ub.scatter_reduce(0, qi[full],
                                       _far_d2(qq[full], lo[node[full]],
                                               hi[node[full]]), "amin")
            keep = near <= ub[qi]
            qi, node = qi[keep], node[keep]
            if lev:
                start, count = kids[levels - lev]
                rep, node = _expand(node, start, count)
                qi = qi[rep]
        # the surviving cells' points, ranked by (d2, index)
        _, cnt, first, _, _ = nodes[0]
        rep, pos = _expand(node, first, cnt)
        qi = qi[rep]
        d = q[qi] - sp[pos]
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        key = _keys(d2, order[pos])
        for s in range(k):
            best = torch.full((nb,), INT64_MAX, dtype=torch.int64, device=dev)
            best = best.scatter_reduce(0, qi, key, "amin")
            got = best < INT64_MAX
            bd2 = (best >> 32).int().view(torch.float32)
            # through float64: correctly rounded, as the kernel's sqrtf
            dists[rows[got], s] = torch.sqrt(bd2[got].double()).float()
            idx[rows[got], s] = best[got] & 0xFFFFFFFF
            key = torch.where(key == best[qi], INT64_MAX, key)
    return dists, idx


def _count(n, device) -> torch.Tensor:
    """A count as a 0-d int32 tensor on ``device`` (an int is uploaded, a
    device tensor converted on the device)."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(n), dtype=torch.int32, device=device)


# (points, n_points (int32 on the card), P, levels, 1/cell, counts, codes,
#  ranks, stream)
_BIN = cuda_lib.KERNELS.entry(
    "dfb_knn_grid_bin", PTR, PTR, INT, INT, FLOAT, PTR, PTR, PTR, PTR,
    kernel="knn_grid_bin_kernel")
# (points, n_points, P, offsets, codes, ranks, sorted float4, stream)
_SCATTER = cuda_lib.KERNELS.entry(
    "dfb_knn_grid_scatter", PTR, PTR, INT, PTR, PTR, PTR, PTR, PTR,
    kernel="knn_grid_scatter_kernel")
# (queries, n_queries (int32 on the card), Q, sorted, offsets, levels,
#  cell, k, dists, idx, stream)
_QUERY = cuda_lib.KERNELS.entry(
    "dfb_knn_grid_query", PTR, PTR, INT, PTR, PTR, INT, FLOAT, INT, PTR, PTR,
    PTR, kernel="knn_grid_query_kernel")
# (k, out[6])
_QUERY_INFO = cuda_lib.KERNELS.entry("dfb_knn_grid_query_info", INT, BUF)


@cuda_lib.wrapper(_BIN)
def grid_bin(points, n_p, levels: int, cell: float):
    """Each of the first ``n_p`` points' cell code and rank in its cell,
    and the cells' counts (8^levels,) int32 (``knn_grid_bin_kernel``)."""
    dev = points.device
    P = points.shape[0]
    cnt = torch.zeros(1 << (3 * levels), dtype=torch.int32, device=dev)
    code = torch.empty(P, dtype=torch.int32, device=dev)
    rank = torch.empty(P, dtype=torch.int32, device=dev)
    _BIN(points.data_ptr(), n_p.data_ptr(), P, levels, 1.0 / cell,
         cnt.data_ptr(), code.data_ptr(), rank.data_ptr(),
         cuda_lib.stream_ptr(dev))
    return code, rank, cnt


@cuda_lib.wrapper(_SCATTER)
def grid_scatter(points, n_p, off, code, rank):
    """The first ``n_p`` points in cell order as float4 (x, y, z, index
    bits) (P,4) (``knn_grid_scatter_kernel``)."""
    sorted_pts = torch.empty((points.shape[0], 4), dtype=torch.float32,
                             device=points.device)
    _SCATTER(points.data_ptr(), n_p.data_ptr(), points.shape[0],
             off.data_ptr(), code.data_ptr(), rank.data_ptr(),
             sorted_pts.data_ptr(), cuda_lib.stream_ptr(points.device))
    return sorted_pts


def grid_build(points, n_p, levels: int, cell: float):
    """The kernel's search structure over the first ``n_p`` (a 0-d int32
    tensor on the card) of ``points`` (P,3) on the card: (the points in
    cell order, the cells' offsets into them (8^levels + 1,) int32)."""
    points = points.contiguous()
    code, rank, cnt = grid_bin(points, n_p, levels, cell)
    off = torch.zeros(cnt.numel() + 1, dtype=torch.int32,
                      device=points.device)
    torch.cumsum(cnt, 0, dtype=torch.int32, out=off[1:])
    return grid_scatter(points, n_p, off, code, rank), off


def grid_query(queries, n_q, sorted_pts, off, k: int, levels: int,
               cell: float):
    """K7 proper: the first ``n_q`` (0-d int32 on the card) ``queries``
    (Q,3) searched in :func:`grid_build`'s structure. Returns (dists
    (Q,k) f32, idx (Q,k) int64). Its launches count in
    ``knn_grid.launches``."""
    dev = queries.device
    Q = queries.shape[0]
    dists = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int64, device=dev)
    queries = queries.contiguous()
    _QUERY(queries.data_ptr(), n_q.data_ptr(), Q, sorted_pts.data_ptr(),
           off.data_ptr(), levels, float(cell), k, dists.data_ptr(),
           idx.data_ptr(), cuda_lib.stream_ptr(dev))
    return dists, idx


def _check(queries, points, k: int, n_q, n_p, extent: float, cell=None):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_grid: k = {k}, need 1..{MAX_K}")
    for name, t in (("queries", queries), ("points", points)):
        if t.dim() != 2 or t.shape[1] != 3 or t.dtype != torch.float32:
            raise ValueError(f"knn_grid: {name} must be (n,3) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if queries.device != points.device:
        raise ValueError("knn_grid: queries and points on two devices")


def _twin(queries, points, k: int, n_q, n_p, extent: float, cell=None):
    """The CPU's knn_grid: the plain twin, which reads the counts on the
    host."""
    cell = leaf_cell(extent) if cell is None else cell
    return knn_grid_ref(queries, points, k, n_q, n_p,
                        grid_levels(extent, cell), cell)


@cuda_lib.wrapper(_QUERY, twin=_twin, check=_check)
def knn_grid(queries, points, k: int, n_q, n_p, extent: float,
             cell: float | None = None):
    """k nearest of the first ``n_p`` ``points`` (P,3) for each of the
    first ``n_q`` ``queries`` (Q,3), lattice coordinates on [0, extent)³
    (module docstring): (dists (Q,k) f32, idx (Q,k) int64). ``cell`` (a
    power of two) overrides :func:`leaf_cell`'s, for the tools. The kernel
    reads the counts on the card."""
    cell = leaf_cell(extent) if cell is None else cell
    levels = grid_levels(extent, cell)
    dev = queries.device
    if max(queries.shape[0], points.shape[0]) * max(k, 3) >= 2**31:
        raise ValueError(f"knn_grid: {queries.shape[0]} queries or "
                         f"{points.shape[0]} points: the kernel indexes at "
                         f"most 2^31 with 32 bits")
    sorted_pts, off = grid_build(points, _count(n_p, dev), levels, cell)
    return grid_query(queries, _count(n_q, dev), sorted_pts, off, k, levels,
                      cell)


def kernel_info(k: int = 4) -> dict:
    """What the card makes of the query kernel for ``k``, as
    :func:`cuda_lib.info` reads it, with static shared bytes. Needs the
    card."""
    return cuda_lib.info(_QUERY_INFO, k)
