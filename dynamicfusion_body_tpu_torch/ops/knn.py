"""Brute-force k-nearest-neighbour search — counterpart of
``dynamicfusion_body_tpu/ops/knn.py`` (``knn``, ``nearest``,
``knn_2level``).

Distances use the expanded form ‖q‖² − 2 q·p + ‖p‖² (one float32 matmul
per query chunk), candidates are picked on those, and the exact distances
of the picked points are recomputed by direct differences. Ties go to the
lowest point index, as scipy's KDTree does: an index-proportional 1e-12 is
added before the selection, then ``k <= 4`` runs k first-min argmin passes
and larger k a top-k that breaks the remaining ties to the lower index
(:func:`smallest_k`).

``approx=True`` computes what the JAX package computes off the TPU. There
``jax.lax.approx_max_k`` is an exact top-k, and the card has no hardware
approximate top-k either: the keys are the f32 distances less a per-query
estimate of the nearest one (from a 1/16 subsample of the points),
rounded to bf16, then exactly selected with lowest-index ties; the picks'
exact distances are re-sorted stably. :func:`knn_2level` is the chunked
two-level search over spatially coherent query batches, exact within its
certified pools.
"""

from __future__ import annotations

import torch

BIG = 3.4e38  # the JAX package's stand-in for +inf in masked distances


def pairwise_sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(Q,D),(P,D) → (Q,P) squared distances, clamped at 0."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    pp = torch.sum(p * p, dim=-1)
    cross = q @ p.T
    return torch.clamp_min(qq - 2.0 * cross + pp[None, :], 0.0)


def smallest_k(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the k smallest f32 ``keys`` of each row (-0 taken
    as +0), ascending, equal keys in ascending column order: the first k
    of a stable ascending sort.

    A float top-k of k + 1 fixes the row's k picks wherever its k-th and
    (k+1)-th smallest keys differ; the picks are then ordered by (key,
    column). Rows where those two tie (a tie across the boundary, or
    fewer than k + 1 finite keys) take :func:`_smallest_k_exact`; finding
    them is one host read a call."""
    if k >= keys.shape[-1]:
        return torch.sort(keys + 0.0, dim=-1, stable=True).indices[..., :k]
    vals, idx = torch.topk(keys, k + 1, dim=-1, largest=False)
    tied = vals[..., k - 1] == vals[..., k]
    idx, by_col = torch.sort(idx[..., :k], dim=-1)
    vals = torch.gather(vals[..., :k], -1, by_col) + 0.0
    idx = torch.gather(idx, -1, torch.sort(vals, dim=-1, stable=True).indices)
    if bool(tied.any()):
        idx[tied] = _smallest_k_exact(keys[tied], k)
    return idx


def _smallest_k_exact(keys: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`smallest_k` by a top-k that meets no tie: each key becomes an
    int64 that orders as the float (sign-folded bits, -0 taken as +0) in
    its upper half with the column in its lower half."""
    bits = (keys + 0.0).view(torch.int32).long()
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(keys.shape[-1], device=keys.device)
    return torch.topk((bits << 32) + col, k, dim=-1, largest=False).indices


def _approx_keys(qc, points, valid):
    """The approximate path's bf16 selection keys of one query chunk
    (``ops/knn.py:77-110`` of the JAX package), as f32."""
    qq = torch.sum(qc * qc, dim=-1, keepdim=True)
    pp = torch.sum(points * points, dim=-1)
    d2_sub = qq - 2.0 * (qc @ points[::16].T) + pp[::16][None, :]
    if valid is not None:
        d2_sub = torch.where(valid[::16][None, :], d2_sub, torch.inf)
    est = torch.amin(d2_sub, dim=1, keepdim=True)
    est = torch.where(torch.isfinite(est), est, 0.0)
    d2c = (qq - 2.0 * (qc @ points.T) + pp[None, :] - est).to(torch.bfloat16)
    if valid is not None:
        d2c = torch.where(valid[None, :], d2c, torch.inf)
    return d2c.float()


def knn(queries, points, k: int, valid=None, approx: bool = False):
    """k-NN: (dists (Q,k) f32, idx (Q,k) int64), ascending.

    ``valid`` (P,) masks pool slots out (distance +inf; such a slot is only
    returned when fewer than k valid points exist). Queries run in chunks
    that bound the (chunk, P) distance matrix. ``approx=True`` selects on
    bf16 keys (module docstring)."""
    npts = points.shape[0]
    k = min(k, npts)
    chunk = max(256, min(8192, (1 << 27) // max(npts, 1)))
    tie = torch.arange(npts, dtype=torch.float32, device=points.device)
    tie = tie * 1e-12
    dists, idxs = [], []
    for start in range(0, queries.shape[0], chunk):
        qc = queries[start:start + chunk]
        if approx:
            idx = smallest_k(_approx_keys(qc, points, valid), k)
        else:
            d2 = pairwise_sqdist(qc, points)
            if valid is not None:
                d2 = torch.where(valid[None, :], d2, torch.inf)
            dwork = d2 + tie[None, :]
            if k <= 4:
                cols = []
                for _ in range(k):
                    am = torch.argmin(dwork, dim=1)
                    cols.append(am)
                    dwork.scatter_(1, am[:, None], torch.inf)
                idx = torch.stack(cols, dim=1)
            else:
                idx = smallest_k(dwork, k)
        sel = points[idx]
        d2s = torch.sum((qc[:, None, :] - sel) ** 2, dim=-1)
        if valid is not None:
            d2s = torch.where(valid[idx], d2s, torch.inf)
        if approx:  # the bf16 keys only ranked coarsely
            d2s, order = torch.sort(d2s, dim=1, stable=True)
            idx = torch.gather(idx, 1, order)
        dists.append(torch.sqrt(d2s))
        idxs.append(idx)
    if not idxs:
        empty = queries.new_zeros((0, k))
        return empty, empty.long()
    return torch.cat(dists), torch.cat(idxs)


def nearest(queries, points, valid=None):
    """1-NN: (dist (Q,), idx (Q,))."""
    d, i = knn(queries, points, 1, valid=valid)
    return d[:, 0], i[:, 0]


def knn_2level(queries, points, k: int, qvalid=None, valid=None,
               chunk: int = 1024, pool: int = 4096):
    """Two-level kNN for spatially coherent query batches (marching-cubes
    vertex order): per ``chunk`` consecutive queries, the ``pool`` points
    nearest the chunk's centroid (of its valid queries), then the exact
    f32 search within that pool, ties to the lowest point index.

    Returns (dists (Q,k), idx (Q,k) int64, n_risk): ``n_risk`` counts the
    valid queries whose k-th neighbour the pool-ball bound cannot certify
    (any point outside the pool is at least r_pool − d(q, centroid) away),
    unless the pool holds every valid point. A query not at risk gets its
    exact k nearest (by direct differences; the flat search selects on
    the expanded form, whose rounding can swap near-equal neighbours).
    The pool is taken by a stable ascending
    sort, as ``lax.top_k`` orders ties (the fine level's first-min
    tie-break reads pool order)."""
    dev = queries.device
    n_q, npts = queries.shape[0], points.shape[0]
    pool = min(pool, npts)
    k = min(k, pool)
    pad = (-n_q) % chunk
    qp = torch.nn.functional.pad(queries, (0, 0, 0, pad))
    if qvalid is None:
        qv = torch.arange(qp.shape[0], device=dev) < n_q
    else:
        qv = torch.nn.functional.pad(qvalid, (0, pad))
    nch = qp.shape[0] // chunk
    q3 = qp.reshape(nch, chunk, 3)
    qm = qv.reshape(nch, chunk)
    cnt = torch.sum(qm.float(), dim=1)
    cent = torch.sum(q3 * qm[:, :, None].float(), dim=1) / torch.clamp_min(
        cnt, 1.0)[:, None]

    # coarse level: the pool points nearest each chunk centroid
    d2c = pairwise_sqdist(cent, points)                       # (nch, P)
    if valid is not None:
        d2c = torch.where(valid[None, :], d2c, torch.inf)
    d2c, pidx = torch.sort(d2c, dim=1, stable=True)
    r_pool2 = d2c[:, pool - 1]
    pidx = pidx[:, :pool]
    ppts = points[pidx]                                       # (nch, pool, 3)
    pv = (valid[pidx] if valid is not None
          else torch.ones((nch, pool), dtype=torch.bool, device=dev))

    # fine level: exact f32 distances within the pool
    dx = q3[:, :, 0:1] - ppts[:, None, :, 0]
    dy = q3[:, :, 1:2] - ppts[:, None, :, 1]
    dz = q3[:, :, 2:3] - ppts[:, None, :, 2]
    d2 = dx * dx + dy * dy + dz * dz                          # (nch, chunk, pool)
    del dx, dy, dz
    d2 = torch.where(pv[:, None, :], d2, BIG)
    tie = torch.arange(npts, dtype=torch.float32, device=dev) * 1e-12
    dwork = d2 + tie[pidx][:, None, :]
    cols_d, cols_i = [], []
    for _ in range(k):
        am = torch.argmin(dwork, dim=2, keepdim=True)          # (nch, chunk, 1)
        cols_d.append(torch.gather(d2, 2, am)[:, :, 0])
        cols_i.append(torch.gather(pidx, 1, am[:, :, 0]))
        dwork.scatter_(2, am, BIG)
    dk = torch.stack(cols_d, dim=-1)                          # (nch, chunk, k)
    ik = torch.stack(cols_i, dim=-1)

    # certificate: a miss is possible iff d(q, kth) + d(q, cent) >= r_pool
    dq_cent = torch.sqrt(torch.sum((q3 - cent[:, None, :]) ** 2, dim=2))
    dq_k = torch.sqrt(torch.clamp_max(dk[:, :, -1], BIG))
    r_pool = torch.sqrt(torch.clamp_min(r_pool2, 0.0))[:, None]
    at_risk = (dq_k + dq_cent >= r_pool) & qm & torch.isfinite(r_pool)
    if valid is not None:  # a pool that holds every valid point never misses
        at_risk = at_risk & (torch.sum(valid) > pool)
    elif npts <= pool:
        at_risk = torch.zeros_like(at_risk)
    n_risk = torch.sum(at_risk)

    d_out = torch.sqrt(torch.clamp_min(dk, 0.0)).reshape(-1, k)[:n_q]
    return d_out, ik.reshape(-1, k)[:n_q], n_risk
