"""Exact brute-force k-nearest-neighbour search — counterpart of
``dynamicfusion_body_tpu/ops/knn.py`` (the ``approx=False`` branch of
``_knn_impl``).

Distances use the expanded form ‖q‖² − 2 q·p + ‖p‖² (one float32 matmul
per query chunk), candidates are picked on those, and the exact distances
of the picked points are recomputed by direct differences. Ties go to the
lowest point index, as scipy's KDTree does: an index-proportional 1e-12 is
added before the selection, then ``k <= 4`` runs k first-min argmin passes
and larger k a stable sort. The TPU's hardware approximate top-k has no
counterpart here; ``approx=True`` and ``"2level"`` raise.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(Q,D),(P,D) → (Q,P) squared distances, clamped at 0."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    pp = torch.sum(p * p, dim=-1)
    cross = q @ p.T
    return torch.clamp_min(qq - 2.0 * cross + pp[None, :], 0.0)


def knn(queries, points, k: int, valid=None, approx: bool | str = False):
    """Exact k-NN: (dists (Q,k) f32, idx (Q,k) int64), ascending.

    ``valid`` (P,) masks pool slots out (distance +inf; such a slot is only
    returned when fewer than k valid points exist). Queries run in chunks
    that bound the (chunk, P) distance matrix."""
    if approx:
        raise NotImplementedError(
            "approximate kNN (TPU approx_max_k / 2-level pools) is not "
            "ported; see ROADMAP.md Queue 1 item 11"
        )
    npts = points.shape[0]
    k = min(k, npts)
    chunk = max(256, min(8192, (1 << 27) // max(npts, 1)))
    tie = torch.arange(npts, dtype=torch.float32, device=points.device)
    tie = tie * 1e-12
    dists, idxs = [], []
    for start in range(0, queries.shape[0], chunk):
        qc = queries[start:start + chunk]
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
            idx = torch.sort(dwork, dim=1, stable=True).indices[:, :k]
        sel = points[idx]
        d2s = torch.sum((qc[:, None, :] - sel) ** 2, dim=-1)
        if valid is not None:
            d2s = torch.where(valid[idx], d2s, torch.inf)
        dists.append(torch.sqrt(d2s))
        idxs.append(idx)
    if not idxs:
        empty = queries.new_zeros((0, k))
        return empty, empty.long()
    return torch.cat(dists), torch.cat(idxs)
