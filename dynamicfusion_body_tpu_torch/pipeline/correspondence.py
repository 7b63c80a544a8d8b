"""Correspondence search between canonical and live surfaces —
counterpart of ``dynamicfusion_body_tpu/pipeline/correspondence.py``.

Closest-point (ICP-style) path, reference semantics
(core/fusion.py:251-276, core/fusion_dm.py:219-244): warp each canonical
vertex into the live frame, take its k nearest live vertices, choose the
candidate with the least point-to-plane cost |n·(v−p)| under the
reference's best_cost = 1 cap (falling back to the nearest candidate when
none beats it), and accept when best_cost <= tolerance.

Variants: the flat exact search, the bf16-keyed search (``approx=True``)
and the two-level pools (``"2level"``); the exact lattice search (K7) over
counted rows (:func:`closest_point_correspondences_lattice`, the rigid
ICP's, which on the card runs with its one-DQ warp and its pick as K9,
``ops/icp_pick_cuda.py``); the grid-hash search
(:func:`closest_point_correspondences_grid`); one candidate search per
frame re-ranked every solve round under a drift certificate
(:func:`correspondence_candidates`,
:func:`correspondences_from_candidates`); and the feature-space matcher
of the CNN path (:func:`feature_correspondences`) with its plane-cost
prune.
"""

from __future__ import annotations

import torch

from ..ops.dualquat import dq_transform_normal, dq_transform_point
from ..ops.grid_knn import grid_knn
from ..ops.knn import BIG, knn, knn_2level
from ..ops.knn_grid_cuda import knn_grid
from ..utils.profiling import span


def _pick(warped_verts, warped_normals, cand, cand_ok):
    """The reference's choice among (V,k,3) candidates ``cand`` (usable
    where ``cand_ok``): (best point (V,3), best_cost (V,))."""
    cost = torch.abs(torch.sum(
        warped_normals[:, None, :] * (warped_verts[:, None, :] - cand), -1))
    cost = torch.where(cand_ok, cost, torch.inf)
    best = torch.argmin(cost, dim=1)
    min_cost = torch.gather(cost, 1, best[:, None])[:, 0]
    use_min = min_cost < 1.0
    best_pt = torch.where(
        use_min[:, None],
        torch.gather(cand, 1, best[:, None, None].expand(-1, 1, 3))[:, 0],
        cand[:, 0],
    )
    return best_pt, torch.where(use_min, min_cost, 1.0)


def closest_point_correspondences(
    warped_verts, warped_normals, vert_mask, live_verts, live_mask,
    k: int, tolerance: float, approx: bool | str = False,
):
    """Returns (corr (V,3), corr_valid (V,) bool, best_cost (V,)).
    ``approx``: False the flat exact search, True the bf16-keyed search,
    ``"2level"`` the chunked pools over the marching-cubes vertex order
    (``ops/knn.py``)."""
    if approx == "2level":
        _, idx, _ = knn_2level(warped_verts, live_verts, k, qvalid=vert_mask,
                               valid=live_mask)
    else:
        _, idx = knn(warped_verts, live_verts, k, valid=live_mask,
                     approx=approx)
    cand_valid = live_mask[idx]
    best_pt, best_cost = _pick(warped_verts, warped_normals, live_verts[idx],
                               cand_valid)
    valid = vert_mask & (best_cost <= tolerance) & cand_valid[:, 0]
    return best_pt, valid, best_cost


def closest_point_correspondences_lattice(
    warped_verts, warped_normals, n_verts, live_verts, n_live, k: int,
    tolerance: float, extent: float,
):
    """:func:`closest_point_correspondences` over the first ``n_verts``
    warped vertices and the first ``n_live`` live ones (0-d counts on the
    device, as the marching cubes return them), the search exact on the
    lattice [0, extent)³ (K7, ``ops/knn_grid_cuda.py``; span ``knn``),
    with no host read. Rows past ``n_verts`` come out invalid."""
    with span("knn"):
        d, idx = knn_grid(warped_verts, live_verts, k, n_verts, n_live,
                          extent)
    found = torch.isfinite(d)
    best_pt, best_cost = _pick(warped_verts, warped_normals, live_verts[idx],
                               found)
    rows = torch.arange(warped_verts.shape[0], device=warped_verts.device)
    valid = (rows < n_verts) & (best_cost <= tolerance) & found[:, 0]
    return best_pt, valid, best_cost


def rigid_correspondences_twin(dq, verts, normals, n_verts, live_verts,
                               n_live, k: int, tolerance: float,
                               extent: float):
    """:func:`closest_point_correspondences_lattice` of the canonical
    ``verts``/``normals`` moved by the one pose ``dq``: the plain
    composition that K9 (``ops/icp_pick_cuda.py:
    rigid_correspondences_lattice``) runs as kernels on the card, and
    that the CPU runs."""
    wv = dq_transform_point(dq, verts)
    wn = dq_transform_normal(dq, normals)
    return closest_point_correspondences_lattice(
        wv, wn, n_verts, live_verts, n_live, k, tolerance, extent)


def closest_point_correspondences_grid(
    warped_verts, warped_normals, vert_mask, live_verts, live_mask,
    k: int, tolerance: float, grid_n: int, cell: float = 16.0,
):
    """The grid-hash variant for voxel-lattice coordinates: exact within a
    ±cell/2 neighbourhood; a vertex with no live vertex in range is
    invalid, and when any cell overflowed its candidate cap every vertex
    is (a truncated candidate set is not matched against)."""
    _, idx, found, overflow = grid_knn(
        warped_verts, live_verts, k, valid=live_mask, cell=cell,
        grid_n=grid_n)
    best_pt, best_cost = _pick(warped_verts, warped_normals, live_verts[idx],
                               found)
    valid = vert_mask & (best_cost <= tolerance) & found[:, 0] & ~overflow
    return best_pt, valid, best_cost


def correspondence_candidates(warped_verts, vert_mask, live_verts, live_mask,
                              kc: int, approx: bool | str = False):
    """One candidate search per frame, at the frame-entry warp, that every
    solve round re-ranks: returns (cand_idx (V,kc), d_kc (V,) the kc-th
    candidate's distance from the base warped position, n_risk). With
    ``approx="2level"`` the pools' own uncertified count is ``n_risk``;
    otherwise it is 0."""
    if approx == "2level":
        d, idx, n_risk = knn_2level(warped_verts, live_verts, kc,
                                    qvalid=vert_mask, valid=live_mask)
    else:
        d, idx = knn(warped_verts, live_verts, kc, valid=live_mask,
                     approx=approx)
        n_risk = torch.zeros((), dtype=torch.long, device=idx.device)
    return idx, d[:, -1], n_risk


def correspondences_from_candidates(
    warped_verts, warped_normals, vert_mask, live_verts, live_mask,
    cand_idx, d_kc, base_warped, k: int, tolerance: float,
):
    """:func:`closest_point_correspondences` against the cached candidates
    ``cand_idx`` (V,kc): k first-min argmin passes over them (ties to the
    earlier candidate, i.e. the nearer from the base), the reference's
    choice among the k, and the ball certificate. Returns (corr, valid,
    best_cost, n_risk).

    Every live vertex outside the cached set is at least d_kc from
    ``base_warped``, so at least d_kc − δ from the current position (δ =
    |warped − base|): the re-ranked top-k equals a fresh exact search
    wherever d(current, k-th chosen) < d_kc − δ. ``n_risk`` counts the
    valid vertices where that fails."""
    cand = live_verts[cand_idx]                               # (V, kc, 3)
    cvalid = live_mask[cand_idx]
    wv = warped_verts
    dx = wv[:, 0:1] - cand[..., 0]
    dy = wv[:, 1:2] - cand[..., 1]
    dz = wv[:, 2:3] - cand[..., 2]
    d2 = torch.where(cvalid, dx * dx + dy * dy + dz * dz, BIG)
    dwork = d2.clone()
    sel_cols = []
    for _ in range(k):
        am = torch.argmin(dwork, dim=1, keepdim=True)
        dk_last = torch.gather(dwork, 1, am)[:, 0]
        sel_cols.append(am)
        dwork.scatter_(1, am, BIG)
    sel = torch.cat(sel_cols, dim=1)                          # (V, k)

    scand = torch.gather(cand, 1, sel[:, :, None].expand(-1, -1, 3))
    sval = torch.gather(cvalid, 1, sel) & (torch.gather(d2, 1, sel) < 1e30)
    sx, sy, sz = scand[..., 0], scand[..., 1], scand[..., 2]
    wn = warped_normals
    cost = torch.abs(wn[:, 0:1] * (wv[:, 0:1] - sx)
                     + wn[:, 1:2] * (wv[:, 1:2] - sy)
                     + wn[:, 2:3] * (wv[:, 2:3] - sz))
    cost = torch.where(sval, cost, torch.inf)
    best = torch.argmin(cost, dim=1, keepdim=True)
    min_cost = torch.gather(cost, 1, best)[:, 0]
    use_min = min_cost < 1.0
    pick = torch.where(use_min[:, None], best, 0)
    best_pt = torch.gather(scand, 1, pick[:, :, None].expand(-1, 1, 3))[:, 0]
    best_cost = torch.where(use_min, min_cost, 1.0)
    valid = vert_mask & (best_cost <= tolerance) & sval[:, 0]

    delta = torch.sqrt(torch.sum((wv - base_warped) ** 2, dim=-1))
    dk = torch.sqrt(torch.clamp_max(dk_last, BIG))
    n_risk = torch.sum(vert_mask & (dk >= d_kc - delta))
    return best_pt, valid, best_cost, n_risk


def feature_correspondences(canon_feats, vert_mask, live_feats, live_verts,
                            live_mask):
    """Feature-space 1-NN matching (CNN path, reference
    core/fusion.py:277-296): each canonical vertex takes the live vertex
    whose descriptor is nearest. Returns (corr (V,3), valid (V,)); the
    point-to-plane prune (:func:`prune_by_plane_cost`) comes after."""
    _, idx = knn(canon_feats, live_feats, 1, valid=live_mask)
    return live_verts[idx[:, 0]], vert_mask & live_mask[idx[:, 0]]


def prune_by_plane_cost(warped_verts, warped_normals, corrs, valid,
                        tolerance: float):
    """Reject correspondences with |n·(v−c)| > tolerance (reference
    core/fusion.py:287-296). Returns (valid, cost)."""
    cost = torch.abs(torch.sum(warped_normals * (warped_verts - corrs), -1))
    return valid & (cost <= tolerance), cost
