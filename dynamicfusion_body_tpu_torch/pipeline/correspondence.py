"""Closest-point correspondences — counterpart of
``dynamicfusion_body_tpu/pipeline/correspondence.py:
closest_point_correspondences`` (reference core/fusion.py:251-276).

Warp each canonical vertex into the live frame, take its k nearest live
vertices, choose the candidate with the least point-to-plane cost
|n·(v−p)| under the reference's best_cost = 1 cap (falling back to the
nearest candidate when none beats it), and accept when best_cost <=
tolerance. The cached-candidate (``reuse_corr``), grid and feature paths
are ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

import torch

from ..ops.knn import knn


def closest_point_correspondences(
    warped_verts, warped_normals, vert_mask, live_verts, live_mask,
    k: int, tolerance: float, approx: bool | str = False,
):
    """Returns (corr (V,3), corr_valid (V,) bool, best_cost (V,)).
    ``approx`` must be False (exact search); other values raise."""
    _, idx = knn(warped_verts, live_verts, k, valid=live_mask, approx=approx)
    cand = live_verts[idx]                                   # (V, k, 3)
    cost = torch.abs(torch.sum(
        warped_normals[:, None, :] * (warped_verts[:, None, :] - cand), -1))
    cand_valid = live_mask[idx]
    cost = torch.where(cand_valid, cost, torch.inf)
    best = torch.argmin(cost, dim=1)
    min_cost = torch.gather(cost, 1, best[:, None])[:, 0]
    use_min = min_cost < 1.0
    best_pt = torch.where(
        use_min[:, None],
        torch.gather(cand, 1, best[:, None, None].expand(-1, 1, 3))[:, 0],
        cand[:, 0],
    )
    best_cost = torch.where(use_min, min_cost, 1.0)
    valid = vert_mask & (best_cost <= tolerance) & cand_valid[:, 0]
    return best_pt, valid, best_cost
