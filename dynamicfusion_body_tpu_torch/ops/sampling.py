"""Greedy radius subsample — counterpart of
``dynamicfusion_body_tpu/ops/sampling.py:radius_subsample``.

Reference ``uniform_sample`` (core/util.py:27-47): greedy first-fit in
index order — take the first remaining point, drop every point within
``radius`` of it, repeat. The greedy loop runs in its fixpoint form, as in
the JAX package: per round, a point commits once no earlier point is
still undecided within the radius, and commits SELECTED iff no earlier
selected point lies within it. The round count is the dependency-chain
depth (tens), each round one blocked distance pass.

The distance test keeps the JAX package's expanded form
``‖q‖² − 2 q·p + ‖p‖² < r²`` so that points near the radius boundary
round the same way in both packages.
"""

from __future__ import annotations

import torch


def radius_subsample(points, radius, capacity: int, valid=None):
    """Greedy radius subsample with fixed output capacity.

    points (N,3); radius: float or 0-d tensor; valid: optional (N,) bool
    (invalid points are never selected and never suppress others).
    Returns (indices (capacity,) int64, count 0-d int64); slots >= count
    hold index 0."""
    n = points.shape[0]
    dev = points.device
    out = torch.zeros(capacity, dtype=torch.long, device=dev)
    if n == 0:
        return out, torch.zeros((), dtype=torch.long, device=dev)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    r2 = r * r
    pts = points.float()
    pp = torch.sum(pts * pts, dim=-1)
    chunk = max(128, min(2048, (1 << 26) // n))
    gidx = torch.arange(n, device=dev)

    committed = ~valid
    selected = torch.zeros(n, dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < n and not bool(torch.all(committed)):
        conflict = torch.empty_like(selected)
        blocked = torch.empty_like(selected)
        for c0 in range(0, n, chunk):
            q = pts[c0:c0 + chunk]
            qq = torch.sum(q * q, dim=-1, keepdim=True)
            d2 = qq - 2.0 * (q @ pts.T) + pp[None, :]
            lower = gidx[None, :] < gidx[c0:c0 + chunk, None]
            near = (d2 < r2) & lower
            conflict[c0:c0 + chunk] = torch.any(near & selected[None, :], 1)
            blocked[c0:c0 + chunk] = torch.any(near & ~committed[None, :], 1)
        new_sel = ~committed & ~conflict & ~blocked
        new_rej = ~committed & conflict
        selected = selected | new_sel
        committed = committed | new_sel | new_rej
        rounds += 1

    chosen = torch.nonzero(selected).flatten()[:capacity]
    out[: chosen.numel()] = chosen
    return out, torch.tensor(chosen.numel(), device=dev)
