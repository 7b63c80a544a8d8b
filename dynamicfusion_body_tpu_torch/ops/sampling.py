"""Greedy radius subsample and furthest-point sampling — counterparts of
``dynamicfusion_body_tpu/ops/sampling.py:radius_subsample`` and
``:furthest_point_sample``.

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

from ..utils.profiling import host_read


def radius_subsample(points, radius, capacity: int, valid=None):
    """Greedy radius subsample with fixed output capacity.

    points (N,3); radius: float or 0-d tensor; valid: optional (N,) bool
    (invalid points are never selected and never suppress others).
    Returns (indices (capacity,) int64, count 0-d int64); slots >= count
    hold index 0."""
    dev = points.device
    out = torch.zeros(capacity, dtype=torch.long, device=dev)
    # invalid points start committed and unselected, so they neither
    # suppress nor block anyone: the loop runs over the valid ones only
    # (in index order), and the picks map back through ``keep``
    if valid is None:
        keep = torch.arange(points.shape[0], device=dev)
    else:
        with host_read():
            keep = torch.nonzero(valid).flatten()
    n = keep.numel()
    if n == 0:
        return out, torch.zeros((), dtype=torch.long, device=dev)
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    r2 = r * r
    pts = points[keep].float()
    pp = torch.sum(pts * pts, dim=-1)
    chunk = max(128, min(2048, (1 << 26) // n))
    gidx = torch.arange(n, device=dev)

    committed = torch.zeros(n, dtype=torch.bool, device=dev)
    selected = torch.zeros(n, dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < n:
        with host_read():  # one read a round
            done = bool(torch.all(committed))
        if done:
            break
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

    with host_read():
        chosen = keep[torch.nonzero(selected).flatten()[:capacity]]
    out[: chosen.numel()] = chosen
    with host_read():
        count = torch.tensor(chosen.numel(), device=dev)
    return out, count


def furthest_point_sample(points, n_samples: int, start_idx: int = 0):
    """Deterministic FPS: iteratively pick the point furthest from the set
    (reference core/meshutil.py:72-90, from a deterministic start). Each
    of the ``n_samples`` steps folds the newest pick into every point's
    nearest-pick distance; ties go to the first maximum, as
    ``jnp.argmax``'s. Returns (indices (n_samples,) int64, assign (N,)
    int64: the step whose pick is each point's nearest, the first on a
    tie)."""
    n = points.shape[0]
    dev = points.device
    idxs = torch.zeros(n_samples, dtype=torch.long, device=dev)
    idxs[0] = start_idx
    d2 = torch.full((n,), 1e10, dtype=points.dtype, device=dev)
    assign = torch.zeros(n, dtype=torch.long, device=dev)
    for i in range(n_samples):
        nd2 = torch.sum((points - points[idxs[i]]) ** 2, dim=-1)
        upd = nd2 < d2
        d2 = torch.where(upd, nd2, d2)
        assign = torch.where(upd, i, assign)
        if i + 1 < n_samples:
            idxs[i + 1] = torch.argmax(d2)
    return idxs, assign
