"""Deformation graph / warp field: fixed-capacity node pool + DQB skinning.

Counterpart of ``dynamicfusion_body_tpu/models/warp_field.py``. Reference
semantics (core/fusion.py:101-239):

* graph construction — radius-subsample mesh vertices; every node starts
  at the reference's init DQ with dg_w = 2·radius;
* node insertion — re-anchor nodes, find vertices no kNN node supports
  (normalized distance >= 1), subsample them into free pool slots, and
  initialize their DQs by blending the existing field;
* the per-voxel non-rigid TSDF update — kNN nodes per voxel, DQB warp,
  trilerp of the live TSDF, running average with wi = mean node distance.

Per-voxel kNN is two-level, as in the JAX package: an exact kNN per 8³
brick over the node pool gives C candidates, then an exact top-k per voxel
among them. The per-voxel selection depends only on the node positions,
so it is cached (``build_warp_cache``) and the per-frame work is the
blend, warp and trilerp of the K2 kernel (``ops/trilerp_cuda.py``); an
update called without the cache selects per voxel inside the K3 kernel.

Compaction that the JAX package does by binary search over a cumsum
(``_compact_map``) is ``nonzero`` here, which keeps index order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops.bricks import vol_from_bricks, vol_to_bricks
from ..ops.dualquat import dq_blend, dq_transform_normal, dq_transform_point
from ..ops.interp import trilinear_c as _trilinear_c
from ..ops.knn import knn
from ..ops.sampling import radius_subsample
from ..ops.trilerp_cuda import (
    live_brick_mip,
    mip_skip_supported,
    warp_trilerp_bricks,
    warp_trilerp_bricks_cached,
    warp_voxels,
)
from ..utils.profiling import host_read

INIT_NODE_DQ = (1.0, 0.0, 0.0, 0.0, 0.0, 0.01, 0.01, 0.0)  # core/fusion.py:115
_BIG = 3.4e38


@dataclass(frozen=True)
class WarpField:
    """node_pos (M,3) f32; node_dq (M,8) f32; node_w (M,) f32 blend support
    (2·radius); node_vert_idx (M,) int64 anchor vertex; active (M,) bool;
    radius 0-d f32 sampling radius. Update with ``dataclasses.replace``."""

    node_pos: torch.Tensor
    node_dq: torch.Tensor
    node_w: torch.Tensor
    node_vert_idx: torch.Tensor
    active: torch.Tensor
    radius: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.node_pos.shape[0]

    @property
    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active)

    def replace(self, **changes) -> "WarpField":
        return dataclasses.replace(self, **changes)


def construct_graph(verts, radius, capacity: int, valid=None) -> WarpField:
    """Build the deformation graph from (masked) mesh vertices
    (reference core/fusion.py:101-116)."""
    dev = verts.device
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    idx, count = radius_subsample(verts, radius, capacity, valid=valid)
    active = torch.arange(capacity, device=dev) < count
    node_pos = torch.where(active[:, None], verts[idx], 0.0)
    return WarpField(
        node_pos=node_pos,
        node_dq=torch.tensor(INIT_NODE_DQ, device=dev).repeat(capacity, 1),
        node_w=(2.0 * radius).repeat(capacity),
        node_vert_idx=idx,
        active=active,
        radius=radius,
    )


def neighbor_lookup(wf: WarpField, verts, k: int):
    """Per-vertex kNN node table (V,k) — reference core/fusion.py:119-123."""
    return knn(verts, wf.node_pos, k, valid=wf.active)[1]


def blend_at(wf: WarpField, pos, nbr_idx):
    """Normalized blended DQs (...,8) at ``pos`` (...,3) over the nodes
    ``nbr_idx`` (...,k)."""
    return dq_blend(pos, wf.node_pos[nbr_idx], wf.node_dq[nbr_idx],
                    wf.node_w[nbr_idx], mask=wf.active[nbr_idx])


def warp_points(wf: WarpField, pos, nbr_idx, normals=None, m_lw=None):
    """DQB-skin points (and normals) into the live frame — reference
    ``warp`` (core/fusion.py:502-520), batched."""
    se3 = blend_at(wf, pos, nbr_idx)
    p = dq_transform_point(se3, pos)
    if m_lw is not None:
        p = dq_transform_point(m_lw, p)
    if normals is None:
        return p
    n = dq_transform_normal(se3, normals)
    if m_lw is not None:
        n = dq_transform_normal(m_lw, n)
    return p, n


def _grid_centers(n3, size: int, device, x_offset=0):
    """Centres of a size³-cell grid with n3 = (nx, ny, nz) cells, x-major
    (z fastest), as (nx·ny·nz, 3) f32, x shifted by ``x_offset``."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) * size
            + (size - 1) / 2.0 for n in n3]
    axes[0] = axes[0] + x_offset
    g = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([c.reshape(-1) for c in g], dim=-1)


def brick_candidates(wf: WarpField, shape, brick: int, n_candidates: int,
                     x_offset=0):
    """Exact kNN of every brick centre over the node pool → (NB, C); the
    lattice's x starts at ``x_offset`` (a sharded slab's origin)."""
    nb3 = [s // brick for s in shape]
    centers = _grid_centers(nb3, brick, wf.node_pos.device, x_offset)
    return knn(centers, wf.node_pos, n_candidates, valid=wf.active)[1]


def brick_candidates_2level(
    wf: WarpField, shape, brick: int, n_candidates: int, x_offset=0,
    s: int = 2, n_super: int = 192, with_risk: bool = False,
    risk_k: int | None = None, with_pool: bool = False,
):
    """Two-level ``brick_candidates``: exact top-``n_super`` nodes per
    super-brick of s³ bricks, then per brick the top-``n_candidates`` in
    its super's pool (first-min tie-break, as the flat search). Falls back
    to the flat search when the brick grid does not tile by ``s`` or the
    pool exceeds the node capacity.

    ``with_pool=True`` returns ``(cand, r_pool)`` with the per-super pool
    radii (NS,) for ``build_warp_cache``'s per-voxel certificate (None
    after the flat fallback). ``with_risk=True`` returns ``(cand, n)``:
    bricks where a pool-boundary miss is possible by the conservative
    brick-ball bound (JAX docstring). ``x_offset`` as in
    :func:`brick_candidates`."""
    nbx, nby, nbz = (d // brick for d in shape)
    if nbx % s or nby % s or nbz % s or n_super > wf.capacity:
        out = brick_candidates(wf, shape, brick, n_candidates, x_offset)
        if with_pool:
            return out, None
        zero = torch.zeros((), dtype=torch.long, device=out.device)
        return (out, zero) if with_risk else out
    dev = wf.node_pos.device
    nsx, nsy, nsz = nbx // s, nby // s, nbz // s
    NS = nsx * nsy * nsz
    sb = brick * s
    centers_s = _grid_centers((nsx, nsy, nsz), sb, dev, x_offset)
    sdist, sidx = knn(centers_s, wf.node_pos, n_super, valid=wf.active)
    spos = wf.node_pos[sidx]                               # (NS, n_super, 3)
    sact = wf.active[sidx]
    inner = _grid_centers((s, s, s), brick, dev)           # (s³, 3)
    bc = (centers_s - (sb - 1) / 2.0)[:, None, :] + inner[None, :, :]
    diff = bc[:, :, None, :] - spos[:, None, :, :]
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
    d2 = torch.where(sact[:, None, :], d2, _BIG)           # (NS, s³, n_super)

    C = n_candidates
    kth = C if risk_k is None else max(1, min(risk_k, C))
    picks = []
    kth_d2 = None
    for p in range(C):
        if p == kth - 1:
            kth_d2 = torch.amin(d2, dim=2)
        am = torch.argmin(d2, dim=2)
        picks.append(am)
        d2.scatter_(2, am[:, :, None], _BIG)
    local = torch.stack(picks, dim=-1)                     # (NS, s³, C)
    cand_s = torch.gather(sidx[:, None, :].expand(NS, s ** 3, n_super), 2,
                          local)
    out = cand_s.reshape(nsx, nsy, nsz, s, s, s, C)
    out = out.permute(0, 3, 1, 4, 2, 5, 6).reshape(nbx * nby * nbz, C)
    r_pool = sdist[:, -1]
    if with_pool:
        return out, r_pool
    if not with_risk:
        return out
    hd_b = (3.0 ** 0.5) * (brick - 1) / 2.0
    half = (sb - 1) / 2.0
    d_off = torch.sqrt(torch.sum((inner - half) ** 2, dim=-1))     # (s³,)
    d_c = torch.sqrt(torch.clamp_max(kth_d2, _BIG))
    at_risk = (d_c + 2.0 * hd_b + d_off[None, :]) >= r_pool[:, None]
    at_risk = at_risk & torch.isfinite(r_pool)[:, None]
    return out, torch.sum(at_risk)


def build_warp_cache(wf: WarpField, shape, cand, k: int, brick: int,
                     x_offset=0, pool_ctx=None, sfac: int = 2):
    """Per-voxel kNN selection cache for ``update_tsdf_nonrigid``.

    The per-voxel top-k choice among the brick's candidates, its Gaussian
    blend weights, and wi = mean node distance depend only on (node_pos,
    node_w, active), never on node_dq, so they are computed once per node
    set. Returns ``(sel, selw, wi)``:
      sel  (NB, V) int32 — the j-th selected candidate slot in bits
           [5j, 5j+5) (C <= 32, k <= 6);
      selw (NB, k, V) f32 — Gaussian weight of each selection (0 where
           inactive), in selection order;
      wi   (NB, V) f32 — mean distance over the finite selections.

    With ``pool_ctx`` (per-super pool radii from
    ``brick_candidates_2level(..., with_pool=True)``) a 4th element counts
    the voxels whose selection cannot be certified equal to the flat
    search AND that some node could materially influence (JAX docstring:
    min(d₁, L) <= 3·max(node_w) with L = r_pool − |v − super centre|,
    in the lattice's own coordinates: under sharding the pool radii and
    the voxels carry the same ``x_offset``, which cancels). The voxels'
    x starts at ``x_offset``. Processed one x-slab of bricks at a time to
    bound memory."""
    rx, ry, rz = shape
    nbx, nby, nbz = rx // brick, ry // brick, rz // brick
    C = cand.shape[1]
    if C > 32 or k > 6:
        raise ValueError(f"cache packing needs C<=32, k<=6 (got {C}, {k})")
    V = brick ** 3
    nbs = nby * nbz
    dev = cand.device
    vi = torch.arange(V, device=dev)
    ox = (vi // (brick * brick)).float()
    oy = ((vi // brick) % brick).float()
    oz = (vi % brick).float()
    bi = torch.arange(nbs, device=dev)
    by0 = ((bi // nbz) * brick).float()
    bz0 = ((bi % nbz) * brick).float()
    pyv = by0[:, None] + oy[None, :]
    pzv = bz0[:, None] + oz[None, :]
    if pool_ctx is not None:
        sw_max = torch.amax(torch.where(wf.active, wf.node_w, 0.0))
        nsy, nsz = nby // sfac, nbz // sfac
        sb = brick * sfac
        syc = torch.div(by0, sb, rounding_mode="floor") * sb + (sb - 1) / 2.0
        szc = torch.div(bz0, sb, rounding_mode="floor") * sb + (sb - 1) / 2.0
        sub = ((by0 // sb).long() * nsz + (bz0 // sb).long())
        risk = torch.zeros((), dtype=torch.long, device=dev)

    sels, wss, wis = [], [], []
    for s in range(nbx):
        cidx = cand[s * nbs:(s + 1) * nbs]
        npos = wf.node_pos[cidx]                           # (nbs, C, 3)
        ncw = wf.node_w[cidx]
        nact = wf.active[cidx]
        pxv = (s * brick + x_offset + ox)[None, :]
        dx = pxv[:, None, :] - npos[:, :, 0, None]
        dy = pyv[:, None, :] - npos[:, :, 1, None]
        dz = pzv[:, None, :] - npos[:, :, 2, None]
        d2 = dx * dx + dy * dy + dz * dz                   # (nbs, C, V)
        d2 = torch.where(nact[:, :, None], d2, _BIG)

        sel = torch.zeros((nbs, V), dtype=torch.int32, device=dev)
        ws = []
        wi_sum = torch.zeros((nbs, V), device=dev)
        wi_cnt = torch.zeros((nbs, V), device=dev)
        for j in range(k):
            bc = torch.argmin(d2, dim=1)                   # (nbs, V)
            best_d2 = torch.gather(d2, 1, bc[:, None, :])[:, 0]
            dk = torch.sqrt(torch.clamp_max(best_d2, _BIG))
            if j == 0:
                d_first = dk
            w_node = torch.gather(ncw, 1, bc)
            finite = torch.gather(nact, 1, bc) & (best_d2 < 1e18)
            wk = torch.where(finite, torch.exp(-((dk / (2.0 * w_node)) ** 2)),
                             0.0)
            sel = sel | (bc.int() << (5 * j))
            ws.append(wk)
            wi_sum = wi_sum + torch.where(finite, dk, 0.0)
            wi_cnt = wi_cnt + finite.float()
            d2.scatter_(1, bc[:, None, :], _BIG)
        sels.append(sel)
        wss.append(torch.stack(ws, dim=1))
        wis.append(wi_sum / torch.clamp_min(wi_cnt, 1.0))
        if pool_ctx is not None:
            sxc = (s // sfac) * sb + (sb - 1) / 2.0
            rp = pool_ctx[(s // sfac) * (nsy * nsz) + sub]
            pxl = s * brick + ox[None, :]
            dsc = torch.sqrt((pxl - sxc) ** 2 + (pyv - syc[:, None]) ** 2
                             + (pzv - szc[:, None]) ** 2)
            L = rp[:, None] - dsc
            material = torch.minimum(d_first, L) <= 3.0 * sw_max
            risk = risk + torch.sum(material & (dk >= L))  # dk: k-th dist
    out = (torch.cat(sels), torch.cat(wss), torch.cat(wis))
    return out + (risk,) if pool_ctx is not None else out


def update_tsdf_nonrigid(
    values, weights, live, wf: WarpField, lw_dq, k: int, tdist: float,
    wmax: float = 100.0, brick: int = 8, n_candidates: int = 8,
    x_offset=0, use_kernels: bool = False, cand_cache=None,
    warp_cache=None,
):
    """Non-rigid canonical TSDF fusion (reference core/fusion.py:153-198).

    Per voxel: kNN selection among the brick's candidate nodes → DQB blend
    → sandwich warp (+ global lw) → trilerp of the live TSDF → running
    average with wi = mean node distance and the wi_t == 0 → wi
    substitution; a sample updates only when it lies inside the live
    volume and is strictly above -tdist. ``values``/``weights`` are the
    canonical lattice (extents multiples of ``brick``); ``live`` may be
    smaller (``Fusion.updateTSDF`` pads the canonical volume only): the
    in-volume test and the taps use the live volume's own shape.

    Returns (values, weights, esc_dropped, pool_risk); esc_dropped is
    always 0 (kept for the JAX signature).

    ``use_kernels`` (the JAX ``use_pallas``) samples through the kernels —
    on CUDA tensors the kernels, on CPU ones their twins: K2 with a
    ``warp_cache`` (with the mip certificate when the live volume has the
    canonical shape and ``mip_skip_supported`` holds), K3 without one (the
    selection, its weights and ``wi`` computed per voxel in the kernel),
    neither writing the warped coordinates, which nothing here reads.
    Without ``use_kernels`` the selection comes from ``warp_cache`` (built
    here when None). Both arms interpolate in f32 with ``_trilinear_c``'s
    formula, so the JAX update's near-threshold re-sample (after its
    kernels' bf16 interpolation) has no counterpart.

    Without ``cand_cache`` the brick candidates and their risk count are
    searched here (two-level). The JAX argument ``exact_candidates`` (no
    caller passes it to the update) is not ported.

    ``x_offset`` is the global x index of the canonical block's first
    plane (a rank's slab, ``parallel/sharded.py``). The kernels take no
    offset, as the JAX package's sharded path runs none: with
    ``use_kernels`` a nonzero offset raises.
    """
    vol_shape = tuple(values.shape)
    if use_kernels and x_offset:
        raise ValueError(
            "update_tsdf_nonrigid: the kernels take no x_offset (the "
            f"sharded path runs the plain form); got x_offset={x_offset}")
    if cand_cache is not None:
        cand, pool_risk = cand_cache
    else:
        cand, pool_risk = brick_candidates_2level(
            wf, vol_shape, brick, n_candidates, x_offset, with_risk=True,
            risk_k=k)

    if use_kernels:
        if warp_cache is None:
            tsdf_l, valid, wi, _, _, _ = warp_trilerp_bricks(
                live, wf.node_pos, wf.node_w, wf.active, wf.node_dq, cand,
                lw_dq, vol_shape=vol_shape, brick=brick, k=k, coords=False)
        else:
            sel, selw, wi = warp_cache
            mip_ok = (mip_skip_supported(live.shape)
                      and tuple(live.shape) == vol_shape)
            tsdf_l, valid, _, _, _ = warp_trilerp_bricks_cached(
                live, wf.node_dq, cand, sel, selw, lw_dq, brick=brick,
                tdist=float(tdist) if mip_ok else None,
                live_mip=live_brick_mip(live) if mip_ok else None,
                vol_shape=vol_shape, coords=False,
            )
    else:
        if warp_cache is None:
            warp_cache = build_warp_cache(wf, vol_shape, cand, k, brick,
                                          x_offset)
        sel, selw, wi = warp_cache
        wx, wy, wz = warp_voxels(wf.node_dq, cand, sel, selw, lw_dq,
                                 vol_shape, brick, x_offset)
        tsdf_l, valid = _trilinear_c(live, wx, wy, wz)

    out_v, out_w = merge_running_average(values, weights, tsdf_l, valid, wi,
                                         tdist, wmax, brick)
    esc_dropped = torch.zeros((), dtype=torch.long, device=values.device)
    return out_v, out_w, esc_dropped, pool_risk


def merge_running_average(values, weights, tsdf_l, valid, wi, tdist: float,
                          wmax: float = 100.0, brick: int = 8):
    """The running average of :func:`update_tsdf_nonrigid` (reference
    core/fusion.py:186-198): the brick-row samples ``tsdf_l``/``valid``/
    ``wi`` (NB, V) merged into the canonical ``values``/``weights``, with
    the wi_t == 0 → wi substitution; a sample updates only when valid and
    strictly above -tdist. Returns (values', weights')."""
    vals = vol_to_bricks(values, brick)
    wts = vol_to_bricks(weights, brick)
    wi_t = torch.where(wts == 0.0, wi, wts)
    upd = valid & (tsdf_l > -tdist)
    denom = torch.clamp_min(wi + wi_t, 1e-30)
    new_vals = (vals * wi_t + torch.clamp_max(tsdf_l, tdist) * wi) / denom
    new_wts = torch.clamp_max(wi + wi_t, wmax)
    out_v = vol_from_bricks(torch.where(upd, new_vals, vals), values.shape,
                            brick)
    out_w = vol_from_bricks(torch.where(upd, new_wts, wts), values.shape,
                            brick)
    return out_v, out_w


def update_graph(wf: WarpField, verts, valid_verts, k: int):
    """Node maintenance after fusion — reference core/fusion.py:201-239.

    1. re-anchor every active node to its nearest valid vertex;
    2. a valid vertex is unsupported when min_j ‖v - n_j‖ / w_j >= 1 over
       its kNN nodes;
    3. radius-subsample the unsupported vertices (in index order, at most
       4·capacity of them) into free pool slots, DQB-initializing the new
       node transforms from the existing field.

    Returns (WarpField, n_dropped): n_dropped counts new nodes that did
    not fit the pool or the compaction cap (grow node_cap when > 0)."""
    capacity = wf.capacity
    dev = verts.device
    vidx = knn(wf.node_pos, verts, 1, valid=valid_verts)[1][:, 0]
    wf = wf.replace(node_vert_idx=torch.where(wf.active, vidx,
                                              wf.node_vert_idx))

    d, nidx = knn(verts, wf.node_pos, k, valid=wf.active)
    ratio = d / wf.node_w[nidx]
    unsupported = valid_verts & (torch.amin(ratio, dim=1) >= 1.0)

    ucap = min(4 * capacity, verts.shape[0])
    with host_read():
        src_all = torch.nonzero(unsupported).flatten()
    n_over = max(src_all.numel() - ucap, 0)
    src = src_all[:ucap]
    new_idx_c, new_count = radius_subsample(verts[src], wf.radius, capacity)
    with host_read(2):
        new_count = int(new_count)
        base = int(wf.num_active)
    take = min(new_count, capacity - base)
    with host_read():
        n_dropped = torch.tensor((new_count - take) + n_over, device=dev)
    if take == 0:
        return wf, n_dropped

    new_idx = src[new_idx_c[:take]]
    new_pos = verts[new_idx]
    bidx = knn(new_pos, wf.node_pos, k, valid=wf.active)[1]
    new_dq = blend_at(wf, new_pos, bidx)
    slots = slice(base, base + take)
    node_pos = wf.node_pos.clone()
    node_pos[slots] = new_pos
    node_dq = wf.node_dq.clone()
    node_dq[slots] = new_dq
    node_vert_idx = wf.node_vert_idx.clone()
    node_vert_idx[slots] = new_idx
    node_w = wf.node_w.clone()
    node_w[slots] = 2.0 * wf.radius
    active = wf.active.clone()
    active[slots] = True
    return wf.replace(node_pos=node_pos, node_dq=node_dq,
                      node_vert_idx=node_vert_idx, node_w=node_w,
                      active=active), n_dropped
