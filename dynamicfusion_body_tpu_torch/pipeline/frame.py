"""The per-frame DynamicFusion step — counterpart of
``dynamicfusion_body_tpu/pipeline/frame.py`` (``init_canonical``,
``fusion_frame``, ``FrameStats``).

Per frame, as the reference's Fusion.solve / updateTSDF / update_graph
(core/fusion.py:327-412, 153-198, 201-239): canonical and live surface
extraction, closest-point correspondences, a rigid presolve, the
non-rigid GN rounds with the reference's regularization relaxation,
non-rigid TSDF fusion, and deformation-graph maintenance.

The JAX package compiles the frame into one device program; the port runs
it eagerly, reading the loop predicates (round activity, node insertion)
on the host. Removing those syncs is later work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import warp_field as WF
from ..ops.dualquat import dqb_weights
from ..ops.marching_cubes import marching_cubes
from ..solvers.nonrigid import (
    gn_solve_core,
    make_reg_pairs,
    make_solver_ctx,
    relaxation_step,
)
from ..solvers.rigid import solve_rigid
from .correspondence import closest_point_correspondences


class FrameStats(NamedTuple):
    cost_before: torch.Tensor    # (iters,) raw cost per GN round
    cost_after: torch.Tensor     # (iters,) huberized cost per GN round
    cost_before_h: torch.Tensor  # (iters,) huberized pre-solve cost
    n_corr: torch.Tensor         # valid correspondences in round 0
    n_nodes: torch.Tensor        # active nodes after the graph update
    n_verts: torch.Tensor        # canonical mesh verts after the update
    overflow: torch.Tensor       # a mesh cap or the node pool saturated
    pool_risk: torch.Tensor      # voxels the 2-level pool cannot certify
    corr_risk: torch.Tensor      # 0: only fresh searches are ported
    corr_refresh: torch.Tensor   # 0: only fresh searches are ported
    ell_overflow: torch.Tensor   # JᵀWJ contributions past the degree cap


def _build_caches(wf, vol_shape, brick, n_candidates, knn_k,
                  exact_candidates):
    """((cand, pool_risk), (sel, selw, wi)) for update_tsdf_nonrigid, with
    the per-voxel material pool certificate as the risk count."""
    zero = torch.zeros((), dtype=torch.long, device=wf.node_pos.device)
    if exact_candidates:
        cand = WF.brick_candidates(wf, vol_shape, brick, n_candidates)
        return (cand, zero), WF.build_warp_cache(wf, vol_shape, cand, knn_k,
                                                 brick)
    cand, r_pool = WF.brick_candidates_2level(
        wf, vol_shape, brick, n_candidates, with_pool=True)
    if r_pool is None:  # grid not s-tileable: the flat (exact) search ran
        return (cand, zero), WF.build_warp_cache(wf, vol_shape, cand, knn_k,
                                                 brick)
    sel, selw, wi, risk = WF.build_warp_cache(
        wf, vol_shape, cand, knn_k, brick, pool_ctx=r_pool)
    return (cand, risk), (sel, selw, wi)


def _canonical_mesh(values, vert_cap, face_cap, step_size, use_kernels=False):
    m = marching_cubes(values, level=0.0, vert_cap=vert_cap,
                       face_cap=face_cap, step_size=step_size,
                       use_kernels=use_kernels)
    return m, torch.arange(vert_cap, device=values.device) < m["n_verts"]


def _blend_weights(wf, verts, nbr_idx):
    w = dqb_weights(verts, wf.node_pos[nbr_idx], wf.node_w[nbr_idx])
    return torch.where(wf.active[nbr_idx], w, 0.0)


def init_canonical(values, subsample_rate: float = 5.0, node_cap: int = 2048,
                   vert_cap: int = 1 << 16, face_cap: int = 1 << 17,
                   mc_step: int = 3):
    """Marching cubes → sampling radius (subsample_rate × mean face edge
    length, core/fusion.py:89-92) → deformation graph. Returns (wf,
    radius)."""
    mesh, vmask = _canonical_mesh(values, vert_cap, face_cap, mc_step)
    tri = mesh["verts"][mesh["faces"]]                      # (F, 3, 3)
    e = (torch.linalg.vector_norm(tri[:, 0] - tri[:, 1], dim=1)
         + torch.linalg.vector_norm(tri[:, 0] - tri[:, 2], dim=1)
         + torch.linalg.vector_norm(tri[:, 1] - tri[:, 2], dim=1)) / 3.0
    fmask = torch.arange(face_cap, device=values.device) < mesh["n_faces"]
    radius = subsample_rate * torch.sum(torch.where(fmask, e, 0.0)) / (
        torch.clamp_min(mesh["n_faces"], 1))
    wf = WF.construct_graph(mesh["verts"], radius, node_cap, valid=vmask)
    return wf, radius


def fusion_frame(
    values, weights, live, wf: WF.WarpField, lw_dq, regularization_weight,
    knn_k: int = 4, tdist: float = 0.2, wmax: float = 100.0,
    vert_cap: int = 1 << 16, face_cap: int = 1 << 17,
    live_vert_cap: int | None = None, live_face_cap: int | None = None,
    mc_step: int = 3, live_mc_step: int = 1, solve_iters: int = 3,
    gn_iters: int | tuple = 8, cg_iters: int | tuple = 32,
    ftol: float = 1e-5, tolerance: float = 0.2, brick: int = 8,
    n_candidates: int = 16, update_graph: bool = True,
    use_kernels: bool = False, use_grid_corr: bool = False,
    approx_knn: bool = False, reuse_corr: bool = True,
    allow_large: bool = False, exact_candidates: bool = False,
    canon_mesh=None,
):
    """One DynamicFusion frame. Returns (values', weights', wf', lw',
    FrameStats, mesh) — ``mesh`` is the canonical mesh after the graph
    update, carrying the brick-candidate and warp-selection caches; pass
    it as the next frame's ``canon_mesh``.

    ``use_kernels`` is the JAX ``use_pallas``: marching cubes go through
    K1 and the TSDF update through K2 (kernels on CUDA tensors, their
    twins on CPU tensors). Only fresh exact correspondences are ported:
    ``reuse_corr=True`` and ``use_grid_corr=True`` raise, as does
    ``approx_knn`` (ROADMAP.md Queue 1 item 11). ``gn_iters``/``cg_iters``
    may be per-round tuples of length ``solve_iters``."""
    if reuse_corr or use_grid_corr:
        raise NotImplementedError(
            "fusion_frame: only reuse_corr=False, use_grid_corr=False is "
            "ported; the cached-candidate and grid correspondence paths are "
            "ROADMAP.md Queue 1 item 11"
        )
    live_vert_cap = vert_cap if live_vert_cap is None else live_vert_cap
    live_face_cap = face_cap if live_face_cap is None else live_face_cap
    n_vox = 1
    for d in values.shape:
        n_vox *= int(d)
    if n_vox > (1 << 26) and not allow_large:  # > 64M voxels (~406³)
        raise ValueError(
            f"fusion_frame: volume {tuple(values.shape)} ({n_vox/1e6:.0f}M "
            "voxels) exceeds the single-dispatch HBM budget (measured "
            "thrashing at 512³ on a 16 GB TPU; docs/tpu_kernel_notes.md). "
            "Use the multi-dispatch driver pipeline.fusion.Fusion (see "
            "benchmarks/bench512.py) or pass allow_large=True to override."
        )
    dev = values.device
    if canon_mesh is None:
        mesh, vmask = _canonical_mesh(values, vert_cap, face_cap, mc_step,
                                      use_kernels)
    else:
        mesh = canon_mesh
        vmask = torch.arange(vert_cap, device=dev) < mesh["n_verts"]
    verts, normals = mesh["verts"], mesh["normals"]
    nbr_idx = WF.neighbor_lookup(wf, verts, knn_k)
    blend_wts = _blend_weights(wf, verts, nbr_idx)

    live_mesh = marching_cubes(
        live, level=0.0, vert_cap=live_vert_cap, face_cap=live_face_cap,
        step_size=live_mc_step, with_normals=False, use_kernels=use_kernels)
    lmask = torch.arange(live_vert_cap, device=dev) < live_mesh["n_verts"]

    def correspondences(wf_, lw_):
        wv, wn = WF.warp_points(wf_, verts, nbr_idx, normals=normals,
                                m_lw=lw_)
        c, v, _ = closest_point_correspondences(
            wv, wn, vmask, live_mesh["verts"], lmask, knn_k, tolerance,
            approx=approx_knn)
        return c, v

    # rigid presolve (core/fusion.py:350-364) on node-field pre-warped points
    corr, cvalid = correspondences(wf, lw_dq)
    pv, pn = WF.warp_points(wf, verts, nbr_idx, normals=normals)
    lw_dq, _ = solve_rigid(lw_dq, pv, pn, corr, cvalid, iterations=12)
    n_corr0 = torch.sum(cvalid)

    # non-rigid rounds with regularization relaxation (327-412)
    pair_i, pair_j, _, pmask0 = make_reg_pairs(
        wf.node_vert_idx, nbr_idx, wf.node_w, wf.active, 1.0)
    pair_v = wf.node_pos[pair_j]
    base_scale = torch.maximum(wf.node_w[pair_i], wf.node_w[pair_j])
    solver_ctx = make_solver_ctx(nbr_idx, vmask, pair_i, pair_j, pmask0,
                                 wf.capacity)

    gn_sched = (tuple(gn_iters) if isinstance(gn_iters, (tuple, list))
                else (gn_iters,) * solve_iters)
    cg_sched = (tuple(cg_iters) if isinstance(cg_iters, (tuple, list))
                else (cg_iters,) * solve_iters)
    if len(gn_sched) != solve_iters or len(cg_sched) != solve_iters:
        raise ValueError(
            f"gn_iters/cg_iters schedules must have length solve_iters="
            f"{solve_iters}, got {gn_sched}/{cg_sched}")
    node_dq = wf.node_dq
    rw = torch.as_tensor(regularization_weight, dtype=torch.float32,
                         device=dev)
    dmp = torch.tensor(1e-4, device=dev)
    act = True
    zero = torch.zeros((), device=dev)
    cbs, cbhs, cas, ellovs = [], [], [], []
    for r in range(solve_iters):
        if not act:  # the reference breaks out of its loop (405-412)
            cbs.append(zero)
            cbhs.append(zero)
            cas.append(zero)
            continue
        corr_, cval_ = correspondences(wf.replace(node_dq=node_dq), lw_dq)
        data_args = (verts, normals, corr_, cval_, nbr_idx, blend_wts)
        reg_args = (pair_i, pair_j, pair_v, rw * base_scale, pmask0)
        # damping warm-started from the previous round, clamped to 100×
        # its floor (a converged round can exit with inflated damping)
        node_dq, cb, cbh, ca, dmp, ellov = gn_solve_core(
            node_dq, data_args, reg_args, lw_dq, gn_sched[r], cg_sched[r],
            1e-4, ftol, damping_init=torch.clamp_max(dmp, 1e-2),
            solver_ctx=solver_ctx)
        cbs.append(cb)
        cbhs.append(cbh)
        cas.append(ca)
        ellovs.append(ellov)
        relax, rw = relaxation_step(cb, ca, rw)
        act = bool(relax)
    wf = wf.replace(node_dq=node_dq)

    # non-rigid canonical fusion (153-198): the candidate and warp caches
    # depend only on the node set, so the previous frame's are exact
    if canon_mesh is not None and "brick_cand" in canon_mesh:
        cand_cache = (canon_mesh["brick_cand"], canon_mesh["brick_risk"])
        warp_cache = (canon_mesh["warp_sel"], canon_mesh["warp_selw"],
                      canon_mesh["warp_wi"])
    else:
        cand_cache, warp_cache = _build_caches(
            wf, values.shape, brick, n_candidates, knn_k, exact_candidates)
    values, weights, esc_dropped, pool_risk = WF.update_tsdf_nonrigid(
        values, weights, live, wf, lw_dq, k=knn_k, tdist=tdist, wmax=wmax,
        brick=brick, n_candidates=n_candidates, use_kernels=use_kernels,
        cand_cache=cand_cache, warp_cache=warp_cache)

    # deformation-graph maintenance (201-239)
    n_dropped = torch.zeros((), dtype=torch.long, device=dev)
    mesh_out = mesh
    if update_graph:
        mesh_out, vmask2 = _canonical_mesh(values, vert_cap, face_cap,
                                           mc_step, use_kernels)
        n_act0 = int(wf.num_active)
        wf, n_dropped = WF.update_graph(wf, mesh_out["verts"], vmask2, knn_k)
        if int(wf.num_active) > n_act0:  # the node set changed
            cand_cache, warp_cache = _build_caches(
                wf, values.shape, brick, n_candidates, knn_k,
                exact_candidates)
    mesh_out = dict(
        mesh_out, brick_cand=cand_cache[0], brick_risk=cand_cache[1],
        warp_sel=warp_cache[0], warp_selw=warp_cache[1],
        warp_wi=warp_cache[2])

    stats = FrameStats(
        cost_before=torch.stack(cbs),
        cost_after=torch.stack(cas),
        cost_before_h=torch.stack(cbhs),
        n_corr=n_corr0,
        n_nodes=wf.num_active,
        n_verts=mesh_out["n_verts"],
        overflow=(mesh["overflow"] | mesh_out["overflow"]
                  | live_mesh["overflow"] | (n_dropped > 0)
                  | (esc_dropped > 0)),
        pool_risk=pool_risk,
        corr_risk=torch.zeros((), dtype=torch.long, device=dev),
        corr_refresh=torch.zeros((), dtype=torch.long, device=dev),
        ell_overflow=(torch.sum(torch.stack(ellovs)) if ellovs
                      else torch.zeros((), dtype=torch.long, device=dev)),
    )
    return values, weights, wf, lw_dq, stats, mesh_out
