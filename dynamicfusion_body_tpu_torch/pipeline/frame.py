"""The per-frame DynamicFusion step — counterpart of
``dynamicfusion_body_tpu/pipeline/frame.py`` (``init_canonical``,
``fusion_frame``, ``FrameStats``).

Per frame, as the reference's Fusion.solve / updateTSDF / update_graph
(core/fusion.py:327-412, 153-198, 201-239): canonical and live surface
extraction, closest-point correspondences, a rigid presolve, the
non-rigid GN rounds with the reference's regularization relaxation,
non-rigid TSDF fusion, and deformation-graph maintenance.

The JAX package compiles the frame into one device program; the port runs
it eagerly, reading the loop predicates (round activity, node insertion,
the cached correspondences' refresh) on the host. Removing those syncs is
later work.
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
from ..utils.profiling import host_read, span, traced
from .correspondence import (
    closest_point_correspondences,
    closest_point_correspondences_grid,
    correspondence_candidates,
    correspondences_from_candidates,
)


class FrameStats(NamedTuple):
    cost_before: torch.Tensor    # (iters,) raw cost per GN round
    cost_after: torch.Tensor     # (iters,) huberized cost per GN round
    cost_before_h: torch.Tensor  # (iters,) huberized pre-solve cost
    n_corr: torch.Tensor         # valid correspondences in round 0
    n_nodes: torch.Tensor        # active nodes after the graph update
    n_verts: torch.Tensor        # canonical mesh verts after the update
    overflow: torch.Tensor       # a mesh cap or the node pool saturated
    pool_risk: torch.Tensor      # voxels the 2-level pool cannot certify
    corr_risk: torch.Tensor      # vertices (over the rounds) whose cached
                                 # candidates were used uncertified; 0 on
                                 # the fresh and grid paths
    corr_refresh: torch.Tensor   # rounds that dropped the cached candidates
                                 # for a fresh search (certificate failed
                                 # for > CORR_REFRESH_FRAC of the mesh)
    ell_overflow: torch.Tensor   # JᵀWJ contributions past the degree cap


# When a round's drift certificate fails for more than this share of the
# canonical mesh, the round drops the cached candidates and runs a fresh
# search (the JAX package's value: uncertified cached matches left a
# large-motion frame's warp far worse on a fresh-correspondence objective,
# certified reuse did not).
CORR_REFRESH_FRAC = 0.01


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


def stack_rounds(xs, dev):
    """The per-round costs as one (solve_iters,) tensor; empty when no
    round ran (``solve_iters=0``, where JAX's scan gives (0,))."""
    return torch.stack(xs) if xs else torch.zeros((0,), device=dev)


@traced("fusion_frame")
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
    twins on CPU tensors). ``gn_iters``/``cg_iters`` may be per-round
    tuples of length ``solve_iters``.

    Correspondences, as in the JAX package: ``use_grid_corr`` the
    grid-hash search every round; else ``reuse_corr`` (the default) one
    candidate search of max(4·knn_k, 16) per frame at the frame-entry
    warp, re-ranked every round under the drift certificate, with a fresh
    search on a round whose certificate fails for more than
    CORR_REFRESH_FRAC of the mesh (at least 8 vertices); else a fresh
    search every round. ``approx_knn`` (False, True or ``"2level"``)
    picks the search (``pipeline/correspondence.py``).

    Spans: ``marching_cubes``, ``correspondences``, ``rigid``, ``solve``
    (``solvers/nonrigid.py:gn_solve_core``), ``tsdf_update`` and
    ``graph_update``, with a ``host_read`` at each value the host waits
    for."""
    live_vert_cap = vert_cap if live_vert_cap is None else live_vert_cap
    live_face_cap = face_cap if live_face_cap is None else live_face_cap
    n_vox = 1
    for d in values.shape:
        n_vox *= int(d)
    if n_vox > (1 << 26) and not allow_large:  # > 64M voxels (~406³)
        raise ValueError(
            f"fusion_frame: volume {tuple(values.shape)} ({n_vox/1e6:.0f}M "
            "voxels) is above the 64M-voxel limit of one call, which this "
            "package keeps from the JAX package; only 256³ is measured: "
            "there the frame bench (dynamicfusion_body_tpu_torch."
            "benchmarks.bench) peaks at 3.57 GiB of device memory over "
            "its frames (3.80 GiB with its accuracy arms) on an NVIDIA "
            "H100 80GB HBM3 at 700 W. Pass allow_large=True to run it "
            "anyway."
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

    lverts = live_mesh["verts"]
    zero_i = torch.zeros((), dtype=torch.long, device=dev)

    def fresh(wv, wn):
        if use_grid_corr:
            return closest_point_correspondences_grid(
                wv, wn, vmask, lverts, lmask, knn_k, tolerance,
                grid_n=(max(live.shape) + 15) // 16)
        return closest_point_correspondences(
            wv, wn, vmask, lverts, lmask, knn_k, tolerance,
            approx=approx_knn)

    reuse = reuse_corr and not use_grid_corr
    cand_risk = zero_i
    if reuse:
        # one candidate search per frame at the frame-entry warp; later
        # rounds re-rank it (the reference re-queries its KDTree every
        # round, core/fusion.py:371 → 251-276)
        with span("correspondences"):
            wv0, _ = WF.warp_points(wf, verts, nbr_idx, normals=normals,
                                    m_lw=lw_dq)
            cand_idx, d_kc, cand_risk = correspondence_candidates(
                wv0, vmask, lverts, lmask, kc=max(4 * knn_k, 16),
                approx=approx_knn)
            n_valid0 = torch.sum(vmask)
            risk_cap = torch.clamp_min(
                (CORR_REFRESH_FRAC * n_valid0.float()).long(), 8)

    @traced("correspondences")
    def correspondences(wf_, lw_):
        """(corr, valid, uncertified vertices, refreshed) of one round."""
        wv, wn = WF.warp_points(wf_, verts, nbr_idx, normals=normals,
                                m_lw=lw_)
        refresh = zero_i
        if reuse:
            c, v, _, risk = correspondences_from_candidates(
                wv, wn, vmask, lverts, lmask, cand_idx, d_kc, wv0, knn_k,
                tolerance)
            # certificate-steered refresh: one host read a round (the JAX
            # package's lax.cond); the fresh search runs only on such rounds
            with host_read():
                stale = bool(risk > risk_cap)
            if not stale:
                return c, v, risk, zero_i
            refresh = torch.ones_like(zero_i)
        c, v, _ = fresh(wv, wn)
        return c, v, zero_i, refresh

    # rigid presolve (core/fusion.py:350-364) on node-field pre-warped points
    corr, cvalid, risk0, refresh0 = correspondences(wf, lw_dq)
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
    with host_read():
        rw = torch.as_tensor(regularization_weight, dtype=torch.float32,
                             device=dev)
    with host_read():
        dmp = torch.tensor(1e-4, device=dev)
    act = True
    zero = torch.zeros((), device=dev)
    cbs, cbhs, cas, ellovs = [], [], [], []
    corr_risk, corr_refresh = cand_risk + risk0, refresh0
    for r in range(solve_iters):
        if not act:  # the reference breaks out of its loop (405-412)
            cbs.append(zero)
            cbhs.append(zero)
            cas.append(zero)
            continue
        corr_, cval_, risk, refresh = correspondences(
            wf.replace(node_dq=node_dq), lw_dq)
        corr_risk = corr_risk + risk
        corr_refresh = corr_refresh + refresh
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
        with host_read():
            act = bool(relax)
    wf = wf.replace(node_dq=node_dq)

    # non-rigid canonical fusion (153-198): the candidate and warp caches
    # depend only on the node set, so the previous frame's are exact
    with span("tsdf_update"):
        if canon_mesh is not None and "brick_cand" in canon_mesh:
            cand_cache = (canon_mesh["brick_cand"],
                          canon_mesh["brick_risk"])
            warp_cache = (canon_mesh["warp_sel"], canon_mesh["warp_selw"],
                          canon_mesh["warp_wi"])
        else:
            cand_cache, warp_cache = _build_caches(
                wf, values.shape, brick, n_candidates, knn_k,
                exact_candidates)
        values, weights, esc_dropped, pool_risk = WF.update_tsdf_nonrigid(
            values, weights, live, wf, lw_dq, k=knn_k, tdist=tdist,
            wmax=wmax, brick=brick, n_candidates=n_candidates,
            use_kernels=use_kernels, cand_cache=cand_cache,
            warp_cache=warp_cache)

    # deformation-graph maintenance (201-239)
    n_dropped = torch.zeros((), dtype=torch.long, device=dev)
    mesh_out = mesh
    if update_graph:
        with span("graph_update"):
            mesh_out, vmask2 = _canonical_mesh(values, vert_cap, face_cap,
                                               mc_step, use_kernels)
            with host_read():
                n_act0 = int(wf.num_active)
            wf, n_dropped = WF.update_graph(wf, mesh_out["verts"], vmask2,
                                            knn_k)
            with host_read():
                grown = int(wf.num_active) > n_act0
            if grown:  # the node set changed
                cand_cache, warp_cache = _build_caches(
                    wf, values.shape, brick, n_candidates, knn_k,
                    exact_candidates)
    mesh_out = dict(
        mesh_out, brick_cand=cand_cache[0], brick_risk=cand_cache[1],
        warp_sel=warp_cache[0], warp_selw=warp_cache[1],
        warp_wi=warp_cache[2])

    stats = FrameStats(
        cost_before=stack_rounds(cbs, dev),
        cost_after=stack_rounds(cas, dev),
        cost_before_h=stack_rounds(cbhs, dev),
        n_corr=n_corr0,
        n_nodes=wf.num_active,
        n_verts=mesh_out["n_verts"],
        overflow=(mesh["overflow"] | mesh_out["overflow"]
                  | live_mesh["overflow"] | (n_dropped > 0)
                  | (esc_dropped > 0)),
        pool_risk=pool_risk,
        corr_risk=corr_risk,
        corr_refresh=corr_refresh,
        ell_overflow=(torch.sum(torch.stack(ellovs)) if ellovs
                      else torch.zeros((), dtype=torch.long, device=dev)),
    )
    return values, weights, wf, lw_dq, stats, mesh_out
