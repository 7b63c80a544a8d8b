"""Sharded fusion and solve over a :class:`~.mesh.Mesh` — counterpart of
``dynamicfusion_body_tpu/parallel/sharded.py``.

Layout (JAX ``parallel/sharded.py``): the canonical voxel grid is sharded
along x, each rank holding its slab; the live TSDF, depth maps, cameras,
poses and node pool are replicated. Every function reuses the one-device
code with an ``x_offset`` so that each rank computes global voxel
coordinates for its slab; the only collectives are the Gauss-Newton
all-reduces and the all-gather of the coupling graph.

The JAX factories return jitted ``shard_map`` programs; these return plain
callables that every rank calls with its own slab or vertex shard, in the
same order on every rank. As in the JAX package, the sharded path runs the
plain forms (no CUDA kernel takes an offset).
"""

from __future__ import annotations

import torch

from ..models.tsdf_volume import fuse_depth, update_tsdf_rigid
from ..models.warp_field import (
    brick_candidates,
    brick_candidates_2level,
    build_warp_cache,
    update_tsdf_nonrigid,
)
from ..solvers.nonrigid import (
    ELL_DEGREE_CAP,
    SolverCtx,
    gn_solve_core,
    make_block_ell_sharded,
    make_ell_dict,
)
from .mesh import Mesh


def fuse_depth_sharded(mesh: Mesh, tdist: float, wmax: float = 100.0):
    """(values, weights, depth, proj, kinv) → (values', weights') with the
    volume this rank's x-slab and everything else replicated."""

    def fuse(values, weights, depth, proj, kinv):
        x0 = mesh.rank * values.shape[0]
        return fuse_depth(values, weights, depth, proj, kinv, tdist, wmax,
                          x_offset=x0)

    return fuse


def update_tsdf_rigid_sharded(mesh: Mesh, tdist: float, wmax: float = 100.0):
    """Rigid TSDF-to-TSDF fusion with the canonical volume this rank's
    slab and the live volume replicated (warped samples cross slab
    boundaries)."""

    def update(values, weights, live, lw_dq):
        x0 = mesh.rank * values.shape[0]
        return update_tsdf_rigid(values, weights, live, lw_dq, tdist, wmax,
                                 x_offset=x0)

    return update


def update_local_with_caches(values, weights, live, wf, lw_dq, mesh: Mesh,
                             k, tdist, wmax, brick, n_candidates):
    """This rank's slab of the non-rigid TSDF update, its caches (2-level
    brick candidates and the per-voxel selection with its per-voxel
    material pool certificate) built at the slab's ``x_offset``, so that
    ``pool_risk`` means what it means on one device; the flat (exact,
    risk 0) candidates when the slab's brick grid is not 2-tileable.
    Returns (values', weights', esc_dropped, pool_risk), this rank's."""
    x0 = mesh.rank * values.shape[0]
    shape = tuple(values.shape)
    cand, r_pool = brick_candidates_2level(wf, shape, brick, n_candidates,
                                           x_offset=x0, with_pool=True)
    if r_pool is None:
        cand = brick_candidates(wf, shape, brick, n_candidates, x_offset=x0)
        warp_cache = build_warp_cache(wf, shape, cand, k, brick, x_offset=x0)
        risk = torch.zeros((), dtype=torch.long, device=values.device)
    else:
        sel, selw, wi, risk = build_warp_cache(
            wf, shape, cand, k, brick, x_offset=x0, pool_ctx=r_pool)
        warp_cache = (sel, selw, wi)
    return update_tsdf_nonrigid(
        values, weights, live, wf, lw_dq, k=k, tdist=tdist, wmax=wmax,
        brick=brick, n_candidates=n_candidates, x_offset=x0,
        cand_cache=(cand, risk), warp_cache=warp_cache)


def update_tsdf_nonrigid_sharded(mesh: Mesh, k: int, tdist: float,
                                 wmax: float = 100.0, brick: int = 8,
                                 n_candidates: int = 8):
    """Non-rigid canonical fusion: (values, weights, live, wf, lw_dq) →
    (values', weights', esc_dropped, pool_risk), the canonical volume this
    rank's slab, the live volume and the warp field replicated; the two
    counts are summed over the ranks."""

    def update(values, weights, live, wf, lw_dq):
        v, w, esc, risk = update_local_with_caches(
            values, weights, live, wf, lw_dq, mesh, k, tdist, wmax, brick,
            n_candidates)
        return v, w, mesh.psum(esc), mesh.psum(risk)

    return update


def global_ell_dict(mesh: Mesh, nbr_idx, corr_mask, pair_i, pair_j,
                    pair_mask, M: int):
    """The slot dictionary of the GLOBAL coupling graph: the ranks'
    vertex shards all-gathered (one block size on every rank), then
    ``make_ell_dict``, the same on every rank."""
    nbr_g = mesh.all_gather(nbr_idx)
    mask_g = mesh.all_gather(corr_mask.to(torch.uint8)).bool()
    return make_ell_dict(nbr_g, mask_g, pair_i, pair_j, pair_mask, M,
                         ELL_DEGREE_CAP)


def solve_nonrigid_sharded(mesh: Mesh, gn_iters: int = 8, cg_iters: int = 32,
                           damping: float = 1e-4, ftol: float = 1e-5):
    """Vertex-sharded non-rigid GN: data residuals and Jacobians on this
    rank's vertex shard, the gradient, energies and JᵀWJ blocks
    all-reduced; the reg term and the PCG state replicated. The GN math
    is ``solvers.nonrigid.gn_solve_core`` with the all-reduce as its
    ``psum``, and the block-ELL from the global coupling graph
    (:func:`global_ell_dict`, ``make_block_ell_sharded``). The JAX
    options ``cg_rtol`` and ``dense_pairs`` keep their defaults here, as
    in ``solvers/nonrigid.py:solve_nonrigid``.

    Returns solve(node_dq, verts, normals, corrs, corr_mask, nbr_idx,
    blend_wts, pair_i, pair_j, pair_v, pair_scale, pair_mask, lw_dq) →
    (node_dq, cost0_raw, cost0, cost1, dmp_out, ell_overflow), the vertex
    arguments this rank's shard, the rest replicated."""

    def solve(node_dq, verts, normals, corrs, corr_mask, nbr_idx, blend_wts,
              pair_i, pair_j, pair_v, pair_scale, pair_mask, lw_dq):
        M = node_dq.shape[0]
        ell_dict = global_ell_dict(mesh, nbr_idx, corr_mask, pair_i, pair_j,
                                   pair_mask, M)
        ctx = SolverCtx(make_block_ell_sharded(
            ell_dict, nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M,
            mesh.psum, mesh.world))
        return gn_solve_core(
            node_dq, (verts, normals, corrs, corr_mask, nbr_idx, blend_wts),
            (pair_i, pair_j, pair_v, pair_scale, pair_mask), lw_dq,
            gn_iters, cg_iters, damping, ftol, mesh.psum, solver_ctx=ctx)

    return solve
