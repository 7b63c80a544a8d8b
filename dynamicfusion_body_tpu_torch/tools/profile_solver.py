"""Microbenchmark the non-rigid solver's PCG matvec constituents on the
card — the port of ``tools/profile_solver.py``, on the bench scene's
graph (``tools/_scene.py:bench_scene`` at ``--res``; at 256³ M = 4096
nodes, V = 32,768 vertices, k = 3, the JAX tool's sizes), each part as
``solvers/nonrigid.py`` computes it:

* ``elementwise_(N,8)``: one axpy-like pass over (N, 8) rows;
* ``gather_rows_(M,8)->(N,8)``: the node rows of every (vertex,
  neighbour) pair, ``p[nbr]``. JAX's ``take_lane_(8,M)->(8,N)_sum`` and
  ``take_row_(M,8)->(N,8)_sum`` timed the TPU's lane-major (8, N) and
  row-major layouts; the port keeps one row-major layout, so they are
  this one row;
* ``red_nbr_(N,8)``, ``red_nbr_(N,64)``: the neighbour reduce (N rows
  onto M nodes, ``index_add_``, as the gradient is summed); JAX's sorted
  cumsum reducer (``make_sorted_reducer``) and its ``cumsum_(8,N)`` row
  are a TPU workaround with no counterpart and no row;
* ``precond_(M,8,8)``: the block-Jacobi preconditioner of ``pcg_solve``;
* ``matvec_data``: the data term's JᵀWJ·p without assembly (the node
  rows gathered, J·p per vertex, weighted, Jᵀ reduced by ``index_add_``);
* ``matvec_blockH_(M,D,8,8)``: ``pcg_solve``'s matvec on the assembled
  block-ELL table (D = ``ELL_DEGREE_CAP`` = 24 slots a node; JAX timed
  S = 32);
* ``assembly_red_(T,64)``: ``make_block_ell``'s reduce of the (T, 64)
  contribution rows into the (M·D, 64) slots, T = V·k² + 4·M·k;
* ``pcg_16``: 16 PCG steps (``pcg_solve``) on the assembled table.

The graph is the bench's, as ``profile_solve5`` takes it: the canonical
mesh's node neighbours (``init_canonical``'s field, subsample rate 1.5),
its reg pairs, and the closest-point correspondences to config 4's live
mesh (a vertex without one adds no data coupling). JAX drew every
neighbour uniformly from the M nodes, which couples a node to ~48 others
and drops half the contributions past the degree cap; the header prints
this graph's coupling degree, the node-id gaps of its couplings (what
the gathers' locality follows) and the contributions past the cap.
Jacobians, IRLS weights and the right-hand side are drawn from
``RandomState(0)``. Rows report the median synced wall, the CUDA-event
mean, the bound and its share (``tools/_timing.py:Timer``); rows under
10 ms are also timed as one CUDA graph of 64 calls, the counterpart of
the JAX tool's loop inside one program, and marked when launch-bound.

    python -m dynamicfusion_body_tpu_torch.tools.profile_solver
    python -m dynamicfusion_body_tpu_torch.tools.profile_solver \\
        --device cpu --res 32 --reps 1
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..pipeline.correspondence import closest_point_correspondences
from ..pipeline.fusion import resolve_device
from ..solvers.nonrigid import (
    ELL_DEGREE_CAP, _inv8_spd, jtwj_contributions, make_block_ell,
    pcg_solve)
from ._scene import KNN_K, bench_scene, meshes, reg_pairs
from ._timing import Timer, bound, device_label, parse_args
from .profile_solve5 import TOLERANCE

LAM = 1e-3


def solver_inputs(res: int, dev, seed: int = 0):
    """Solver inputs on the bench scene's graph at ``res`` (module
    docstring): node neighbours (V, k), reg pairs (M·k) and the
    correspondence mask, seeded Jacobians and IRLS weights, the
    assembled block-ELL table (M, D, 8, 8), its diagonal blocks and their
    damped inverses, and a right-hand side."""
    sc = bench_scene(res, dev)
    ms = meshes(sc)
    mesh, live = ms.mesh, ms.live_mesh
    _, corr_mask, _ = closest_point_correspondences(
        mesh["verts"], mesh["normals"], ms.vmask, live["verts"], ms.lmask,
        KNN_K, TOLERANCE)
    pair_i, pair_j, _, _, pair_mask = reg_pairs(sc, ms)
    nbr_idx = ms.nbr_idx
    M, (V, k), P = sc.wf.capacity, nbr_idx.shape, pair_i.shape[0]
    rng = np.random.RandomState(seed)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    J_d = put(rng.randn(V, k, 8).astype(np.float32))
    w_d = put(rng.rand(V).astype(np.float32)) * corr_mask
    J_ri = put(rng.randn(P, 3, 8).astype(np.float32))
    J_rj = put(rng.randn(P, 3, 8).astype(np.float32))
    w_r = put(rng.rand(P, 3).astype(np.float32)) * pair_mask[:, None]
    rhs = put(rng.randn(M, 8).astype(np.float32))
    reduce_ell, ell_nbr, self_ids, present, n_over = make_block_ell(
        nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M, ELL_DEGREE_CAP)
    contrib = jtwj_contributions(J_d, w_d, J_ri, J_rj, w_r)
    blocks = reduce_ell(contrib)
    D = ell_nbr.numel() // M
    Bl = blocks.reshape(M, D, 8, 8)
    blk = (blocks[self_ids] * present[:, None]).reshape(M, 8, 8)
    Dinv = _inv8_spd(blk + LAM * torch.eye(8, device=dev))
    return SimpleNamespace(
        M=M, V=V, k=k, D=D, nbr_idx=nbr_idx, corr_mask=corr_mask,
        pair_i=pair_i, pair_j=pair_j, pair_mask=pair_mask, J_d=J_d, w_d=w_d,
        J_ri=J_ri, J_rj=J_rj, w_r=w_r, rhs=rhs, reduce_ell=reduce_ell,
        ell_nbr=ell_nbr, contrib=contrib, Bl=Bl, blk=blk, Dinv=Dinv,
        n_overflow=int(n_over), n_nodes=int(sc.wf.num_active),
        n_verts=int(mesh["n_verts"]))


def graph_stats(s) -> dict:
    """The coupling graph of ``solver_inputs`` ``s``: each distinct pair
    of nodes that a corresponded vertex's neighbours or a live reg pair
    couples, counted once. Returns the degree (partners a coupled node
    has: mean, max) and the node-id gap |i − j| of the pairs (p50, p95,
    max)."""
    M, k = s.M, s.k
    a = s.nbr_idx[s.corr_mask]
    ii, jj = torch.triu_indices(k, k, 1, device=a.device)
    i = torch.cat([a[:, ii].reshape(-1), s.pair_i[s.pair_mask]])
    j = torch.cat([a[:, jj].reshape(-1), s.pair_j[s.pair_mask]])
    keep = i != j
    lo, hi = torch.minimum(i, j)[keep], torch.maximum(i, j)[keep]
    key = torch.unique(lo * M + hi)
    lo, hi = key // M, key % M
    deg = torch.bincount(torch.cat([lo, hi]), minlength=M)
    deg = deg[deg > 0].double()
    gap = (hi - lo).double()
    q = torch.quantile(gap, torch.tensor([0.5, 0.95], dtype=torch.float64,
                                         device=gap.device))
    return dict(pairs=int(key.numel()), deg_mean=float(deg.mean()),
                deg_max=int(deg.max()), gap_p50=float(q[0]),
                gap_p95=float(q[1]), gap_max=int(gap.max()))


def precond(Dinv, r):
    """``pcg_solve``'s block-Jacobi step: Dinv (M, 8, 8) · r (M, 8)."""
    return torch.einsum("mab,mb->ma", Dinv, r)


def matvec_blockH(Bl, ell_nbr, p, lam: float = LAM):
    """``pcg_solve``'s matvec: the block-ELL table (M, D, 8, 8) times the
    node rows its slots couple, plus lam·p."""
    M, D = Bl.shape[:2]
    return torch.einsum("mdab,mdb->ma", Bl, p[ell_nbr].reshape(M, D, 8)) \
        + lam * p


def red_nbr(x, idx, M: int):
    """Rows ``x`` (N, C) summed onto their nodes ``idx`` (N,): (M, C)."""
    return x.new_zeros((M, x.shape[1])).index_add_(0, idx, x)


def matvec_data(J_d, w_d, nbr_idx, p):
    """The data term's Jᵀ W J p without assembly: J_d (V, k, 8), w_d (V,),
    p (M, 8) → (M, 8)."""
    Jp = torch.sum(J_d * p[nbr_idx], dim=(1, 2))                  # (V,)
    rows = (J_d * (w_d * Jp)[:, None, None]).reshape(-1, 8)
    return red_nbr(rows, nbr_idx.reshape(-1), p.shape[0])


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=8)
    dev = resolve_device(args.device)
    s = solver_inputs(args.res, dev)
    M, V, k, D = s.M, s.V, s.k, s.D
    N, T = V * k, s.contrib.shape[0]
    nbr_flat = s.nbr_idx.reshape(-1)
    rng = np.random.RandomState(1)
    xN8 = torch.from_numpy(rng.rand(N, 8).astype(np.float32)).to(dev)
    xN64 = torch.from_numpy(rng.rand(N, 64).astype(np.float32)).to(dev)
    p = s.rhs
    t = Timer(dev, args.reps, args.trace)
    g = graph_stats(s)
    print(f"# profile_solver: bench scene {args.res}^3, {s.n_nodes} nodes "
          f"of M {M}, {s.n_verts} vertices of V {V}, k {k}, N {N}, D {D}, "
          f"T {T}; on {device_label(dev)}; reps {args.reps}", flush=True)
    print(f"# graph: {g['pairs']} coupled node pairs, degree mean "
          f"{g['deg_mean']:.2f} max {g['deg_max']}; node-id gap p50 "
          f"{g['gap_p50']:g} p95 {g['gap_p95']:g} max {g['gap_max']}; "
          f"{s.n_overflow} contributions past the degree cap", flush=True)

    t("elementwise_(N,8)", lambda: xN8 * 1.000001 + 0.001, graph=True,
      **bound(2 * 32 * N, 16 * N))
    t("gather_rows_(M,8)->(N,8)", lambda: p[nbr_flat], graph=True,
      **bound(8 * N + 32 * N + 32 * M, 0))
    t("red_nbr_(N,8)", lambda: red_nbr(xN8, nbr_flat, M), graph=True,
      **bound(8 * N + 32 * N + 32 * M, 8 * N))
    t("red_nbr_(N,64)", lambda: red_nbr(xN64, nbr_flat, M), graph=True,
      **bound(8 * N + 256 * N + 256 * M, 64 * N))
    t("precond_(M,8,8)", lambda: precond(s.Dinv, p), graph=True,
      **bound(256 * M + 64 * M, 128 * M))
    t("matvec_data", lambda: matvec_data(s.J_d, s.w_d, s.nbr_idx, p),
      graph=True, **bound(8 * N + 32 * N + 4 * V + 64 * M, 36 * N))
    t(f"matvec_blockH_(M,{D},8,8)",
      lambda: matvec_blockH(s.Bl, s.ell_nbr, p), graph=True,
      **bound(256 * M * D + 8 * M * D + 32 * M * D + 64 * M, 128 * M * D))
    t("assembly_red_(T,64)", lambda: s.reduce_ell(s.contrib), graph=True,
      **bound(256 * T + 8 * T + 256 * M * D, 64 * T))
    # the table, its slots, the diagonal blocks and the right-hand side
    # read once, the solution written once; 17 matvecs
    t("pcg_16", lambda: pcg_solve(s.Bl, s.blk, s.ell_nbr, s.rhs, LAM, 16),
      graph=True, **bound(256 * M * D + 8 * M * D + 256 * M + 64 * M,
                          17 * 128 * M * D))
    return t.rows


if __name__ == "__main__":
    main()
