"""The whole DynamicFusion frame over a :class:`~.mesh.Mesh` — counterpart
of ``dynamicfusion_body_tpu/parallel/frame_sharded.py``.

The six stages of ``pipeline/frame.py:fusion_frame`` (live and canonical
extraction, correspondences, rigid presolve, the relaxed non-rigid GN
rounds, non-rigid fusion, graph maintenance) with the JAX module's layout:

* the canonical volume is sharded along x; the live volume, node pool,
  pose and reg pairs are replicated;
* both surfaces extract per slab (``parallel/mc_sharded.py``): canonical
  vertices stay per-rank blocks and feed the vertex-sharded GN data term;
  live vertices are all-gathered (correspondence targets must be globally
  searchable);
* correspondence candidates and their per-round re-ranking run on the
  rank's canonical block against the whole live set; the drift
  certificate's count is all-reduced, so the refresh takes the same
  branch on every rank;
* the rigid presolve all-reduces its 8×8 system (``solve_rigid_core``);
  the GN rounds run ``gn_solve_core`` with the all-reduce as its
  ``psum`` and the block-ELL of the global coupling graph;
* the TSDF update runs per slab with its caches built at the slab's
  x_offset (``sharded.update_local_with_caches``);
* graph maintenance runs replicated on the all-gathered canonical
  surface: every rank computes the same insertion.

The JAX factories return jitted SPMD programs; these return plain
callables that every rank calls with its slab. Every predicate read on
the host — the refresh's risk count, the relaxation energies, the LM
acceptance energies inside ``gn_solve_core`` — is an all-reduced value,
the same on every rank; a rank-local one would leave the ranks' collectives
unmatched (JAX ``frame_sharded.py:37-43``; ``check_vma`` enforces it
there, the group's timeout turns a breach into an error here).

The JAX module's two differences from the one-device frame hold here:
vertex order is per slab (greedy node insertion can tie-break otherwise,
so the paths agree geometrically, not bitwise), and the update caches
are rebuilt every frame.
"""

from __future__ import annotations

import torch

from ..models import warp_field as WF
from ..pipeline.correspondence import (
    closest_point_correspondences,
    correspondence_candidates,
    correspondences_from_candidates,
)
from ..pipeline.frame import (
    CORR_REFRESH_FRAC, FrameStats, _blend_weights, stack_rounds)
from ..solvers.nonrigid import (
    SolverCtx,
    gn_solve_core,
    make_block_ell_sharded,
    make_reg_pairs,
    relaxation_step,
)
from ..solvers.rigid import solve_rigid_core
from .mc_sharded import global_count, global_faces, mc_local_slab
from .mesh import Mesh
from .sharded import global_ell_dict, update_local_with_caches


def _make_extract_canon(mesh: Mesh, vert_cap, face_cap, mc_step):
    def extract_canon(values):
        """This rank's canonical block: (verts, normals, faces (global
        indices), vert_valid, vert_owned, n_owned, n_faces, overflow),
        the counts and overflow over all ranks."""
        m = mc_local_slab(values, mesh, vert_cap=vert_cap, face_cap=face_cap,
                          step_size=mc_step, with_normals=True)
        dev = values.device
        faces, _ = global_faces(m["faces"], m["n_faces"], mesh.rank,
                                mesh.world, vert_cap)
        vvalid = torch.arange(vert_cap, device=dev) < m["n_verts"]
        return (m["verts"], m["normals"], faces, vvalid, m["vert_owned"],
                mesh.psum(torch.sum(m["vert_owned"])),
                global_count(mesh, m["n_faces"], vert_cap, face_cap),
                mesh.psum(m["overflow"].long()) > 0)

    return extract_canon


def make_init_canonical_sharded(mesh: Mesh, *, subsample_rate: float = 5.0,
                                node_cap: int = 2048, vert_cap: int = 1 << 13,
                                face_cap: int = 1 << 14, mc_step: int = 3):
    """Canonical-space init in the sharded vertex layout: the node
    anchors (``node_vert_idx``) index the all-gathered per-rank vertex
    blocks, so a field from ``pipeline.frame.init_canonical`` must not be
    fed to :func:`make_fusion_frame_sharded`'s frame. Same construction as
    ``init_canonical`` (radius = subsample_rate × mean face edge, the
    graph on the owned vertices). Returns init(values slab) → (wf,
    radius), replicated."""
    extract_canon = _make_extract_canon(mesh, vert_cap, face_cap, mc_step)
    psum = mesh.psum

    def init(values):
        verts, _n, faces, _vv, owned, _no, n_faces, _ov = extract_canon(
            values)
        verts_g = mesh.all_gather(verts)
        # this rank's faces on the gathered vertices; an invalid face
        # slot names vertex 0 three times, so its edge mean is 0
        tri = verts_g[faces]                                  # (F, 3, 3)
        e = (torch.linalg.vector_norm(tri[:, 0] - tri[:, 1], dim=1)
             + torch.linalg.vector_norm(tri[:, 0] - tri[:, 2], dim=1)
             + torch.linalg.vector_norm(tri[:, 1] - tri[:, 2], dim=1)) / 3.0
        radius = subsample_rate * psum(torch.sum(e)) / torch.clamp_min(
            n_faces, 1)
        wf = WF.construct_graph(
            verts_g, radius, node_cap,
            valid=mesh.all_gather(owned.to(torch.uint8)).bool())
        return wf, radius

    return init


def make_fusion_frame_sharded(
    mesh: Mesh, *, regularization_weight: float = 0.5, knn_k: int = 4,
    tdist: float = 0.2, wmax: float = 100.0, vert_cap: int = 1 << 13,
    face_cap: int = 1 << 14, live_vert_cap: int | None = None,
    live_face_cap: int | None = None, mc_step: int = 3,
    solve_iters: int = 3, gn_iters: int = 8, cg_iters: int = 16,
    ftol: float = 1e-5, tolerance: float = 0.2, brick: int = 8,
    n_candidates: int = 16, update_graph: bool = True,
    approx_knn: bool = False, reuse_corr: bool = True,
):
    """Build the sharded frame (JAX's defaults). ``vert_cap``/
    ``live_vert_cap`` are per-rank caps (they must cover the largest
    slab's surface). Returns

        frame(values, weights, live, wf, lw_dq)
            → (values', weights', wf', lw', FrameStats, mesh_out)

    with values/weights this rank's x-slab, live/wf/lw replicated, and
    mesh_out this rank's block of the canonical mesh after fusion
    (verts/normals/faces/vert_valid/vert_owned, counts over all ranks)."""
    live_vert_cap = vert_cap if live_vert_cap is None else live_vert_cap
    live_face_cap = face_cap if live_face_cap is None else live_face_cap
    kc = max(4 * knn_k, 16)
    psum = mesh.psum
    extract_canon = _make_extract_canon(mesh, vert_cap, face_cap, mc_step)

    def extract_live(live):
        m = mc_local_slab(live, mesh, vert_cap=live_vert_cap,
                          face_cap=live_face_cap, step_size=1,
                          with_normals=False, replicated_vol=True)
        lvalid = torch.arange(live_vert_cap, device=live.device) < (
            m["n_verts"])
        return (mesh.all_gather(m["verts"]),
                mesh.all_gather(lvalid.to(torch.uint8)).bool(),
                psum(m["overflow"].long()) > 0)

    def solve_stage(wf, lw_dq, verts, normals, owned, nbr_idx, blend_wts,
                    lverts, lvalid, pair_i, pair_j, pair_v, base_scale,
                    pmask0, ell_dict):
        dev = verts.device
        zero_i = torch.zeros((), dtype=torch.long, device=dev)
        cand_risk = zero_i
        if reuse_corr:
            wv0 = WF.warp_points(wf, verts, nbr_idx, m_lw=lw_dq)
            cand_idx, d_kc, cr = correspondence_candidates(
                wv0, owned, lverts, lvalid, kc=kc, approx=approx_knn)
            cand_risk = psum(torch.as_tensor(cr, device=dev))
            n_valid0 = psum(torch.sum(owned))
            risk_cap = torch.clamp_min(
                (CORR_REFRESH_FRAC * n_valid0.float()).long(), 8)

        def correspondences(wf_, lw_):
            """(corr, valid, uncertified vertices, refreshed) of a round;
            the refresh predicate is all-reduced (module docstring)."""
            wv, wn = WF.warp_points(wf_, verts, nbr_idx, normals=normals,
                                    m_lw=lw_)
            if reuse_corr:
                c, v, _, risk_l = correspondences_from_candidates(
                    wv, wn, owned, lverts, lvalid, cand_idx, d_kc, wv0,
                    knn_k, tolerance)
                risk = psum(risk_l)
                if not bool(risk > risk_cap):
                    return c, v, risk, zero_i
            c, v, _ = closest_point_correspondences(
                wv, wn, owned, lverts, lvalid, knn_k, tolerance,
                approx=approx_knn)
            refreshed = torch.ones_like(zero_i) if reuse_corr else zero_i
            return c, v, zero_i, refreshed

        # rigid presolve: the 8×8 normal system all-reduced
        corr, cvalid, risk0, refresh0 = correspondences(wf, lw_dq)
        pv, pn = WF.warp_points(wf, verts, nbr_idx, normals=normals)
        lw_dq, _ = solve_rigid_core(lw_dq, pv, pn, corr, cvalid,
                                    iterations=12, reduce=psum)
        n_corr0 = psum(torch.sum(cvalid))

        M = wf.capacity
        ctx = SolverCtx(make_block_ell_sharded(
            ell_dict, nbr_idx, owned, pair_i, pair_j, pmask0, M, psum,
            mesh.world))
        node_dq = wf.node_dq
        rw = torch.tensor(regularization_weight, dtype=torch.float32,
                          device=dev)
        dmp = torch.tensor(1e-4, device=dev)
        zero = torch.zeros((), device=dev)
        act = True
        cbs, cbhs, cas, ellovs = [], [], [], []
        corr_risk, corr_refresh = cand_risk + risk0, refresh0
        for _ in range(solve_iters):
            if not act:  # every rank reads the same all-reduced energies
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
            node_dq, cb, cbh, ca, dmp, ellov = gn_solve_core(
                node_dq, data_args, reg_args, lw_dq, gn_iters, cg_iters,
                1e-4, ftol, psum, damping_init=torch.clamp_max(dmp, 1e-2),
                solver_ctx=ctx)
            cbs.append(cb)
            cbhs.append(cbh)
            cas.append(ca)
            ellovs.append(ellov)
            relax, rw = relaxation_step(cb, ca, rw)
            act = bool(relax)
        ell_ov = (torch.sum(torch.stack(ellovs)) if ellovs
                  else torch.zeros((), dtype=torch.long, device=dev))
        return (node_dq, lw_dq, stack_rounds(cbs, dev),
                stack_rounds(cbhs, dev), stack_rounds(cas, dev), n_corr0,
                corr_risk, corr_refresh, ell_ov)

    def frame(values, weights, live, wf, lw_dq):
        M = wf.capacity
        # A. surfaces
        (cverts, cnormals, _cfaces, _cvalid, cowned, _n_owned, _nf,
         cov) = extract_canon(values)
        lverts, lvalid, lov = extract_live(live)

        # B. frame-constant plumbing on the global sparsity: the kNN
        # rows are per vertex (this block's), the reg pairs read the
        # anchors' rows of the gathered table
        nbr_idx = WF.neighbor_lookup(wf, cverts, knn_k)
        blend_wts = _blend_weights(wf, cverts, nbr_idx)
        nbr_g = mesh.all_gather(nbr_idx)
        pair_i, pair_j, _, pmask0 = make_reg_pairs(
            wf.node_vert_idx, nbr_g, wf.node_w, wf.active, 1.0)
        pair_v = wf.node_pos[pair_j]
        base_scale = torch.maximum(wf.node_w[pair_i], wf.node_w[pair_j])
        ell_dict = global_ell_dict(mesh, nbr_idx, cowned, pair_i, pair_j,
                                   pmask0, M)

        # C. presolve + relaxed GN rounds
        (node_dq, lw_dq, cbs, cbhs, cas, n_corr0, corr_risk, corr_refresh,
         ell_ov) = solve_stage(wf, lw_dq, cverts, cnormals, cowned, nbr_idx,
                               blend_wts, lverts, lvalid, pair_i, pair_j,
                               pair_v, base_scale, pmask0, ell_dict)
        wf = wf.replace(node_dq=node_dq)

        # D. fusion, per slab
        values, weights, esc, pool_risk = update_local_with_caches(
            values, weights, live, wf, lw_dq, mesh, knn_k, tdist, wmax,
            brick, n_candidates)
        esc, pool_risk = psum(esc), psum(pool_risk)

        # E. canonical re-extraction + graph maintenance, replicated on
        # the gathered surface
        (verts2, normals2, faces2, vvalid2, owned2, n_owned2, nf2,
         cov2) = extract_canon(values)
        n_dropped = torch.zeros((), dtype=torch.long, device=values.device)
        if update_graph:
            wf, n_dropped = WF.update_graph(
                wf, mesh.all_gather(verts2),
                mesh.all_gather(owned2.to(torch.uint8)).bool(), knn_k)

        mesh_out = {"verts": verts2, "normals": normals2, "faces": faces2,
                    "vert_valid": vvalid2, "vert_owned": owned2,
                    "n_verts": n_owned2, "n_faces": nf2, "overflow": cov2}
        stats = FrameStats(
            cost_before=cbs, cost_after=cas, cost_before_h=cbhs,
            n_corr=n_corr0, n_nodes=wf.num_active, n_verts=n_owned2,
            overflow=(cov | cov2 | lov | (n_dropped > 0) | (esc > 0)),
            pool_risk=pool_risk, corr_risk=corr_risk,
            corr_refresh=corr_refresh, ell_overflow=ell_ov)
        return values, weights, wf, lw_dq, stats, mesh_out

    return frame
