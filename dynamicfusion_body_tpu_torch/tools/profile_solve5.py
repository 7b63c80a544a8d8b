"""Split the non-rigid solve at bench scale into its parts — the port of
``tools/profile_solve5.py``.

On the bench scene (``tools/_scene.py:bench_scene``: the canonical's
stride-2 mesh and its 4096-node field, config 4's live surface at stride
1, k = 3, the global pose of config 4) with exact correspondences at the
unwarped canonical vertices and the reg pairs at weight 0.5, each row
times one part, as a separate call:

* ``make_block_ell_dict``: the slot dictionary (``make_ell_dict``:
  ``unique`` over the coupling keys, where JAX argsorts);
* ``residual_pass``: data and reg residuals;
* ``jacobian_pass_24tangent``: the data Jacobians, ``jacfwd`` of
  ``data_residual_one`` under ``vmap`` over k·8 = 24 parameters a vertex;
* ``solve_{8,1}gn16cg_inline_ell``: ``solve_nonrigid`` at gn 8 and 1
  (the GN marginal cost), cg 16, the slot dictionary built inside;
* ``solve_{8,1}gn16cg_prebuilt_ell``: ``gn_solve_core`` with a
  ``SolverCtx`` built beforehand from the correspondence mask (the
  port's ``solver_ctx`` takes the place of JAX's ``ell_ctx``);
* ``solve_{8,1}gn16cg_prebuilt_ctx``: the same from the mesh's valid
  mask, as ``fusion_frame`` builds it once a frame;
* ``assembly_gather64_reduce``: the JᵀWJ contributions of seeded random
  Jacobians (``jtwj_contributions``) summed into the ELL slots
  (``index_add_``);
* ``corr_rerank_cached``: a round's re-rank of cached candidates (kc 12)
  at the frame-entry warp (``correspondences_from_candidates``);
* ``warp_points_mesh``: the canonical mesh warped by the field and pose.

The JAX tool's ``sorted_reducer_build+call`` is left out: it times the
sorted-segment cumsum reducer, a TPU workaround that the port's direct
``index_add_`` replaced (``solvers/nonrigid.py``). Its correspondence
searches use the TPU's approximate top-k (``approx=True``); these use the
exact search (``approx=False``), as every path on the card does.

Each row is the median synced wall and the CUDA-event mean
(``tools/_timing.py:Timer``); ``--trace DIR`` adds the busy share. The
meshes go through K1 on the card.

    python -m dynamicfusion_body_tpu_torch.tools.profile_solve5
    python -m dynamicfusion_body_tpu_torch.tools.profile_solve5 \\
        --device cpu --res 32 --reps 1
"""

from __future__ import annotations

import torch

from ..models.warp_field import warp_points
from ..pipeline.correspondence import (
    closest_point_correspondences,
    correspondence_candidates,
    correspondences_from_candidates,
)
from ..pipeline.fusion import resolve_device
from ..solvers import nonrigid as NR
from ._scene import KNN_K, bench_scene, meshes, reg_pairs
from ._timing import Timer, device_label, parse_args

TOLERANCE = 5.0  # the bench's correspondence tolerance
KC = 12          # profile_solve5.py:173: the cached candidates per vertex


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=8)
    dev = resolve_device(args.device)
    sc = bench_scene(args.res, dev)
    ms = meshes(sc)
    wf, mesh, lm = sc.wf, ms.mesh, ms.live_mesh
    M = wf.capacity
    print(f"# profile_solve5: {args.res}^3, nodes {int(wf.num_active)} M "
          f"{M}, canonical verts {int(mesh['n_verts'])}, live verts "
          f"{int(lm['n_verts'])} on {device_label(dev)}; reps {args.reps}",
          flush=True)
    corr, cvalid, _ = closest_point_correspondences(
        mesh["verts"], mesh["normals"], ms.vmask, lm["verts"], ms.lmask,
        KNN_K, TOLERANCE)
    pair_i, pair_j, pair_v, pair_scale, pmask = reg_pairs(sc, ms)
    data = (mesh["verts"], mesh["normals"], corr, cvalid, ms.nbr_idx,
            ms.blend)
    reg = (pair_i, pair_j, pair_v, pair_scale, pmask)
    t = Timer(dev, args.reps, args.trace)

    # the slot dictionary, the residual and Jacobian passes
    t("make_block_ell_dict", lambda: NR.make_ell_dict(
        ms.nbr_idx, cvalid, pair_i, pair_j, pmask, M, NR.ELL_DEGREE_CAP))
    t("residual_pass", lambda: NR._residuals(wf.node_dq, data, reg,
                                             sc.lw)[0])
    t("jacobian_pass_24tangent", lambda: NR._data_jacobians(
        wf.node_dq, data, sc.lw)[1])

    # full solves: the context inline, prebuilt from the correspondence
    # mask (JAX's ell_ctx), prebuilt from the mesh mask (fusion_frame's)
    for gn in (8, 1):
        t(f"solve_{gn}gn16cg_inline_ell", lambda gn=gn: NR.solve_nonrigid(
            wf.node_dq, *data, *reg, sc.lw, gn_iters=gn, cg_iters=16,
            dense_pairs=True))
    for name, mask in (("ell", cvalid), ("ctx", ms.vmask)):
        ctx = NR.make_solver_ctx(ms.nbr_idx, mask, pair_i, pair_j, pmask, M)
        for gn in (8, 1):
            t(f"solve_{gn}gn16cg_prebuilt_{name}",
              lambda gn=gn, ctx=ctx: NR.gn_solve_core(
                  wf.node_dq, data, reg, sc.lw, gn, 16, 1e-4, 1e-5,
                  solver_ctx=ctx))

    # the assembly reduce alone, on seeded random Jacobians and weights
    V, P = ms.nbr_idx.shape[0], pair_i.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    J_d, w_d = randn(V, KNN_K, 8), torch.abs(randn(V)) * cvalid
    J_ri, J_rj, w_r = randn(P, 3, 8), randn(P, 3, 8), torch.abs(randn(P, 3))
    reduce_ell = NR.make_block_ell(ms.nbr_idx, cvalid, pair_i, pair_j, pmask,
                                   M, NR.ELL_DEGREE_CAP)[0]
    t("assembly_gather64_reduce", lambda: reduce_ell(
        NR.jtwj_contributions(J_d, w_d, J_ri, J_rj, w_r)))

    # a round's re-rank of cached candidates, the mesh warp
    wv0, wn0 = warp_points(wf, mesh["verts"], ms.nbr_idx,
                           normals=mesh["normals"], m_lw=sc.lw)
    cand_idx, d_kc, _ = correspondence_candidates(
        wv0, ms.vmask, lm["verts"], ms.lmask, kc=KC)
    t("corr_rerank_cached", lambda: correspondences_from_candidates(
        wv0, wn0, ms.vmask, lm["verts"], ms.lmask, cand_idx, d_kc, wv0,
        KNN_K, TOLERANCE)[0])
    t("warp_points_mesh", lambda: warp_points(
        wf, mesh["verts"], ms.nbr_idx, normals=mesh["normals"],
        m_lw=sc.lw)[0])
    return t.rows


if __name__ == "__main__":
    main()
