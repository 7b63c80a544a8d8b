"""Split the non-rigid solve at bench scale into its fixed, per-GN and
per-CG cost.

Port of ``tools/profile_solve.py``: on the bench canonical's stride-2
mesh and field, warped by the field and config 4's global pose, against
the live mesh, it times the exact correspondence search (``corr_exact``),
the bf16-keyed one (``corr_approx``: ``approx=True``, an exact selection
on the card as off the TPU in the JAX package) and ``solve_nonrigid`` on
the exact correspondences over the JAX grid of (GN, CG) iterations
``(1,1) (1,4) (1,16) (2,16) (4,16) (8,16) (8,4)``
(``profile_solve.py:97-100``), with ``dense_pairs`` as there. The solve is host-bound (one host-read predicate per GN step and LM try),
so its CUDA-event time includes the card's idle gaps; ``--trace`` gives
the busy share.

    python -m dynamicfusion_body_tpu_torch.tools.profile_solve
    python -m dynamicfusion_body_tpu_torch.tools.profile_solve \\
        --device cpu --res 32
"""

from __future__ import annotations

from ..models.warp_field import warp_points
from ..pipeline.correspondence import closest_point_correspondences
from ..pipeline.fusion import resolve_device
from ..solvers.nonrigid import solve_nonrigid
from ._scene import KNN_K, bench_scene, meshes, reg_pairs
from ._timing import Timer, device_label, parse_args

GRID = ((1, 1), (1, 4), (1, 16), (2, 16), (4, 16), (8, 16), (8, 4))
TOLERANCE = 5.0  # the bench's correspondence tolerance


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=8)
    dev = resolve_device(args.device)
    sc = bench_scene(args.res, dev)
    ms = meshes(sc)
    wf, mesh, lm = sc.wf, ms.mesh, ms.live_mesh
    print(f"# profile_solve: {args.res}^3, nodes {int(wf.num_active)}, "
          f"canonical verts {int(mesh['n_verts'])}, live verts "
          f"{int(lm['n_verts'])} on {device_label(dev)}; reps {args.reps}",
          flush=True)
    wv, wn = warp_points(wf, mesh["verts"], ms.nbr_idx,
                         normals=mesh["normals"], m_lw=sc.lw)
    t = Timer(dev, args.reps, args.trace)

    def corr_exact():
        return closest_point_correspondences(
            wv, wn, ms.vmask, lm["verts"], ms.lmask, KNN_K, TOLERANCE)

    t("corr_exact", corr_exact)
    t("corr_approx", lambda: closest_point_correspondences(
        wv, wn, ms.vmask, lm["verts"], ms.lmask, KNN_K, TOLERANCE,
        approx=True))
    corr, cvalid, _ = corr_exact()
    data = (mesh["verts"], mesh["normals"], corr, cvalid, ms.nbr_idx,
            ms.blend)
    pairs = reg_pairs(sc, ms)
    for gn, cg in GRID:
        t(f"solve_gn{gn}_cg{cg}",
          lambda gn=gn, cg=cg: solve_nonrigid(
              wf.node_dq, *data, *pairs, sc.lw, gn_iters=gn, cg_iters=cg,
              dense_pairs=True))
    return t.rows


if __name__ == "__main__":
    main()
