"""Time the frame's candidate search at the bench's shapes: the flat exact
search against the two-level pools.

Port of ``tools/profile_corr5.py``. A ``reuse_corr`` frame runs one
candidate search of kc = 16 per frame: the bench canonical's stride-2
vertices, warped by the ``init_canonical`` field and config 4's global
pose (the frame-entry warp), against the live mesh at stride 1. Rows:
the flat exact search (``knn_exact_kc16``), the bf16-keyed search
(``knn_approx_kc16``, what ``approx=True`` computes off the TPU) and
``knn_2level`` at the JAX tool's (chunk, pool) settings
(``knn_2lvl_c{chunk}_p{pool}``, each with its ``risk`` count). The
bf16-keyed row and the 2-level row at its defaults (chunk 1024, pool
4096) also get ``agree``: over the valid queries, the share whose 16
indices equal the flat search's, in order, and the mean and least
overlap of the index sets.

    python -m dynamicfusion_body_tpu_torch.tools.profile_corr5
    python -m dynamicfusion_body_tpu_torch.tools.profile_corr5 \\
        --device cpu --res 32 --reps 1
"""

from __future__ import annotations

import torch

from ..models.warp_field import warp_points
from ..ops.knn import knn, knn_2level
from ..pipeline.fusion import resolve_device
from ._scene import bench_scene, meshes
from ._timing import Timer, device_label, parse_args

KC = 16  # max(4 * knn_k, 16) at the bench's knn_k = 3
POOLS = ((1024, 4096), (2048, 8192), (1024, 8192), (512, 4096))


def agreement(idx, ref, qmask) -> dict:
    """Over the queries in ``qmask``: the share whose index rows equal
    ``ref``'s, and the mean and least size of the index sets' overlap."""
    idx, ref = idx[qmask], ref[qmask]
    overlap = torch.sum(torch.any(idx[:, :, None] == ref[:, None, :], 2), 1)
    return dict(equal=float(torch.mean(torch.all(idx == ref, 1).float())),
                overlap_mean=float(torch.mean(overlap.float())),
                overlap_min=int(torch.min(overlap)))


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=5)
    dev = resolve_device(args.device)
    sc = bench_scene(args.res, dev)
    ms = meshes(sc)
    q = warp_points(sc.wf, ms.mesh["verts"], ms.nbr_idx, m_lw=sc.lw)
    p, vmask, lmask = ms.live_mesh["verts"], ms.vmask, ms.lmask
    print(f"# profile_corr5: {args.res}^3, queries {int(vmask.sum())} of "
          f"{len(q)}, live verts {int(lmask.sum())} of {len(p)}, kc {KC} "
          f"on {device_label(dev)}; reps {args.reps}", flush=True)
    t = Timer(dev, args.reps, args.trace)
    t("knn_exact_kc16", lambda: knn(q, p, KC, valid=lmask))
    t("knn_approx_kc16", lambda: knn(q, p, KC, valid=lmask, approx=True))
    for chunk, pool in POOLS:
        risk = int(knn_2level(q, p, KC, qvalid=vmask, valid=lmask,
                              chunk=chunk, pool=pool)[2])
        t(f"knn_2lvl_c{chunk}_p{pool}",
          lambda c=chunk, n=pool: knn_2level(q, p, KC, qvalid=vmask,
                                             valid=lmask, chunk=c, pool=n),
          risk=risk)
        print(f"{'':34s} risk {risk}", flush=True)
    ref = knn(q, p, KC, valid=lmask)[1]
    for row, idx in (
            ("knn_2lvl_c1024_p4096",
             knn_2level(q, p, KC, qvalid=vmask, valid=lmask)[1]),
            ("knn_approx_kc16", knn(q, p, KC, valid=lmask, approx=True)[1])):
        a = t.rows[row]["agree"] = agreement(idx, ref, vmask)
        print(f"# {row} vs knn_exact_kc16: indices equal on "
              f"{a['equal']:.4f} of the queries; candidate overlap mean "
              f"{a['overlap_mean']:.2f}/{KC}, min {a['overlap_min']}",
              flush=True)
    return t.rows


if __name__ == "__main__":
    main()
