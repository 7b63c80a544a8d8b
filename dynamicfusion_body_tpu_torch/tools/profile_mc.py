"""Split marching cubes at 256³ into its stages.

What ``tools/profile_mc.py`` is for, on the port's own stages
(``ops/marching_cubes.py``) over the bench canonical: the whole
extraction (``mc_full``), K1 ``mc_case_cross`` alone, the vertex stage
(crossing edges by ``nonzero``, their zero crossings), the face stage
(triangles per cell by ``repeat_interleave``, vertex ranks by
``searchsorted``) and the normal stage (central-difference gradients at
the vertices).

The JAX tool's rows ``a_crossmask_ranks``, ``b_a_plus_unrank``,
``c_case_ntris_ranks``, ``c2_casebytes_only``, ``f_gradient``,
``g_brick_minmax``, ``h_vranks_build``, ``i_franks_unrank_262k``,
``j_vranks_rank_incl_262k``, ``k_onehot_tri15_262k`` and
``l_vranks_unrank_131k`` time the TPU's rank/unrank compaction, one-hot
table lookups and brick min/max, which the port replaced with
``cumsum``/``nonzero`` and direct gathers; they have no counterpart and
no row here.

    python -m dynamicfusion_body_tpu_torch.tools.profile_mc
    python -m dynamicfusion_body_tpu_torch.tools.profile_mc \\
        --device cpu --res 32
"""

from __future__ import annotations

import torch

from ..ops.marching_cubes import (
    marching_cubes, mc_faces, mc_normals, mc_vertices)
from ..ops.mc_cuda import mc_case_cross
from ..pipeline.fusion import resolve_device
from ._scene import bumpy, cap
from ._timing import Timer, device_label, parse_args


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=8)
    dev = resolve_device(args.device)
    vol = torch.from_numpy(bumpy(args.res, (128, 128, 128), 0.0)).to(dev)
    vert_cap, face_cap = cap(1 << 16, args.res), cap(1 << 17, args.res,
                                                       4096)
    t = Timer(dev, args.reps, args.trace)
    m = marching_cubes(vol, 0.0, vert_cap=vert_cap, face_cap=face_cap,
                       use_kernels=True)
    print(f"# profile_mc: {args.res}^3, verts {int(m['n_verts'])} faces "
          f"{int(m['n_faces'])} (caps {vert_cap}/{face_cap}) on "
          f"{device_label(dev)}; reps {args.reps}", flush=True)
    t("mc_full", lambda: marching_cubes(vol, 0.0, vert_cap=vert_cap,
                                        face_cap=face_cap, use_kernels=True))
    t("mc_case_cross", lambda: mc_case_cross(vol, 0.0))
    fused = mc_case_cross(vol, 0.0).reshape(-1)
    t("mc_vertices", lambda: mc_vertices(vol, fused, 0.0, vert_cap))
    edges, elin, lin1, et, _ = mc_vertices(vol, fused, 0.0, vert_cap)
    t("mc_faces", lambda: mc_faces(fused, edges, vol.shape, face_cap,
                                   vert_cap))
    t("mc_normals", lambda: mc_normals(vol, elin, lin1, et))
    return t.rows


if __name__ == "__main__":
    main()
