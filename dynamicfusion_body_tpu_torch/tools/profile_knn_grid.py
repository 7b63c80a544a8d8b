"""K7 (``ops/knn_grid_cuda.py``) at the ICP ingest's shapes: the exact
lattice k-NN against its plain twin, timed beside its bound.

The repository's body mesh (``meshes/original.obj``) is rendered from 8
ring views at 512² (config 6's cameras); each view is fused alone into a
fresh ``--res``³ TSDF on the grid the 8 views calibrate, as
``FusionDM.compute_live_tsdf(useICP=True)`` fuses them, and meshed at
stride 1. Each row searches view 0's mesh (the queries: the canonical
vertices, moved by a rigid pose as the ICP moves them) in a later view's
mesh (the points), k = 4, and reports:

* ``unequal``: query slots whose index or distance differs from the
  twin's (must be 0);
* the share of queries whose 4th neighbour lies beyond 4 voxels;
* the CUDA-event mean of the whole search (build and query) and of the
  query kernel alone, its bound (queries and points read once, the
  outputs written once, over 3.35 TB/s: ``h100bench/counts_icp.py``'s
  count) and the share;
* the twin's time (one synced call).

Then the query kernel's registers and local (stack) bytes.

    python -m dynamicfusion_body_tpu_torch.tools.profile_knn_grid
    python -m dynamicfusion_body_tpu_torch.tools.profile_knn_grid \\
        --device cpu --res 32 --reps 1
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..benchmarks.suite import IMG, N_VIEWS, _render_views, camera
from ..benchmarks.suite import reference_mesh
from ..models.tsdf_volume import TsdfVolume
from ..ops import knn_grid_cuda as K7
from ..ops.marching_cubes import marching_cubes
from ..ops.projection import estimate_alignment, make_ind_matrix
from ..pipeline.fusion import FusionDM, resolve_device
from ._timing import HBM_BPS, device_label, parse_args

K = 4
# ~0.5 degrees about a tilted axis through the lattice's centre, and a
# voxel and a half along it: the calibration error the ICP corrects
ANGLE = math.radians(0.5)
SHIFT = 1.5


def pose_dq(res: int) -> torch.Tensor:
    """The rigid DQ (w, x, y, z, dual) of the rows' moved queries."""
    axis = np.array([0.3, 1.0, 0.2])
    axis /= np.linalg.norm(axis)
    qr = np.concatenate([[math.cos(ANGLE / 2)], math.sin(ANGLE / 2) * axis])
    c = np.full(3, res / 2)
    rot = _rotmat(qr)
    t = c - rot @ c + SHIFT * axis
    tq = np.concatenate([[0.0], t])
    qd = 0.5 * _qmul(tq, qr)
    return torch.tensor(np.concatenate([qr, qd]), dtype=torch.float32)


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def _rotmat(q):
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)]])


def view_volumes(res: int, dev, views=(0, 1, 2, 4)):
    """({view: (values, weights) of its single-view TSDF at res³}, tdist),
    each view fused alone on the grid the 8 views calibrate, as
    ``FusionDM.compute_live_tsdf(useICP=True)`` fuses them."""
    verts, faces = reference_mesh()
    img = IMG if dev.type == "cuda" else 64
    Kc = camera(img)
    depths, lws = _render_views(verts, faces, Kc, N_VIEWS, img, img, dev)
    fus = FusionDM(8.0 / res * 1.3, Kc, tsdf_res=res, device=dev)
    maps = fus._stack(depths)
    avg, std = estimate_alignment(maps, fus._tensor(fus._Kinv),
                                  fus._stack(lws))
    ind = make_ind_matrix(res, avg, std, factor=8.0)
    fus.volume = TsdfVolume.create(res, fus._tdist, ind=ind)
    out = {}
    for v in views:
        fresh = TsdfVolume.create(res, fus._tdist, ind=ind)
        out[v] = fus._fuse(fresh.values, fresh.weights, maps[v:v + 1],
                           [lws[v]])
    return out, fus._tdist


def view_meshes(res: int, dev, views=(0, 1, 2, 4)):
    """{view: (verts (cap,3), n_verts 0-d)} of the views' single-view
    TSDFs at res³ (:func:`view_volumes`), meshed at stride 1."""
    vols, _ = view_volumes(res, dev, views)
    cap = 1 << max(14, math.ceil(math.log2(40.0 * res * res)))
    out = {}
    for v, (vol, _) in vols.items():
        m = marching_cubes(vol, vert_cap=cap, face_cap=2 * cap,
                           with_normals=False, use_kernels=True)
        if bool(m["overflow"]):
            raise RuntimeError(f"view {v}: mesh over the cap {cap}")
        out[v] = (m["verts"], m["n_verts"])
    return out


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> list:
    args = parse_args(argv, __doc__, reps=10, extend=lambda ap: (
        ap.add_argument("--cell", type=float, default=None,
                        help="voxels a leaf cell spans, a power of two "
                             "(default: the search's own for --res)")))
    dev = resolve_device(args.device)
    meshes = view_meshes(args.res, dev)
    dq = pose_dq(args.res).to(dev)
    from ..ops.dualquat import dq_transform_point

    canon, n_q = meshes[0]
    if args.cell is None:
        args.cell = K7.leaf_cell(args.res)
    levels = K7.grid_levels(args.res, args.cell)
    print(f"# profile_knn_grid: {args.res}^3 on {device_label(dev)}; "
          f"{int(n_q)} queries (view 0), grid 2^{levels} cells of "
          f"{args.cell} voxels, reps {args.reps}", flush=True)
    rows = []
    for v in sorted(meshes)[1:]:
        pts, n_p = meshes[v]
        for moved in (False, True):
            q = dq_transform_point(dq, canon) if moved else canon
            t0 = time.perf_counter()
            rd, ri = K7.knn_grid_ref(q, pts, K, n_q, n_p, levels, args.cell)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            twin_ms = (time.perf_counter() - t0) * 1e3
            d, i = K7.knn_grid(q, pts, K, n_q, n_p, args.res, args.cell)
            nq, npt = int(n_q), int(n_p)
            unequal = int(((i != ri) | (d != rd))[:nq].any(1).sum())
            far = float((rd[:nq, -1] > 4.0).float().mean())
            row = {"view": v, "moved": moved, "queries": nq, "points": npt,
                   "unequal": unequal, "far_share": round(far, 4),
                   "twin_ms": round(twin_ms, 1)}
            nbytes = 12 * nq + 12 * npt + nq * K * 12
            row["bound_ms"] = nbytes / HBM_BPS * 1e3
            if dev.type == "cuda":
                nqt = n_q.to(torch.int32)
                npp = n_p.to(torch.int32)
                built = K7.grid_build(pts, npp, levels, args.cell)
                row["search_ms"] = _event_ms(
                    lambda: K7.knn_grid(q, pts, K, n_q, n_p, args.res,
                                        args.cell), args.reps)
                row["query_ms"] = _event_ms(
                    lambda: K7.grid_query(q, nqt, *built, K, levels,
                                          args.cell), args.reps)
                row["share_pct"] = 100.0 * row["bound_ms"] / row["query_ms"]
            print(row, flush=True)
            rows.append(row)
    if dev.type == "cuda":
        print(f"# K7 query kernel, k={K}: {K7.kernel_info(K)}", flush=True)
    bad = sum(r["unequal"] for r in rows)
    print(f"# unequal slots against the twin: {bad}", flush=True)
    if bad:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
