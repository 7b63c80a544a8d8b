"""K9 (``ops/icp_pick_cuda.py``) at the ICP ingest's shapes: the rigid
ICP's warp and pick held to the plain composition they replace, on the
card, and timed beside their bound.

First the small cases of :func:`edge_cases` (no rows counted, some, all;
no live vertex; k = 1, 4, 8; tied costs; non-finite rows past the count;
costs above 1; NaN normals), then the ingest's first search: config 6's
body mesh rendered from 8 ring views at 512²
(:func:`profile_knn_grid.view_volumes`), view 0 fused alone and meshed
with normals at the ICP cell's caps (2^23 vertex slots at 512³) as the
canonical mesh, view 1's mesh the live one, the canonical mesh moved by
the calibration error the ICP corrects (``profile_knn_grid.pose_dq``).
Each row reports:

* ``unequal``: elements of (corr, valid, best_cost) whose bits differ
  between K9 (:func:`rigid_correspondences_lattice`) and the composition
  (``pipeline/correspondence.py:rigid_correspondences_twin``) on the
  same device (must be 0);
* ``launches`` and ``host_reads`` of one call of each (the kernel
  launches a profiler sees; the program's ``host_read`` count);
* the CUDA-event means of the whole search both ways, of K7 alone, and
  of the warp and the pick kernels alone, beside their bound (bytes over
  3.35 TB/s: the warp reads and writes 12 bytes a counted row; the pick
  reads k slots of 12 bytes and writes 17 bytes a row, and reads 24
  bytes a row with a candidate and 12 a candidate found) and share.

Then the order in which ``torch.sum`` adds three terms on the card (the
pick adds them so), and each kernel's registers, local (spill) bytes and
CTAs per SM. On the CPU both sides are the composition: a rehearsal.

    python -m dynamicfusion_body_tpu_torch.tools.profile_icp_pick --res 512
    python -m dynamicfusion_body_tpu_torch.tools.profile_icp_pick \\
        --device cpu --res 32 --reps 1
"""

from __future__ import annotations

import math

import torch

from ..ops import icp_pick_cuda as K9
from ..ops.dualquat import IDENTITY_DQ
from ..ops.knn_grid_cuda import knn_grid
from ..ops.marching_cubes import marching_cubes
from ..pipeline.correspondence import rigid_correspondences_twin
from ..pipeline.fusion import FusionDM, resolve_device
from ..utils.profiling import LAUNCH_CALLS, RECORDER, tracing
from ._timing import HBM_BPS, device_label, parse_args
from .profile_knn_grid import _event_ms, pose_dq, view_volumes

K = 4                    # FusionDM's default knn
TOLERANCE = FusionDM.ICP_TOLERANCE


def vert_cap(res: int) -> int:
    """The canonical mesh's slots: the ICP cell's 2^23 at 512³, scaled
    with the surface (res²) elsewhere."""
    return 1 << math.ceil(math.log2(32 * res * res))


def edge_cases(dev) -> dict:
    """{name: the arguments of :func:`rigid_correspondences_lattice`} on a
    32³ lattice, the counts 0-d int32 tensors as the marching cubes return
    them."""
    g = torch.Generator().manual_seed(0)
    V, P, n, n_live = 96, 80, 64, 70
    dq = pose_dq(32)
    verts = 4.0 + 24.0 * torch.rand(V, 3, generator=g)
    normals = torch.nn.functional.normalize(torch.randn(V, 3, generator=g),
                                            dim=1)
    live = 4.0 + 24.0 * torch.rand(P, 3, generator=g)

    def case(dq=dq, verts=verts, normals=normals, n=n, live=live,
             n_live=n_live, k=K, tolerance=TOLERANCE):
        count = lambda c: torch.tensor(c, dtype=torch.int32, device=dev)
        return (torch.as_tensor(dq, dtype=torch.float32).to(dev),
                verts.to(dev), normals.to(dev), count(n), live.to(dev),
                count(n_live), k, tolerance, 32.0)

    bad = verts.clone()
    bad[n::2] = torch.inf
    bad[n + 1::2] = torch.nan
    nan_normals = normals.clone()
    nan_normals[::5] = torch.nan
    # cells' centres a quarter voxel above the lattice points, normals
    # along z, the identity pose: four nearest at one distance, one cost
    ax = torch.arange(8.0, 14.0)
    lattice = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                          -1).reshape(-1, 3)
    centres = lattice[:V] + torch.tensor([0.5, 0.5, 0.25])
    up = torch.tensor([0.0, 0.0, 1.0]).expand(V, 3).contiguous()
    # every live vertex 8 or more voxels along the normals: costs above 1
    far = verts.clone()
    far[:, 2] = 10.0 + 2.0 * torch.rand(V, generator=g)
    far_live = live.clone()
    far_live[:, 2] = 20.0 + 2.0 * torch.rand(P, generator=g)
    return {
        "rows_0": case(n=0),
        "rows_some": case(),
        "rows_all": case(n=V),
        "live_0": case(n_live=0),
        "k1": case(k=1),
        "k4": case(n=V, k=4),
        "k8": case(k=8),
        "tie": case(dq=IDENTITY_DQ, verts=centres, normals=up, n=V,
                    live=lattice, n_live=lattice.shape[0]),
        "nonfinite_past_n": case(verts=bad),
        "fallback": case(verts=far, normals=up, live=far_live),
        "fallback_tol_half": case(verts=far, normals=up, live=far_live,
                                  tolerance=0.5),
        "nan_normals": case(normals=nan_normals),
    }


def unequal(a, b) -> int:
    """Elements of the outputs (corr, valid, best_cost) whose bits
    differ."""
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    return sum(int((bits(x) != bits(y)).sum()) for x, y in zip(a, b))


def launches(fn, dev) -> int | None:
    """The kernel launches of one call of ``fn`` (None off the card)."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.name in LAUNCH_CALLS for e in prof.events())


def host_reads(fn) -> int:
    """The program's ``host_read`` count over one call of ``fn``."""
    RECORDER.reset()
    with tracing():
        fn()
    reads = sum(c for p, c in RECORDER.counts.items()
                if p.rsplit("/", 1)[-1] == "host_read")
    RECORDER.reset()
    return reads


def sum_order(dev, n: int = 1 << 20) -> dict | None:
    """Rows of torch.sum over a last axis of 3 that differ from each
    order of adding the three terms, on random float32 (None off the
    card)."""
    if dev.type != "cuda":
        return None
    g = torch.Generator(device=dev).manual_seed(1)
    t = torch.randn(n, K, 3, generator=g, device=dev) * torch.exp(
        4.0 * torch.randn(n, K, 3, generator=g, device=dev))
    s = torch.sum(t, -1)
    t0, t1, t2 = t.unbind(-1)
    orders = {"(t0+t1)+t2": (t0 + t1) + t2, "(t0+t2)+t1": (t0 + t2) + t1,
              "t0+(t1+t2)": t0 + (t1 + t2)}
    return {name: int((s != o).sum()) for name, o in orders.items()}


def pick_bytes(dists, k: int) -> int:
    """The pick's bytes (module docstring) for K7's ``dists``."""
    found = torch.isfinite(dists)
    V = dists.shape[0]
    return (12 * k * V + 17 * V + 24 * int(found.any(1).sum())
            + 12 * int(found.sum()))


def compare(name: str, args, dev, reps: int, timed: bool) -> dict:
    """One row (module docstring) for the arguments ``args`` of
    :func:`rigid_correspondences_lattice`, timed where ``timed``."""
    dq, verts, normals, n, live, n_live, k, tol, extent = args
    kern = lambda: K9.rigid_correspondences_lattice(*args)
    plain = lambda: rigid_correspondences_twin(*args)
    row = {"case": name, "rows": verts.shape[0], "counted": int(n),
           "k": k, "unequal": unequal(kern(), plain()),
           "launches": launches(kern, dev),
           "launches_composition": launches(plain, dev),
           "host_reads": host_reads(kern),
           "host_reads_composition": host_reads(plain)}
    if not timed or dev.type != "cuda":
        return row
    wv = K9.warp(dq, verts, n)
    dists, idx = knn_grid(wv, live, k, n, n_live, extent)
    row["k9_ms"] = _event_ms(kern, reps)
    row["composition_ms"] = _event_ms(plain, reps)
    row["k7_ms"] = _event_ms(
        lambda: knn_grid(wv, live, k, n, n_live, extent), reps)
    row["warp_ms"] = _event_ms(lambda: K9.warp(dq, verts, n), reps)
    row["pick_ms"] = _event_ms(
        lambda: K9.pick(dq, wv, normals, n, live, dists, idx, tol), reps)
    row["warp_bound_ms"] = 24 * min(int(n), verts.shape[0]) / HBM_BPS * 1e3
    row["pick_bound_ms"] = pick_bytes(dists, k) / HBM_BPS * 1e3
    row["warp_share_pct"] = 100.0 * row["warp_bound_ms"] / row["warp_ms"]
    row["pick_share_pct"] = 100.0 * row["pick_bound_ms"] / row["pick_ms"]
    return row


def search_args(res: int, dev):
    """The ingest's first search at ``res``³ (module docstring)."""
    vols, _ = view_volumes(res, dev, views=(0, 1))
    cap = vert_cap(res)
    canon = marching_cubes(vols[0][0], vert_cap=cap, face_cap=2 * cap,
                           with_normals=True, use_kernels=True)
    live = marching_cubes(vols[1][0], vert_cap=cap, face_cap=2 * cap,
                          with_normals=False, use_kernels=True)
    for name, m in (("view 0", canon), ("view 1", live)):
        if bool(m["overflow"]):
            raise RuntimeError(f"{name}: mesh over the cap {cap}")
    return (pose_dq(res).to(dev), canon["verts"], canon["normals"],
            canon["n_verts"], live["verts"], live["n_verts"], K, TOLERANCE,
            float(res))


def main(argv=None) -> list:
    args = parse_args(argv, __doc__, reps=10)
    dev = resolve_device(args.device)
    print(f"# profile_icp_pick: {args.res}^3 on {device_label(dev)}; reps "
          f"{args.reps}", flush=True)
    rows = []
    for name, case in edge_cases(dev).items():
        rows.append(compare(name, case, dev, args.reps, timed=False))
        print(rows[-1], flush=True)
    rows.append(compare("search", search_args(args.res, dev), dev,
                        args.reps, timed=True))
    print(rows[-1], flush=True)
    if dev.type == "cuda":
        print(f"# torch.sum over 3 terms on the card, rows unequal to each "
              f"order: {sum_order(dev)}", flush=True)
        for which, kernel in enumerate(("icp_warp_kernel",
                                        "icp_pick_kernel")):
            print(f"# {kernel}: {K9.kernel_info(which)}", flush=True)
    bad = sum(r["unequal"] for r in rows)
    print(f"# unequal elements against the composition: {bad}", flush=True)
    if bad:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
