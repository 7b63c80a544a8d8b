"""K8 (``ops/rigid_update_cuda.py``) at the ICP ingest's shapes: the rigid
TSDF update against its plain twin, timed beside its bound.

Config 6's body mesh is rendered from 8 ring views at 512²
(:func:`profile_knn_grid.view_volumes`); view 0 fused alone into a fresh
``--res``³ TSDF is the canonical volume and view 1 fused alone the live
one, as the ICP ingest's first update sees them. Each row updates the
canonical volume by the live one under a pose, the identity and the
calibration error the ICP corrects (``profile_knn_grid.pose_dq``: 0.5°
about a tilted axis and 1.5 voxels), and reports:

* ``unequal_values``, ``unequal_weights``: voxels that differ from the
  twin (must be 0);
* ``updated``: the share of voxels whose weight the update raises;
* ``k8_ms``: the CUDA-event mean of the path's launch (float4 accesses)
  and ``scalar_ms`` the scalar instantiation's, beside the bound (20
  bytes a voxel over 3.35 TB/s) and the path's share of it;
* ``launches``: K8's launch count over the row's calls;
* the twin's time (one synced call).

Then each instantiation's registers and local (spill) bytes.

    python -m dynamicfusion_body_tpu_torch.tools.profile_rigid_update \\
        --res 512
    python -m dynamicfusion_body_tpu_torch.tools.profile_rigid_update \\
        --device cpu --res 32 --reps 1
"""

from __future__ import annotations

import time

import torch

from ..ops import rigid_update_cuda as K8
from ..pipeline.fusion import WMAX, resolve_device
from ._timing import HBM_BPS, device_label, parse_args
from .profile_knn_grid import _event_ms, pose_dq, view_volumes

BYTES_VOXEL = 20  # values and weights read and written, live read once


def run(res: int, dev, reps: int) -> list:
    """The rows (module docstring) at ``res``³ on ``dev``."""
    vols, tdist = view_volumes(res, dev, views=(0, 1))
    (values, weights), (live, _) = vols[0], vols[1]
    identity = torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0], device=dev)
    rows = []
    for name, dq in (("identity", identity), ("icp", pose_dq(res).to(dev))):
        args = (values, weights, live, dq, tdist, WMAX)
        n0 = K8.rigid_update.launches
        t0 = time.perf_counter()
        tv, tw = K8.rigid_update_ref(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        twin_ms = (time.perf_counter() - t0) * 1e3
        kv, kw = K8.rigid_update(*args)
        row = {"pose": name, "voxels": values.numel(),
               "unequal_values": int((kv != tv).sum()),
               "unequal_weights": int((kw != tw).sum()),
               "updated": round(float((kw != weights).float().mean()), 4),
               "twin_ms": round(twin_ms, 1),
               "bound_ms": BYTES_VOXEL * values.numel() / HBM_BPS * 1e3}
        del tv, tw
        if dev.type == "cuda":
            row["k8_ms"] = _event_ms(lambda: K8.rigid_update(*args), reps)
            row["scalar_ms"] = _event_ms(
                lambda: K8.launch(*args, 0, vec=1), reps)
            row["share_pct"] = 100.0 * row["bound_ms"] / row["k8_ms"]
        row["launches"] = K8.rigid_update.launches - n0
        print(row, flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    args = parse_args(argv, __doc__, reps=10)
    dev = resolve_device(args.device)
    print(f"# profile_rigid_update: {args.res}^3 on {device_label(dev)}; "
          f"reps {args.reps}", flush=True)
    rows = run(args.res, dev, args.reps)
    if dev.type == "cuda":
        for vec in (4, 1):
            print(f"# K8, vec {vec}: {K8.kernel_info(vec)}", flush=True)
    bad = sum(r["unequal_values"] + r["unequal_weights"] for r in rows)
    print(f"# voxels unequal to the twin: {bad}", flush=True)
    if bad:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
