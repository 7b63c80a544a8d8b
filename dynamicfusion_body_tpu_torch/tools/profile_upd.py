"""Split the non-rigid TSDF update at 256³ into its parts.

Port of ``tools/profile_upd.py:66-148`` on the port's
``models/warp_field.py``, the bench canonical's field and config 4's live
volume:

* ``update_full_cached_cand``: the update with cached brick candidates
  (K3 samples); ``build_warp_cache``; ``update_full_warp_cache``: the
  update with both caches (K2 samples, as the fused frame pays it);
* K2 (``k2_cached``) and K3 (``k3_kernel``) alone, with coordinates, and
  K3 as the update calls it, without (``k3_no_coords``). Their CTAs walk
  the bricks of a persistent grid, so the JAX group sweep has no
  counterpart there; it stands for K4 on K3's coordinates instead: K4 itself
  (``trilerp_only_k4``) and K4's arithmetic in K6's ``full`` mode at 128,
  256 and 512 threads per block (``trilerp_only_t*``);
* ``merge_running_average`` on K3's samples;
* with no JAX counterpart, config 4's own call (``benchmarks/suite.py``
  config 4: ``update_tsdf_nonrigid`` with no caches and zero weights,
  ``config4_update``) and its three parts: ``config4_candidates``
  (``brick_candidates_2level`` with the risk count), ``k3_no_coords`` and
  ``config4_merge``; their sum is printed beside the whole.

    python -m dynamicfusion_body_tpu_torch.tools.profile_upd
    python -m dynamicfusion_body_tpu_torch.tools.profile_upd \\
        --device cpu --res 32
"""

from __future__ import annotations

import torch

from ..models.warp_field import (
    brick_candidates_2level, build_warp_cache, merge_running_average,
    update_tsdf_nonrigid)
from ..ops.trilerp_cuda import (
    ABLATION_THREADS, trilerp_ablation, trilerp_bricks, warp_trilerp_bricks,
    warp_trilerp_bricks_cached)
from ..pipeline.fusion import resolve_device
from ._scene import KNN_K, bench_scene
from ._timing import Timer, device_label, parse_args

BRICK, N_CAND, WMAX = 8, 16, 100.0


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=8)
    dev = resolve_device(args.device)
    sc = bench_scene(args.res, dev)
    wf, live, lw, shape, tdist = sc.wf, sc.live, sc.lw, sc.shape, sc.tdist
    values = sc.canonical
    ones = torch.ones_like(values)
    zeros = torch.zeros_like(values)
    print(f"# profile_upd: {args.res}^3, nodes {int(wf.num_active)} on "
          f"{device_label(dev)}; reps {args.reps}", flush=True)
    t = Timer(dev, args.reps, args.trace)

    def candidates():
        return brick_candidates_2level(wf, shape, BRICK, N_CAND,
                                       with_risk=True, risk_k=KNN_K)

    def update(weights, **caches):
        return update_tsdf_nonrigid(values, weights, live, wf, lw, k=KNN_K,
                                    tdist=tdist, wmax=WMAX, brick=BRICK,
                                    n_candidates=N_CAND, use_kernels=True,
                                    **caches)

    cand, risk = candidates()
    t("update_full_cached_cand", lambda: update(ones,
                                               cand_cache=(cand, risk)))
    wc = build_warp_cache(wf, shape, cand, KNN_K, BRICK)
    t("build_warp_cache",
      lambda: build_warp_cache(wf, shape, cand, KNN_K, BRICK))
    t("update_full_warp_cache",
      lambda: update(ones, cand_cache=(cand, risk), warp_cache=wc))
    t("k2_cached", lambda: warp_trilerp_bricks_cached(
        live, wf.node_dq, cand, wc[0], wc[1], lw, brick=BRICK,
        vol_shape=shape))

    def k3(coords=True):
        return warp_trilerp_bricks(live, wf.node_pos, wf.node_w, wf.active,
                                   wf.node_dq, cand, lw, vol_shape=shape,
                                   brick=BRICK, k=KNN_K, coords=coords)

    t("k3_kernel", k3)
    t("k3_no_coords", lambda: k3(coords=False))
    tsdf_l, valid, wi, wx, wy, wz = k3()
    t("trilerp_only_k4", lambda: trilerp_bricks(live, wx, wy, wz))
    for threads in ABLATION_THREADS:
        t(f"trilerp_only_t{threads}",
          lambda n=threads: trilerp_ablation(live, wx, wy, wz, "full", n))
    t("merge_running_average", lambda: merge_running_average(
        values, ones, tsdf_l, valid, wi, tdist, WMAX, BRICK))

    t("config4_update", lambda: update(zeros))
    t("config4_candidates", candidates)
    t("config4_merge", lambda: merge_running_average(
        values, zeros, tsdf_l, valid, wi, tdist, WMAX, BRICK))
    parts = ("config4_candidates", "k3_no_coords", "config4_merge")
    for key in ("wall_ms", "event_ms"):
        if t.rows["config4_update"][key] is None:
            continue
        split = [t.rows[p][key] for p in parts]
        whole = t.rows["config4_update"][key]
        print(f"# config 4 split ({key}): candidates {split[0]:.4f} + K3 "
              f"{split[1]:.4f} + merge {split[2]:.4f} = {sum(split):.4f} ms "
              f"of the whole update's {whole:.4f} ms "
              f"({sum(split) / whole:.1%})", flush=True)
    return t.rows


if __name__ == "__main__":
    main()
