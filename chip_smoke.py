#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dynamicfusion_body_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):
  0. print the card, torch and CUDA versions; build the kernels from
     ``dynamicfusion_body_tpu_torch/csrc`` with nvcc for sm_90a;
  1. K1 (mc_case_cross) against its plain twin at 256³, 128³ and an odd
     shape — bit-equal;
  2. K2 (warp_trilerp_bricks_cached) against its plain twin on the 256³
     bench state with perturbed node DQs and a clipped live TSDF, so that
     both mip-certified classes occur;
  3. the bench scene (bench.py): init_canonical, 2 warm-up frames and 3
     timed frames of fusion_frame at 256³ with the bench's settings and
     exact kNN, through the kernels; both kernels must have launched, no
     mesh may overflow its cap (the 4096-node pool is full from
     init_canonical on, so FrameStats.overflow is reported, not checked)
     and every frame must keep tracking (energy per correspondence after
     the solve below TRACK_MAX);
  4. one frame of the plain arm (use_kernels=False) from the state of the
     last timed frame: p99.9 |Δtsdf| < 0.5 (bench gate 1).
The last lines are the kernel table and the card as JSON, then
``{"ok": true, "device": {...}}``. No result is printed without a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

RES = 256
K2_TOL_COORD = 1e-4  # voxels: a few f32 ulps at 256 (kernel vs twin)
K2_TOL_VAL = 1e-4    # TSDF units: K2_TOL_COORD times |∇live| <= ~1
GATE_DEV_P999 = 0.5  # bench gate 1 (bench.py:314-340), in voxels
# Tracking sanity: huberized energy per correspondence after the solve, in
# voxels² (0.05 ~ a 0.3-voxel RMS point-to-plane residual). Measured
# 2e-4..1.3e-3 on the bench frames; ~1 when far-field warps blow up.
TRACK_MAX = 0.05


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, reps=10):
    """Mean device time of ``fn`` in ms over ``reps`` launches (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_k1(torch, dev):
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import (
        mc_case_cross, mc_case_cross_ref)

    rng = np.random.default_rng(1)
    row = None
    for shape in ((RES,) * 3, (RES // 2,) * 3, (37, 41, 53)):
        vol = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
        got = mc_case_cross(vol, 0.0)
        want = mc_case_cross_ref(vol, 0.0)
        err = float(torch.max(torch.abs(got - want)))
        check(err == 0.0, f"K1 differs from its twin at {shape} by {err}")
        ms = cuda_ms(torch, lambda: mc_case_cross(vol, 0.0))
        plain = cuda_ms(torch, lambda: mc_case_cross_ref(vol, 0.0))
        print(f"# K1 {shape}: bit-equal; kernel {ms:.4f} ms, twin "
              f"{plain:.4f} ms")
        if row is None:  # the live MC shape of the main path
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    return row


def bench_state(torch, dev):
    from bench import bumpy_sdf
    from dynamicfusion_body_tpu_torch.ops.marching_cubes import marching_cubes
    from dynamicfusion_body_tpu_torch.pipeline.frame import init_canonical

    canonical = torch.from_numpy(
        bumpy_sdf(RES, (128, 128, 128), 70.0, 4.0, 3.0, 0.0)).to(dev)
    lives = [torch.from_numpy(bumpy_sdf(RES, (130, 129, 128), 70.0, 4.0,
                                        3.0, 0.05 * i)).to(dev)
             for i in range(1, 6)]
    # FrameStats.overflow also flags a full node pool, which this
    # configuration has from the start (as the JAX package does): check
    # the mesh caps directly, on the twin so no kernel launch is counted
    for name, vol, caps in (
            ("canonical", canonical, dict(vert_cap=1 << 15,
                                          face_cap=1 << 16, step_size=2)),
            *((f"live {i}", lv, dict(vert_cap=1 << 17, face_cap=1 << 18,
                                     with_normals=False))
              for i, lv in enumerate(lives))):
        check(not bool(marching_cubes(vol, **caps)["overflow"]),
              f"the {name} mesh overflows its caps")
    t0 = time.perf_counter()
    wf, radius = init_canonical(canonical, subsample_rate=1.5,
                                node_cap=4096, mc_step=2, vert_cap=1 << 15,
                                face_cap=1 << 16)
    torch.cuda.synchronize()
    print(f"# init_canonical {time.perf_counter() - t0:.2f} s: nodes "
          f"{int(wf.num_active)} radius {float(radius):.4f}")
    return canonical, lives, wf


def phase_k2(torch, dev, lives, wf):
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        live_brick_mip, mip_short_bricks, warp_trilerp_bricks_cached,
        warp_trilerp_bricks_cached_ref)
    from dynamicfusion_body_tpu_torch.pipeline.frame import _build_caches

    rng = np.random.default_rng(2)
    noise = torch.from_numpy(
        (0.02 * rng.standard_normal((wf.capacity, 8))).astype(np.float32))
    node_dq = wf.node_dq + noise.to(dev)
    (cand, _), (sel, selw, _) = _build_caches(wf, (RES,) * 3, 8, 16, 3,
                                              False)
    tdist = 3.0
    live = torch.clamp(lives[0], -tdist, tdist)
    mip = live_brick_mip(live)
    lw = torch.tensor([1, 0, 0, 0, 0, 0.1, 0, 0], dtype=torch.float32,
                      device=dev)
    args = (live, node_dq, cand, sel, selw, lw)
    kw = dict(brick=8, tdist=tdist, live_mip=mip)
    vals, valid, wx, wy, wz = warp_trilerp_bricks_cached(*args, **kw)
    r_vals, r_valid, r_wx, r_wy, r_wz = warp_trilerp_bricks_cached_ref(
        *args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(valid, r_valid), "K2 valid differs from its twin")
    err_w = max(float(torch.max(torch.abs(a - b)))
                for a, b in ((wx, r_wx), (wy, r_wy), (wz, r_wz)))
    err_v = float(torch.max(torch.abs(torch.where(r_valid, vals - r_vals,
                                                  0.0))))
    check(err_w <= K2_TOL_COORD, f"K2 coords differ by {err_w}")
    check(err_v <= K2_TOL_VAL, f"K2 values differ by {err_v}")
    short, cval = mip_short_bricks(r_wx, r_wy, r_wz, r_valid, live.shape,
                                   tdist, mip)
    n_skip = int(torch.sum(short & (cval == -tdist)))
    n_const = int(torch.sum(short & (cval != -tdist)))
    check(n_skip > 0 and n_const > 0 and bool(torch.any(~short)),
          f"mip classes missing: skip {n_skip} const {n_const}")
    check(torch.equal(vals[short], cval[short, None].expand(-1, 512)),
          "K2 short-circuited bricks are not exact constants")
    ms = cuda_ms(torch, lambda: warp_trilerp_bricks_cached(*args, **kw))
    plain = cuda_ms(torch,
                    lambda: warp_trilerp_bricks_cached_ref(*args, **kw),
                    reps=3)
    print(f"# K2 {RES}^3: valid equal, coord err {err_w:.3g}, value err "
          f"{err_v:.3g}; bricks skip {n_skip} const {n_const} full "
          f"{int(torch.sum(~short))}; kernel {ms:.4f} ms, twin {plain:.4f} ms")
    return dict(max_abs_err=max(err_w, err_v), ms=ms, plain_ms=plain)


def run_frame(torch, fusion_frame, state, live, hyper):
    values, weights, wf, lw, mesh = state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v, w, wf2, lw2, stats, mesh2 = fusion_frame(
        values, weights, live, wf, lw, canon_mesh=mesh, **hyper)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(v).all() and torch.isfinite(w).all()),
          "non-finite TSDF")
    check(int(stats.n_corr) > 0, "no correspondences")
    check(float(stats.cost_after[-1]) <= float(stats.cost_before_h[-1]),
          "the solve raised the energy")
    check(not bool(mesh2["overflow"]), "the canonical mesh overflowed")
    track = float(stats.cost_after[-1]) / max(int(stats.n_corr), 1)
    check(track < TRACK_MAX, f"tracking lost: energy per correspondence "
          f"{track:.3g} >= {TRACK_MAX}")
    print(f"# frame {ms:.1f} ms: n_corr {int(stats.n_corr)} nodes "
          f"{int(stats.n_nodes)}/{wf2.capacity} overflow flag "
          f"{bool(stats.overflow)} verts {int(stats.n_verts)} pool_risk "
          f"{int(stats.pool_risk)} ell_overflow {int(stats.ell_overflow)} "
          f"cost {float(stats.cost_before_h[-1]):.2f} -> "
          f"{float(stats.cost_after[-1]):.2f} ({track:.2e} per corr)")
    return (v, w, wf2, lw2, mesh2), ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from dynamicfusion_body_tpu_torch.ops import cuda_lib
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks_cached)
    from dynamicfusion_body_tpu_torch.pipeline.frame import fusion_frame

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    _, build_s, log = cuda_lib.build()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"# nvcc: {line.strip()}")
    cuda_lib.lib()
    print(f"# kernels built in {build_s:.1f} s")

    k1 = phase_k1(torch, dev)
    canonical, lives, wf = bench_state(torch, dev)
    k2 = phase_k2(torch, dev, lives, wf)

    tdist = float(canonical.max())
    hyper = dict(
        regularization_weight=0.5, knn_k=3, tdist=tdist, mc_step=2,
        solve_iters=1, gn_iters=12, cg_iters=16, tolerance=5.0,
        reuse_corr=False, n_candidates=16, approx_knn=False,
        use_kernels=True, vert_cap=1 << 15, face_cap=1 << 16,
        live_vert_cap=1 << 17, live_face_cap=1 << 18,
    )
    lw = torch.tensor([1, 0, 0, 0, 0, 0.1, 0, 0], dtype=torch.float32,
                      device=dev)
    state = (canonical, torch.zeros_like(canonical), wf, lw, None)

    mc_case_cross.launches = 0
    warp_trilerp_bricks_cached.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = run_frame(torch, fusion_frame, state, lives[0], hyper)
    times = []
    for live in lives[1:4]:
        prev = state
        state, ms = run_frame(torch, fusion_frame, state, live, hyper)
        times.append(ms)
    launches = (mc_case_cross.launches, warp_trilerp_bricks_cached.launches)
    check(all(n > 0 for n in launches), f"kernel launches {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"# timed frames (ms): {times}; median {np.median(times):.1f}; "
          f"peak device memory {peak_gb:.2f} GiB; launches K1 "
          f"{launches[0]} K2 {launches[1]}")

    plain_state, plain_ms = run_frame(
        torch, fusion_frame, prev, lives[3], dict(hyper, use_kernels=False))
    adiff = torch.abs(state[0] - plain_state[0]).cpu().numpy()
    dev99 = float(np.percentile(adiff, 99.9))
    print(f"# plain arm {plain_ms:.1f} ms; |tsdf_kernels - tsdf_plain| "
          f"p99.9 {dev99:.6f} max {float(adiff.max()):.6f}")
    check(dev99 < GATE_DEV_P999, f"kernel arm deviates: p99.9 {dev99}")

    pkg = "dynamicfusion_body_tpu"
    table = {"kernels": [
        dict(name="mc_case_cross", route="cuda",
             source=f"{pkg}_torch/csrc/mc_case_cross.cu",
             replaces=f"{pkg}/ops/mc_pallas.py:98", launches=launches[0],
             **k1),
        dict(name="warp_trilerp_bricks_cached", route="cuda",
             source=f"{pkg}_torch/csrc/warp_trilerp_cached.cu",
             replaces=f"{pkg}/ops/trilerp_pallas.py:656",
             launches=launches[1], **k2),
    ]}
    print(smi)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
