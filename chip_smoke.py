#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dynamicfusion_body_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):
  0. print the card, torch and CUDA versions; build the kernels from
     ``dynamicfusion_body_tpu_torch/csrc`` with nvcc for sm_90a; print the
     registers, spill bytes and CTAs per SM of K1's, K5's and K6's
     instantiations, K2 and each K3 instantiation, and K2/K3's and K6's
     persistent grids (a spill fails);
  1. K1 (mc_case_cross) against its plain twin, bit-equal, on random
     volumes at 256³ and 128³, the bench's 256³ canonical TSDF, its
     stride-2 view (read where it lies: the call may allocate its output
     only) and ragged shapes (37, 41, 53) and (2, 3, 5);
  2. K2 (warp_trilerp_bricks_cached) against its plain twin on the 256³
     bench state with perturbed node DQs and a clipped live TSDF, so that
     both mip-certified classes occur, with and without coordinates:
     bit-equal (0 voxels differ); both calls timed, the row is the
     update's (no coordinates);
  3. K3 (warp_trilerp_bricks) at config 4's 256³ shapes, with perturbed
     node DQs so that the blend depends on the Gaussian weights, at C = 8,
     16 and 32 candidates (one kernel instantiation each), with and
     without coordinates: bit-equal to its twin; at C = 16 also wi, valid
     and the values held as before and against the warp cache + K2;
  4. K4 (trilerp_bricks) at K3's coordinates: bit-equal to its twin in the
     volume; timed beside grid_sample. K4's path is the profiling tools
     (phase 12), as in the JAX package;
  4b. K6 (trilerp_ablation) in each mode at 128/256/512 threads on the
     trilerp profiler's 256³ rows (16.8 M random samples, every row's box
     staged in shared memory), K3's coordinates from phase 3, rows spread
     over and past the volume (taps from global memory), a prime row count
     that leaves every persistent grid a partial last round, a 1-D input
     with a short last row, and a ragged 37x41x53 volume with rows of 37
     (the threads' copies, where the copy engine cannot): bit-equal to its
     twin, the full mode to K4's values, the kernel's row map (loads,
     full) equal to trilerp_box_rows, both paths run; the SASS keeps the
     taps (at least 8 shared and 8 global loads more in loads and full
     than in weights), the boxes' tensor copies (none in weights) and the
     coordinates' bulk copies; each mode and K4 timed on the profiler's
     rows beside the twin, grid_sample, the bound and the sector floor;
  5. K2 and K3 on a 72³ canonical lattice over a 65³ live volume (with
     and without coordinates, bit-equal), and the update's kernel arm
     against its plain arm there; then both on a lattice whose brick count
     leaves a ragged last round of their persistent grids (bit-equal);
  6. benchmarks/suite.py config 4 through the port's suite.config4: the
     non-rigid update at 256³ without caches (K3 once per call), a warm
     call and 3 timed calls, then one more against the plain arm (p99.9
     |Δvalues| < 0.5);
  7. the bench scene (bench.py): init_canonical, 2 warm-up frames and 3
     timed frames of fusion_frame at 256³ with the bench's settings and
     exact kNN, through the kernels; both kernels must have launched, no
     mesh may overflow its cap (the 4096-node pool is full from
     init_canonical on, so FrameStats.overflow is reported, not checked)
     and every frame must keep tracking (energy per correspondence after
     the solve below TRACK_MAX); then one frame of the plain arm
     (use_kernels=False) from the state of the last timed frame: p99.9
     |Δtsdf| < 0.5 (bench gate 1); phase 14 follows;
  8. K5 (fuse_depth_multi) against its plain twin, bit-equal, at 256³ on
     the inputs of benchmarks/suite.py config 6: meshes/original.obj
     rendered from 8 yaw views at 512² by the port's render_depth, the grid
     from estimate_alignment; from an empty volume and from a half-fused
     one whose weights are near WMAX, so the running average and the clamp
     run; with one view; on a ragged 37x41x53 volume with 3 views; with a
     camera inside the volume and with a view the volume only grazes. In
     each the kernel's view cull equals fuse_cull_tiles; the share it
     skips, the voxel-views by path and K5's issue time from its SASS are
     printed;
  9. config 6 at 256³ through the port's suite.run_config6 (FusionDM's
     ingest, marching_cubes, the score), then one profiled ingest: K5 and
     K1 must have launched, and the vertices seen by >= 3 views must lie on
     the mesh within a mean of 1 voxel and a p95 of 2 voxels (the mesh
     overflows its 2^17-vertex cap, so the share of the surface the scored
     vertices cover is printed beside the score);
  10. the ICP branch (useICP=True) at 256³ with the first 3 views: a
     finite volume, correspondences, the recovered pose, K7's bin,
     scatter and query launches and K9's warp and pick once a search,
     and K8's once a later view; K7 (knn_grid) on the last
     view's meshes against its plain twin, 0 unequal slots, and K9's
     warp and pick there against the composition they replace, 0
     unequal elements, each timed;
  10b. K8 (rigid_update) at 512³ (tools/profile_rigid_update.py): config
     6's view 0 fused alone updated by view 1 fused alone, under the
     identity and the ICP's calibration error (0.5° and 1.5 voxels), 0
     voxels unequal to the plain twin in values and weights, one launch a
     call; its CUDA-event mean (float4 and scalar) beside its bound of
     20 bytes a voxel, the twin's time and its registers;
  11. benchmarks/suite.py config 7 at 256³ through the port's
     suite.run_config7 and Fusion: the reference mesh bent by 0.08, 0.16
     and 0.24 rad, per frame a live TSDF fused on the canonical lattice and
     setupCorrespondences → solve → updateTSDF → update_graph; every
     frame's TSDF finite, K1, K2 and K5 launched, and the final surface
     error below the untracked one;
  12. the profiling entry points (dynamicfusion_body_tpu_torch/tools), in
     process at 256³: profile_trilerp and profile_upd as a user runs
     them, profile_mc and profile_frame with --reps 1 and --trace (into
     a temporary directory), profile_solve with --reps 1, then
     profile_corr5 as a user runs it; their lines go out as '#' lines;
     K6 must have launched there;
  13. the benchmark entry points (dynamicfusion_body_tpu_torch/
     benchmarks, tools/diag_*), in process: the bench at 256³ with its
     three accuracy gates (bench.py's keys, accuracy_ok true, K1 and K2
     launched, no mesh over its caps), the suite's configs 1-3 (config
     3's median rotation error below 1 degree), diag_gate's exact arm and
     diag_config7's base arm (config 7: tracked below untracked) at 64³;
     K1, K2 and K5 must have launched there;
  14. (run right after phase 7, from its post-warm-up state on its first
     timed frame's live volume) the other correspondence modes of the
     frame at 256³ with the bench's settings and kernels: one frame each
     with reuse_corr=True, approx_knn="2level", approx_knn=True and
     use_grid_corr=True, each printed with its wall, n_corr, corr_risk,
     corr_refresh and final cost; K1 and K2 launched, every frame finite
     with no mesh over its caps, the reuse and bf16-keyed frames tracking
     (the 2-level frame's tracking printed: the reference's pools miss
     most of this scene's neighbours), the reuse frame's final cost at
     most 1.05 x the fresh frame's (phase 7's first timed frame), the grid
     frame, without correspondences, keeping its pose; then on the
     frame-entry warped vertices: knn_2level's distances equal to a direct
     search on all but at most its risk count of queries, grid_knn equal
     to it within cell/2 wherever no cell of the query's block
     overflowed (the overflow printed), the bf16-keyed search's recall,
     and the k > 4 selection equal to and timed against the stable sort;
  15. (run right after phase 11) the CNN correspondence path: TF32 off for
     matmuls and cuDNN; the DHBC forward at 8 x 512² on the card within
     CNN_FWD_RTOL of the same module on the CPU; benchmarks/bench_cnn.py at
     its defaults (24 views of 512², the bench canonical and live meshes
     at 256³), its JSON line and coverage printed, S = 4 covering at least
     CNN_COVER_S4 of the canonical's vertices; the training loop of
     tests/test_dhbc.py:204-276 on the card (600 batch-1 steps at 64²,
     cuDNN deterministic): at the test's rate 1e-3 printed, at
     CNN_GATE_LR run twice (the losses bit-equal) and held to the test's
     gate (the last loss below 0.6 of the first, held-out pixel accuracy
     above 0.2 and above random init + 0.1); tools/train_dhbc.py at
     CNN_GATE_LR into data/ (git-ignored), the same accuracy gate on the
     body mesh's held-out yaw with its weights; then one
     Fusion(use_cnn=True) frame with
     those weights on config 7's 256³ scene (the first bend): finite, with
     valid correspondences, its surface error printed beside config 7's
     closest-point frame; K1, K2 and K5 launched.
  16. (run after phase 13) the 512³ bench (the port's
     benchmarks/bench512.py): the Fusion driver built on the first of its
     four 512³ volumes and two frames, each phase's synced wall, the peak
     device memory and its JSON line printed; then one fused frame
     (fusion_frame(allow_large=True), bench512 --fused) on the same
     volumes; K1 and K2 launched, the TSDFs finite;
  17. K1, K2, K5 and K3 at 512³ against their twins, the count of
     unequal elements printed and held to 0: K1 on Fusion's canonical
     volume and a live volume, whole and at the path's strides 4 and 2;
     K2 with Fusion's update inputs (node field, pose, caches, mip); K5
     fusing config 6's 8 views of 512² into an empty 512³ volume; K3 on
     bench512_sharded's equivalence inputs (the cache-less update, C = 16,
     k = 3, no coordinates); each timed beside its twin and its bound;
  18. the sharded frame (parallel/frame_sharded.py) at world size 1 on
     NCCL, in process through parallel/launch.py, on the bench's 256³
     scene (init and one frame), held against init_canonical +
     fusion_frame by the JAX package's tests/test_frame_sharded.py:75-97
     criteria (radius rtol 1e-6, equal n_corr, costs rtol 0.05 before and
     0.10 after, a descent, p99.9 |Δvalues| < 0.25, nodes within 16); its
     synced wall printed;
  19. the sharded 512³ bench (benchmarks/bench512_sharded.py) at world
     size 1 on NCCL, in process: the equivalence (the sharded non-rigid
     update against the dense one, both deviations exactly 0) and the
     full sharded frame (descended, no overflow, a finite cost), each
     JSON line and peak memory printed;
  20. the round-5 tools at 256³, short: profile_solve5 and exp_freeze
     (--reps 1), exp_solver (--reps 1, a 2-frame chain, arm gn2_cg16),
     profile_frame5 (2 frames, base and solve_iters=0), sweep_solver5
     (2 frames, 2,16), sweep_frame5 (2 frames, si1): every value finite,
     K1 and K2 launched;
  21. the native I/O library (g++ here): the body mesh read and written,
     a .dist volume read, each equal (bytes for the writer) to the
     Python path;
  22. (run right after phase 15) the ablation grid
     (tools/make_ablation.py) at its defaults, 128³ over 3 frames, four
     arms, the CNN arm on the weights phase 15 trained at 64² (never
     skipped), into the git-ignored data/ablation/: each arm's wall, mesh
     counts and K1/K2 launches printed, K1 launched in every arm and K2
     in every fused one, ``original`` equal in counts to
     meshes/original.obj with its vertex-position difference printed, and
     each mesh's symmetric mean and p95 distance to the committed mesh of
     its name printed;
  23. the microbenchmarks at their default shapes, --reps 3:
     profile_mc2 (256³, live caps), profile_prims and profile_prims2
     (256³ sizes), profile_solver and exp_asm (M 4096, V 32,768): every
     row finite, exp_asm's layouts within EXP_ASM_RTOL of the current
     assembly.
The last lines are the kernel table as JSON, the card, then
``{"ok": true, "device": {...}}``. No result is printed without a GPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from dynamicfusion_body_tpu_torch.tools._timing import (
    F32_OPS, HBM_BPS, bound, live_taps)

ROOT = Path(__file__).resolve().parent
PKG = "dynamicfusion_body_tpu"
RES = 256
K2_TOL_COORD = 1e-4  # voxels: a few f32 ulps at 256 (kernel vs twin)
K2_TOL_VAL = 1e-4    # TSDF units: K2_TOL_COORD times |∇live| <= ~1
GATE_DEV_P999 = 0.5  # bench gate 1 (bench.py:314-340), in voxels
# Tracking sanity: huberized energy per correspondence after the solve, in
# voxels² (0.05 ~ a 0.3-voxel RMS point-to-plane residual). Measured
# 2e-4..1.3e-3 on the bench frames; ~1 when far-field warps blow up.
TRACK_MAX = 0.05
# the reuse_corr frame's final cost against the fresh frame's from the same
# state (the bound of the JAX package's tests/test_frame.py:195)
REUSE_COST_MAX = 1.05
# benchmarks/suite.py config 6 (suite.py:261-316)
K6 = np.array([[400.0, 0, 256], [0, 400, 256], [0, 0, 1]], np.float32)
N_VIEWS, IMG = 8, 512
TDIST6 = 8.0 / RES * 1.3
ICP_VIEWS = 3
# f32 operations per voxel of K2 (k = 3): blend 40 (8 + 2 x 16), normalize
# 26 (squares and their sum 15, sqrt, compare, division, 8 scalings), two
# dual-quaternion sandwiches with v's literal zeros and ones pruned, 69 each
# (t[4:8] 4 x 6, components 5-7 of the outer product 3 x 15), the in-volume
# test 6, the brick's coordinate range 6; and per trilerped voxel 40.
# (With the full 176-operation sandwiches the count was 423.)
K2_OPS_VOXEL, K2_OPS_TRILERP = 216, 40
# K3, per voxel: d2 for each active candidate slot 8; k argmin passes of
# C-1 compares; per pick sqrt, min, compares, division, 2 multiplies,
# negation and exp ~10, the blend 16, wi 2; fixed: normalize 26, two pruned
# sandwiches 138, bounds 6, trilerp 40, wi division 2, less the first
# pick's 8 blend additions (425 with the full sandwiches)
K3_OPS_SLOT, K3_OPS_PICK, K3_OPS_FIXED = 8, 28, 204
# K3's candidate counts, one kernel instantiation (register budget) each
K3_CANDIDATES = (8, 16, 32)
# the global pose of benchmarks/suite.py config 4 and the Fusion driver
LW_REF = (1.0, 0.0, 0.0, 0.0, 0.0, 0.1, 0.0, 0.0)
# K5's f32 operations, an IEEE division counted as one (the bound's count):
# per voxel and view, the projection u, v, pw 18 and the bounds test's 4
# compares, and the divisions px, py; per in-image voxel-view, the sample
# and the signed distance 29; per update, 6 and the running average's
# division
K5_OPS_VIEW, K5_DIVS_VIEW, K5_OPS_INB = 22, 2, 29
K5_OPS_UPD, K5_DIVS_UPD = 6, 1
# K5's issue slots, counted by hand in `cuobjdump -sass` of
# fuse_depth_multi_kernel<true> (the 16-byte instantiation, `length`
# instructions; divisions on their fast path, the slow-path calls not
# taken): the instructions one lane issues for one voxel-view that leaves
# at the px test (projection of u and pw, division, test: 21), at the py
# test (37), that is in the image (83: taps, sample, the signed-distance
# block, 11, which a missing depth skips), the more an update takes (17);
# and
# per (x-plane, view) of a lane's run of 4 voxels, the view loop with the
# row's prefix (25) or for a culled view (12)
K5_SASS = dict(length=1416, out_x=21, out_y=37, in_view=83, update=17,
               view=25, culled=12, signed_distance=11)
# phase 15, the CNN path: the DHBC forward on the card against the same
# module on the CPU, relative to the output's largest magnitude (TF32 would
# give ~1e-3); the vertex coverage the card's S = 4 descriptors must reach
# on the bench canonical; the training gate of tests/test_dhbc.py:204-276
CNN_FWD_RTOL = 1e-4
CNN_COVER_S4 = 0.995
CNN_TRAIN_STEPS, CNN_TRAIN_SIZE, CNN_CLASSES, CNN_VIEWS = 600, 64, 16, 6
# The test's rate, 1e-3, sits at the edge of this normalization-free net's
# stability: from the port's init the test's loop throws the loss to ~15
# and stays at the class prior, and train_dhbc at its defaults stuck there
# in 1 of 5 fresh runs on the card and in 1 of 2 runs of this phase (JAX's
# own loop from PRNG seeds 1-3 misses the test's gate as well, ROADMAP.md
# Queue 3). The gate is held at the rate of the JAX package's stability
# recipe, which converged in every run.
CNN_GATE_LR = 3e-4
# phase 22: the committed canonical mesh of the ablation grid (the JAX
# tool's output, tools/make_ablation.py), which the port's must reproduce
ABLATION_ORIGINAL = (22982, 45960)
# phase 23: exp_asm's sorted-segment layouts against index_add_, relative
# to the table's largest magnitude (their prefix sums over T = 344,064
# rows carry ~T ulps; measured 3.0e-3 on the H100, 1.2e-3 on the CPU)
EXP_ASM_RTOL = 1e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, reps=10):
    """Mean device time of ``fn`` in ms over ``reps`` launches (CUDA
    events), after one warm-up call. The card first sleeps ~2 ms, so the
    host has queued the launches before the first event: a call shorter
    than its own host overhead is timed on the card, not on the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def n_not_equal(got, want):
    """Voxels at which any output of a K2/K3 call differs from its twin's;
    outputs the call did not write (None) are skipped."""
    bad = None
    for g, w in zip(got, want):
        if g is not None:
            d = g != w
            bad = d if bad is None else bad | d
    return int(bad.sum())


def issue_ms(nops):
    """The time ``nops`` f32 operations take at one instruction each (the
    kernels build with -fmad=false, so no multiply-add is fused): half the
    f32 rate."""
    return nops / (F32_OPS / 2) * 1e3


def print_kernel_info(torch):
    """K1's, K2's, each K3 instantiation's, K5's and K6's registers, local
    (spill) bytes and CTAs per SM (occupancy calculator), and the
    persistent grids of K2/K3 and K6; fails on a spill. Returns {(name,
    C): info} for K2 and K3."""
    from dynamicfusion_body_tpu_torch.ops import fusion_cuda, mc_cuda
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        ablation_kernel_info, kernel_info)

    out = {}
    for C in K3_CANDIDATES:
        for name, info in kernel_info(brick=8, k=3, C=C).items():
            key = (name, None if name == "warp_trilerp_bricks_cached" else C)
            out[key] = info
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (name, C), info in out.items():
        occ = info["ctas_per_sm"] * info["threads"] / 2048
        print(f"# {name}{'' if C is None else f' C<={C}'}: registers "
              f"{info['registers']}, local bytes {info['local_bytes']}, "
              f"{info['threads']} threads, CTAs per SM {info['ctas_per_sm']} "
              f"({occ:.1%} of the SM's threads), persistent grid "
              f"{info['grid']} on {sms} SMs, dynamic shared "
              f"{info['dynamic_smem']} B")
        check(info["local_bytes"] == 0, f"{name} spills: {info}")
    for name, infos, smem in (
            ("mc_case_cross", mc_cuda.kernel_info(), "static_smem"),
            ("fuse_depth_multi", fusion_cuda.kernel_info(N_VIEWS),
             "dynamic_smem"),
            ("trilerp_ablation", {f"{m} t{t}": i for (m, t), i in
                                  ablation_kernel_info().items()},
             "dynamic_smem")):
        for inst, info in infos.items():
            occ = info["ctas_per_sm"] * info["threads"] / 2048
            print(f"# {name} {inst}: registers {info['registers']}, local "
                  f"bytes {info['local_bytes']}, {info['threads']} threads, "
                  f"CTAs per SM {info['ctas_per_sm']} ({occ:.1%} of the "
                  f"SM's threads), shared {info[smem]} B"
                  + {"fuse_depth_multi": f" at {N_VIEWS} views",
                     "trilerp_ablation": " at rows of 512, persistent grid "
                     f"{info['grid']}"}.get(name, ""))
            check(info["local_bytes"] == 0, f"{name} {inst} spills: {info}")
    return out


def phase_k1(torch, dev, canonical):
    """K1 against its twin: random volumes at 256³ and 128³, the bench's
    256³ canonical TSDF and its stride-2 view (the canonical MC's call,
    which the kernel reads where it lies: the call allocates its output
    and nothing else), and ragged shapes (Z % 4 != 0, extents of 2).
    Returns the kernel-table row (random 256³, the live MC's shape)."""
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import (
        mc_case_cross, mc_case_cross_ref)

    rng = np.random.default_rng(1)

    def rand(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    stride2 = canonical[::2, ::2, ::2]
    row = None
    for name, vol in (("random", rand((RES,) * 3)),
                      ("random", rand((RES // 2,) * 3)),
                      ("bench TSDF", canonical),
                      ("bench TSDF [::2, ::2, ::2]", stride2),
                      ("random", rand((37, 41, 53))),
                      ("random", rand((2, 3, 5)))):
        got = mc_case_cross(vol, 0.0)
        want = mc_case_cross_ref(vol, 0.0)
        err = float(torch.max(torch.abs(got - want)))
        check(err == 0.0, f"K1 differs from its twin on {name} "
              f"{tuple(vol.shape)} by {err}")
        ms = cuda_ms(torch, lambda: mc_case_cross(vol, 0.0))
        plain = cuda_ms(torch, lambda: mc_case_cross_ref(vol, 0.0))
        print(f"# K1 {name} {tuple(vol.shape)} strides {vol.stride()}: "
              f"bit-equal; kernel {ms:.4f} ms, twin {plain:.4f} ms")
        if row is None:  # the live MC shape of the main path
            # each cell: its voxel read, its word written; 8 f32 compares
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                       **bound(8 * vol.numel(), 8 * vol.numel()),
                       library_ms=None)
    # the stride-2 call allocates its output only (a .contiguous() copy of
    # the view would allocate as much again)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = mc_case_cross(stride2, 0.0)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    out_bytes = out.numel() * out.element_size()
    check(extra < 2 * out_bytes, f"the stride-2 K1 call allocated {extra} B "
          f"for a {out_bytes} B output: a copy of its input?")
    copy_ms = cuda_ms(torch, lambda: mc_case_cross(stride2.contiguous(), 0.0))
    print(f"# K1 stride-2 call allocated {extra} B ({out_bytes} B output); "
          f"with a .contiguous() copy first (the wrapper's former call): "
          f"{copy_ms:.4f} ms")
    return row


def bench_state(torch, dev):
    """The bench scene at 256³ (``tools/_scene.py:bench_scene``: the
    canonical, config 4's live volume, the ``init_canonical`` field) and
    the five live frames of phases 2-7 (bump phases 0.05·i; the second is
    the scene's live volume)."""
    from dynamicfusion_body_tpu_torch.ops.marching_cubes import marching_cubes
    from dynamicfusion_body_tpu_torch.tools._scene import bench_scene, bumpy

    t0 = time.perf_counter()
    sc = bench_scene(RES, dev)
    torch.cuda.synchronize()
    print(f"# bench scene with init_canonical {time.perf_counter() - t0:.2f}"
          f" s: nodes {int(sc.wf.num_active)} radius "
          f"{float(sc.wf.radius):.4f}")
    lives = [torch.from_numpy(bumpy(RES, (130, 129, 128), 0.05 * i)).to(dev)
             for i in range(1, 6)]
    # FrameStats.overflow also flags a full node pool, which this
    # configuration has from the start (as the JAX package does): check
    # the mesh caps directly, on the twin so no kernel launch is counted
    for name, vol, caps in (
            ("canonical", sc.canonical, dict(vert_cap=1 << 15,
                                             face_cap=1 << 16, step_size=2)),
            *((f"live {i}", lv, dict(vert_cap=1 << 17, face_cap=1 << 18,
                                     with_normals=False))
              for i, lv in enumerate(lives))):
        check(not bool(marching_cubes(vol, **caps)["overflow"]),
              f"the {name} mesh overflows its caps")
    return sc, lives


def phase_k2(torch, dev, lives, wf, grid):
    """K2 on the 256³ bench state (node DQs perturbed, live clipped so that
    both mip classes occur) against its twin, with and without
    coordinates: bit-equal; both calls timed, the row is the main path's
    (no coordinates)."""
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
    got = {c: warp_trilerp_bricks_cached(*args, **kw, coords=c)
           for c in (True, False)}
    ref = warp_trilerp_bricks_cached_ref(*args, **kw)
    torch.cuda.synchronize()
    vals, valid, wx, wy, wz = got[True]
    r_vals, r_valid, r_wx, r_wy, r_wz = ref
    check(torch.equal(valid, r_valid), "K2 valid differs from its twin")
    err_w = max(float(torch.max(torch.abs(a - b)))
                for a, b in ((wx, r_wx), (wy, r_wy), (wz, r_wz)))
    err_v = float(torch.max(torch.abs(torch.where(r_valid, vals - r_vals,
                                                  0.0))))
    check(err_w <= K2_TOL_COORD, f"K2 coords differ by {err_w}")
    check(err_v <= K2_TOL_VAL, f"K2 values differ by {err_v}")
    check(all(c is None for c in got[False][2:]),
          "K2 without coordinates returned coordinates")
    n_neq = {c: n_not_equal(got[c], ref) for c in got}
    check(not any(n_neq.values()), f"K2 is not bit-equal to its twin: "
          f"voxels differing {n_neq} (with / without coordinates)")
    short, cval = mip_short_bricks(r_wx, r_wy, r_wz, r_valid, live.shape,
                                   tdist, mip)
    n_skip = int(torch.sum(short & (cval == -tdist)))
    n_const = int(torch.sum(short & (cval != -tdist)))
    check(n_skip > 0 and n_const > 0 and bool(torch.any(~short)),
          f"mip classes missing: skip {n_skip} const {n_const}")
    check(torch.equal(vals[short], cval[short, None].expand(-1, 512)),
          "K2 short-circuited bricks are not exact constants")
    ms = {c: cuda_ms(torch, lambda c=c: warp_trilerp_bricks_cached(
        *args, **kw, coords=c)) for c in (True, False)}
    plain = cuda_ms(torch,
                    lambda: warp_trilerp_bricks_cached_ref(*args, **kw),
                    reps=3)
    n_full = int(torch.sum(~short))
    n_taps = live_taps(live.shape, [w[~short] for w in (r_wx, r_wy, r_wz)])
    nb, v = sel.shape
    nops = nb * v * K2_OPS_VOXEL + n_full * v * K2_OPS_TRILERP
    bounds = {}
    for c in (True, False):
        # live: only the cells the full bricks tap (short-circuited bricks
        # read none); the other inputs whole; outputs vals, valid (1 B) and
        # with coordinates wx, wy, wz
        nbytes = (4 * n_taps
                  + sum(t.numel() * t.element_size()
                        for t in (node_dq, cand.to(torch.int32), sel, selw,
                                  lw, *mip))
                  + (4 * 4 if c else 4) * nb * v + nb * v)
        bounds[c] = dict(**bound(nbytes, nops), mb=nbytes / 1e6)
        b = bounds[c]
        print(f"# K2 {RES}^3 {'with' if c else 'without'} coordinates: "
              f"kernel {ms[c]:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}; {b['mb']:.1f} MB, {nops / 1e9:.3f} G "
              f"operations, their -fmad=false issue {issue_ms(nops):.4f} "
              f"ms), {b['bound_ms'] / ms[c]:.1%} of it; voxels not "
              f"bit-equal to the twin {n_neq[c]}")
    print(f"# K2 {RES}^3: NB {nb}, persistent grid {grid} (NB % grid = "
          f"{nb % grid}); valid equal, coord err {err_w:.3g}, value err "
          f"{err_v:.3g}; bricks skip {n_skip} const {n_const} full {n_full}; "
          f"live cells tapped {n_taps} of {live.numel()}; twin {plain:.4f} "
          f"ms")
    b = bounds[False]
    return dict(max_abs_err=max(err_w, err_v), ms=ms[False], plain_ms=plain,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                library_ms=None)


def k3_bound(live, wf, cand, k, coords, n_taps):
    """(bound dict, bytes, operations) of one K3 call at these inputs."""
    nb, C = cand.shape
    v = 512
    n_act = int(wf.active[cand].sum())  # active candidate slots
    M = wf.capacity
    # outputs vals, wi (+ wx, wy, wz) and valid (1 B); node rows once
    nbytes = (4 * n_taps + M * (12 + 4 + 1 + 32) + 4 * cand.numel() + 32
              + (5 if coords else 2) * 4 * nb * v + nb * v)
    nops = (K3_OPS_SLOT * n_act * v
            + nb * v * (k * (C - 1) + k * K3_OPS_PICK + K3_OPS_FIXED))
    return bound(nbytes, nops), nbytes, nops


def phase_k3(torch, dev, live, wf, grids):
    """K3 at config 4's shapes: the 256³ bench canonical's node field, its
    two-level brick candidates, k = 3, the live volume of
    benchmarks/suite.py config 4. Every node of that field holds the same
    DQ, and a normalized blend of equal DQs ignores its weights, so the
    node DQs are perturbed here, as in phase K2. At C = 8, 16 and 32 (one
    instantiation each), with and without coordinates: bit-equal to its
    twin; at config 4's C = 16 also held to build_warp_cache followed by
    K2 (no mip certificate), both calls timed. Returns (kernel-table row,
    K3's coordinates at C = 16 for phase K4)."""
    from dynamicfusion_body_tpu_torch.models.warp_field import (
        brick_candidates_2level, build_warp_cache)
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks, warp_trilerp_bricks_cached,
        warp_trilerp_bricks_ref)

    rng = np.random.default_rng(4)
    noise = torch.from_numpy(
        (0.02 * rng.standard_normal((wf.capacity, 8))).astype(np.float32))
    wf = wf.replace(node_dq=wf.node_dq + noise.to(dev))
    lw = torch.tensor(LW_REF, dtype=torch.float32, device=dev)
    k = 3
    kw = dict(brick=8, k=k)
    for C in K3_CANDIDATES:
        cand = brick_candidates_2level(wf, (RES,) * 3, 8, C)
        args = (live, wf.node_pos, wf.node_w, wf.active, wf.node_dq, cand, lw)
        got = {c: warp_trilerp_bricks(*args, **kw, coords=c)
               for c in (True, False)}
        ref = warp_trilerp_bricks_ref(*args, **kw)
        torch.cuda.synchronize()
        check(all(c is None for c in got[False][3:]),
              "K3 without coordinates returned coordinates")
        n_neq = {c: n_not_equal(got[c], ref) for c in got}
        ms = {c: cuda_ms(torch, lambda c=c: warp_trilerp_bricks(
            *args, **kw, coords=c)) for c in (True, False)}
        n_taps = live_taps(live.shape, ref[3:])
        nb = cand.shape[0]
        grid = grids[C]
        for c in (True, False):
            b, nbytes, nops = k3_bound(live, wf, cand, k, c, n_taps)
            print(f"# K3 {RES}^3 C {C} {'with' if c else 'without'} "
                  f"coordinates: voxels not bit-equal to the twin "
                  f"{n_neq[c]}; kernel {ms[c]:.4f} ms; bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
                  f"{nbytes / HBM_BPS * 1e3:.4f} ms for {nbytes / 1e6:.1f} "
                  f"MB, ops {nops / F32_OPS * 1e3:.4f} ms for "
                  f"{nops / 1e9:.3f} G, their -fmad=false issue "
                  f"{issue_ms(nops):.4f} ms), {b['bound_ms'] / ms[c]:.1%} of "
                  f"it; NB {nb}, persistent grid {grid} (NB % grid = "
                  f"{nb % grid})")
        check(not any(n_neq.values()), f"K3 at C = {C} is not bit-equal to "
              f"its twin: voxels differing {n_neq} (with / without "
              "coordinates)")
        if C == 16:  # config 4's
            k3 = (args, got[True], ref, ms, n_taps, cand)
        del got, ref
    args, got, ref, ms, n_taps, cand = k3
    sel, selw, wi_c = build_warp_cache(wf, (RES,) * 3, cand, k, 8)
    k2 = warp_trilerp_bricks_cached(live, wf.node_dq, cand, sel, selw, lw,
                                    brick=8)
    torch.cuda.synchronize()
    vals, valid, wi, wx, wy, wz = got
    r_vals, r_valid, r_wi, r_wx, r_wy, r_wz = ref
    check(torch.equal(wi, r_wi), "K3 wi differs from its twin")
    check(torch.equal(wi, wi_c), "K3 wi differs from build_warp_cache")
    err_w = max(float(torch.max(torch.abs(a - b)))
                for a, b in ((wx, r_wx), (wy, r_wy), (wz, r_wz)))
    # valid may flip only for a coordinate within K2_TOL_COORD of a face
    rs = RES - 1.0
    edge = torch.zeros_like(valid)
    for c in (r_wx, r_wy, r_wz):
        edge |= (torch.abs(c) <= K2_TOL_COORD) | (torch.abs(c - rs)
                                                  <= K2_TOL_COORD)
    n_vflip = int(torch.sum(valid != r_valid))
    check(not bool(torch.any((valid != r_valid) & ~edge)),
          "K3 valid differs from its twin away from the volume's faces")
    both = valid & r_valid
    err_v = float(torch.max(torch.abs(torch.where(both, vals - r_vals, 0.0))))
    check(err_w <= K2_TOL_COORD, f"K3 coords differ by {err_w}")
    check(err_v <= K2_TOL_VAL, f"K3 values differ by {err_v}")
    n_neq_k2 = int(torch.sum((vals != k2[0]) | (wx != k2[2]) | (wy != k2[3])
                             | (wz != k2[4]) | (valid != k2[1])))
    err_k2 = max(float(torch.max(torch.abs(a - b)))
                 for a, b in ((wx, k2[2]), (wy, k2[3]), (wz, k2[4]),
                              (torch.where(both, vals, 0.0),
                               torch.where(both, k2[0], 0.0))))
    check(err_k2 <= K2_TOL_COORD, f"K3 differs from cache + K2 by {err_k2}")
    plain = cuda_ms(torch, lambda: warp_trilerp_bricks_ref(*args, brick=8,
                                                           k=k), reps=3)
    b, _, _ = k3_bound(live, wf, cand, k, False, n_taps)
    print(f"# K3 {RES}^3 C 16 (config 4): wi equal to the twin and to "
          f"build_warp_cache; valid flips {n_vflip} (at the faces); coord "
          f"err {err_w:.3g}, value err {err_v:.3g}; voxels not bit-equal to "
          f"cache + K2 {n_neq_k2} (max diff {err_k2:.3g}); twin {plain:.4f} "
          f"ms; live cells tapped {n_taps}")
    row = dict(max_abs_err=max(err_w, err_v), ms=ms[False], plain_ms=plain,
               **b, library_ms=None)
    return row, (wx, wy, wz)


def phase_k4(torch, live, coords):
    """K4 at K3's output coordinates on config 4's live volume: bit-equal
    to its twin on in-volume samples; timed beside the twin and beside
    grid_sample, the one PyTorch call computing the same trilerp."""
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        trilerp_bricks, trilerp_bricks_ref)
    from dynamicfusion_body_tpu_torch.tools.profile_trilerp import (
        grid_sample_fn)

    wx, wy, wz = coords
    vals, valid, esc = trilerp_bricks(live, wx, wy, wz)
    r_vals, r_valid, _ = trilerp_bricks_ref(live, wx, wy, wz)
    library = grid_sample_fn(live, wx, wy, wz)
    lib_vals = library().reshape(wx.shape)
    torch.cuda.synchronize()
    check(torch.equal(valid, r_valid), "K4 valid differs from its twin")
    check(not bool(esc.any()), "K4 escaped a sample")
    err = float(torch.max(torch.abs(torch.where(valid, vals - r_vals, 0.0))))
    n_neq = int(torch.sum(valid & (vals != r_vals)))
    check(n_neq == 0, f"K4 is not bit-equal to its twin in the volume: "
          f"{n_neq} samples, max {err}")
    err_lib = float(torch.max(torch.abs(torch.where(valid, vals - lib_vals,
                                                    0.0))))
    ms = cuda_ms(torch, lambda: trilerp_bricks(live, wx, wy, wz))
    plain = cuda_ms(torch, lambda: trilerp_bricks_ref(live, wx, wy, wz),
                    reps=3)
    lib_ms = cuda_ms(torch, library)
    n = wx.numel()
    n_taps = live_taps(live.shape, coords)
    nbytes = 12 * n + 4 * n_taps + 5 * n
    nops = n * (K2_OPS_TRILERP + 6)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, **bound(nbytes, nops),
               library_ms=lib_ms)
    print(f"# K4 {n} samples ({int(valid.sum())} in the volume): bit-equal "
          f"to its twin there; grid_sample differs by {err_lib:.3g}; kernel "
          f"{ms:.4f} ms, twin {plain:.4f} ms, grid_sample {lib_ms:.4f} ms; "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
          f"{nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} G operations)")
    return row


def sass_functions(torch):
    """The built library's SASS by function: {mangled name: [instruction
    text]}. The toolkit that builds the kernels ships cuobjdump; a machine
    without it fails the check."""
    from torch.utils.cpp_extension import CUDA_HOME

    from dynamicfusion_body_tpu_torch.ops import cuda_lib

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    check(tool.exists(), f"no {tool} to read the kernels' SASS")
    text = subprocess.run([str(tool), "-sass", str(cuda_lib.build()[0])],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            cur = funcs.setdefault(fn.group(1), [])
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.+?)\s*;", line)
        if cur is not None and ins:
            cur.append(ins.group(1))
    return funcs


def sass_opcode(ins):
    """The opcode of one SASS instruction, without its predicate and
    modifiers ("@!P0 LDG.E.CONSTANT R2, ..." -> "LDG")."""
    words = ins.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def sass_loads(torch):
    """Loads and copies of each K6 instantiation in the built library's
    SASS, by (mode, threads): {"LDG": global loads, "LDS": shared loads,
    "UBLKCP": bulk copies, "UTMALDG": tensor copies}."""
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import ABLATION_MODES

    counts = {}
    for name, code in sass_functions(torch).items():
        m = re.search(r"trilerp_ablation_kernelILi(\d)ELi(\d+)E", name)
        if m:
            ops = [sass_opcode(ins) for ins in code]
            counts[(ABLATION_MODES[int(m.group(1))], int(m.group(2)))] = {
                op: ops.count(op)
                for op in ("LDG", "LDS", "UBLKCP", "UTMALDG")}
    return counts


def k6_cases(torch, dev, k3_live, k3_coords, grids):
    """Phase 4b's inputs, [(name, live, (wx, wy, wz))]: the trilerp
    profiler's 256³ rows; K3's coordinates at config 4 (phase 3), rows of
    512; rows spread over the whole volume and past it (the global-tap
    path); a prime row count, above every persistent grid in ``grids``,
    half tool rows and half spread ones, so the last round of every grid
    is partial; a 1-D input of both kinds whose last row is short; and a
    ragged volume with rows of 37, where the threads copy the boxes and
    the coordinates."""
    from dynamicfusion_body_tpu_torch.tools._scene import trilerp_inputs

    live, *tool = trilerp_inputs(RES, dev)
    rng = np.random.RandomState(7)
    spread = [torch.from_numpy(a).to(dev) for a in rng.uniform(
        -8.0, RES + 8.0, (3, 4096, 512)).astype(np.float32)]
    rows = 4099  # prime
    check(all(rows > g for g in grids.values()),
          f"K6's ragged case needs more rows than the grids {grids}")
    ragged = [torch.cat([t[:rows // 2], s[:rows - rows // 2]])
              for t, s in zip(tool, spread)]
    n_1d = 900 * 512 - 200
    flat = [torch.cat([t[:600].reshape(-1), s[:300].reshape(-1)])[:n_1d]
            for t, s in zip(tool, spread)]
    # a ragged 37x41x53 volume (no TMA tensor: rz * 4 is not a multiple of
    # 16) with rows of 37 samples (not whole 16-byte chunks): the threads
    # copy the boxes and the coordinates; a quarter of the rows spread
    shape_r = (37, 41, 53)
    live_r = torch.from_numpy(rng.rand(*shape_r).astype(np.float32)).to(dev)
    ext = np.array(shape_r, np.float32)
    w_r = (rng.rand(2000, 1, 3) * (ext - 9) + rng.rand(2000, 37, 3) * 7)
    w_r[::4] = rng.uniform(-3.0, 1.0, (500, 37, 3)) * (ext + 6) / 4 + ext / 2
    ragged_vol = tuple(torch.from_numpy(np.ascontiguousarray(
        w_r[..., a].astype(np.float32))).to(dev) for a in range(3))
    return [(f"tool rows {RES}^3", live, tuple(tool)),
            ("K3's coordinates", k3_live,
             tuple(c.reshape(-1, 512) for c in k3_coords)),
            ("spread rows", live, tuple(spread)),
            (f"{rows} rows (ragged grid)", live, tuple(ragged)),
            (f"1-D, {n_1d} samples", live, tuple(flat)),
            ("37x41x53 volume, rows of 37", live_r, ragged_vol)]


def phase_k6(torch, dev, k3_live, k3_coords, grids):
    """K6 in every mode at 128/256/512 threads on each case of
    :func:`k6_cases`: bit-equal to its twin, the full mode to K4's values,
    the kernel's row map (loads and full) equal to ``trilerp_box_rows``;
    both the staged and the global-tap path run. The SASS keeps the taps
    and the copy engine's copies: in loads and full at least 8 shared loads
    (the staged path's taps) and 8 global loads (the other path's) more
    than in weights, and tensor copies (the boxes), none in weights; bulk
    copies (the coordinates) in every mode. On the tool's rows each mode
    and K4 are timed beside the twin, grid_sample, the bound and the
    sector floor."""
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        ABLATION_MODES, ABLATION_THREADS, ablation_rows, trilerp_ablation,
        trilerp_ablation_ref, trilerp_box_rows, trilerp_bricks)
    from dynamicfusion_body_tpu_torch.tools.profile_trilerp import (
        grid_sample_fn, mode_bounds)

    err = 0.0
    paths = [0, 0]  # rows staged, rows read from global memory
    cases = k6_cases(torch, dev, k3_live, k3_coords, grids)
    for name, live, coords in cases:
        k4_vals = trilerp_bricks(live, *coords)[0]
        fits = trilerp_box_rows(live.shape, *coords)[2].to(torch.uint8)
        rows = ablation_rows(coords[0].shape)[0]
        for mode in ABLATION_MODES:
            want = trilerp_ablation_ref(live, *coords, mode)
            for threads in ABLATION_THREADS:
                row_map = (None if mode == "weights" else torch.full(
                    (rows,), 7, dtype=torch.uint8, device=dev))
                got = trilerp_ablation(live, *coords, mode, threads,
                                       row_map=row_map)
                torch.cuda.synchronize()
                n_neq = int(torch.sum(got != want))
                err = max(err, float(torch.max(torch.abs(got - want))))
                check(n_neq == 0, f"K6 {mode} at {threads} threads on "
                      f"{name} differs from its twin at {n_neq} samples "
                      f"(max {err})")
                if mode == "full":
                    check(torch.equal(got, k4_vals), f"K6 full at "
                          f"{threads} threads on {name} differs from K4")
                if row_map is not None:
                    n_map = int(torch.sum(row_map != fits))
                    check(n_map == 0, f"K6 {mode} at {threads} threads on "
                          f"{name}: row map differs from trilerp_box_rows "
                          f"at {n_map} of {rows} rows")
                del got
            del want
        staged = int(fits.sum())
        paths[0] += staged
        paths[1] += rows - staged
        print(f"# K6 {name}: {coords[0].numel()} samples, {rows} rows, "
              f"{staged / rows:.2%} staged; every mode at "
              f"{'/'.join(map(str, ABLATION_THREADS))} threads bit-equal to "
              f"its twin, full to K4, loads' and full's row map = "
              f"trilerp_box_rows")
    check(all(paths), f"K6 rows staged / global {paths}: a path did not run")
    print(f"# K6 rows over the cases: staged {paths[0]}, global taps "
          f"{paths[1]}")

    _, live, coords = cases[0]
    del cases
    bounds = mode_bounds(live, coords)
    times = {}
    for mode in ABLATION_MODES:
        b = bounds[mode]
        ms = {t: cuda_ms(torch, lambda m=mode, t=t: trilerp_ablation(
            live, *coords, m, t)) for t in ABLATION_THREADS}
        plain = cuda_ms(torch, lambda m=mode: trilerp_ablation_ref(
            live, *coords, m), reps=3)
        times[mode] = (ms[256], plain)
        floor = (f"; sector floor {b['floor_ms']:.4f} ms, "
                 f"{b['floor_ms'] / ms[256]:.1%} of it"
                 if "floor_ms" in b else "")
        print(f"# K6 {mode} on the tool's 256^3 rows: kernel "
              + ", ".join(f"{ms[t]:.4f} ms at {t}" for t in ABLATION_THREADS)
              + f"; twin {plain:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), {b['bound_ms'] / ms[256]:.1%} of it at "
              f"256{floor}")
    k4_ms = cuda_ms(torch, lambda: trilerp_bricks(live, *coords))
    lib_ms = cuda_ms(torch, grid_sample_fn(live, *coords))
    b4 = bounds["k4"]
    print(f"# K6 beside K4 on the same samples: K4 {k4_ms:.4f} ms (bound "
          f"{b4['bound_ms']:.4f}, sector floor {b4['floor_ms']:.4f}); "
          f"grid_sample {lib_ms:.4f} ms")

    loads = sass_loads(torch)
    for t in ABLATION_THREADS:
        n = {m: loads.get((m, t)) for m in ABLATION_MODES}
        check(None not in n.values(), f"K6 SASS at {t} threads: {n}")
        w = n["weights"]
        check(w["UTMALDG"] == 0 and all(n[m]["UBLKCP"] > 0 for m in n)
              and all(n[m]["LDG"] >= w["LDG"] + 8
                      and n[m]["LDS"] >= w["LDS"] + 8
                      and n[m]["UTMALDG"] > 0 for m in ("loads", "full")),
              f"K6 SASS at {t} threads: loads and copies {n}")
    print(f"# K6 SASS per instantiation (LDG global loads, LDS shared "
          f"loads, UBLKCP bulk copies, UTMALDG tensor copies): "
          f"{ {f'{m}_t{t}': n for (m, t), n in sorted(loads.items())} }")
    ms, plain = times["full"]
    full = bounds["full"]
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=full["bound_ms"], bound_by=full["bound_by"],
                library_ms=lib_ms)


class HashLines(io.TextIOBase):
    """A text stream that writes each line to ``out`` as a '#' line and
    keeps the lines as written in ``lines``."""

    def __init__(self, out):
        self.out = out
        self.tail = ""
        self.lines = []

    def write(self, text):
        lines = (self.tail + text).split("\n")
        self.tail = lines.pop()
        self.lines += lines
        for line in lines:
            self.out.write((line if line.startswith("#") else "# " + line)
                           + "\n")
        self.out.flush()
        return len(text)


def quiet(fn):
    """fn() with its standard output and error as '#' lines; returns (fn's
    result, its standard output's lines)."""
    out = HashLines(sys.stdout)
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(HashLines(sys.stdout)):
        res = fn()
    return res, out.lines


def phase_tools(torch):
    """The profiling entry points at 256³, in this process:
    profile_trilerp and profile_upd at their defaults, profile_mc and
    profile_frame with --reps 1 and --trace into a temporary directory
    (deleted after each tool), profile_solve with --reps 1, then
    profile_corr5 at its defaults. Returns {tool: rows}."""
    from dynamicfusion_body_tpu_torch.tools import (
        profile_corr5, profile_frame, profile_mc, profile_solve,
        profile_trilerp, profile_upd)

    # (tool, traced): None runs the tool at its defaults
    runs = ((profile_trilerp, None), (profile_upd, None),
            (profile_mc, True), (profile_solve, False),
            (profile_frame, True), (profile_corr5, None))
    out = {}
    for tool, traced in runs:
        name = tool.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            argv = ([] if traced is None else ["--reps", "1"]
                    + (["--trace", tmp] if traced else []))
            with contextlib.redirect_stdout(HashLines(sys.stdout)):
                out[name] = tool.main(argv)
        print(f"# {name} {' '.join(argv[:3])}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    # a traced row that is not whole (a port kernel traced fewer times
    # than its wrapper launched it, or a launch without its kernel) says so
    # and has no busy share; the single-launch rows must be whole
    lost = {f"{tool.__name__.rsplit('.', 1)[1]}.{row}": r["trace_lost"]
            for tool, traced in runs if traced
            for row, r in out[tool.__name__.rsplit(".", 1)[1]].items()
            if r["trace_lost"]}
    n = sum(len(out[t.__name__.rsplit(".", 1)[1]]) for t, tr in runs if tr)
    print(f"# traced rows whole: {n - len(lost)} of {n}; not whole: {lost}")
    for tool, row in (("profile_mc", "mc_case_cross"),
                      ("profile_frame", "trilerp_k4")):
        r = out[tool][row]
        check(not r["trace_lost"] and r["device_ms"] > 0,
              f"the trace of {tool} {row} is not whole: {r['trace_lost']}")
    return out


def phase_entry_points(torch, dev, stamp):
    """The benchmark entry points in this process, as a user runs them:
    the bench at 256³ (its JSON line must carry bench.py's keys with
    every gate's value and accuracy_ok true; K1 and K2 must launch; no
    mesh may overflow its caps), the suite's configs 1, 2 and 3 (finite
    values; config 3's median rotation error below 1 degree; configs 4,
    6 and 7 have phases of their own), then diag_gate (its exact arm)
    and diag_config7 (its base arm, which is config 7 at 64³: the final
    error must be below the untracked one) at 64³. Their lines go out as
    '#' lines."""
    from dynamicfusion_body_tpu_torch.benchmarks import bench, suite
    from dynamicfusion_body_tpu_torch.tools import diag_config7, diag_gate

    report, lines = quiet(lambda: bench.main([]))
    line = json.loads(lines[-1])
    check(tuple(line) == bench.RESULT_KEYS,
          f"bench: the JSON line's keys {tuple(line)}")
    gate_keys = ("accuracy_tsdf_dev_p999", "accuracy_tsdf_dev_max",
                 "accuracy_cost_ratio", "accuracy_cost_slack_vs_presolve",
                 "pool_risk", "corr_risk", "corr_refresh")
    check(all(np.isfinite(line[k]) for k in gate_keys),
          f"bench: a gate value is not finite: {line}")
    print(f"# bench at {RES}^3: {line['value']} ms/frame by the chain, "
          f"{report.walls_ms:.1f} by the six chained frames' walls / 6, "
          f"synced frames {[round(w, 1) for w in report.frame_walls]} ms; "
          f"gates {report.gates}; arms {report.arm_ms} ms; peak "
          f"{report.peak_gib:.2f} GiB (chain {report.peak_chain_gib:.2f}); "
          f"launches {report.launches}; mesh overflow "
          f"{report.mesh_overflow}")
    check(line["accuracy_ok"] is True, f"bench: accuracy gates {line}")
    check(all(report.launches.values()),
          f"bench: K1/K2 launches {report.launches}")
    check(not report.mesh_overflow, "bench: a mesh overflowed its caps")
    del report
    torch.cuda.empty_cache()
    stamp("bench entry point")

    for c in (1, 2, 3):
        lines, _ = quiet(lambda c=c: suite.CONFIGS[c](dev))
        for ln in lines:
            check(np.isfinite(ln["value"]) and ln["value"] > 0,
                  f"suite config {c}: {ln}")
        print(f"# suite config {c}: {lines}")
    icp = lines[0]["median_rot_err_deg"]
    check(icp < 1.0, f"suite config 3: median rotation error {icp} deg")
    torch.cuda.empty_cache()
    stamp("suite configs 1-3")

    arms, _ = quiet(lambda: diag_gate.main(["--res", "64", "--arm",
                                            "exact"]))
    check(all(np.isfinite(v) for v in arms["exact"].values()),
          f"diag_gate: {arms}")
    torch.cuda.empty_cache()
    stamp("diag_gate at 64^3")
    (arm,), _ = quiet(lambda: diag_config7.main(["--res", "64"]))
    print(f"# diag_config7 base arm at 64^3: {arm}")
    check(arm["final_voxels"] < arm["untracked_voxels"],
          f"diag_config7: error {arm['final_voxels']} not below the "
          f"untracked {arm['untracked_voxels']}")
    torch.cuda.empty_cache()
    stamp("diag_config7 at 64^3")


def phase_bare_window(torch):
    """How many kernel records a profiler window without device_trace's
    pre-roll drops, in this process: PREROLL additions in a bare window.
    Fails if the pre-roll would not cover the loss."""
    from dynamicfusion_body_tpu_torch.utils.profiling import (
        PREROLL, device_trace)

    x = torch.zeros(1, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp, cuda=True, preroll=0) as tr:
            for _ in range(PREROLL):
                x.add_(1.0)
        lost = tr.unmatched_launches()
    print(f"# a profiler window without the pre-roll lost {lost} of its "
          f"first {PREROLL} kernel launches")
    check(lost < PREROLL, f"a bare profiler window lost all {PREROLL} of "
          "its first kernel launches: the pre-roll may not cover the loss")


def phase_padded(torch, dev):
    """K2 and K3 on a 72³ canonical lattice over a 65³ live volume (the
    reference's .dist size, padded to the brick as Fusion.updateTSDF pads
    it), against their twins; then the update on the kernel arm against the
    plain arm."""
    from dynamicfusion_body_tpu_torch.models.warp_field import (
        update_tsdf_nonrigid)
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks, warp_trilerp_bricks_cached,
        warp_trilerp_bricks_cached_ref, warp_trilerp_bricks_ref)
    from dynamicfusion_body_tpu_torch.pipeline.frame import (
        _build_caches, init_canonical)
    from dynamicfusion_body_tpu_torch.tools._scene import bumpy_sdf

    canon = torch.from_numpy(bumpy_sdf(65, (32, 32, 32), 18.0, 1.0, 3.0,
                                       0.0)).to(dev)
    live = torch.from_numpy(bumpy_sdf(65, (33, 32, 32), 18.0, 1.0, 3.0,
                                      0.1)).to(dev)
    tdist = float(canon.max())
    values = torch.nn.functional.pad(canon, (0, 7) * 3, value=tdist)
    shape = tuple(values.shape)
    wf, _ = init_canonical(canon, subsample_rate=1.5, node_cap=1024,
                           mc_step=2, vert_cap=1 << 14, face_cap=1 << 15)
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((wf.capacity, 8)).astype(np.float32) * 0.02
    wf = wf.replace(node_dq=wf.node_dq + torch.from_numpy(noise).to(dev))
    lw = torch.tensor(LW_REF, dtype=torch.float32, device=dev)
    (cand, risk), (sel, selw, wi) = _build_caches(wf, shape, 8, 16, 3, False)
    k2_args = (live, wf.node_dq, cand, sel, selw, lw)
    k2 = warp_trilerp_bricks_cached(*k2_args, brick=8, vol_shape=shape)
    k2n = warp_trilerp_bricks_cached(*k2_args, brick=8, vol_shape=shape,
                                     coords=False)
    k2r = warp_trilerp_bricks_cached_ref(*k2_args, brick=8, vol_shape=shape)
    args = (live, wf.node_pos, wf.node_w, wf.active, wf.node_dq, cand, lw)
    k3 = warp_trilerp_bricks(*args, vol_shape=shape, brick=8, k=3)
    k3n = warp_trilerp_bricks(*args, vol_shape=shape, brick=8, k=3,
                              coords=False)
    k3r = warp_trilerp_bricks_ref(*args, vol_shape=shape, brick=8, k=3)
    torch.cuda.synchronize()
    errs, n_neq = [], {}
    for name, got, ref in (("K2", k2, k2r), ("K3", k3, k3r)):
        check(torch.equal(got[1], ref[1]), f"{name} padded: valid differs")
        err = float(torch.max(torch.abs(torch.where(ref[1], got[0] - ref[0],
                                                    0.0))))
        for g, r in zip(got[2:], ref[2:]):  # (wi,) wx, wy, wz
            err = max(err, float(torch.max(torch.abs(g - r))))
        check(err <= K2_TOL_COORD, f"{name} padded differs by {err}")
        errs.append(err)
    for name, got, ref in (("K2", k2, k2r), ("K2 no coordinates", k2n, k2r),
                           ("K3", k3, k3r), ("K3 no coordinates", k3n, k3r)):
        n_neq[name] = n_not_equal(got, ref)
    check(not any(n_neq.values()),
          f"padded: not bit-equal to the twins at {n_neq} voxels")
    n_out = int(torch.sum(~k3r[1]))
    kw = dict(k=3, tdist=tdist, brick=8, n_candidates=16)
    arms = {}
    for cached in (False, True):
        for kern in (True, False):
            arms[cached, kern] = update_tsdf_nonrigid(
                values, torch.zeros_like(values), live, wf, lw,
                use_kernels=kern, cand_cache=(cand, risk),
                warp_cache=(sel, selw, wi) if cached else None, **kw)
    dev_max = max(float(torch.max(torch.abs(arms[c, True][i]
                                            - arms[c, False][i])))
                  for c in (False, True) for i in (0, 1))
    check(dev_max <= 1e-3, f"padded update: kernel arm deviates {dev_max}")
    check(all(bool(torch.isfinite(a[0]).all()) for a in arms.values()),
          "padded update: non-finite TSDF")
    print(f"# padded lattice {shape} over live {tuple(live.shape)} (NB "
          f"{cand.shape[0]}): K2 and K3 match their twins (max err "
          f"{errs[0]:.3g}, {errs[1]:.3g}; voxels not bit-equal {n_neq}); "
          f"{n_out} samples outside the live volume; update kernel vs plain "
          f"arm max |d| {dev_max:.3g}")


def phase_ragged(torch, dev, grids):
    """K2 (with the mip certificate) and K3 on a lattice whose brick count
    is neither a multiple of either kernel's persistent grid nor below
    twice it, so the CTAs walk two, three or more bricks and the last
    round is ragged: a 24 x 32 x 8n clipped cylinder and a random node
    graph. Bit-equal to their twins, with and without coordinates."""
    from dynamicfusion_body_tpu_torch.models.warp_field import (
        build_warp_cache, brick_candidates_2level, construct_graph)
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        live_brick_mip, warp_trilerp_bricks, warp_trilerp_bricks_cached,
        warp_trilerp_bricks_cached_ref, warp_trilerp_bricks_ref)

    g = max(grids.values())
    n = 2 * g // 12 + 1
    while any((12 * n) % gr == 0 for gr in grids.values()):
        n += 1
    shape = (24, 32, 8 * n)
    nb = 12 * n
    rng = np.random.default_rng(5)
    x, y, z = np.meshgrid(*(np.arange(e, dtype=np.float32) for e in shape),
                          indexing="ij")
    tdist = 3.0
    live = torch.from_numpy(np.clip(np.sqrt((x - 12) ** 2 + (y - 15) ** 2)
                                    - 8.0, -tdist, tdist)).to(dev)
    verts = rng.random((8 * n, 3)).astype(np.float32) * np.array(
        shape, np.float32)
    wf = construct_graph(torch.from_numpy(verts).to(dev), 2.0, 12 * n)
    dqs = (rng.standard_normal((wf.capacity, 8)) * 0.03).astype(np.float32)
    dqs[:, 0] += 1.0
    wf = wf.replace(node_dq=torch.from_numpy(dqs).to(dev))
    lw = torch.tensor(LW_REF, dtype=torch.float32, device=dev)
    cand = brick_candidates_2level(wf, shape, 8, 16)
    sel, selw, _ = build_warp_cache(wf, shape, cand, 3, 8)
    k2_args = (live, wf.node_dq, cand, sel, selw, lw)
    k2_kw = dict(brick=8, tdist=tdist, live_mip=live_brick_mip(live))
    k3_args = (live, wf.node_pos, wf.node_w, wf.active, wf.node_dq, cand, lw)
    n_neq = {}
    for c in (True, False):
        n_neq["K2", c] = n_not_equal(
            warp_trilerp_bricks_cached(*k2_args, **k2_kw, coords=c),
            warp_trilerp_bricks_cached_ref(*k2_args, **k2_kw))
        n_neq["K3", c] = n_not_equal(
            warp_trilerp_bricks(*k3_args, brick=8, k=3, coords=c),
            warp_trilerp_bricks_ref(*k3_args, brick=8, k=3))
    print(f"# ragged tail: lattice {shape}, NB {nb}, nodes "
          f"{int(wf.num_active)}/{wf.capacity}; NB % grid "
          f"{ {name: nb % gr for name, gr in grids.items()} }; voxels not "
          f"bit-equal to the twins (kernel, coordinates) {n_neq}")
    check(not any(n_neq.values()), f"ragged tail: not bit-equal {n_neq}")


def phase_config4(torch, dev, sc):
    """benchmarks/suite.py config 4 (suite.py:193-226) through the port's
    ``suite.config4`` on the bench scene: the cache-less non-rigid update
    at 256³ through K3, a warm call and 3 timed calls; then one more call
    against the plain arm."""
    from dynamicfusion_body_tpu_torch.benchmarks import suite
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks)

    warp_trilerp_bricks.launches = 0
    warp_trilerp_bricks.coord_launches = 0
    (line,), _ = quiet(lambda: suite.config4(dev, RES, scene=sc))
    launches = warp_trilerp_bricks.launches
    check(launches == 4, f"config 4: K3 launched {launches} times in 4 "
          "calls")
    check(warp_trilerp_bricks.coord_launches == 0,
          "config 4: the update's K3 wrote coordinates")
    zeros = torch.zeros_like(sc.canonical)
    v, w, _, risk = suite.config4_update(sc, zeros, True)
    pv, pw, _, p_risk = suite.config4_update(sc, zeros, False)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(v).all() and torch.isfinite(w).all()),
          "config 4: non-finite TSDF")
    dv = torch.abs(v - pv).cpu().numpy()
    dw = torch.abs(w - pw).cpu().numpy()
    p_v, p_w = float(np.percentile(dv, 99.9)), float(np.percentile(dw, 99.9))
    print(f"# config 4 at {RES}^3 (no caches, K3): {line['value']} ms an "
          f"update (suite.config4, mean of 3); pool_risk {int(risk)} (plain "
          f"arm {int(p_risk)}); kernel vs plain arm |dvalues| p99.9 "
          f"{p_v:.3g} max {float(dv.max()):.3g}, |dweights| p99.9 "
          f"{p_w:.3g} max {float(dw.max()):.3g}; updated voxels "
          f"{int(torch.sum(w > 0))}; launches K3 {launches}, of which with "
          f"coordinates 0")
    check(p_v < GATE_DEV_P999 and p_w < GATE_DEV_P999,
          f"config 4: kernel arm deviates (p99.9 {p_v}, {p_w})")
    return launches


def run_frame(torch, fusion_frame, state, live, hyper):
    """One frame from ``state`` that must track. Returns (state', its
    synced wall ms, its FrameStats)."""
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
    return (v, w, wf2, lw2, mesh2), ms, stats


def direct_knn(torch, q, p, valid, k, chunk=256):
    """k-NN by direct differences, the arithmetic of knn_2level's and
    grid_knn's fine level, ties to the lower index: (squared distances
    (Q,k) ascending, idx (Q,k))."""
    from dynamicfusion_body_tpu_torch.ops.knn import BIG, smallest_k

    tie = torch.arange(len(p), dtype=torch.float32, device=p.device) * 1e-12
    d2s, idxs = [], []
    for s in range(0, len(q), chunk):
        qc = q[s:s + chunk]
        dx = qc[:, 0:1] - p[None, :, 0]
        dy = qc[:, 1:2] - p[None, :, 1]
        dz = qc[:, 2:3] - p[None, :, 2]
        d2 = torch.where(valid[None, :], dx * dx + dy * dy + dz * dz, BIG)
        idx = smallest_k(d2 + tie, k)
        d2s.append(torch.gather(d2, 1, idx))
        idxs.append(idx)
    return torch.cat(d2s), torch.cat(idxs)


def phase_modes(torch, warm, live, hyper, fresh):
    """The correspondence modes of fusion_frame at 256³ on the bench scene,
    from phase 7's post-warm-up state ``warm`` on ``live`` (phase 7's
    first timed frame, whose (wall ms, stats) are ``fresh``): one frame
    each with reuse_corr=True, approx_knn="2level", approx_knn=True and
    use_grid_corr=True on the bench's settings, kernels on. K1 and K2 must
    launch, every frame be finite with no mesh over its caps, the reuse
    and bf16-keyed frames track and the reuse frame's final cost be within
    REUSE_COST_MAX of the fresh frame's; the grid frame, without
    correspondences, must keep its pose. The 2-level frame's tracking is
    printed, not required: the JAX package's 2-level pools miss the
    nearest live vertices of most of this scene's warped vertices (its
    certificate flags them; the risk is printed below). Then, on the
    frame-entry warped canonical vertices against the live mesh:
    knn_2level and grid_knn held to a search by direct differences, the
    bf16-keyed search's recall, and the k > 4 selection timed against the
    stable sort it replaced. Returns the launches of the four frames."""
    from dynamicfusion_body_tpu_torch.models.warp_field import (
        neighbor_lookup, warp_points)
    from dynamicfusion_body_tpu_torch.ops.grid_knn import grid_knn
    from dynamicfusion_body_tpu_torch.ops.knn import (
        _smallest_k_exact, knn, knn_2level, pairwise_sqdist, smallest_k)
    from dynamicfusion_body_tpu_torch.ops.marching_cubes import marching_cubes
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks_cached)
    from dynamicfusion_body_tpu_torch.pipeline.frame import fusion_frame

    modes = {"reuse_corr": dict(reuse_corr=True),
             "2level": dict(approx_knn="2level"),
             "approx": dict(approx_knn=True),
             "grid": dict(use_grid_corr=True)}
    kernels = (mc_case_cross, warp_trilerp_bricks_cached)
    for kern in kernels:
        kern.launches = 0
    out = {}
    for name, mode in modes.items():
        v0, w0, wf0, lw0, mesh0 = warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, w, _, lw, st, mesh = fusion_frame(v0, w0, live, wf0, lw0,
                                             canon_mesh=mesh0,
                                             **dict(hyper, **mode))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        finite = bool(torch.isfinite(v).all() and torch.isfinite(w).all())
        n_corr, cost = int(st.n_corr), float(st.cost_after[-1])
        out[name] = dict(ms=ms, n_corr=n_corr, corr_risk=int(st.corr_risk),
                         corr_refresh=int(st.corr_refresh), cost=cost,
                         track=cost / max(n_corr, 1), finite=finite,
                         mesh_overflow=bool(mesh["overflow"]),
                         pose_kept=bool(torch.equal(lw, lw0)))
        print(f"# mode {name}: {out[name]}")
        check(finite, f"mode {name}: non-finite TSDF")
        check(not bool(mesh["overflow"]), f"mode {name}: the canonical mesh "
              "overflowed")
        track = out[name]["track"]
        if name in ("reuse_corr", "approx"):
            check(n_corr > 0 and track < TRACK_MAX, f"mode {name}: tracking "
                  f"lost ({n_corr} correspondences, {track:.3g} per corr)")
        elif name == "grid" and n_corr == 0:
            check(out[name]["pose_kept"], "mode grid: the pose moved "
                  "without correspondences")
        del v, w, lw, st, mesh
    launches = {k.__name__: k.launches for k in kernels}
    fresh_ms, fresh_st = fresh
    fresh_cost = float(fresh_st.cost_after[-1])
    print(f"# modes from the post-warm-up state: fresh (phase 7's first "
          f"timed frame) {fresh_ms:.1f} ms, n_corr {int(fresh_st.n_corr)}, "
          f"cost {fresh_cost:.4f}; launches of the four frames {launches}")
    check(all(launches.values()), f"modes: launches {launches}")
    check(out["reuse_corr"]["cost"] <= REUSE_COST_MAX * fresh_cost,
          f"mode reuse_corr: final cost {out['reuse_corr']['cost']} above "
          f"{REUSE_COST_MAX} x the fresh frame's {fresh_cost}")

    # the candidate searches on the frame-entry warped vertices
    _, _, wf0, lw0, mesh0 = warm
    lm = marching_cubes(live, 0.0, vert_cap=hyper["live_vert_cap"],
                        face_cap=hyper["live_face_cap"], with_normals=False,
                        use_kernels=True)
    p = lm["verts"]
    lmask = torch.arange(len(p), device=p.device) < lm["n_verts"]
    vmask = (torch.arange(len(mesh0["verts"]), device=p.device)
             < mesh0["n_verts"])
    nbr = neighbor_lookup(wf0, mesh0["verts"], hyper["knn_k"])
    q = warp_points(wf0, mesh0["verts"], nbr, m_lw=lw0)
    kc = max(4 * hyper["knn_k"], 16)
    ref_d2, ref_i = direct_knn(torch, q, p, lmask, kc)
    _, flat_i = knn(q, p, kc, valid=lmask)
    d2l, i2l, risk = knn_2level(q, p, kc, qvalid=vmask, valid=lmask)
    d_ref = torch.sqrt(ref_d2)
    off = vmask & torch.any(d2l != d_ref, dim=1)
    n_valid = int(vmask.sum())
    print(f"# knn_2level kc {kc} over {n_valid} warped vertices x "
          f"{int(lmask.sum())} live: risk {int(risk)}; distances differ "
          f"from the direct search on {int(off.sum())} queries; indices "
          f"equal to it on {float(torch.mean(torch.all(i2l == ref_i, 1)[vmask].float())):.4f}"
          f", to the flat knn's on "
          f"{float(torch.mean(torch.all(i2l == flat_i, 1)[vmask].float())):.4f}"
          " of the queries")
    check(int(off.sum()) <= int(risk), f"knn_2level differs from the direct "
          f"search on {int(off.sum())} queries, more than its risk "
          f"{int(risk)}")
    _, ia = knn(q, p, kc, valid=lmask, approx=True)
    same = torch.all(torch.sort(ia, 1).values == torch.sort(flat_i, 1).values,
                     1)
    print(f"# approx=True kc {kc}: index sets equal to the flat search's on "
          f"{float(same[vmask].float().mean()):.4f} of the queries")

    k, cell, cap = hyper["knn_k"], 16.0, 256
    grid_n = (max(live.shape) + 15) // 16
    gd, _, gf, govf = grid_knn(q, p, k, valid=lmask, cell=cell,
                                cap_per_cell=cap, grid_n=grid_n)
    c = torch.clamp((p / cell).to(torch.int32), 0, grid_n - 1).long()
    pcell = ((c[:, 0] * grid_n + c[:, 1]) * grid_n + c[:, 2])[lmask]
    count = torch.bincount(pcell, minlength=grid_n ** 3)
    qc = torch.clamp(torch.floor((q - cell / 2) / cell).to(torch.int32), 0,
                     grid_n - 2).long()
    crowded = torch.zeros_like(vmask)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cid = ((qc[:, 0] + dx) * grid_n + qc[:, 1] + dy) * grid_n + (
                    qc[:, 2] + dz)
                crowded |= count[cid] > cap
    held = vmask & ~crowded
    near = d_ref[:, :k] < cell / 2 - 1e-3
    bad = held[:, None] & near & (~gf | (gd != d_ref[:, :k]))
    print(f"# grid_knn k {k}, grid {grid_n}^3 of {cell:g}-voxel cells, cap "
          f"{cap}: overflow {bool(govf)}, cells over the cap "
          f"{int((count > cap).sum())} of {int((count > 0).sum())} occupied "
          f"(most {int(count.max())} points); {int(held.sum())} of {n_valid} "
          f"queries with no crowded cell, {int(bad.any(1).sum())} of them "
          f"off the direct search within cell/2")
    check(not bool(bad.any()), "grid_knn differs from the direct search "
          "where no cell overflowed")

    # the k > 4 selection (a float top-k, int64 keys on tied rows) against
    # the stable sort it replaced, on one (chunk, P) block of the flat
    # candidate search
    chunk = max(256, min(8192, (1 << 27) // len(p)))
    qb = q[:chunk]
    d2 = torch.where(lmask[None, :], pairwise_sqdist(qb, p), torch.inf)
    d2 = d2 + torch.arange(len(p), device=p.device) * 1e-12
    want = torch.sort(d2, dim=1, stable=True).indices[:, :kc]
    check(torch.equal(smallest_k(d2, kc), want)
          and torch.equal(_smallest_k_exact(d2, kc), want),
          "smallest_k differs from the stable sort")
    topk_ms = cuda_ms(torch, lambda: smallest_k(d2, kc))
    exact_ms = cuda_ms(torch, lambda: _smallest_k_exact(d2, kc))
    sort_ms = cuda_ms(torch, lambda: torch.sort(d2, dim=1,
                                                stable=True).indices[:, :kc])
    search_ms = cuda_ms(torch, lambda: knn(q, p, kc, valid=lmask), reps=3)
    n_chunks = -(-len(q) // chunk)
    print(f"# k > 4 selection on a ({chunk}, {len(p)}) block: smallest_k "
          f"{topk_ms:.3f} ms, its int64-key path on every row "
          f"{exact_ms:.3f} ms, the stable sort {sort_ms:.3f} ms (x "
          f"{n_chunks} blocks a search: {topk_ms * n_chunks:.1f} / "
          f"{exact_ms * n_chunks:.1f} / {sort_ms * n_chunks:.1f} ms); the "
          f"whole kc {kc} search {search_ms:.1f} ms")
    return launches


def config6_views(torch, dev):
    """meshes/original.obj, regularized, rendered from 8 yaw views at 512²
    on the card by ``suite._render_views`` (benchmarks/suite.py:53-72,
    dist 2.5, S=8). Returns (verts, faces, the maps as numpy as a caller
    hands them, the maps stacked on the card, lws (8,3,4) numpy)."""
    from dynamicfusion_body_tpu_torch.benchmarks import suite

    verts, faces = suite.reference_mesh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps, lws = suite._render_views(verts, faces, K6, N_VIEWS, IMG, IMG, dev)
    depths = torch.from_numpy(np.stack(maps)).to(dev)
    hits = [int(torch.sum(d != 0)) for d in depths]
    check(min(hits) > 10000, f"renders with few hits: {hits}")
    print(f"# config 6: {len(verts)} verts {len(faces)} faces; 8 views "
          f"rendered in {time.perf_counter() - t0:.3f} s; hit pixels {hits}")
    return verts, faces, maps, depths, np.stack(lws)


def k5_projs(lws, ind, K=K6):
    """K·lw·IND per view in numpy float32, as FusionDM._proj."""
    out = []
    for lw in lws:
        lw4 = np.eye(4, dtype=np.float32)
        lw4[:3] = lw
        out.append(K @ lw4[:3] @ ind)
    return np.stack(out).astype(np.float32)


def k5_case(torch, name, v0, w0, depths, projs, kr):
    """One K5 call against its twin: values and weights bit-equal, and the
    kernel's cull map equal to fuse_cull_tiles. Returns (max |Δ|, the
    kernel's weights, the culled (view, tile) pairs)."""
    from dynamicfusion_body_tpu_torch.ops.fusion_cuda import (
        cull_grid, fuse_cull_tiles, fuse_depth_multi, fuse_depth_multi_ref)

    n, h, w = depths.shape
    cull = torch.empty((n, *cull_grid(v0.shape)), dtype=torch.uint8,
                       device=v0.device)
    gv, gw = fuse_depth_multi(v0, w0, depths, projs, kr, TDIST6,
                              cull_map=cull)
    rv, rw = fuse_depth_multi_ref(v0, w0, depths, projs, kr, TDIST6)
    pred = fuse_cull_tiles(v0.shape, projs, h, w)
    torch.cuda.synchronize()
    n_flip = int(torch.sum(gw != rw))
    err = max(float(torch.max(torch.abs(gv - rv))),
              float(torch.max(torch.abs(gw - rw))))
    bit = n_flip == 0 and torch.equal(gv, rv)
    n_map = int(torch.sum(cull.bool() != pred))
    print(f"# K5 {name}, {tuple(v0.shape)} x {n} views: "
          f"{'bit-equal' if bit else 'NOT bit-equal'} (weights differ at "
          f"{n_flip} voxels, max |d| {err:.3g}); updated voxels "
          f"{int(torch.sum(gw != w0))}, max weight {float(gw.max())}; the "
          f"cull skips {float(pred.float().mean()):.2%} of {pred.numel()} "
          f"(tile, view) pairs, the kernel's map "
          f"{'equals' if n_map == 0 else f'differs at {n_map} from'} "
          f"fuse_cull_tiles")
    check(bit, f"K5 {name}: not bit-equal to its twin ({n_flip} weights, "
          f"max |d| {err})")
    check(n_map == 0, f"K5 {name}: the kernel culled other (tile, view) "
          f"pairs than fuse_cull_tiles ({n_map})")
    return err, gw, pred


def phase_k5(torch, dev, depths, lws):
    """K5 against its twin on config 6's renders: 256³ x 8 views from an
    empty volume and from a half-fused one whose weights are near WMAX (so
    the running average and the clamp run); one view (the ICP branch's
    call); a ragged 37x41x53 volume with 3 views; a camera inside the
    volume (pw changes sign across tiles); a view whose image the volume
    only grazes. Times the 8-view call and splits its voxel-views by the
    path they take in the kernel, for the bound and the issue time."""
    from dynamicfusion_body_tpu_torch.ops.fusion_cuda import (
        CULL_TILE, fuse_depth_multi, fuse_depth_multi_ref)
    from dynamicfusion_body_tpu_torch.ops.projection import (
        estimate_alignment, make_ind_matrix)

    kinv = np.linalg.inv(K6).astype(np.float32)
    avg, std = estimate_alignment(depths, torch.from_numpy(kinv).to(dev),
                                  torch.from_numpy(lws).to(dev))
    ind = make_ind_matrix(RES, avg, std).cpu().numpy()
    projs = torch.from_numpy(k5_projs(lws, ind)).to(dev)
    kr = torch.from_numpy(kinv[2]).to(dev)

    def blank(shape):
        return (torch.full(shape, TDIST6, device=dev),
                torch.zeros(shape, device=dev))

    empty = blank((RES,) * 3)
    half_v, half_w = fuse_depth_multi_ref(*empty, depths[:4], projs[:4], kr,
                                          TDIST6)
    half = (half_v, torch.where(half_w > 0, half_w + 95.0, half_w))
    err = 0.0
    for name, (v0, w0) in (("empty", empty), ("half-fused", half)):
        e, gw, pred = k5_case(torch, f"config 6 from {name}", v0, w0,
                              depths, projs, kr)
        err = max(err, e)
        if name == "empty":
            n_upd = float(torch.sum(gw - w0))  # no clamp from empty
            cull6 = pred
        else:
            check(float(gw.max()) == 100.0, "the WMAX clamp did not run")
    k5_case(torch, "one view (the ICP call)", *empty, depths[:1], projs[:1],
            kr)
    ragged = (37, 41, 53)
    ind_r = make_ind_matrix(max(ragged), avg, std).cpu().numpy()
    k5_case(torch, "ragged", *blank(ragged), depths[:3],
            torch.from_numpy(k5_projs(lws[:3], ind_r)).to(dev), kr)
    # view 0 turned about a centre at the volume's centre
    centre = avg.cpu().numpy().astype(np.float64)
    R = lws[0][:, :3].astype(np.float64)
    inside = np.concatenate([R, (-R @ centre)[:, None]], 1)
    k5_case(torch, "camera inside the volume", *empty, depths[:1],
            torch.from_numpy(k5_projs([inside], ind)).to(dev), kr)
    # view 0 with its principal point moved so that the volume's image
    # (its corners', the camera being outside) ends a tenth inside the
    # image's left border
    corners = np.array([[i, j, k, 1.0] for i in (0, RES - 1)
                        for j in (0, RES - 1) for k in (0, RES - 1)])
    uvw = corners @ projs[0].cpu().numpy().astype(np.float64).T
    px = uvw[:, 0] / uvw[:, 2]
    check(bool((uvw[:, 2] > 0).all()), "view 0 sees the volume from behind")
    graze = K6.copy()
    graze[0, 2] += 0.1 * (px.max() - px.min()) - px.max()
    k5_case(torch, "grazing the image's left border", *empty, depths[:1],
            torch.from_numpy(k5_projs(lws[:1], ind, graze)).to(dev), kr)

    ms = cuda_ms(torch, lambda: fuse_depth_multi(*empty, depths, projs, kr,
                                                 TDIST6))
    plain = cuda_ms(torch, lambda: fuse_depth_multi_ref(*empty, depths,
                                                        projs, kr, TDIST6),
                    reps=3)
    # this run's voxel-views by path: in a culled (tile, view) pair; out of
    # the image at the px test; at the py test; in the image
    g = [torch.arange(RES, dtype=torch.float32, device=dev).reshape(sh)
         for sh in ((-1, 1, 1), (1, -1, 1), (1, 1, -1))]
    n_cull = n_x = n_y = n_inb = 0
    warp_ins = 0  # warp instructions, a block issued where any lane takes it
    for view, p in enumerate(projs):
        culled = cull6[view]
        for axis, t in enumerate(CULL_TILE):
            culled = culled.repeat_interleave(t, dim=axis)
        culled = culled[:RES, :RES, :RES]
        u, v, pw = (p[r, 0] * g[0] + p[r, 1] * g[1] + p[r, 2] * g[2]
                    + p[r, 3] for r in range(3))
        px, py = u / pw, v / pw
        ok_x = (px >= 0) & (px < IMG - 1)
        ok_y = (py >= 0) & (py < IMG - 1)
        n_cull += int(torch.sum(culled))
        n_x += int(torch.sum(~culled & ~ok_x))
        n_y += int(torch.sum(~culled & ok_x & ~ok_y))
        n_inb += int(torch.sum(ok_x & ok_y))
        check(not bool(torch.any(culled & ok_x & ok_y)),
              f"K5 culled an in-image voxel-view of view {view}")
        warp_ins += k5_warp_instructions(torch, culled, ok_x, ok_x & ok_y,
                                         px, py, u, v, pw, depths[view], kr)
        del u, v, pw, px, py, ok_x, ok_y, culled
    nvox = RES ** 3
    nbytes = 16 * nvox + 4 * (depths.numel() + projs.numel() + 3)
    nops = (nvox * N_VIEWS * (K5_OPS_VIEW + K5_DIVS_VIEW)
            + n_inb * K5_OPS_INB + n_upd * (K5_OPS_UPD + K5_DIVS_UPD))
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
               **bound(nbytes, nops), library_ms=None)
    total = nvox * N_VIEWS
    print(f"# K5 kernel {ms:.4f} ms, twin {plain:.4f} ms; voxel-views "
          f"{total}: in culled (tile, view) pairs {n_cull} "
          f"({n_cull / total:.2%}; pairs {float(cull6.float().mean()):.2%}),"
          f" out of the image at px {n_x}, at py {n_y}, in the image "
          f"{n_inb}, updates {int(n_upd)}; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}; bytes {nbytes / HBM_BPS * 1e3:.4f} ms, ops "
          f"{nops / F32_OPS * 1e3:.4f} ms)")
    k5_issue(torch, ms, n_x, n_y, n_inb, n_upd, n_cull, total)
    print(f"# K5 warp issue time {issue_ms(32 * warp_ins):.4f} ms "
          f"({warp_ins / 1e9:.3f} G warp instructions at one a clock on "
          f"each of the 528 schedulers, a block counted for a warp where "
          f"any of its lanes takes it); kernel {ms:.4f} ms, "
          f"{issue_ms(32 * warp_ins) / ms:.1%} of it")
    return row


def phase_bench512(torch, dev):
    """The 512³ bench's main path (the port's benchmarks/bench512.py):
    ``Fusion`` built on the first volume, then two frames; then one fused
    frame (fusion_frame(allow_large=True), ``bench512 --fused``) on the
    same volumes; K1 and K2 must have launched, the TSDFs be finite.
    Returns (the Fusion run's report, the K1/K2 launches of both)."""
    from dynamicfusion_body_tpu_torch.benchmarks import bench512
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks_cached)

    mc_case_cross.launches = 0
    warp_trilerp_bricks_cached.launches = 0
    rep, _ = quiet(lambda: bench512.run(512, dev, n_frames=2))
    launches = {"mc_case_cross": mc_case_cross.launches,
                "warp_trilerp_bricks_cached":
                    warp_trilerp_bricks_cached.launches}
    check(all(launches.values()), f"bench512 launches {launches}")
    vals = rep.fus.volume.values
    check(bool(torch.isfinite(vals).all()), "bench512: non-finite TSDF")
    check(int(rep.fus._warp.num_active) > 0, "bench512: no nodes")
    fused, _ = quiet(lambda: bench512.run_fused(512, dev, rep.vols))
    check(fused.ok and int(fused.stats.n_corr) > 0,
          f"bench512 --fused: {fused.error}")
    launches = {"mc_case_cross": mc_case_cross.launches,
                "warp_trilerp_bricks_cached":
                    warp_trilerp_bricks_cached.launches}
    print(f"# bench512 (2 frames at 512^3): setup {rep.setup_s:.3f} s "
          f"(construct_graph {rep.graph_s:.3f} s); frames "
          + "; ".join(f"{w:.3f} s (" + ", ".join(
              f"{k} {v:.3f}" for k, v in ph.items()) + ")"
              for w, ph in zip(rep.walls, rep.frames))
          + f"; peak device memory {rep.peak_gib:.2f} GiB; nodes "
          f"{int(rep.fus._warp.num_active)}; launches {launches}; "
          f"{json.dumps(rep.result)}")
    return rep, launches


def phase_sharded(torch, dev):
    """The sharded frame (parallel/frame_sharded.py) at world size 1 on
    NCCL, in process through parallel/launch.py, on the bench's 256³
    scene (init and one frame, the bench's settings), held against the
    port's init_canonical + fusion_frame on the same inputs by the
    criteria of the JAX package's tests/test_frame_sharded.py:75-97."""
    from dynamicfusion_body_tpu_torch.parallel import launch, ranks
    from dynamicfusion_body_tpu_torch.pipeline.frame import (
        fusion_frame, init_canonical)
    from dynamicfusion_body_tpu_torch.tools._scene import bumpy

    canonical = bumpy(RES, (128, 128, 128), 0.0)
    live = bumpy(RES, (130, 129, 128), 0.05)
    tdist = float(canonical.max())
    lw = np.array(LW_REF, np.float32)
    caps = dict(vert_cap=1 << 15, face_cap=1 << 16)
    init_kw = dict(subsample_rate=1.5, node_cap=4096, mc_step=2, **caps)
    hyper = dict(regularization_weight=0.5, knn_k=3, tdist=tdist, mc_step=2,
                 solve_iters=1, gn_iters=12, cg_iters=16, tolerance=5.0,
                 n_candidates=16, reuse_corr=False, **caps,
                 live_vert_cap=1 << 17, live_face_cap=1 << 18)
    t0 = time.perf_counter()
    out = launch.run(ranks.fusion_frames, 1,
                     (canonical, [live], lw, init_kw, hyper), backend="nccl")
    total_s = time.perf_counter() - t0
    f = out["frames"][0]
    st_s = f["stats"]

    values = torch.from_numpy(canonical).to(dev)
    wf_c, rad_c = init_canonical(values, **init_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v_c, _, _, _, st_c, _ = fusion_frame(
        values, torch.zeros_like(values), torch.from_numpy(live).to(dev),
        wf_c, torch.from_numpy(lw).to(dev), use_kernels=True, **hyper)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    cb_s, ca_s = st_s.cost_before, st_s.cost_after
    cb_c, ca_c = (st_c.cost_before.cpu().numpy(),
                  st_c.cost_after.cpu().numpy())
    dv = np.abs(f["values"] - v_c.cpu().numpy())
    p999 = float(np.percentile(dv, 99.9))
    n_s, n_c = int(st_s.n_nodes), int(st_c.n_nodes)
    print(f"# sharded frame, world size 1 on NCCL, {RES}^3: frame "
          f"{f['wall_s']:.3f} s synced (init + frame + gathers "
          f"{total_s:.3f} s), fusion_frame {single_s:.3f} s; radius "
          f"{float(out['radius']):.6f} / {float(rad_c):.6f}; n_corr "
          f"{int(st_s.n_corr)} / {int(st_c.n_corr)}; cost before "
          f"{cb_s} / {cb_c}, after {ca_s} / {ca_c}; |dvalues| p99.9 "
          f"{p999:.5f} max {float(dv.max()):.5f}; nodes {n_s} / {n_c}; "
          f"overflow {bool(st_s.overflow)}")
    check(abs(float(out["radius"]) - float(rad_c)) <= 1e-6 * float(rad_c),
          "sharded frame: sampling radius differs")
    check(int(st_s.n_corr) == int(st_c.n_corr),
          "sharded frame: n_corr differs")
    check(np.allclose(cb_s, cb_c, rtol=0.05, atol=0),
          f"sharded frame: cost before {cb_s} vs {cb_c}")
    check(np.allclose(ca_s, ca_c, rtol=0.10, atol=0),
          f"sharded frame: cost after {ca_s} vs {ca_c}")
    check(ca_s[0] < 0.5 * cb_s[0], "sharded frame: the solve did not "
          "descend")
    check(p999 < 0.25, f"sharded frame: |dvalues| p99.9 {p999}")
    check(n_s > 0 and abs(n_s - n_c) <= 16,
          f"sharded frame: nodes {n_s} vs {n_c}")
    return f["wall_s"]


def phase_sharded512(torch):
    """The sharded 512³ bench (benchmarks/bench512_sharded.py) at world
    size 1 on NCCL, in this process: the equivalence (the sharded update
    against the dense one: both deviations exactly 0) and the full frame
    (descended, no overflow, a finite cost); each JSON line printed with
    the arms' peak memory; both must be ``ok``."""
    from dynamicfusion_body_tpu_torch.benchmarks import bench512_sharded

    out = {}
    for name, argv in (("equivalence", []), ("full frame",
                                             ["--full-frame"])):
        t0 = time.perf_counter()
        res, lines = quiet(lambda argv=argv: bench512_sharded.main(argv))
        line = json.loads(lines[-1])
        peaks = {k: round(res[k], 2) for k in ("peak_dense_gib",
                                               "peak_sharded_gib",
                                               "peak_gib") if k in res}
        print(f"# bench512_sharded {name}, 512^3, world 1, NCCL: "
              f"{time.perf_counter() - t0:.1f} s in all; peak GiB {peaks}; "
              f"{json.dumps(line)}")
        check(line["ok"] is True, f"bench512_sharded {name}: {line}")
        out[name] = line
    eq, ff = out["equivalence"], out["full frame"]
    check(eq["max_dev_values"] == 0.0 and eq["max_dev_weights"] == 0.0,
          f"bench512_sharded: the sharded update differs: {eq}")
    check(ff["descended"] and not ff["overflow"],
          f"bench512_sharded --full-frame: {ff}")
    torch.cuda.empty_cache()
    return out


def phase_tools5(torch):
    """The round-5 solve and frame tools at 256³ in this process, short:
    profile_solve5, exp_freeze and exp_solver (--reps 1; exp_solver's
    chain at 2 frames, arm gn2_cg16), profile_frame5 (--frames 2, the
    base and solve_iters=0), sweep_solver5 (--frames 2, 2,16) and
    sweep_frame5 (--frames 2, si1). Every row must be finite; K1 and K2
    must launch (the frames' MC and update). Returns the launches."""
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks_cached)
    from dynamicfusion_body_tpu_torch.tools import (
        exp_freeze, exp_solver, profile_frame5, profile_solve5,
        sweep_frame5, sweep_solver5)

    kernels = (mc_case_cross, warp_trilerp_bricks_cached)
    for kern in kernels:
        kern.launches = 0
    short = ["--frames", "2"]
    for tool, argv in ((profile_solve5, ["--reps", "1"]),
                       (exp_freeze, ["--reps", "1"]),
                       (exp_solver, ["--reps", "1", *short, "--arm",
                                     "gn2_cg16"]),
                       (profile_frame5, [*short, "solve_iters=0"]),
                       (sweep_solver5, [*short, "2,16"]),
                       (sweep_frame5, [*short, "si1"])):
        name = tool.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        out, _ = quiet(lambda tool=tool, argv=argv: tool.main(argv))
        if name in ("profile_solve5", "exp_freeze"):
            vals = [r["wall_ms"] for r in out.values()]
        elif name == "exp_solver":
            vals = ([r["wall_ms"] for r in out.rows.values()]
                    + [c["ms"] for c in out.chain.values()]
                    + [a["cost"] for a in out.acc.values()])
        elif name == "profile_frame5":
            vals = [r["ms"] for r in out.values()]
        else:
            vals = [v for r in out.rows.values()
                    for v in (r["ms"], r["cost_f"], r["ratio"])]
        print(f"# {name} {' '.join(argv)}: {time.perf_counter() - t0:.1f} "
              f"s, {len(vals)} values")
        check(vals and all(np.isfinite(v) for v in vals),
              f"{name}: a value is not finite: {vals}")
        torch.cuda.empty_cache()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"# round-5 tools launches {launches}")
    check(all(launches.values()), f"the round-5 tools launched {launches}")
    return launches


def phase_native_io(torch):
    """The native I/O library (dynamicfusion_body_tpu_torch/native, built
    by g++ here): meshes/original.obj read natively and by the Python
    parser (equal), written by both writers with normals and a
    grid→world map (equal bytes), and a 65³ .dist volume read both ways
    (equal); the native calls timed."""
    from dynamicfusion_body_tpu_torch.benchmarks.suite import REF_MESH
    from dynamicfusion_body_tpu_torch.io.mesh_io import load_obj, save_obj
    from dynamicfusion_body_tpu_torch.io.sdf_io import load_sdf, save_sdf

    t0 = time.perf_counter()
    v, f = load_obj(str(REF_MESH))
    t_read = time.perf_counter() - t0
    v2, f2 = load_obj(str(REF_MESH), native=False)
    check(np.array_equal(v, v2) and np.array_equal(f, f2),
          "native OBJ reader differs from the Python parser")
    ind = np.eye(4)
    ind[:3, :3] *= 0.5
    ind[:3, 3] = (1.0, -2.0, 3.0)
    vol = np.random.default_rng(0).standard_normal((65,) * 3).astype(
        np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a.obj"), os.path.join(tmp, "b.obj")
        t0 = time.perf_counter()
        save_obj(a, v, f, normals=v, ind=ind)
        t_write = time.perf_counter() - t0
        save_obj(b, v, f, normals=v, ind=ind, native=False)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            check(fa.read() == fb.read(),
                  "native OBJ writer's bytes differ from the Python path's")
        d = os.path.join(tmp, "v.dist")
        save_sdf(d, vol, [-1, -1, -1], [1, 1, 1])
        nat, py = load_sdf(d), load_sdf(d, native=False)
        check(all(np.array_equal(x, y) for x, y in zip(nat[:3], py[:3])),
              "native .dist reader differs from the Python path")
    print(f"# native I/O: {len(v)} verts {len(f)} faces read in "
          f"{t_read * 1e3:.1f} ms (build included), written in "
          f"{t_write * 1e3:.1f} ms; bytes, OBJ and .dist equal to the "
          "Python paths")


def phase_k512(torch, dev, fus, live):
    """K1, K2 and K5 held against their twins at 512³ shapes: K1 on the
    bench512 Fusion's canonical volume and on ``live`` at full resolution
    and at the path's strides (4 and 2); K2 with the path's inputs (the
    Fusion's node field, pose, caches and mip certificate on ``live``);
    K5 fusing config 6's 8 views of 512² into an empty 512³ volume. The
    count of unequal elements is printed (expected 0) and must be 0.
    Returns the 512³ rows {name: {ms, plain_ms, bound_ms, bound_by,
    n_not_equal}}."""
    from dynamicfusion_body_tpu_torch.ops.fusion_cuda import (
        fuse_depth_multi, fuse_depth_multi_ref)
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import (
        mc_case_cross, mc_case_cross_ref)
    from dynamicfusion_body_tpu_torch.ops.projection import (
        estimate_alignment, make_ind_matrix)
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        live_brick_mip, mip_short_bricks, mip_skip_supported,
        warp_trilerp_bricks_cached, warp_trilerp_bricks_cached_ref)
    from dynamicfusion_body_tpu_torch.pipeline.frame import _build_caches

    R = 512
    rows = {}
    canonical = fus.volume.values
    for name, vol in (("canonical", canonical), ("live", live),
                      ("canonical [::4]", canonical[::4, ::4, ::4]),
                      ("live [::2]", live[::2, ::2, ::2])):
        got = mc_case_cross(vol, 0.0)
        want = mc_case_cross_ref(vol, 0.0)
        n_neq = int(torch.sum(got != want))
        del want
        ms = cuda_ms(torch, lambda: mc_case_cross(vol, 0.0))
        plain = cuda_ms(torch, lambda: mc_case_cross_ref(vol, 0.0), reps=3)
        b = bound(8 * vol.numel(), 8 * vol.numel())
        print(f"# K1 512^3 {name} {tuple(vol.shape)}: {n_neq} words not "
              f"equal to the twin's; kernel {ms:.4f} ms, twin {plain:.4f} "
              f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        check(n_neq == 0, f"K1 at 512^3 ({name}): {n_neq} words differ")
        if "mc_case_cross" not in rows:
            rows["mc_case_cross"] = dict(ms=ms, plain_ms=plain,
                                         n_not_equal=n_neq, **b)
        del got
    torch.cuda.empty_cache()

    wf, lw, tdist = fus._warp, fus._lw, fus._tdist
    (cand, _), (sel, selw, _) = _build_caches(wf, (R,) * 3, 8, 16, fus._knn,
                                              False)
    check(mip_skip_supported(live.shape), "512^3 live without the mip path")
    mip = live_brick_mip(live)
    args = (live, wf.node_dq, cand, sel, selw, lw)
    kw = dict(brick=8, tdist=tdist, live_mip=mip)
    got = warp_trilerp_bricks_cached(*args, **kw, coords=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = warp_trilerp_bricks_cached_ref(*args, **kw, coords=False)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_neq = n_not_equal(got, ref)
    del got, ref
    # the taps this run's full bricks read (the bound counts each once)
    _, r_valid, r_wx, r_wy, r_wz = warp_trilerp_bricks_cached_ref(*args,
                                                                  **kw)
    short, _ = mip_short_bricks(r_wx, r_wy, r_wz, r_valid, live.shape,
                                tdist, mip)
    n_full = int(torch.sum(~short))
    n_taps = live_taps(live.shape, [w[~short] for w in (r_wx, r_wy, r_wz)])
    del r_valid, r_wx, r_wy, r_wz, short
    torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda: warp_trilerp_bricks_cached(
        *args, **kw, coords=False))
    nb, v = sel.shape
    nbytes = (4 * n_taps
              + sum(t.numel() * t.element_size()
                    for t in (wf.node_dq, cand.to(torch.int32), sel, selw,
                              lw, *mip))
              + 4 * nb * v + nb * v)
    b = bound(nbytes, nb * v * K2_OPS_VOXEL + n_full * v * K2_OPS_TRILERP)
    print(f"# K2 512^3 (Fusion's update inputs, {nb} bricks): {n_neq} "
          f"voxels not bit-equal to the twin; kernel {ms:.4f} ms, twin "
          f"{twin_s * 1e3:.1f} ms (one synced call), bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; full bricks {n_full}, "
          f"taps {n_taps}); peak device memory with the twin {peak:.2f} "
          f"GiB")
    check(n_neq == 0, f"K2 at 512^3: {n_neq} voxels differ from the twin")
    rows["warp_trilerp_bricks_cached"] = dict(
        ms=ms, plain_ms=twin_s * 1e3, n_not_equal=n_neq, **b)
    del cand, sel, selw, mip, args
    torch.cuda.empty_cache()

    _, _, _, depths, lws = config6_views(torch, dev)
    kinv = np.linalg.inv(K6).astype(np.float32)
    avg, std = estimate_alignment(depths, torch.from_numpy(kinv).to(dev),
                                  torch.from_numpy(lws).to(dev))
    ind = make_ind_matrix(R, avg, std).cpu().numpy()
    projs = torch.from_numpy(k5_projs(lws, ind)).to(dev)
    kr = torch.from_numpy(kinv[2]).to(dev)
    td = 8.0 / R * 1.3
    v0 = torch.full((R,) * 3, td, device=dev)
    w0 = torch.zeros((R,) * 3, device=dev)
    gv, gw = fuse_depth_multi(v0, w0, depths, projs, kr, td)
    rv, rw = fuse_depth_multi_ref(v0, w0, depths, projs, kr, td)
    torch.cuda.synchronize()
    n_neq = int(torch.sum((gv != rv) | (gw != rw)))
    n_upd = int(torch.sum(gw))
    del gv, gw, rv, rw
    ms = cuda_ms(torch, lambda: fuse_depth_multi(v0, w0, depths, projs, kr,
                                                 td))
    plain = cuda_ms(torch, lambda: fuse_depth_multi_ref(v0, w0, depths,
                                                        projs, kr, td),
                    reps=3)
    nvox = R ** 3
    # bytes as phase 8; operations without the in-image split (a lower
    # count: every voxel-view's projection and test, every update)
    b = bound(16 * nvox + 4 * (depths.numel() + projs.numel() + 3),
              nvox * N_VIEWS * (K5_OPS_VIEW + K5_DIVS_VIEW)
              + n_upd * (K5_OPS_INB + K5_OPS_UPD + K5_DIVS_UPD))
    print(f"# K5 512^3 x {N_VIEWS} views of {IMG}^2: {n_neq} voxels not "
          f"bit-equal to the twin; updates {n_upd}; kernel {ms:.4f} ms, twin "
          f"{plain:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    check(n_neq == 0, f"K5 at 512^3: {n_neq} voxels differ from the twin")
    rows["fuse_depth_multi"] = dict(ms=ms, plain_ms=plain,
                                    n_not_equal=n_neq, **b)
    del v0, w0, depths
    torch.cuda.empty_cache()
    rows["warp_trilerp_bricks"] = k3_512(torch, dev)
    return rows


def k3_512(torch, dev):
    """K3 against its twin at 512³ on bench512_sharded's equivalence
    inputs (parallel/ranks.py:bench512_scene: the seeded 1024-node field
    with perturbed DQs, the live bumpy sphere, the pose): the cache-less
    update's own call, the two-level candidates at C = 16, k = 3, no
    coordinates. The unequal count is printed and must be 0; the kernel
    is timed beside its twin (one synced call) and its bound."""
    from dynamicfusion_body_tpu_torch.models.warp_field import (
        brick_candidates_2level)
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks, warp_trilerp_bricks_ref)
    from dynamicfusion_body_tpu_torch.parallel.ranks import bench512_scene

    R, k = 512, 3
    sc = bench512_scene(dev, R, 0)
    wf = sc.wf
    cand = brick_candidates_2level(wf, (R,) * 3, 8, 16)
    args = (sc.live, wf.node_pos, wf.node_w, wf.active, wf.node_dq, cand,
            sc.lw)
    got = warp_trilerp_bricks(*args, brick=8, k=k, coords=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = warp_trilerp_bricks_ref(*args, brick=8, k=k)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    n_neq = n_not_equal(got, ref)
    n_taps = live_taps(sc.live.shape, ref[3:])
    del got, ref
    torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda: warp_trilerp_bricks(*args, brick=8, k=k,
                                                    coords=False))
    b, nbytes, nops = k3_bound(sc.live, wf, cand, k, False, n_taps)
    print(f"# K3 512^3 (bench512_sharded's equivalence inputs, C 16, k 3, "
          f"{cand.shape[0]} bricks, {int(wf.num_active)} nodes): {n_neq} "
          f"voxels not bit-equal to the twin; kernel {ms:.4f} ms, twin "
          f"{twin_s * 1e3:.1f} ms (one synced call), bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {nbytes / 1e6:.1f} MB, "
          f"{nops / 1e9:.3f} G ops, taps {n_taps}), {b['bound_ms'] / ms:.1%} "
          f"of it")
    check(n_neq == 0, f"K3 at 512^3: {n_neq} voxels differ from the twin")
    del sc, cand, args
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=twin_s * 1e3, n_not_equal=n_neq, **b)


def k5_warp_instructions(torch, culled, ok_x, img, px, py, u, v, pw, depth,
                         kr):
    """The warp instructions K5 issues for one view at 256³ from K5_SASS's
    blocks, grouped as the kernel's warps run: one step of a warp is one
    x-plane and one position r of the lanes' runs, its 32 lanes 4 y-rows
    by 8 runs of 4 z-voxels; a block is issued when any lane takes it. The
    signed-distance block runs where the sample pz > tdist, the update
    where dz < tdist (fuse_depth's tests, here in PyTorch)."""
    pxc, pyc = torch.where(img, px, 0.0), torch.where(img, py, 0.0)
    x0, y0 = torch.floor(pxc).long(), torch.floor(pyc).long()
    wx, wy = pxc - x0.float(), pyc - y0.float()
    d = depth.reshape(-1)
    w = depth.shape[1]
    up = d[y0 * w + x0] * (1 - wx) + d[y0 * w + x0 + 1] * wx
    bot = d[(y0 + 1) * w + x0] * (1 - wx) + d[(y0 + 1) * w + x0 + 1] * wx
    pz = -(up * (1 - wy) + bot * wy)
    dz_open = -(kr[0] * (px * pz - u) + kr[1] * (py * pz - v)
                + kr[2] * (pz - pw))
    opened = img & (pz > TDIST6)
    upd = img & (torch.where(opened, dz_open, -TDIST6) < TDIST6)

    def steps(flag):  # warp steps in which any lane's voxel takes it
        X, Y, Z = flag.shape
        return int(torch.sum(flag.reshape(X, Y // 4, 4, Z // 32, 8, 4)
                             .any(4).any(2)))

    live = ~culled
    n_steps = steps(live)
    runs = culled.numel() // 128  # a warp's (x-plane, view) runs
    culled_runs = runs - n_steps // 4
    return (n_steps * K5_SASS["out_x"]
            + steps(ok_x & live) * (K5_SASS["out_y"] - K5_SASS["out_x"])
            + steps(img) * (K5_SASS["in_view"] - K5_SASS["out_y"]
                            - K5_SASS["signed_distance"])
            + steps(opened) * K5_SASS["signed_distance"]
            + steps(upd) * K5_SASS["update"]
            + (n_steps // 4) * K5_SASS["view"]
            + culled_runs * K5_SASS["culled"])


def k5_issue(torch, ms, n_x, n_y, n_inb, n_upd, n_cull, total):
    """K5's issue time from the SASS counts of its per-view paths
    (K5_SASS) over this run's voxel-views, beside the kernel's time; and
    the kernel's SASS size and opcode mix, so a stale count shows."""
    funcs = sass_functions(torch)
    body = [ins for name, code in funcs.items()
            if "fuse_depth_multi_kernelILb1E" in name for ins in code]
    check(body, "no SASS for fuse_depth_multi_kernel<true>")
    ops = {}
    for ins in body:
        op = ins.split()[1 if ins.startswith("@") else 0].split(".")[0]
        ops[op] = ops.get(op, 0) + 1
    top = ", ".join(f"{op} {n}" for op, n in
                    sorted(ops.items(), key=lambda kv: -kv[1])[:12])
    stale = len(body) != K5_SASS["length"]
    print(f"# K5 SASS (16-byte instantiation): {len(body)} instructions"
          f"{' (K5_SASS was counted on ' + str(K5_SASS['length']) + ': stale)' if stale else ''}; "
          f"{top}")
    n = (n_x * K5_SASS["out_x"] + n_y * K5_SASS["out_y"]
         + n_inb * K5_SASS["in_view"] + n_upd * K5_SASS["update"]
         + (total - n_cull) / 4 * K5_SASS["view"]
         + n_cull / 4 * K5_SASS["culled"])
    print(f"# K5 issue time {issue_ms(n):.4f} ms ({n / 1e9:.3f} G lane "
          f"instructions: {K5_SASS['out_x']} out at px, {K5_SASS['out_y']} "
          f"out at py, {K5_SASS['in_view']} in the image, "
          f"+{K5_SASS['update']} an update, {K5_SASS['view']} a run's view "
          f"and {K5_SASS['culled']} a culled one); kernel {ms:.4f} ms, "
          f"{issue_ms(n) / ms:.1%} of it")


def profile_ingest(torch, fus, maps, lws):
    """One more ingest under torch.profiler: its wall time, the device
    kernel time in it (busy share) and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fus.compute_live_tsdf(maps, list(lws), UseAutoAlignment=True,
                              as_numpy=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    if not kernels:
        print(f"# config 6 ingest profiled: wall {wall:.3f} ms; device "
              f"kernel time not measured (the profiler saw no kernels)")
        return
    top = "; ".join(f"{name[:48]} x{n} {ms:.4f} ms" for ms, n, name in
                    kernels[:6])
    print(f"# config 6 ingest profiled: wall {wall:.3f} ms, device kernels "
          f"{busy:.4f} ms (busy {busy / wall:.1%}); top: {top}")


def phase_config6(torch, dev, verts, faces, maps, lws):
    """benchmarks/suite.py config 6 at 256³ (suite.py:261-316) through the
    port's ``suite.run_config6``: FusionDM's ingest of the 8 views, MC,
    the observed vertices scored against the mesh; then one profiled
    ingest."""
    from scipy.spatial import cKDTree

    from dynamicfusion_body_tpu_torch.benchmarks import suite
    from dynamicfusion_body_tpu_torch.ops.fusion_cuda import fuse_depth_multi
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross

    samples = suite._sample_surface(verts, faces, 300_000)
    tree = cKDTree(samples)
    fuse_depth_multi.launches = 0
    mc_case_cross.launches = 0
    t0 = time.perf_counter()
    line, fus, scored = suite.run_config6(dev, RES, maps, list(lws), K6,
                                          tree, (1 << 17, 1 << 18))
    secs = time.perf_counter() - t0
    profile_ingest(torch, fus, maps, lws)
    launches = (fuse_depth_multi.launches, mc_case_cross.launches)
    check(all(n > 0 for n in launches), f"config 6 launches K5/K1 {launches}")
    check(bool(torch.isfinite(fus.volume.values).all()), "non-finite TSDF")
    # how much of the body the score speaks for: the mesh overflows its cap
    # (MC keeps the first vertices in edge order), so the scored vertices
    # cover part of the surface only
    voxel = float(fus._IND[0, 0])
    near, _ = cKDTree(scored).query(samples, k=1)
    covered = float(np.mean(near < voxel))
    print(f"# config 6 at {RES}^3 (suite.run_config6, {secs:.2f} s with the "
          f"scoring): {json.dumps(line)}; cap overflow "
          f"{bool(fus._mesh['overflow'])}; the scored vertices lie within 1 "
          f"voxel of {covered:.4f} of the surface samples; launches K5 "
          f"{launches[0]} K1 {launches[1]}")
    check(line["value"] < 1.0 and line["p95_err_voxels"] < 2.0,
          f"config 6 vertex error mean {line['value']} p95 "
          f"{line['p95_err_voxels']} voxels")
    return launches


def phase_icp(torch, dev, depths, lws):
    """The ICP branch at RES³ on the first ICP_VIEWS views: a finite
    volume, correspondences, the recovered pose, K7's three launches
    (bin, scatter, query) and K9's two (warp, pick) once a search, 3
    searches a later view, and one K8 launch (the rigid update) a later
    view. One
    search on the last view's meshes (view 0's canonical mesh at the
    solved pose against the last live mesh) is held to K7's plain twin
    (0 unequal slots) and to K9's (0 unequal elements of the warped
    vertices and of corr, valid and best_cost), and timed. Returns ({K7's,
    K9's warp's and K9's pick's table rows}, {their launches on the
    branch: K7's query's, K9's two})."""
    from dynamicfusion_body_tpu_torch.ops import icp_pick_cuda as K9
    from dynamicfusion_body_tpu_torch.ops import knn_grid_cuda as K7
    from dynamicfusion_body_tpu_torch.ops.dualquat import (
        dq_transform_normal, dq_transform_point)
    from dynamicfusion_body_tpu_torch.pipeline.correspondence import (
        _pick, rigid_correspondences_twin)
    from dynamicfusion_body_tpu_torch.tools import profile_icp_pick
    from dynamicfusion_body_tpu_torch.ops.fusion_cuda import fuse_depth_multi
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross
    from dynamicfusion_body_tpu_torch.ops.rigid_update_cuda import (
        rigid_update)
    from dynamicfusion_body_tpu_torch.ops.se3 import dq_to_se3
    from dynamicfusion_body_tpu_torch.pipeline.fusion import FusionDM

    maps = list(depths[:ICP_VIEWS].cpu().numpy())
    fus = FusionDM(TDIST6, K6, tsdf_res=RES, vert_cap=1 << 17,
                   face_cap=1 << 18)
    lives = []
    solve = fus.solve

    def keep_live(curr_tsdf):  # the last view's live TSDF, for K7's check
        lives[:] = [curr_tsdf]
        return solve(curr_tsdf)

    fus.solve = keep_live
    kernels = (fuse_depth_multi, mc_case_cross, K7.grid_bin,
               K7.grid_scatter, K7.knn_grid, K9.warp,
               K9.rigid_correspondences_lattice, rigid_update)
    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v, w = fus.compute_live_tsdf(maps, list(lws[:ICP_VIEWS]),
                                 UseAutoAlignment=True, useICP=True,
                                 as_numpy=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    check(bool(torch.isfinite(v).all() and torch.isfinite(w).all()),
          "ICP: non-finite TSDF")
    n_corr = int(fus._corr_valid.sum())
    check(n_corr > 0, "ICP: no correspondences")
    icp = fus.icp_settings()
    searches = icp["rounds"] * (ICP_VIEWS - 1)
    for name in ("grid_bin", "grid_scatter", "knn_grid", "warp",
                 "rigid_correspondences_lattice"):
        check(launches[name] == searches, f"ICP: K7/K9 launches "
              f"{launches}, {searches} searches")
    check(launches["rigid_update"] == ICP_VIEWS - 1,
          f"ICP: K8 launches {launches}, {ICP_VIEWS - 1} later views")
    check(len(fus.icp_poses) == ICP_VIEWS - 1,
          f"ICP: {len(fus.icp_poses)} poses for {ICP_VIEWS - 1} views")
    M = dq_to_se3(fus._lw).cpu().numpy()
    cosang = (np.trace(M[:3, :3]) - 1) / 2
    ang = float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
    trans = float(np.linalg.norm(M[:3, 3]))
    qr2 = float(torch.sum(fus._lw[:4] ** 2))  # the free DQ's scale
    print(f"# ICP branch at {RES}^3, {ICP_VIEWS} views: {secs:.2f} s; "
          f"correspondences {n_corr}; pose DQ "
          f"{np.array2string(fus._lw.cpu().numpy(), precision=6)}, "
          f"|q_r|^2 {qr2:.4f}; deviation from identity {ang:.4f} deg, "
          f"{trans:.4f} voxels; launches {launches}")

    k = icp["k"]
    live = fus.marching_cubes(lives[0], step_size=1, with_normals=False)
    q = dq_transform_point(fus._lw, fus._mesh["verts"])
    pts = live["verts"]
    n_q, n_p = fus._mesh["n_verts"], live["n_verts"]
    cell = K7.leaf_cell(RES)
    levels = K7.grid_levels(RES, cell)
    d, i = K7.knn_grid(q, pts, k, n_q, n_p, RES)
    rd, ri = K7.knn_grid_ref(q, pts, k, n_q, n_p, levels, cell)
    unequal = int(((i != ri) | (d != rd)).sum())
    check(unequal == 0, f"K7: {unequal} slots differ from the twin")
    err = float(torch.where(torch.isfinite(rd), (d - rd).abs(), 0.0).max())
    rows_q, rows_p = min(int(n_q), q.shape[0]), min(int(n_p), pts.shape[0])
    ms = cuda_ms(torch, lambda: K7.knn_grid(q, pts, k, n_q, n_p, RES))
    plain = cuda_ms(torch, lambda: K7.knn_grid_ref(q, pts, k, n_q, n_p,
                                                   levels, cell), reps=3)
    # each valid query and point read once, each query's k slots (a f32
    # distance, an int64 index) written once (h100bench/counts_icp.py)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain,
               **bound(12 * rows_q + 12 * rows_p + 12 * k * rows_q, 0),
               library_ms=None)
    info = K7.kernel_info(k)
    print(f"# K7 (knn_grid) at {RES}^3: {rows_q} queries against {rows_p} "
          f"points, k = {k}, {levels} levels of {cell}-voxel cells: 0 "
          f"unequal slots; kernel {ms:.4f} ms (with the grid build), twin "
          f"{plain:.4f} ms; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); registers {info['registers']}, local bytes "
          f"{info['local_bytes']}, CTAs per SM {info['ctas_per_sm']}")

    # K9 on the same search: the warp against dq_transform_point on the
    # counted rows, the route against the composition it replaces
    lw, cv, cn = fus._lw, fus._mesh["verts"], fus._mesh["normals"]
    tol, n32 = icp["tolerance"], K7._count(n_q, dev)
    args = (lw, cv, cn, n_q, pts, n_p, k, tol, RES)
    wv = K9.warp(lw, cv, n32)
    bad_q = profile_icp_pick.unequal([wv[:rows_q]], [q[:rows_q]])
    got = K9.rigid_correspondences_lattice(*args)
    bad = profile_icp_pick.unequal(got,
                                   rigid_correspondences_twin(*args))
    check(bad_q == 0 and bad == 0, f"K9: {bad_q} warped elements and {bad} "
          f"output elements differ from the composition")
    warp_ms = cuda_ms(torch, lambda: K9.warp(lw, cv, n32))
    warp_plain = cuda_ms(torch, lambda: (dq_transform_point(lw, cv),
                                         dq_transform_normal(lw, cn)), reps=3)
    pick_ms = cuda_ms(torch,
                      lambda: K9.pick(lw, wv, cn, n32, pts, d, i, tol))
    wn, found = dq_transform_normal(lw, cn), torch.isfinite(d)
    pick_plain = cuda_ms(torch, lambda: _pick(q, wn, pts[i], found), reps=3)
    route_ms = cuda_ms(torch, lambda: K9.rigid_correspondences_lattice(*args))
    twin_ms = cuda_ms(torch, lambda: rigid_correspondences_twin(*args),
                      reps=3)
    # the warp reads and writes 12 bytes a counted row; the pick's bytes
    # as tools/profile_icp_pick.py counts them; the plain pick timed is
    # the composition's choice (``_pick``) on K7's result
    rows = {
        "knn_grid": row,
        "warp": dict(max_abs_err=0.0, ms=warp_ms, plain_ms=warp_plain,
                     **bound(24 * rows_q, 0), library_ms=None,
                     n_not_equal=bad_q),
        "rigid_correspondences_lattice": dict(
            max_abs_err=0.0, ms=pick_ms, plain_ms=pick_plain,
            **bound(profile_icp_pick.pick_bytes(d, k), 0), library_ms=None,
            n_not_equal=bad),
    }
    info = [K9.kernel_info(which) for which in (0, 1)]
    print(f"# K9 (icp_pick) on that search: 0 unequal warped and output "
          f"elements; warp {warp_ms:.4f} ms (bound "
          f"{rows['warp']['bound_ms']:.4f}, plain warp {warp_plain:.4f}), "
          f"pick {pick_ms:.4f} ms (bound "
          f"{rows['rigid_correspondences_lattice']['bound_ms']:.4f}, plain "
          f"pick {pick_plain:.4f}); the "
          f"route with K7 {route_ms:.4f} ms, the composition {twin_ms:.4f} "
          f"ms; registers {info[0]['registers']}/{info[1]['registers']}, "
          f"local bytes {info[0]['local_bytes']}/{info[1]['local_bytes']}, "
          f"CTAs per SM {info[0]['ctas_per_sm']}/{info[1]['ctas_per_sm']}")
    check(all(x["local_bytes"] == 0 for x in info), "K9 spills")
    names = ("knn_grid", "warp", "rigid_correspondences_lattice")
    return rows, {name: launches[name] for name in names}


def phase_k8(torch, dev):
    """Phase 10b: K8 at 512³ through ``tools/profile_rigid_update.py``
    (its rows as '#' lines), every row 0 voxels unequal to the twin and
    one launch a call. Returns (K8's table row: the ICP pose's, its
    launches)."""
    from dynamicfusion_body_tpu_torch.ops import rigid_update_cuda as K8
    from dynamicfusion_body_tpu_torch.tools import profile_rigid_update

    reps = 10
    rows, _ = quiet(lambda: profile_rigid_update.run(512, dev, reps))
    for r in rows:
        check(r["unequal_values"] == 0 and r["unequal_weights"] == 0,
              f"K8: {r['pose']} pose, {r['unequal_values']} values and "
              f"{r['unequal_weights']} weights differ from the twin")
        # the check's call, the warm-up and the timed calls of each
        # instantiation
        check(r["launches"] == 2 * (reps + 1) + 1,
              f"K8: {r['launches']} launches in the {r['pose']} row")
    icp = rows[-1]
    info = {vec: K8.kernel_info(vec) for vec in (4, 1)}
    print(f"# K8 (rigid_update) at 512^3, the ICP pose: 0 unequal voxels; "
          f"kernel {icp['k8_ms']:.4f} ms (scalar {icp['scalar_ms']:.4f}), "
          f"bound {icp['bound_ms']:.4f} ms (bytes), "
          f"{icp['share_pct']:.1f}%; twin {icp['twin_ms']:.1f} ms; "
          f"registers {info[4]['registers']}/{info[1]['registers']}, local "
          f"bytes {info[4]['local_bytes']}/{info[1]['local_bytes']}, CTAs "
          f"per SM {info[4]['ctas_per_sm']}")
    check(all(i["local_bytes"] == 0 for i in info.values()), "K8 spills")
    row = dict(max_abs_err=0.0, ms=icp["k8_ms"], plain_ms=icp["twin_ms"],
               **bound(profile_rigid_update.BYTES_VOXEL * icp["voxels"], 0),
               library_ms=None)
    return row, sum(r["launches"] for r in rows)


def phase_config7(torch, dev, verts, faces):
    """benchmarks/suite.py config 7 at 256³ (suite.py:341-496) through the
    port's ``suite.run_config7``: the mesh's 8-view canonical TSDF, a
    ``Fusion`` on it, then per bend (0.08, 0.16, 0.24 rad) a live TSDF and
    setupCorrespondences → solve → updateTSDF → update_graph. Every
    frame's TSDF must be finite, and the final surface error below the
    untracked one."""
    from dynamicfusion_body_tpu_torch.benchmarks import suite
    from dynamicfusion_body_tpu_torch.ops.fusion_cuda import fuse_depth_multi
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks_cached)

    kernels = (mc_case_cross, warp_trilerp_bricks_cached, fuse_depth_multi)
    for kern in kernels:
        kern.launches = 0
    warp_trilerp_bricks_cached.coord_launches = 0
    c = suite.run_config7(dev, RES, verts, faces)
    launches = {k.__name__: k.launches for k in kernels}
    vox = c["voxel"]
    errs = [float(np.mean(e) / vox) for e in c["serr"]]
    untracked = float(np.mean(c["untracked"]) / vox)
    build = "; ".join(f"{k} {v['total_s']:.3f} s"
                      for k, v in c["build"].items())
    phases = "; ".join(f"{k} {v['mean_s']:.3f} s"
                       for k, v in c["phases"].items())
    print(f"# config 7 at {RES}^3 (suite.run_config7): construction "
          f"{c['build_s']:.2f} s ({build}); {c['n_tracked']} observed "
          f"canonical vertices; frames {c['frames_s']:.2f} s, per-frame "
          f"phase means {phases}")
    print(f"# config 7: surface error per frame {[round(e, 4) for e in errs]} "
          f"voxels, untracked {untracked:.4f} (the README's TPU-era 2.6 "
          f"voxels at 256^3, to check, not a gate); finite {c['finite']}; "
          f"launches {launches}")
    check(all(c["finite"]), f"config 7: non-finite TSDF {c['finite']}")
    check(all(n > 0 for n in launches.values()),
          f"config 7 launches {launches}")
    check(warp_trilerp_bricks_cached.coord_launches == 0,
          "config 7: updateTSDF's K2 wrote coordinates")
    check(errs[-1] < untracked, f"config 7 tracking: error {errs[-1]} not "
          f"below the untracked {untracked}")
    return launches, errs


def cnn_blob(torch, dev, res=48):
    """tests/test_dhbc.py's asymmetric blob (``_blob_mesh``) by the port's
    MC on ``dev``: numpy (verts, faces)."""
    from dynamicfusion_body_tpu_torch.ops.marching_cubes import (
        marching_cubes)

    g = np.arange(res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (res - 1) / 2
    dx, dy, dz = x - c, y - c, z - c
    r = np.sqrt(dx * dx + dy * dy + dz * dz) + 1e-6
    th = np.arccos(np.clip(dz / r, -1, 1))
    ph = np.arctan2(dy, dx)
    bump = (res / 32) * np.sin(3 * th + 0.5) * np.cos(2 * ph) + (
        res / 48) * np.sin(5 * ph + 1.3)
    sdf = torch.from_numpy((r - (0.3 * res + bump)).astype(np.float32))
    m = marching_cubes(sdf.to(dev), vert_cap=1 << 13, face_cap=1 << 14,
                       use_kernels=dev.type == "cuda")
    nv, nf = int(m["n_verts"]), int(m["n_faces"])
    return (m["verts"][:nv].cpu().numpy(),
            m["faces"][:nf].cpu().numpy().astype(np.int32))


def pixel_acc(torch, model, params, head, d8, lab):
    """The classifier head's pixel accuracy on one view's foreground."""
    with torch.no_grad():
        feats = torch.func.functional_call(model, params, (d8[None, None],))
    pred = torch.argmax(feats[0].permute(1, 2, 0) @ head, dim=-1) + 1
    fg = lab > 0
    return float((pred[fg] == lab[fg]).float().mean())


def heldout_view(dev, verts, faces, labels):
    """(depth8, labels) of the yaw between the first two of CNN_VIEWS
    training views, at CNN_TRAIN_SIZE (tests/test_dhbc.py's held-out
    view)."""
    from dynamicfusion_body_tpu_torch.pipeline.cnn_correspondence import (
        view_mvps)
    from dynamicfusion_body_tpu_torch.tools import train_dhbc

    (d8, lab), = train_dhbc.make_dataset(
        verts, faces, labels, view_mvps(2 * CNN_VIEWS)[1:2], CNN_TRAIN_SIZE,
        dev=dev)
    return d8, lab


def cnn_train_gate(torch, dev, lr=1e-3):
    """The loop of tests/test_dhbc.py:204-276 on ``dev``: the 48³ blob, 16
    furthest-point regions, 6 yaw views at 64² (train_dhbc's labels and
    renders, the test's own), 600 batch-1 steps of make_train_step at
    ``lr`` (the test's 1e-3) from init_dhbc(0), cuDNN deterministic, the
    head from a seeded normal; then the held-out view. Returns the losses,
    the held-out pixel accuracy of the trained and the random-init
    network, and the step's ms (CUDA events over the steps, no host read
    inside)."""
    from dynamicfusion_body_tpu_torch.models.dhbc import (init_dhbc,
                                                          make_train_step)
    from dynamicfusion_body_tpu_torch.pipeline.cnn_correspondence import (
        view_mvps)
    from dynamicfusion_body_tpu_torch.tools import train_dhbc

    verts, faces = cnn_blob(torch, dev)
    labels = train_dhbc.region_labels(verts, CNN_CLASSES, dev=dev)
    data = train_dhbc.make_dataset(verts, faces, labels,
                                   view_mvps(CNN_VIEWS), CNN_TRAIN_SIZE,
                                   dev=dev)
    model, params = init_dhbc(0, device=dev)
    params0 = {k: v.detach().clone() for k, v in params.items()}
    step, init_opt = make_train_step(model, learning_rate=lr,
                                     n_classes=CNN_CLASSES)
    gen = torch.Generator().manual_seed(1)
    head = (torch.randn(16, CNN_CLASSES, generator=gen) * 0.1).to(dev)
    opt = init_opt(params, head)
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # the JAX test's gate rests on deterministic training (its CPU
    # platform); cuDNN's default backward algorithms are not, and 600
    # batch-1 steps of this normalization-free net amplify their rounding
    # into other trajectories run to run
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        start.record()
        for i in range(CNN_TRAIN_STEPS):
            d8, lab = data[i % len(data)]
            params, head, opt, loss = step(params, head, opt,
                                           d8[None, None], lab[None])
            losses.append(loss)
        end.record()
        end.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    losses = torch.stack(losses).cpu().numpy()
    view = heldout_view(dev, verts, faces, labels)
    n = len(data)
    return dict(losses=losses, first=float(losses[0]), last=float(losses[-1]),
                first_cycle=float(losses[:n].mean()),
                last_cycle=float(losses[-n:].mean()),
                acc_trained=pixel_acc(torch, model, params, head, *view),
                acc_random=pixel_acc(torch, model, params0, head, *view),
                step_ms=start.elapsed_time(end) / CNN_TRAIN_STEPS,
                wall_s=wall_s)


def train_line(g):
    """One training loop's figures, for a '#' line."""
    return (f"loss {g['first']:.4f} -> {g['last']:.4f} (ratio "
            f"{g['last'] / g['first']:.3f}; the first and last "
            f"{CNN_VIEWS}-view cycles' means {g['first_cycle']:.4f} -> "
            f"{g['last_cycle']:.4f}); held-out pixel accuracy trained "
            f"{g['acc_trained']:.4f}, random init {g['acc_random']:.4f}; "
            f"step {g['step_ms']:.3f} ms (CUDA events), {g['wall_s']:.2f} s")


def cnn_heldout(torch, dev, weights):
    """The gate of tests/test_dhbc.py on weights ``train_dhbc`` made: the
    pixel accuracy of the held-out yaw between its training views (its
    body mesh and 16 regions, at 64²), with its saved classifier head, for
    those weights and for the random init ``init_dhbc(0)``. Returns
    (trained, random)."""
    from dynamicfusion_body_tpu_torch.models.dhbc import (init_dhbc,
                                                          load_npz_params)
    from dynamicfusion_body_tpu_torch.tools import train_dhbc

    with contextlib.redirect_stdout(io.StringIO()):
        verts, faces = train_dhbc.body_mesh(dev=dev)
    labels = train_dhbc.region_labels(verts, CNN_CLASSES, dev=dev)
    view = heldout_view(dev, verts, faces, labels)
    head = torch.from_numpy(
        np.load(weights.replace(".npz", "_head.npy"))).to(dev)
    model, params0 = init_dhbc(0, device=dev)
    params = load_npz_params(params0, weights)
    return (pixel_acc(torch, model, params, head, *view),
            pixel_acc(torch, model, params0, head, *view))


def cnn_forward(torch, dev):
    """DHBC at 8 x 512² on the card against the same module on the CPU
    (init_dhbc(0), a seeded depth8-like batch: background 255 and a noisy
    body patch). Returns (relative max difference, card ms by CUDA events
    over 5 calls, CPU ms of one call)."""
    from dynamicfusion_body_tpu_torch.models.dhbc import init_dhbc

    rng = np.random.RandomState(15)
    d = np.full((8, 1, 512, 512), 255.0, np.float32)
    d[:, :, 96:448, 160:352] = np.floor(rng.rand(8, 1, 352, 192) * 255.0)
    x = torch.from_numpy(d)
    model, _ = init_dhbc(0, device="cpu")
    with torch.no_grad():
        t0 = time.perf_counter()
        want = model(x)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        model = model.to(dev)
        xd = x.to(dev)
        got = model(xd).cpu()
        ms = cuda_ms(torch, lambda: model(xd), reps=5)
        # cuDNN's own algorithm search, measured only (the port keeps the
        # default heuristics)
        torch.backends.cudnn.benchmark = True
        try:
            tuned = cuda_ms(torch, lambda: model(xd), reps=5)
        finally:
            torch.backends.cudnn.benchmark = False
    rel = float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))
    return rel, ms, tuned, cpu_ms


def cnn_frame(torch, dev, weights):
    """One ``Fusion(use_cnn=True, cnn_weights=weights)`` frame on config 7's
    256³ scene (``suite.run_config7``'s construction, from the suite's
    helpers): the reference mesh's 8-view canonical TSDF, the Fusion on it,
    the first bend's live TSDF, then setupCorrespondences(method="cnn") →
    solve(method="cnn") → updateTSDF. Returns the surface error (voxels),
    the valid correspondences, finiteness and the times."""
    from scipy.spatial import cKDTree

    from dynamicfusion_body_tpu_torch.benchmarks import suite
    from dynamicfusion_body_tpu_torch.models.tsdf_volume import TsdfVolume
    from dynamicfusion_body_tpu_torch.ops.interp import trilinear
    from dynamicfusion_body_tpu_torch.pipeline.fusion import Fusion, FusionDM
    from dynamicfusion_body_tpu_torch.tools._scene import make_bend

    t0 = time.perf_counter()
    verts, faces = suite.reference_mesh()
    vcap, fcap, lvcap, lfcap, node_cap = suite.config7_caps(RES)
    mc_step, live_mc_step = 3, 2   # run_config7's above 64³
    bend = make_bend(verts)
    K = suite.camera(suite.IMG)
    tdist = 8.0 / RES * 1.3
    depths0, lws = suite._render_views(verts, faces, K, suite.N_VIEWS,
                                       suite.IMG, suite.IMG, dev)
    dm = FusionDM(tdist, K, tsdf_res=RES, vert_cap=vcap, face_cap=fcap,
                  device=dev)
    canon_v, canon_w = dm.compute_live_tsdf(depths0, lws,
                                            UseAutoAlignment=True,
                                            as_numpy=False)
    ind = dm._IND
    voxel = float(ind[0, 0])
    fus = Fusion(canon_v, tdist, subsample_rate=2.0 * (RES / 64) / (mc_step / 2),
                 knn=3, marching_cubes_step_size=mc_step,
                 write_warpfield=False, vert_cap=vcap, face_cap=fcap,
                 node_cap=node_cap, live_vert_cap=lvcap,
                 live_face_cap=lfcap, use_cnn=True, cnn_weights=weights,
                 device=dev)
    nv = int(fus._mesh["n_verts"])
    gv = fus._mesh["verts"][:nv]
    obs = (trilinear(canon_w, gv)[0] >= 3.0).cpu().numpy()
    gv = gv.cpu().numpy()
    if not obs.any():
        obs[:] = True
    ang = suite.BEND_ANGLES[0]
    depths, _ = suite._render_views(bend(verts, ang), faces, K, suite.N_VIEWS,
                                    suite.IMG, suite.IMG, dev)
    fresh = TsdfVolume.create(RES, tdist, ind=dm.volume.ind)
    live_v, _ = dm._fuse(fresh.values, fresh.weights, dm._stack(depths), lws)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    walls = {}
    t = time.perf_counter()
    fus.setupCorrespondences(live_v, method="cnn", tolerance=5.0,
                             live_mc_step=live_mc_step)
    n_valid = int(torch.sum(fus._corr_valid))
    walls["setupCorrespondences"] = time.perf_counter() - t
    t = time.perf_counter()
    fus.solve(regularization_weight=0.5, method="cnn", gn_iters=8,
              cg_iters=32)
    torch.cuda.synchronize()
    walls["solve"] = time.perf_counter() - t
    t = time.perf_counter()
    fus.updateTSDF()
    torch.cuda.synchronize()
    walls["updateTSDF"] = time.perf_counter() - t
    finite = bool(torch.isfinite(fus.volume.values).all()
                  & torch.isfinite(fus.volume.weights).all())
    wv = gv @ ind[:3, :3].T + ind[:3, 3]
    tracked = fus.warp(gv, m_lw=fus._lw) @ ind[:3, :3].T + ind[:3, 3]
    surf = np.concatenate([verts, verts[faces].mean(1),
                           0.5 * (verts[faces[:, 0]] + verts[faces[:, 1]])])
    tree = cKDTree(bend(surf, ang))
    err = float(np.mean(tree.query(tracked[obs], k=1)[0]) / voxel)
    untracked = float(np.mean(tree.query(wv[obs], k=1)[0]) / voxel)
    return dict(err=err, untracked=untracked, n_valid=n_valid,
                n_verts=nv, finite=finite, build_s=build_s, walls=walls,
                angle=ang)


def phase_cnn(torch, dev, clpts_err, stamp):
    """Phase 15, the CNN path: TF32 off; the DHBC forward on the card
    within CNN_FWD_RTOL of the CPU's (and timed under cudnn.benchmark);
    bench_cnn at its defaults (S = 4 coverage of the canonical at least
    CNN_COVER_S4); the training loop of tests/test_dhbc.py on the card,
    deterministic: at the test's rate printed, at CNN_GATE_LR run twice
    (bit-equal) and held to the test's gate; train_dhbc at CNN_GATE_LR
    (the npz into the git-ignored data/) and the gate on its weights; one
    Fusion(use_cnn=True) frame on config 7's scene with those weights,
    finite with valid correspondences, its surface error printed beside
    config 7's closest-point value. Returns the launches of K1, K2 and K5
    in the phase and the path of train_dhbc's weights."""
    from dynamicfusion_body_tpu_torch.benchmarks import bench_cnn
    from dynamicfusion_body_tpu_torch.ops.fusion_cuda import fuse_depth_multi
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        warp_trilerp_bricks_cached)
    from dynamicfusion_body_tpu_torch.tools import train_dhbc

    kernels = (mc_case_cross, warp_trilerp_bricks_cached, fuse_depth_multi)
    for kern in kernels:
        kern.launches = 0
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    print(f"# CNN path: allow_tf32 matmul {flags[0]}, cudnn {flags[1]}")
    check(flags == (False, False), f"TF32 is on: {flags}")
    rel, ms, tuned, cpu_ms = cnn_forward(torch, dev)
    print(f"# DHBC forward 8 x 512^2: card {ms:.3f} ms (CUDA events, mean "
          f"of 5; {tuned:.3f} ms under cudnn.benchmark), CPU {cpu_ms:.1f} "
          f"ms; max |card - CPU| / max |CPU| {rel:.3e} (bound "
          f"{CNN_FWD_RTOL})")
    check(rel < CNN_FWD_RTOL, f"DHBC forward: card vs CPU {rel}")
    torch.cuda.empty_cache()

    (line, report), _ = quiet(lambda: bench_cnn.main([]))
    print(f"# bench_cnn: {json.dumps(line)}")
    rows = "; ".join(f"{k} {r['wall_ms']:.3f} / {r['event_ms']:.3f}"
                     for k, r in report["rows"].items())
    print(f"# bench_cnn: canonical {report['n_canon']} / live "
          f"{report['n_live']} verts; coverage S=8/4/2 "
          f"{line['coverage_s8']:.4f} / {line['coverage_s4']:.4f} / "
          f"{line['coverage_s2']:.4f}; {report['n_matched']} matched; ms "
          f"(median synced wall / CUDA-event mean): {rows}")
    check(line["coverage_s4"] >= CNN_COVER_S4,
          f"bench_cnn: S=4 coverage {line['coverage_s4']}")
    check(all(np.isfinite(v) for k, v in line.items()
              if k not in ("metric", "unit")), f"bench_cnn: {line}")
    torch.cuda.empty_cache()
    stamp("CNN forward, bench_cnn")

    ref = cnn_train_gate(torch, dev)
    print(f"# the JAX test's DHBC loop at its rate 1e-3 ({CNN_TRAIN_STEPS} "
          f"batch-1 steps at {CNN_TRAIN_SIZE}^2, printed): "
          + train_line(ref))
    g = cnn_train_gate(torch, dev, CNN_GATE_LR)
    again = cnn_train_gate(torch, dev, CNN_GATE_LR)["losses"]
    diverge = np.flatnonzero(again != g["losses"])
    print(f"# the loop at {CNN_GATE_LR}, run twice: losses bit-equal on "
          f"{CNN_TRAIN_STEPS - diverge.size} of {CNN_TRAIN_STEPS} steps; "
          + train_line(g))
    check(diverge.size == 0, "the DHBC training loop is not deterministic")
    check(g["last"] < 0.6 * g["first"], f"training loss {g['first']} -> "
          f"{g['last']}")
    check(g["acc_trained"] > 0.2,
          f"held-out accuracy {g['acc_trained']}")
    check(g["acc_trained"] > g["acc_random"] + 0.1,
          f"trained {g['acc_trained']} vs random init {g['acc_random']}")
    t0 = time.perf_counter()
    rep, _ = quiet(lambda: train_dhbc.main(["--lr", str(CNN_GATE_LR)]))
    acc, acc_rand = cnn_heldout(torch, dev, rep["out"])
    print(f"# train_dhbc --lr {CNN_GATE_LR}: {rep['n_views']} views, best "
          f"loss {rep['best_loss']:.4f}, acc0 {rep['best_acc0']:.4f}, step "
          f"{rep['step_ms']:.3f} ms (wall, loss read each step), "
          f"{time.perf_counter() - t0:.1f} s; weights "
          f"{Path(rep['out']).relative_to(ROOT)}; held-out yaw pixel "
          f"accuracy trained {acc:.4f}, random init {acc_rand:.4f}")
    check(acc > 0.2 and acc > acc_rand + 0.1,
          f"train_dhbc's weights: held-out {acc}, random init {acc_rand}")
    torch.cuda.empty_cache()
    stamp("DHBC training")

    f = cnn_frame(torch, dev, rep["out"])
    launches = {k.__name__: k.launches for k in kernels}
    print(f"# CNN frame on config 7's {RES}^3 scene (bend {f['angle']} rad): "
          f"surface error {f['err']:.4f} voxels (config 7's closest-point "
          f"frame: {clpts_err:.4f}; untracked {f['untracked']:.4f}); valid "
          f"correspondences {f['n_valid']} of {f['n_verts']}; finite "
          f"{f['finite']}; construction {f['build_s']:.2f} s; frame "
          + "; ".join(f"{k} {v:.3f} s" for k, v in f["walls"].items())
          + f"; launches {launches}")
    check(f["finite"], "CNN frame: non-finite TSDF")
    check(f["n_valid"] > 0, "CNN frame: no valid correspondence")
    check(np.isfinite(f["err"]), f"CNN frame: surface error {f['err']}")
    check(all(n > 0 for n in launches.values()),
          f"CNN phase launches {launches}")
    torch.cuda.empty_cache()
    return launches, rep["out"]


def phase_ablation(torch, weights):
    """Phase 22: tools/make_ablation.py at its defaults (128³, 3 frames,
    four arms) with the CNN arm on ``weights`` and ``--compare meshes``.
    Returns the launches of K1 and K2 over the arms."""
    from dynamicfusion_body_tpu_torch.tools import make_ablation

    t0 = time.perf_counter()
    rep, _ = quiet(lambda: make_ablation.main(
        ["--cnn-weights", str(weights), "--compare", str(ROOT / "meshes")]))
    arms = rep["arms"]
    print(f"# make_ablation: {len(arms)} arms in "
          f"{time.perf_counter() - t0:.1f} s into "
          f"{Path(rep['out_dir']).relative_to(ROOT)}")
    check(list(arms) == [a[0] for a in make_ablation.ARMS],
          f"make_ablation ran {list(arms)}")
    for name, a in arms.items():
        c = a["vs_ref"]
        print(f"# ablation {name}: {a['wall_s']:.2f} s, {a['n_verts']} "
              f"verts / {a['n_faces']} faces (committed {c['n_verts'][1]} "
              f"/ {c['n_faces'][1]}), launches K1 {a['k1']} K2 {a['k2']}; "
              f"symmetric distance to meshes/{name}.obj mean "
              f"{c['mean']:.6f} p95 {c['p95']:.6f} voxels"
              + ("" if c["max_pos"] is None else
                 f", max |Δ position| {c['max_pos']:.3e}"))
        check(a["k1"] > 0, f"ablation {name}: no K1 launch")
        check(name == "original" or a["k2"] > 0,
              f"ablation {name}: no K2 launch")
    orig = arms["original"]
    check((orig["n_verts"], orig["n_faces"]) == ABLATION_ORIGINAL,
          f"ablation original: {orig['n_verts']} / {orig['n_faces']}, "
          f"committed {ABLATION_ORIGINAL}")
    torch.cuda.empty_cache()
    return {"mc_case_cross": sum(a["k1"] for a in arms.values()),
            "warp_trilerp_bricks_cached": sum(a["k2"]
                                              for a in arms.values())}


def phase_microbench(torch):
    """Phase 23: profile_mc2, profile_prims, profile_prims2,
    profile_solver and exp_asm at their default shapes with --reps 3, in
    this process; every row finite, exp_asm's layouts within EXP_ASM_RTOL
    of index_add_. Returns K1's launches (profile_mc2 and the case-build
    row)."""
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross
    from dynamicfusion_body_tpu_torch.tools import (
        exp_asm, profile_mc2, profile_prims, profile_prims2, profile_solver)

    mc_case_cross.launches = 0
    for tool in (profile_mc2, profile_prims, profile_prims2, profile_solver,
                 exp_asm):
        name = tool.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        rows, _ = quiet(lambda tool=tool: tool.main(["--reps", "3"]))
        vals = [r[k] for r in rows.values()
                for k in ("wall_ms", "event_ms", "bound_ms")]
        print(f"# {name} --reps 3: {time.perf_counter() - t0:.1f} s, "
              f"{len(rows)} rows; launch-bound: "
              + (", ".join(k for k, r in rows.items()
                           if r.get("launch_bound")) or "none"))
        check(rows and all(np.isfinite(v) for v in vals),
              f"{name}: a value is not finite: {vals}")
        if tool is exp_asm:
            bad = {k: (r["max_diff"], r["scale"]) for k, r in rows.items()
                   if not r["max_diff"] <= EXP_ASM_RTOL * r["scale"]}
            check(not bad, f"exp_asm: layouts off the assembly: {bad}")
        torch.cuda.empty_cache()
    launches = {"mc_case_cross": mc_case_cross.launches}
    print(f"# microbenchmark launches {launches}")
    check(launches["mc_case_cross"] > 0, "the microbenchmarks launched no K1")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dynamicfusion_body_tpu_torch.ops import cuda_lib
    from dynamicfusion_body_tpu_torch.ops.fusion_cuda import fuse_depth_multi
    from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross
    from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
        ablation_kernel_info, trilerp_ablation, trilerp_bricks,
        warp_trilerp_bricks, warp_trilerp_bricks_cached)
    from dynamicfusion_body_tpu_torch.pipeline.frame import fusion_frame

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    t_run = time.perf_counter()

    _, build_s, log = cuda_lib.build()
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print(f"# nvcc: {line.strip()}")
    cuda_lib.KERNELS.handle
    print(f"# kernels built in {build_s:.1f} s")

    def stamp(name):
        print(f"# -- {name} done at {time.perf_counter() - t_run:.1f} s")

    rows = {}
    # launches of each kernel on the paths it serves (bench, the
    # correspondence modes, config 4, config 6, config 7, the profiling
    # tools, the benchmark entry points, the 512³ bench), each path's
    # counts set to 0 just before it; K4 (trilerp_bricks) and K6
    # (trilerp_ablation) serve the tools only, K7 (knn_grid) the ICP
    # branch (its launches there: the query's); the sharded frame runs no
    # kernel (as the JAX package's sharded path runs no Pallas kernel)
    meta = {
        "mc_case_cross": ("mc_case_cross.cu", f"{PKG}/ops/mc_pallas.py:98"),
        "warp_trilerp_bricks_cached": (
            "warp_trilerp_cached.cu", f"{PKG}/ops/trilerp_pallas.py:656"),
        "warp_trilerp_bricks": ("warp_trilerp_bricks.cu",
                                f"{PKG}/ops/trilerp_pallas.py:742"),
        "trilerp_bricks": ("trilerp_bricks.cu",
                           f"{PKG}/ops/trilerp_pallas.py:227"),
        "fuse_depth_multi": ("fuse_depth_multi.cu",
                             f"{PKG}/ops/fusion_pallas.py:223"),
        "trilerp_ablation": ("trilerp_ablation.cu",
                             "tools/profile_trilerp.py:142"),
        # K7 replaces no TPU kernel: the JAX package's ICP runs the flat
        # search, ops/knn.py:knn
        "knn_grid": ("knn_grid.cu", None),
        # K8 replaces no TPU kernel: the JAX package's rigid update is the
        # plain jnp models/tsdf_volume.py:update_tsdf_rigid
        "rigid_update": ("rigid_update.cu", None),
        # K9 replaces no TPU kernel: the JAX package's rigid ICP warps and
        # picks in plain jnp (ops/dualquat.py, pipeline/correspondence.py)
        "warp": ("icp_pick.cu", None),
        "rigid_correspondences_lattice": ("icp_pick.cu", None),
    }
    total = dict.fromkeys(meta, 0)
    info = print_kernel_info(torch)
    grids = {f"K3 C<={C}": info["warp_trilerp_bricks", C]["grid"]
             for C in K3_CANDIDATES}
    grids["K2"] = info["warp_trilerp_bricks_cached", None]["grid"]
    sc, lives = bench_state(torch, dev)
    canonical, wf = sc.canonical, sc.wf
    rows["mc_case_cross"] = phase_k1(torch, dev, canonical)
    rows["warp_trilerp_bricks_cached"] = phase_k2(torch, dev, lives, wf,
                                                  grids["K2"])
    stamp("K1, K2")
    rows["warp_trilerp_bricks"], coords = phase_k3(
        torch, dev, lives[1], wf,
        {C: info["warp_trilerp_bricks", C]["grid"] for C in K3_CANDIDATES})
    rows["trilerp_bricks"] = phase_k4(torch, lives[1], coords)
    rows["trilerp_ablation"] = phase_k6(
        torch, dev, lives[1], coords,
        {key: i["grid"] for key, i in ablation_kernel_info().items()})
    del coords
    torch.cuda.empty_cache()
    stamp("K6")
    phase_padded(torch, dev)
    phase_ragged(torch, dev, grids)
    stamp("K3, K4, padded lattice, ragged tail")
    total["warp_trilerp_bricks"] = phase_config4(torch, dev, sc)
    stamp("config 4")

    tdist = float(canonical.max())
    hyper = dict(
        regularization_weight=0.5, knn_k=3, tdist=tdist, mc_step=2,
        solve_iters=1, gn_iters=12, cg_iters=16, tolerance=5.0,
        reuse_corr=False, n_candidates=16, approx_knn=False,
        use_kernels=True, vert_cap=1 << 15, face_cap=1 << 16,
        live_vert_cap=1 << 17, live_face_cap=1 << 18,
    )
    lw = torch.tensor(LW_REF, dtype=torch.float32, device=dev)
    state = (canonical, torch.zeros_like(canonical), wf, lw, None)

    mc_case_cross.launches = 0
    warp_trilerp_bricks_cached.launches = 0
    warp_trilerp_bricks_cached.coord_launches = 0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _, _ = run_frame(torch, fusion_frame, state, lives[0], hyper)
    warm, times, frame_stats = state, [], []
    for live in lives[1:4]:
        prev = state
        state, ms, stats = run_frame(torch, fusion_frame, state, live, hyper)
        times.append(ms)
        frame_stats.append(stats)
    launches = (mc_case_cross.launches, warp_trilerp_bricks_cached.launches)
    check(all(n > 0 for n in launches), f"kernel launches {launches}")
    check(warp_trilerp_bricks_cached.coord_launches == 0,
          "the frame's K2 wrote coordinates")
    total["mc_case_cross"] += launches[0]
    total["warp_trilerp_bricks_cached"] += launches[1]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"# timed frames (ms): {times}; median {np.median(times):.1f}; "
          f"peak device memory {peak_gb:.2f} GiB; launches K1 "
          f"{launches[0]} K2 {launches[1]}, of which with coordinates "
          f"{warp_trilerp_bricks_cached.coord_launches}")

    plain_state, plain_ms, _ = run_frame(
        torch, fusion_frame, prev, lives[3], dict(hyper, use_kernels=False))
    adiff = torch.abs(state[0] - plain_state[0]).cpu().numpy()
    dev99 = float(np.percentile(adiff, 99.9))
    print(f"# plain arm {plain_ms:.1f} ms; |tsdf_kernels - tsdf_plain| "
          f"p99.9 {dev99:.6f} max {float(adiff.max()):.6f}")
    check(dev99 < GATE_DEV_P999, f"kernel arm deviates: p99.9 {dev99}")
    del state, prev, plain_state
    stamp("bench frames")

    for name, n in phase_modes(torch, warm, lives[1], hyper,
                               (times[0], frame_stats[0])).items():
        total[name] += n
    del sc, canonical, lives, wf, warm
    torch.cuda.empty_cache()
    stamp("correspondence modes")

    verts, faces, maps, depths, lws = config6_views(torch, dev)
    rows["fuse_depth_multi"] = phase_k5(torch, dev, depths, lws)
    k5_n, k1_n = phase_config6(torch, dev, verts, faces, maps, lws)
    total["fuse_depth_multi"] += k5_n
    total["mc_case_cross"] += k1_n
    icp_rows, launches = phase_icp(torch, dev, depths, lws)
    rows.update(icp_rows)
    for name, n in launches.items():
        total[name] += n
    # K8's launches: the ICP branch's, one a later view, and phase 10b's
    rows["rigid_update"], n = phase_k8(torch, dev)
    total["rigid_update"] = ICP_VIEWS - 1 + n
    stamp("K5, config 6, ICP branch, K8")
    launches, c7_errs = phase_config7(torch, dev, verts, faces)
    for name, n in launches.items():
        total[name] += n
    stamp("config 7")
    del verts, faces, maps, depths
    torch.cuda.empty_cache()

    launches, weights = phase_cnn(torch, dev, c7_errs[0], stamp)
    for name, n in launches.items():
        total[name] += n
    stamp("CNN path")
    for name, n in phase_ablation(torch, weights).items():
        total[name] += n
    stamp("ablation grid")

    phase_bare_window(torch)
    kernels = {k.__name__: k for k in (
        mc_case_cross, warp_trilerp_bricks_cached, warp_trilerp_bricks,
        trilerp_bricks, fuse_depth_multi, trilerp_ablation)}
    for kern in kernels.values():
        kern.launches = 0
    phase_tools(torch)
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"# tools launches {launches}")
    check(launches["trilerp_ablation"] > 0, "the tools launched no K6")
    check(launches["trilerp_bricks"] > 0, "the tools launched no K4")
    for name, n in launches.items():
        total[name] += n
    stamp("profiling tools")

    for kern in kernels.values():
        kern.launches = 0
    phase_entry_points(torch, dev, stamp)
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"# entry points launches {launches}")
    for name in ("mc_case_cross", "warp_trilerp_bricks_cached",
                 "fuse_depth_multi"):
        check(launches[name] > 0, f"the entry points launched no {name}")
    for name, n in launches.items():
        total[name] += n
    stamp("benchmark entry points")

    rep, launches = phase_bench512(torch, dev)
    for name, n in launches.items():
        total[name] += n
    stamp("bench512 and the fused 512^3 frame")
    phase_k512(torch, dev, rep.fus, rep.vols[2])
    del rep
    torch.cuda.empty_cache()
    stamp("K1, K2, K5, K3 at 512^3")
    phase_sharded(torch, dev)
    stamp("sharded frame")
    phase_sharded512(torch)
    stamp("bench512_sharded, both modes")
    for name, n in phase_tools5(torch).items():
        total[name] += n
    stamp("round-5 tools")
    phase_native_io(torch)
    stamp("native I/O")
    for name, n in phase_microbench(torch).items():
        total[name] += n
    stamp("microbenchmarks")

    symbols = {fn.__name__: k for fn, k in cuda_lib.wrappers().items()}
    table = {"kernels": [
        dict(name=name, route="cuda", source=f"{PKG}_torch/csrc/{src}",
             kernel=symbols[name], replaces=tpu, launches=total[name],
             **rows[name])
        for name, (src, tpu) in meta.items()]}
    print(json.dumps(table))
    print(smi)
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
