"""The frame bench with its three accuracy gates — the port of the
repository's ``bench.py`` (BASELINE config 5).

The scene is ``bench.py:54-99``: a bumpy canonical sphere, six live
frames at bump phases 0.05·i, ``init_canonical(subsample_rate=1.5,
node_cap=4096, mc_step=2)``, canonical caps 2^15/2^16, live caps
2^17/2^18. ``--res`` scales the spheres and the caps with the lattice
(``tools/_scene.py:bumpy``/``cap``), so that the tests run 32³; at 256³
they are ``bench.py``'s own. The settings are ``bench.py:130-146`` as
the JAX bench runs them off the TPU (``approx_knn=False``: it sets the
bf16-keyed search on the TPU only, ``bench.py:142``), the kernels on the
card and their plain twins on the CPU. A failing kernel raises: there is no fallback to other settings.

Timing keeps ``bench.py``'s chain, ``(T(6 frames) − T(1 frame)) / 5``,
so that the metric means what the JAX bench's does. Each frame ends with
``torch.cuda.synchronize()`` (the JAX bench's host fetch): the port's
frames read their loop predicates on the host, so a frame is synced
before it ends anyway. The frames' synced wall times, the six chained
frames' walls over six (the window over its frames, free of the
one-frame chain's noise), the peak device memory and the card's name and
power limit are printed on ``#`` lines.

Accuracy (``bench.py:250-345``). Three arms start from the state after
the chain and run on ``lives[0]``, the rewind frame (the frame the chain
started from, far behind the state's last frame):

* ``fast``: the bench's settings;
* ``exact_same``: cg 32 and ``exact_candidates=True``. Exact kNN and
  fresh correspondences are the fast arm's own on the card, so cg 16
  against 32 and 2-level against flat candidates are the only
  differences asked for. The carried canonical mesh holds the fast
  arm's brick candidates, and the frame reuses them until the node set
  changes (as in ``bench.py``, which carries the same mesh); the bench's
  4096-node pool is full from ``init_canonical`` on, so both arms fuse
  with the same candidates and differ in cg depth alone;
* ``exact_deep``: pinned at 3 relaxation rounds of gn 8 and cg 32.

The gates (:func:`gates`): (1) p99.9 |tsdf_fast − tsdf_exact_same| < 0.5;
(2) the fast arm's final warp scored on a common objective
(:func:`track_energy`: fresh exact correspondences at that warp, the
huberized point-to-plane data cost) against the deep arm's: ratio
< 1.10, or slack ≤ 1% of the pre-solve cost with ratio < 2; (3)
pool_risk ≤ 1e-4·R³ and corr_risk ≤ 1% of the canonical vertices. The
bench searches fresh correspondences every round (``reuse_corr=False``,
``bench.py:133``), so corr_risk and corr_refresh are 0 by construction.

The last line of standard output is ``bench.py``'s JSON line; the rest
goes to standard error.

    python -m dynamicfusion_body_tpu_torch.benchmarks.bench
    python -m dynamicfusion_body_tpu_torch.benchmarks.bench \\
        --res 32 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..models.warp_field import neighbor_lookup, warp_points
from ..ops.marching_cubes import marching_cubes
from ..ops.mc_cuda import mc_case_cross
from ..ops.trilerp_cuda import warp_trilerp_bricks_cached
from ..pipeline.correspondence import closest_point_correspondences
from ..pipeline.frame import _blend_weights, fusion_frame, init_canonical
from ..pipeline.fusion import resolve_device
from ..solvers.nonrigid import _energies, _residuals
from ..tools._scene import bench_scene, bumpy, cap
from ..tools._timing import device_label

# the reference's best combined frame, at 65³ on a lab CPU (BASELINE.md)
REFERENCE_BEST_COMBINED_MS = 380_100.0
N_LIVES = 6
GATE_DEV_P999 = 0.5       # gate 1, voxels
GATE_RATIO = 1.10         # gate 2
GATE_SLACK = 0.01         # gate 2, share of the pre-solve cost
GATE_RATIO_CAP = 2.0      # gate 2, with the slack
GATE_POOL_RISK = 1e-4     # gate 3, share of the voxels
GATE_CORR_RISK = 0.01     # gate 3, share of the canonical vertices
RESULT_KEYS = (
    "metric", "value", "unit", "vs_baseline", "accuracy_tsdf_dev_p999",
    "accuracy_tsdf_dev_max", "accuracy_cost_ratio",
    "accuracy_cost_slack_vs_presolve", "pool_risk", "corr_risk",
    "corr_refresh", "accuracy_ok")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def scene(res: int, dev: torch.device):
    """``bench.py:75-99`` at ``res``: ``tools/_scene.py:bench_scene`` (the
    canonical volume, tdist, the canonical caps, the ``init_canonical``
    field and the global pose) with the six live frames and the live
    caps."""
    sc = bench_scene(res, dev)
    sc.lives = [torch.from_numpy(bumpy(res, (130, 129, 128), 0.05 * i)).to(
        dev) for i in range(1, N_LIVES + 1)]
    sc.caps = dict(vert_cap=sc.vert_cap, face_cap=sc.face_cap)
    sc.live_caps = dict(live_vert_cap=cap(1 << 17, res),
                        live_face_cap=cap(1 << 18, res, 4096))
    return sc


def settings(sc, use_kernels: bool) -> dict:
    """The fast arm: ``bench.py:130-146`` with exact correspondences."""
    return dict(
        regularization_weight=0.5, knn_k=3, tdist=sc.tdist, mc_step=2,
        solve_iters=1, gn_iters=12, cg_iters=16, tolerance=5.0,
        reuse_corr=False, n_candidates=16, approx_knn=False,
        use_kernels=use_kernels, **sc.caps, **sc.live_caps)


def arms(hyper: dict) -> dict:
    """The three arms of ``bench.py:250-268`` (module docstring)."""
    exact = dict(hyper, cg_iters=32, approx_knn=False, use_grid_corr=False,
                 reuse_corr=False, exact_candidates=True)
    deep = dict(exact, gn_iters=8, cg_iters=32, solve_iters=3,
                live_mc_step=1)
    return {"fast": hyper, "exact_same": exact, "exact_deep": deep}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_frame(state, live, hyper):
    """One ``fusion_frame`` from ``state`` = (values, weights, wf, lw,
    mesh); returns (state', stats)."""
    values, weights, wf, lw, mesh = state
    v, w, wf2, lw2, stats, mesh2 = fusion_frame(
        values, weights, live, wf, lw, canon_mesh=mesh, **hyper)
    return (v, w, wf2, lw2, mesh2), stats


def run_chain(state, frames, hyper, dev, walls: list):
    """The frames one after another, each synced; appends each frame's
    wall ms to ``walls``. Returns (state, stats of the last frame, the
    canonical meshes' largest (n_verts, n_faces) and any overflow)."""
    vmax = fmax = 0
    over = False
    for live in frames:
        t0 = time.perf_counter()
        state, stats = run_frame(state, live, hyper)
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        mesh = state[4]
        vmax = max(vmax, int(mesh["n_verts"]))
        fmax = max(fmax, int(mesh["n_faces"]))
        over |= bool(mesh["overflow"])
    return state, stats, (vmax, fmax, over)


def live_mesh_caps(lives, hyper):
    """The live meshes' largest (n_verts, n_faces) at the frame's live
    caps and stride, and whether any overflowed (a full node pool
    apart: ``FrameStats.overflow`` also counts it)."""
    vmax = fmax = 0
    over = False
    for live in lives:
        m = marching_cubes(live, 0.0, vert_cap=hyper["live_vert_cap"],
                           face_cap=hyper["live_face_cap"], step_size=1,
                           with_normals=False,
                           use_kernels=hyper["use_kernels"])
        vmax = max(vmax, int(m["n_verts"]))
        fmax = max(fmax, int(m["n_faces"]))
        over |= bool(m["overflow"])
    return vmax, fmax, over


def energy_context(wf, mesh, live, hyper):
    """The fixed parts of gate 2's objective at the state (wf, mesh)
    (``bench.py:279-285``): the live surface at stride 1 without normals,
    the valid masks and the canonical vertices' node neighbours."""
    dev = live.device
    lm = marching_cubes(live, 0.0, vert_cap=hyper["live_vert_cap"],
                        face_cap=hyper["live_face_cap"], step_size=1,
                        with_normals=False, use_kernels=hyper["use_kernels"])
    return SimpleNamespace(
        wf=wf, verts=mesh["verts"], normals=mesh["normals"],
        vmask=torch.arange(hyper["vert_cap"], device=dev) < mesh["n_verts"],
        live_verts=lm["verts"],
        lmask=torch.arange(hyper["live_vert_cap"], device=dev)
        < lm["n_verts"],
        nbr=neighbor_lookup(wf, mesh["verts"], hyper["knn_k"]),
        k=hyper["knn_k"], tolerance=hyper["tolerance"])


def track_energy(ctx, node_dq, lw_dq):
    """Gate 2's common objective (``bench.py:287-308``): the warp
    (node_dq, lw_dq) scored by the point-to-plane data cost under fresh
    exact correspondences at that warp, the regularization left out (8
    zero pairs). Returns (raw 0.5·Σr², huberized 0.5·Σρ(r²), valid
    correspondences), 0-d tensors."""
    wfx = ctx.wf.replace(node_dq=node_dq)
    bw = _blend_weights(wfx, ctx.verts, ctx.nbr)
    wv, wn = warp_points(wfx, ctx.verts, ctx.nbr, normals=ctx.normals,
                         m_lw=lw_dq)
    corr, cval, _ = closest_point_correspondences(
        wv, wn, ctx.vmask, ctx.live_verts, ctx.lmask, ctx.k, ctx.tolerance,
        approx=False)
    data_args = (ctx.verts, ctx.normals, corr, cval, ctx.nbr, bw)
    P, dev = 8, node_dq.device
    zi = torch.zeros(P, dtype=torch.long, device=dev)
    reg_args = (zi, zi, torch.zeros((P, 3), device=dev),
                torch.zeros(P, device=dev),
                torch.zeros(P, dtype=torch.bool, device=dev))
    r_d, r_r = _residuals(node_dq, data_args, reg_args, lw_dq)
    raw, rob = _energies(r_d, r_r)
    return raw, rob, torch.sum(cval)


def final_cost(stats) -> float:
    """A frame's last relaxation round's huberized cost after its solve
    (rounds that did not run hold 0)."""
    cas = stats.cost_after.cpu().numpy()
    return float(cas[int(np.max(np.where(cas > 0, np.arange(len(cas)),
                                         0)))])


def gates(dev99: float, cost_pre: float, cost_fast: float, cost_deep: float,
          pool_risk: int, corr_risk: int, n_verts: int, res: int) -> dict:
    """The three gates of ``bench.py:309-345`` from the measured values:
    (1) dev99 < 0.5; (2) ratio < 1.10, or slack ≤ 1% of the pre-solve
    cost with ratio < 2; (3) pool_risk ≤ 1e-4·R³ and corr_risk ≤ 1% of
    max(n_verts, 1)."""
    ratio = cost_fast / max(cost_deep, 1e-30)
    slack = cost_fast - cost_deep
    gate1 = dev99 < GATE_DEV_P999
    gate2 = (ratio < GATE_RATIO) or (
        (slack <= GATE_SLACK * cost_pre) and (ratio < GATE_RATIO_CAP))
    gate3 = (pool_risk <= GATE_POOL_RISK * res ** 3) and (
        corr_risk <= GATE_CORR_RISK * max(n_verts, 1))
    return dict(cost_ratio=ratio, cost_slack=slack, gate1=gate1,
                gate2=gate2, gate3=gate3,
                accuracy_ok=gate1 and gate2 and gate3)


def drive(res: int, dev: torch.device):
    """The scene, the two warm-up frames and the timed chain
    (``bench.py:75-204``): the bench's gate state. Returns a namespace
    with the scene, the settings, the state after the chain, the chain's
    ms per frame, the six chained frames' mean synced wall and every
    frame's synced wall, the meshes' cap use and
    the peak device memory of the frames."""
    cuda = dev.type == "cuda"
    log(f"# bench at {res}^3 on {device_label(dev)}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sc = scene(res, dev)
    hyper = settings(sc, use_kernels=cuda)
    lv_v, lv_f, lv_over = live_mesh_caps(sc.lives, hyper)
    sync(dev)
    log(f"# setup {time.perf_counter() - t0:.2f} s: nodes "
        f"{int(sc.wf.num_active)}/{sc.wf.capacity}, tdist {sc.tdist:.4f}")

    # warm-up: the first frame extracts the canonical mesh, the second
    # gets the first's (bench.py:155-176, without its fallback)
    walls: list = []
    state = (sc.canonical, torch.zeros_like(sc.canonical), sc.wf, sc.lw,
             None)
    state, stats, mesh_c = run_chain(state, [sc.lives[0]] * 2, hyper, dev,
                                     walls)
    log(f"# warm-up frames {[round(w, 1) for w in walls]} ms: corr "
        f"{int(stats.n_corr)} nodes {int(stats.n_nodes)} verts "
        f"{int(stats.n_verts)}")

    # bench.py:182-204: T(1 frame) and T(6 chained frames)
    t0 = time.perf_counter()
    state, _, m1 = run_chain(state, sc.lives[:1], hyper, dev, walls)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, stats, mk = run_chain(state, sc.lives, hyper, dev, walls)
    tk = time.perf_counter() - t0
    ms = (tk - t1) / (N_LIVES - 1) * 1e3
    # the six chained frames' synced walls over six: the whole window
    # over its frames, without the one-frame chain's own noise
    walls_ms = float(np.mean(walls[-N_LIVES:]))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    can_v = max(mesh_c[0], m1[0], mk[0])
    can_f = max(mesh_c[1], m1[1], mk[1])
    mesh_over = mesh_c[2] or m1[2] or mk[2] or lv_over
    log(f"# steady: 1 frame {t1 * 1e3:.1f} ms, {N_LIVES} frames "
        f"{tk * 1e3:.1f} ms -> {ms:.1f} ms/frame (chain formula); "
        f"{N_LIVES} chained frames' synced walls / {N_LIVES} "
        f"{walls_ms:.1f} ms/frame; synced frame walls "
        f"{[round(w, 1) for w in walls[2:]]} ms (median "
        f"{np.median(walls[2:]):.1f}); peak device memory "
        + (f"{peak:.2f} GiB" if cuda else "not measured (cpu)"))
    log(f"# mesh caps: canonical max {can_v}/{hyper['vert_cap']} verts "
        f"{can_f}/{hyper['face_cap']} faces, live max "
        f"{lv_v}/{hyper['live_vert_cap']} verts "
        f"{lv_f}/{hyper['live_face_cap']} faces: overflow {mesh_over}; "
        f"node pool {int(stats.n_nodes)}/{sc.wf.capacity} (FrameStats."
        f"overflow {bool(stats.overflow)} counts a full pool too)")
    return SimpleNamespace(scene=sc, hyper=hyper, state=state, chain_ms=ms,
                           walls_ms=walls_ms, frame_walls=walls, mesh_overflow=mesh_over,
                           peak_chain_gib=peak)


def run_arm(state, live, hyper):
    """``fusion_frame`` with ``hyper`` from ``state`` on ``live``, synced:
    (outputs, wall ms)."""
    values0, weights0, wf0, lw0, mesh0 = state
    t0 = time.perf_counter()
    out = fusion_frame(values0, weights0, live, wf0, lw0, canon_mesh=mesh0,
                       **hyper)
    sync(values0.device)
    return out, (time.perf_counter() - t0) * 1e3


def run(res: int, dev: torch.device):
    """The bench at ``res`` on ``dev``; returns the :func:`drive`
    namespace with the JSON line's dict (``result``) and what the arms
    and gates measured added."""
    cuda = dev.type == "cuda"
    kernels = (mc_case_cross, warp_trilerp_bricks_cached)
    launches0 = [k.launches for k in kernels]
    d = drive(res, dev)
    _, _, wf0, lw0, mesh0 = d.state
    outs, arm_ms = {}, {}
    for name, h in arms(d.hyper).items():
        outs[name], arm_ms[name] = run_arm(d.state, d.scene.lives[0], h)
    ctx = energy_context(wf0, mesh0, d.scene.lives[0], d.hyper)
    t0 = time.perf_counter()
    cost_pre = float(track_energy(ctx, wf0.node_dq, lw0)[1])
    energy_ms = (time.perf_counter() - t0) * 1e3
    cost = {name: float(track_energy(ctx, out[2].node_dq, out[3])[1])
            for name, out in outs.items()}
    f_stats = outs["fast"][4]
    adiff = torch.abs(outs["fast"][0] - outs["exact_same"][0])
    adiff = adiff.cpu().numpy()
    dev99 = float(np.percentile(adiff, 99.9))
    devmax = float(adiff.max())
    pool_risk = int(f_stats.pool_risk)
    corr_risk = int(f_stats.corr_risk)
    corr_refresh = int(f_stats.corr_refresh)
    n_verts = max(int(f_stats.n_verts), 1)
    g = gates(dev99, cost_pre, cost["fast"], cost["exact_deep"], pool_risk,
              corr_risk, n_verts, res)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    launches = {k.__name__: k.launches - n for k, n in zip(kernels,
                                                         launches0)}
    for name, out in outs.items():
        st = out[4]
        log(f"# arm {name}: {arm_ms[name]:.1f} ms; in-frame cost "
            f"{float(st.cost_before_h[0]):.3f} -> {final_cost(st):.3f}; "
            f"common-objective cost "
            f"{cost[name]:.3f}; n_corr {int(st.n_corr)} pool_risk "
            f"{int(st.pool_risk)}")
    log(f"# accuracy: gate 1 |tsdf_fast - tsdf_exact_same| p99.9 "
        f"{dev99:.4f} max {devmax:.4f} ({g['gate1']}); gate 2 common-"
        f"objective cost fast/deep {cost['fast']:.2f}/"
        f"{cost['exact_deep']:.2f} = {g['cost_ratio']:.3f}, pre-solve(h) "
        f"{cost_pre:.1f}, slack {g['cost_slack']:.2f} <= "
        f"{GATE_SLACK * cost_pre:.2f} ({g['gate2']}); gate 3 pool_risk "
        f"{pool_risk} <= {GATE_POOL_RISK * res ** 3:.0f}, corr_risk "
        f"{corr_risk}/{n_verts} and corr_refresh {corr_refresh} (0 by "
        f"construction: reuse_corr=False) ({g['gate3']}): "
        f"{'OK' if g['accuracy_ok'] else 'FAIL'}; one common-objective "
        f"score {energy_ms:.1f} ms")
    log("# peak device memory of the run "
        + (f"{peak:.2f} GiB" if cuda else "not measured (cpu)")
        + f"; launches {launches}")
    if cuda and not all(launches.values()):
        raise RuntimeError(f"bench: a kernel of the frame never launched "
                           f"({launches})")
    ms = d.chain_ms
    d.result = {
        "metric": f"frame_ms_{res}",
        "value": round(ms, 2),
        "unit": "ms/frame",
        "vs_baseline": round(REFERENCE_BEST_COMBINED_MS / ms, 1),
        "accuracy_tsdf_dev_p999": round(dev99, 4),
        "accuracy_tsdf_dev_max": round(devmax, 4),
        "accuracy_cost_ratio": round(g["cost_ratio"], 4),
        "accuracy_cost_slack_vs_presolve": round(
            g["cost_slack"] / max(cost_pre, 1e-30), 5),
        "pool_risk": pool_risk,
        "corr_risk": corr_risk,
        "corr_refresh": corr_refresh,
        "accuracy_ok": g["accuracy_ok"],
    }
    d.gates, d.arm_ms, d.cost, d.cost_pre = g, arm_ms, cost, cost_pre
    d.launches, d.peak_gib = launches, peak
    return d


def arg_parser(doc: str) -> argparse.ArgumentParser:
    """The entry points' common flags, --res and --device; check the
    parsed flags with :func:`parse`."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--res", type=int, default=256,
                    help="volume resolution, a multiple of 16 (default 256)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "twins run")
    return ap


def parse(ap: argparse.ArgumentParser, argv):
    args = ap.parse_args(argv)
    if args.res < 32 or args.res % 16:
        ap.error("--res must be a multiple of 16, at least 32")
    return args


def main(argv=None):
    args = parse(arg_parser(__doc__), argv)
    report = run(args.res, resolve_device(args.device))
    print(json.dumps(report.result), flush=True)
    return report


if __name__ == "__main__":
    main()
