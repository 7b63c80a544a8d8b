"""Solver cost: the standalone GN solve at several CG depths, and the
frame chain at candidate (gn, cg, ftol) settings with its final cost —
the port of ``tools/exp_solver.py``.

(a) The standalone ``solve_nonrigid`` at gn 8 and cg 16, 8 and 2
(``solve_8gn_{cg}cg_flat_exit``), which splits the per-step fixed cost
(Jacobians, normal blocks, residual pass) from the per-CG-step cost, on
the bench canonical's stride-2 mesh against config 4's live surface
with exact correspondences at the unwarped vertices (the JAX tool runs
this part only under ``EXP_STANDALONE``; here it always runs). Each row
is the median synced wall and the CUDA-event mean
(``tools/_timing.py:Timer``), with the busy share under ``--trace DIR``.

(b) The amortized frame chain (the bench's live frames, carried from
one chain to the next as the JAX tool does: ``tools/_frames.py:
chain_ms``) at each arm's (gn, cg, ftol) on the JAX tool's base (3
relaxation rounds, cached correspondences, 16 candidates), printed with
its last frame's per-round costs; then, from the steady state of the
deepest arm run (gn 8 when it ran), one frame of the exact arm (gn 8,
cg 32, exact kNN, fresh correspondences) and one of each arm on the
first live volume: p99.9 |Δtsdf| against the exact arm and the in-frame
final huberized cost against its, so that speed cannot come from
under-solving. The JAX tool searches with the TPU's approximate top-k
(``approx=True``/``approx_knn=True``); here every search is exact, as
on every path on the card (``tools/_frames.py``). The kernels run on
the card.

``--arm NAME`` (repeatable) runs only those arms of (b) (default all:
gn2_cg16 gn3_cg16 gn4_cg16 gn8_cg16); ``--frames N`` shortens the chain.

    python -m dynamicfusion_body_tpu_torch.tools.exp_solver
    python -m dynamicfusion_body_tpu_torch.tools.exp_solver \\
        --device cpu --res 32 --reps 1 --frames 2 --arm gn2_cg16
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from ..benchmarks import bench
from ..pipeline.correspondence import closest_point_correspondences
from ..pipeline.fusion import resolve_device
from ..solvers.nonrigid import solve_nonrigid
from . import _frames
from ._scene import KNN_K, meshes, reg_pairs
from ._timing import Timer, parse_args

ARMS = {f"gn{gn}_cg16": dict(gn_iters=gn, cg_iters=16, ftol=1e-5)
        for gn in (2, 3, 4, 8)}
TOLERANCE = 5.0


def _extend(ap):
    ap.add_argument("--frames", type=int, default=bench.N_LIVES,
                    help=f"live frames of the chain (2..{bench.N_LIVES}, "
                         f"default {bench.N_LIVES})")
    ap.add_argument("--arm", action="append", default=None,
                    choices=list(ARMS),
                    help="a chain arm to run (repeatable; default all)")


def main(argv=None) -> SimpleNamespace:
    """Returns ``rows`` (the standalone solves' Timer rows), ``chain``
    (per arm: ms, walls, the last frame's per-round costs) and ``acc``
    (per arm: p99.9 |Δtsdf|, final cost and its ratio to the exact
    arm's)."""
    args = parse_args(argv, __doc__, reps=8, extend=_extend)
    if not 2 <= args.frames <= bench.N_LIVES:
        raise SystemExit(f"exp_solver: --frames must be in "
                         f"2..{bench.N_LIVES}")
    args.dev = resolve_device(args.device)
    dev = args.dev
    sc = _frames.setup(args, "exp_solver")

    # (a) the standalone solve
    ms_ = meshes(sc)
    mesh, lm = ms_.mesh, ms_.live_mesh
    corr, cvalid, _ = closest_point_correspondences(
        mesh["verts"], mesh["normals"], ms_.vmask, lm["verts"], ms_.lmask,
        KNN_K, TOLERANCE)
    data = (mesh["verts"], mesh["normals"], corr, cvalid, ms_.nbr_idx,
            ms_.blend)
    pairs = reg_pairs(sc, ms_)
    t = Timer(dev, args.reps, args.trace)
    for cg in (16, 8, 2):
        t(f"solve_8gn_{cg}cg_flat_exit", lambda cg=cg: solve_nonrigid(
            sc.wf.node_dq, *data, *pairs, sc.lw, gn_iters=8, cg_iters=cg,
            dense_pairs=True))
    del ms_, mesh, lm, corr, cvalid, data, pairs

    # (b) the chain at each arm's settings
    names = args.arm or list(ARMS)
    chain, states = {}, {}
    for name in names:
        hyper = _frames.base_settings(sc, dev, **ARMS[name])
        state, _ = _frames.warm_state(sc, hyper, dev)
        ms, walls, states[name], stats = _frames.chain_ms(
            state, sc.lives, hyper, dev, carry=True)
        cb = stats.cost_before.cpu().numpy()
        ca = stats.cost_after.cpu().numpy()
        chain[name] = dict(ms=ms, walls=walls, cost_before=cb,
                           cost_after=ca)
        print(f"chain {name:12s} {ms:9.1f} ms/frame  rounds cb={cb} "
              f"ca={ca}; {_frames.walls_line(walls)}", flush=True)

    ref = "gn8_cg16" if "gn8_cg16" in states else names[-1]
    state_ref = states[ref]
    exact = _frames.base_settings(sc, dev, **ARMS["gn8_cg16"])
    exact.update(cg_iters=32, reuse_corr=False)
    t0 = time.perf_counter()
    out_e = bench.run_arm(state_ref, sc.lives[0], exact)[0]
    cost_e = bench.final_cost(out_e[4])
    print(f"# accuracy from {ref}'s steady state: exact arm "
          f"{time.perf_counter() - t0:.1f} s, final cost {cost_e:.2f}",
          flush=True)
    acc = {}
    for name in names:
        hyper = _frames.base_settings(sc, dev, **ARMS[name])
        out_f = bench.run_arm(state_ref, sc.lives[0], hyper)[0]
        adiff = torch.abs(out_f[0] - out_e[0]).cpu().numpy()
        p999 = float(np.percentile(adiff, 99.9))
        cost_f = bench.final_cost(out_f[4])
        acc[name] = dict(tsdf_p999=p999, cost=cost_f,
                         ratio=cost_f / max(cost_e, 1e-9))
        print(f"acc {name:12s} tsdf_p999={p999:.4f} cost={cost_f:.2f} vs "
              f"exact {cost_e:.2f} ratio={acc[name]['ratio']:.4f}",
              flush=True)
    return SimpleNamespace(rows=t.rows, chain=chain, acc=acc)


if __name__ == "__main__":
    main()
