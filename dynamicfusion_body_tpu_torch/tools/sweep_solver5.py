"""Solver-depth sweep: fast arms at (gn_iters, cg_iters) against the
pinned exact arm — the port of ``tools/sweep_solver5.py``.

The bench's gate compares its fast arm to an exact arm that shares
gn_iters, so lowering gn_iters for both would keep the ratio near 1
while the tracking drifts. This sweep pins the exact arm (gn 8, cg 32,
exact kNN, fresh correspondences, flat candidates: ``tools/_frames.py:
EXACT``) and scores every arm on gate 2's common objective
(``benchmarks/bench.py:track_energy``: the huberized point-to-plane data
cost under a fresh exact correspondence search at the arm's final warp).
An arm is a legitimate speed-up only while its ratio to that arm stays
below 1.10.

Protocol (the JAX tool's): two warm-up frames at the first pair's
settings from the scene's start give the state every arm starts from;
the exact arm and each fast arm run one frame from it on the first live
volume and are scored there (ratio, and slack as a share of the
pre-solve cost); each fast arm's speed is the amortized chain
(``tools/_frames.py:chain_ms``). The base settings are the JAX tool's (3
relaxation rounds, cached correspondences, 16 candidates) with the exact
search the card runs (the JAX tool's ``approx_knn=True`` is the TPU's
approximate top-k; ``tools/_frames.py``); the kernels run on the card.

Pairs are ``gn,cg`` positional arguments (default the JAX tool's 8,16
6,16 5,16 8,12 6,12); ``--frames N`` shortens the chain.

    python -m dynamicfusion_body_tpu_torch.tools.sweep_solver5 8,16 6,12
    python -m dynamicfusion_body_tpu_torch.tools.sweep_solver5 \\
        --device cpu --res 32 --frames 2 8,16
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from ..benchmarks import bench
from ._frames import (
    EXACT, base_settings, chain_ms, parse_args, score, setup, walls_line,
    warm_state)

DEFAULT = ((8, 16), (6, 16), (5, 16), (8, 12), (6, 12))


def main(argv=None) -> SimpleNamespace:
    """Runs the sweep; returns its ``rows`` (per pair: ms, walls, costs,
    ratio, slack and the fast and exact arms' final warps (node_dq, lw)),
    the state every arm starts from (``state0``), its ``live`` volume and
    the base ``hyper``."""
    args = parse_args(argv, __doc__, "pairs",
                      "gn,cg pairs (default 8,16 6,16 5,16 8,12 6,12)")
    try:
        pairs = [tuple(int(x) for x in a.split(",")) for a in args.pairs]
    except ValueError:
        raise SystemExit(f"sweep_solver5: pairs are gn,cg: {args.pairs}")
    if any(len(p) != 2 for p in pairs):
        raise SystemExit(f"sweep_solver5: pairs are gn,cg: {args.pairs}")
    pairs = pairs or list(DEFAULT)
    sc = setup(args, "sweep_solver5")
    dev = args.dev

    gn0, cg0 = pairs[0]
    t0 = time.perf_counter()
    state0, _ = warm_state(sc, base_settings(sc, dev, gn_iters=gn0,
                                             cg_iters=cg0), dev)
    print(f"# setup+warmup {time.perf_counter() - t0:.1f} s", flush=True)
    _, _, wf0, lw0, mesh0 = state0
    ctx = bench.energy_context(wf0, mesh0, sc.lives[0],
                               base_settings(sc, dev))
    t0 = time.perf_counter()
    exact = bench.run_arm(state0, sc.lives[0],
                          base_settings(sc, dev, **EXACT))[0]
    cost_e = score(ctx, exact)
    cost_pre = float(bench.track_energy(ctx, wf0.node_dq, lw0)[1])
    print(f"# exact arm {time.perf_counter() - t0:.1f} s cost_e="
          f"{cost_e:.3f} pre={cost_pre:.1f}", flush=True)

    rows = {}
    for gn, cg in pairs:
        hyper = base_settings(sc, dev, gn_iters=gn, cg_iters=cg)
        t0 = time.perf_counter()
        out = bench.run_arm(state0, sc.lives[0], hyper)[0]
        cost_f = score(ctx, out)
        t_gate = time.perf_counter() - t0
        ms, walls, _, _ = chain_ms(state0, sc.lives, hyper, dev)
        ratio = cost_f / max(cost_e, 1e-30)
        slack = (cost_f - cost_e) / max(cost_pre, 1e-30)
        rows[f"{gn},{cg}"] = dict(
            ms=ms, walls=walls, cost_f=cost_f, cost_e=cost_e,
            cost_pre=cost_pre, ratio=ratio, slack=slack,
            warp=(out[2].node_dq, out[3]),
            exact_warp=(exact[2].node_dq, exact[3]))
        print(f"gn={gn} cg={cg}: {ms:7.1f} ms/frame  cost_f={cost_f:.3f} "
              f"ratio={ratio:.3f} slack={slack:.5f} (gate frame "
              f"{t_gate:.1f} s); {walls_line(walls)}", flush=True)
    return SimpleNamespace(rows=rows, state0=state0, live=sc.lives[0],
                           hyper=base_settings(sc, dev))


if __name__ == "__main__":
    main()
