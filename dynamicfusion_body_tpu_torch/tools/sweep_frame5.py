"""Frame sweep: named fast arms against the pinned exact arm, gated from
the bench's own gate state (the rewind frame) — the port of
``tools/sweep_frame5.py``.

``sweep_solver5`` gates from the warm-up state on a small forward step;
the bench's gate runs from the end of the chain back to the first live
volume (a rewind of 0.25 in bump phase), which is where shallow
schedules fail. This tool follows the bench's protocol:

1. two warm-up frames, then the whole chain of live frames: the rewind
   state;
2. the pinned exact arm from that state (gn 8, cg 32, exact kNN, fresh
   correspondences, flat candidates, live MC stride 1:
   ``tools/_frames.py:EXACT``);
3. each fast arm one frame from the same state; both warps scored on
   gate 2's common objective (``benchmarks/bench.py:track_energy``): the
   ratio, and the slack as a share of the pre-solve cost;
4. each arm's speed: the amortized chain (``tools/_frames.py:chain_ms``)
   from the warm-up state.

Arms are the JAX tool's presets (``ARMS``, ``sweep_frame5.py:59-84``) on
its base (3 relaxation rounds of gn 6 / cg 12, cached correspondences, 16
candidates), with the exact search the card runs (the JAX tool's
``approx_knn=True`` is the TPU's approximate top-k; ``tools/_frames.py``);
the kernels run on the card. Name them as positional arguments (default
fresh sched2 lms2 sched2+lms2); ``--frames N`` shortens the chain.

    python -m dynamicfusion_body_tpu_torch.tools.sweep_frame5 fresh si1
    python -m dynamicfusion_body_tpu_torch.tools.sweep_frame5 \\
        --device cpu --res 32 --frames 2 si1
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from ..benchmarks import bench
from ._frames import (
    EXACT, base_settings, chain_ms, parse_args, run_chain, score, setup,
    walls_line, warm_state)

# fast-arm presets on the base settings (sweep_frame5.py:59-84)
ARMS = {
    # the base: cached candidates under the drift certificate
    "cached": dict(),
    # a fresh search every round
    "fresh": dict(reuse_corr=False),
    "fresh_gn4": dict(reuse_corr=False, gn_iters=4),
    # deep-first schedules (14 GN steps a frame against 18)
    "sched2": dict(reuse_corr=False, gn_iters=(8, 4, 2)),
    "sched3": dict(reuse_corr=False, gn_iters=(6, 3, 2),
                   cg_iters=(16, 12, 8)),
    # a half-density live target surface (the exact arm keeps stride 1)
    "lms2": dict(reuse_corr=False, live_mc_step=2),
    "sched2+lms2": dict(reuse_corr=False, gn_iters=(8, 4, 2),
                        live_mc_step=2),
    "cached+sched2": dict(gn_iters=(8, 4, 2)),
    # two relaxation rounds: one round's fixed cost less
    "si2": dict(reuse_corr=False, solve_iters=2, gn_iters=(10, 6),
                cg_iters=(16, 12)),
    "si2b": dict(reuse_corr=False, solve_iters=2, gn_iters=(8, 8)),
    "si1": dict(reuse_corr=False, solve_iters=1, gn_iters=12, cg_iters=16),
}
DEFAULT = ("fresh", "sched2", "lms2", "sched2+lms2")


def main(argv=None) -> SimpleNamespace:
    """Runs the sweep; returns its ``rows`` (per arm: ms, walls, costs,
    ratio, slack and the fast and exact arms' final warps (node_dq, lw)),
    the rewind state the arms are gated from (``state0``), its ``live``
    volume and the base ``hyper``."""
    args = parse_args(argv, __doc__, "arms",
                      f"arms (default {' '.join(DEFAULT)}): "
                      f"{', '.join(ARMS)}")
    unknown = [a for a in args.arms if a not in ARMS]
    if unknown:
        raise SystemExit(f"sweep_frame5: unknown arms {unknown}")
    names = args.arms or list(DEFAULT)
    sc = setup(args, "sweep_frame5")
    dev = args.dev
    base = base_settings(sc, dev)

    t0 = time.perf_counter()
    state0, _ = warm_state(sc, base, dev)
    rewind, _ = run_chain(state0, sc.lives, base, dev)
    print(f"# setup+chain {time.perf_counter() - t0:.1f} s (gate = rewind "
          f"from live[{len(sc.lives) - 1}] to live[0])", flush=True)
    _, _, wf0, lw0, mesh0 = rewind
    ctx = bench.energy_context(wf0, mesh0, sc.lives[0], base)
    t0 = time.perf_counter()
    exact = bench.run_arm(rewind, sc.lives[0], dict(
        base, **EXACT, live_mc_step=1))[0]
    cost_e = score(ctx, exact)
    cost_pre = float(bench.track_energy(ctx, wf0.node_dq, lw0)[1])
    print(f"# exact arm {time.perf_counter() - t0:.1f} s cost_e="
          f"{cost_e:.3f} pre={cost_pre:.1f}", flush=True)

    rows = {}
    for name in names:
        hyper = dict(base, **ARMS[name])
        t0 = time.perf_counter()
        out = bench.run_arm(rewind, sc.lives[0], hyper)[0]
        cost_f = score(ctx, out)
        t_gate = time.perf_counter() - t0
        ms, walls, _, _ = chain_ms(state0, sc.lives, hyper, dev)
        ratio = cost_f / max(cost_e, 1e-30)
        slack = (cost_f - cost_e) / max(cost_pre, 1e-30)
        rows[name] = dict(ms=ms, walls=walls, cost_f=cost_f, cost_e=cost_e,
                          cost_pre=cost_pre, ratio=ratio, slack=slack,
                          warp=(out[2].node_dq, out[3]),
                          exact_warp=(exact[2].node_dq, exact[3]))
        print(f"{name:16s} {ms:7.1f} ms/frame  cost_f={cost_f:.3f} "
              f"ratio={ratio:.3f} slack={slack:.5f} (gate frame "
              f"{t_gate:.1f} s); {walls_line(walls)}", flush=True)
    return SimpleNamespace(rows=rows, state0=rewind, live=sc.lives[0],
                           hyper=base)


if __name__ == "__main__":
    main()
