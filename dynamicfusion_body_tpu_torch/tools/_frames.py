"""What the frame tools share (``profile_frame5``, ``sweep_solver5``,
``sweep_frame5``, ``exp_solver``): their flags, the bench scene with its
live frames, the JAX tools' base settings, the pinned exact arm and the
JAX tools' amortized chain.

The JAX tools time a chain of frames as ``(T(N frames) − T(1 frame)) /
(N − 1)``, each chain ending in a host fetch; here each frame ends in
``torch.cuda.synchronize()`` (the port reads its loop predicates on the
host, so a frame is synced before it ends anyway), and every frame's
synced wall is kept beside the formula.

The JAX tools' base settings search with the TPU's approximate top-k
(``approx_knn=True``); here every arm searches exactly
(``approx_knn=False``), as every path on the card does: the card has no
approximate top-k, and the port's ``approx=True`` is a bf16-keyed exact
selection, not that search.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..benchmarks import bench
from ..pipeline.fusion import resolve_device
from ._timing import device_label

# the pinned exact arm (sweep_solver5.py:126-128, sweep_frame5.py:186-189)
EXACT = dict(gn_iters=8, cg_iters=32, approx_knn=False, use_grid_corr=False,
             reuse_corr=False, exact_candidates=True)


def parse_args(argv, doc: str, positional: str | None = None,
               help_pos: str = ""):
    """The bench's --res and --device (``bench.arg_parser``), --frames
    and, with ``positional``, the JAX tool's positional arguments (a list,
    empty when none are given)."""
    ap = bench.arg_parser(doc)
    ap.add_argument("--frames", type=int, default=bench.N_LIVES,
                    help=f"live frames of the chain (default "
                         f"{bench.N_LIVES}, the JAX tools' 6)")
    if positional:
        ap.add_argument(positional, nargs="*", help=help_pos)
    args = bench.parse(ap, argv)
    if not 2 <= args.frames <= bench.N_LIVES:
        ap.error(f"--frames must be in 2..{bench.N_LIVES}")
    args.dev = resolve_device(args.device)
    return args


def setup(args, name: str):
    """The bench scene (``bench.scene``) at ``args.res`` with its first
    ``args.frames`` live frames, on ``args.dev``."""
    sc = bench.scene(args.res, args.dev)
    sc.lives = sc.lives[:args.frames]
    print(f"# {name}: {args.res}^3, {args.frames} frames, nodes "
          f"{int(sc.wf.num_active)} on {device_label(args.dev)}",
          flush=True)
    return sc


def base_settings(sc, dev, **over) -> dict:
    """The JAX frame tools' base (``profile_frame5.py:77-83``: 3 rounds of
    gn 6 / cg 12, k = 3, MC stride 2, tolerance 5, 16 candidates, cached
    correspondences) with exact search, the kernels on the card; ``over``
    replaces keys."""
    hyper = dict(bench.settings(sc, use_kernels=dev.type == "cuda"),
                 solve_iters=3, gn_iters=6, cg_iters=12, reuse_corr=True)
    hyper.update(over)
    return hyper


def init_state(sc):
    """(values, weights, wf, lw, mesh) before the first frame."""
    return (sc.canonical, torch.zeros_like(sc.canonical), sc.wf, sc.lw,
            None)


def run_chain(state, lives, hyper, dev, walls: list | None = None):
    """The frames one after another, each synced (its wall in ms appended
    to ``walls``). Returns (state, stats of the last frame)."""
    stats = None
    for live in lives:
        t0 = time.perf_counter()
        state, stats = bench.run_frame(state, live, hyper)
        bench.sync(dev)
        if walls is not None:
            walls.append((time.perf_counter() - t0) * 1e3)
    return state, stats


def warm_state(sc, hyper, dev):
    """Two frames on the first live volume from the scene's start (the
    first extracts the canonical mesh, the second carries it): the JAX
    tools' warm-up. Returns (state, synced s)."""
    t0 = time.perf_counter()
    state, _ = run_chain(init_state(sc), [sc.lives[0]] * 2, hyper, dev)
    return state, time.perf_counter() - t0


def chain_ms(state, lives, hyper, dev, carry: bool = False):
    """The JAX tools' amortized chain: one warm frame, then T(1 frame)
    and T(len(lives) frames), each from ``state`` (``carry``: the second
    chain continues from the first's end, as ``exp_solver.py:127-133``
    does). Returns (ms per frame, the long chain's synced walls in ms,
    its end state, its last frame's stats)."""
    run_chain(state, lives[:1], hyper, dev)
    t0 = time.perf_counter()
    s1, _ = run_chain(state, lives[:1], hyper, dev)
    t1 = time.perf_counter() - t0
    walls: list = []
    t0 = time.perf_counter()
    sk, stats = run_chain(s1 if carry else state, lives, hyper, dev, walls)
    tk = time.perf_counter() - t0
    return (tk - t1) / (len(lives) - 1) * 1e3, walls, sk, stats


def walls_line(walls) -> str:
    return (f"synced frames {[round(w, 1) for w in walls]} ms (median "
            f"{float(np.median(walls)):.1f})")


def score(ctx, out) -> float:
    """Gate 2's common objective (``bench.track_energy``, huberized) of a
    frame's output warp."""
    return float(bench.track_energy(ctx, out[2].node_dq, out[3])[1])
