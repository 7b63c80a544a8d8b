"""In-frame stage attribution: the frame timed with one knob changed per
arm — the port of ``tools/profile_frame5.py``.

Standalone stage timings (``tools/profile_frame.py``) miss what a stage
costs inside the frame; here every arm runs the JAX tool's amortized
chain (``tools/_frames.py:chain_ms``: two warm-up frames from the scene's
start, then ``(T(N) − T(1)) / (N − 1)`` over the bench's live frames)
with one knob changed from the base, and its delta against the base
attributes that stage's in-frame cost. The base is the JAX tool's
(``profile_frame5.py:77-83``: 3 rounds of gn 6 / cg 12, cached
correspondences, 16 candidates) with the exact search the card runs
(``tools/_frames.py``: the JAX tool's ``approx_knn=True`` is the TPU's
approximate top-k); the kernels run on the card (K1, K2).

Arms (the JAX tool's, by the knob they change): ``solve_iters=0`` (no
solve), ``solve_iters=1``, ``gn_iters=1`` (3 rounds of 1),
``update_graph=False``, ``reuse_corr=False`` (fresh search every round),
``exact_candidates`` (flat brick candidates), ``cg_iters=6``. Name arms
to run only those (the base always runs); ``--frames N`` shortens the
chain (2..6, default 6). Each arm prints its ms per frame, its delta
against the base and its frames' synced walls.

    python -m dynamicfusion_body_tpu_torch.tools.profile_frame5
    python -m dynamicfusion_body_tpu_torch.tools.profile_frame5 \\
        solve_iters=0 --frames 2
    python -m dynamicfusion_body_tpu_torch.tools.profile_frame5 \\
        --device cpu --res 32 --frames 2 cg_iters=6
"""

from __future__ import annotations

import time

from ._frames import (
    base_settings, chain_ms, parse_args, setup, walls_line, warm_state)

ARMS = {
    "base": dict(),
    "solve_iters=0": dict(solve_iters=0),
    "solve_iters=1": dict(solve_iters=1),
    "gn_iters=1": dict(gn_iters=1),
    "update_graph=False": dict(update_graph=False),
    "reuse_corr=False": dict(reuse_corr=False),
    "exact_candidates": dict(exact_candidates=True),
    "cg_iters=6": dict(cg_iters=6),
}


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, "arms",
                      f"arms to run besides the base (default all): "
                      f"{', '.join(list(ARMS)[1:])}")
    unknown = [a for a in args.arms if a not in ARMS]
    if unknown:
        raise SystemExit(f"profile_frame5: unknown arms {unknown}")
    names = ["base"] + [a for a in (args.arms or list(ARMS)[1:])
                        if a != "base"]
    sc = setup(args, "profile_frame5")
    rows = {}
    for name in names:
        hyper = base_settings(sc, args.dev, **ARMS[name])
        t0 = time.perf_counter()
        state, warm_s = warm_state(sc, hyper, args.dev)
        ms, walls, _, _ = chain_ms(state, sc.lives, hyper, args.dev)
        rows[name] = dict(ms=ms, walls=walls, warm_s=warm_s,
                          total_s=time.perf_counter() - t0)
        delta = ms - rows["base"]["ms"]
        print(f"{name:20s} {ms:9.1f} ms/frame  delta vs base {delta:+9.1f} "
              f"ms  (warm-up {warm_s:.1f} s); {walls_line(walls)}",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
