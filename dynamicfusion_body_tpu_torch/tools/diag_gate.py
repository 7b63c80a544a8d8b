"""Attribute the bench's gate 2 arm by arm — the port of
``tools/diag_gate.py``.

It drives the bench to its gate state (the scene, two warm-up frames and
the timed chain, :func:`..benchmarks.bench.drive`) and runs each arm
from there on the rewind frame ``lives[0]`` without the graph update.
For each arm it prints two costs:

1. the in-frame final huberized solve cost: each arm scores its own
   correspondence set, so arms with different (equally valid) matches
   solve different objectives;
2. the common-objective cost of gate 2 (:func:`..benchmarks.bench.
   track_energy`): the arm's final warp under fresh exact
   correspondences, the huberized point-to-plane data cost, with the raw
   cost and the valid correspondences beside it.

Arms: ``fast`` (the bench's settings), ``exact`` (cg 32 and flat
candidates) and the fast arm with one knob changed: ``fast+cg32``,
``fast+flat_cand`` (the carried mesh's 2-level candidate caches dropped,
so the flat search really runs, in this arm and in ``exact``),
``fast+deep`` (3 relaxation rounds of gn 8) and ``fast+reuse_corr`` (the
cached candidates with the drift certificate, ``reuse_corr=True``: the
correspondence mode of the JAX tool's own fast arm, which leaves
``reuse_corr`` at its default, ``tools/diag_gate.py:68-75``). The JAX
tool's ``fast+exact_knn`` equals its ``fast`` off the TPU (``approx_knn =
backend == "tpu"``, ``:72``), as it does on the card, where the bench
runs exact kNN; its ``fast+fresh_corr`` is the port's ``fast``, because
the port's fast arm is the bench's (fresh correspondences every round).

    python -m dynamicfusion_body_tpu_torch.tools.diag_gate
    python -m dynamicfusion_body_tpu_torch.tools.diag_gate --res 64 \\
        --arm fast+cg32
    python -m dynamicfusion_body_tpu_torch.tools.diag_gate --res 32 \\
        --device cpu --arm fast
"""

from __future__ import annotations

from ..benchmarks import bench
from ..pipeline.fusion import resolve_device


def arm_settings(hyper: dict) -> dict:
    """{arm: (settings, drop the mesh's candidate caches)}."""
    exact = bench.arms(hyper)["exact_same"]
    return {
        "fast": (hyper, False),
        "exact": (exact, True),
        "fast+cg32": (dict(hyper, cg_iters=32), False),
        "fast+flat_cand": (dict(hyper, exact_candidates=True), True),
        "fast+deep": (dict(hyper, gn_iters=8, solve_iters=3), False),
        "fast+reuse_corr": (dict(hyper, reuse_corr=True), False),
    }


def main(argv=None) -> dict:
    ap = bench.arg_parser(__doc__)
    ap.add_argument("--arm", action="append", default=None,
                    choices=list(arm_settings({})),
                    help="an arm to run (repeatable; default all)")
    args = bench.parse(ap, argv)
    names = args.arm or list(arm_settings({}))
    dev = resolve_device(args.device)

    d = bench.drive(args.res, dev)
    _, _, wf0, lw0, mesh0 = d.state
    ctx = bench.energy_context(wf0, mesh0, d.scene.lives[0], d.hyper)
    raw0, rob0, nc0 = bench.track_energy(ctx, wf0.node_dq, lw0)
    print(f"# pre-solve tracking energy raw={float(raw0):.3f} "
          f"huber={float(rob0):.3f} ncorr={int(nc0)}", flush=True)

    results = {}
    settings = arm_settings(d.hyper)
    for name in names:
        hyper, drop = settings[name]
        mesh = ({k: v for k, v in mesh0.items()
                 if not k.startswith(("brick_", "warp_"))} if drop else mesh0)
        out, ms = bench.run_arm((*d.state[:4], mesh), d.scene.lives[0],
                                dict(hyper, update_graph=False))
        raw, rob, nc = bench.track_energy(ctx, out[2].node_dq, out[3])
        results[name] = dict(in_frame=bench.final_cost(out[4]),
                             huber=float(rob), raw=float(raw), ncorr=int(nc),
                             corr_risk=int(out[4].corr_risk),
                             corr_refresh=int(out[4].corr_refresh), ms=ms)
        r = results[name]
        print(f"{name:16s} in-frame final cost {r['in_frame']:10.4f}   "
              f"common-obj huber {r['huber']:10.4f} raw {r['raw']:10.4f} "
              f"ncorr {r['ncorr']} corr_risk {r['corr_risk']} corr_refresh "
              f"{r['corr_refresh']}   {ms:.1f} ms", flush=True)

    if "exact" in results:
        ref = results["exact"]
        print("# ratios vs exact:", flush=True)
        for name, r in results.items():
            in_frame = r["in_frame"] / max(ref["in_frame"], 1e-30)
            common = r["huber"] / max(ref["huber"], 1e-30)
            print(f"{name:16s} in-frame {in_frame:7.4f}   common-obj "
                  f"{common:7.4f}", flush=True)
    return results


if __name__ == "__main__":
    main()
