"""The sharded 512³ bench — the port of the repository's
``benchmarks/bench512_sharded.py``.

Two modes, each run on ``--world`` ranks through ``parallel/launch.py``
(one card a rank on NCCL, the default; CPU processes on gloo), each rank
building the scene from (res, seed) on its own device
(``parallel/ranks.py:bench512_equivalence``/``bench512_full_frame``), so
that no volume is pickled to a spawned rank:

* the equivalence (``run_equivalence``, JAX ``:39``): the non-rigid TSDF
  update of ``parallel/sharded.py:update_tsdf_nonrigid_sharded`` (the
  canonical volume sharded along x, the live volume and the node pool
  replicated) against the dense ``update_tsdf_nonrigid`` on rank 0, on
  the JAX script's seeded scene: ``tools/_scene.py:sharded_volumes``
  (bumpy spheres of radius 0.27·res), 1024 nodes near the canonical's
  zero set from ``RandomState(seed)`` (``construct_graph`` at radius
  0.05·res), DQs perturbed by 0.02, random weights, k = 3, brick 8, 16
  candidates. The gate: both deviations ≤ 1e-5 (expected exactly 0:
  bricks never cross a slab boundary and the candidate pools are per
  brick). Rank 0 keeps only the dense arm's (values, weights) before
  the sharded arm starts; each arm's peak device memory is printed;
* the full frame (``run_full_frame``, JAX ``:106``, ``--full-frame``):
  ``make_init_canonical_sharded`` then one ``make_fusion_frame_sharded``
  frame at the JAX script's settings (subsample rate 1.5, MC stride 2, 3
  rounds of gn 4 / cg 8, tolerance 5, k = 3, 16 candidates, the JAX
  defaults' cached correspondences). The gate: the first round descends,
  nothing overflows, the cost is finite. The JAX script's per-device
  caps are sized for 8 devices; here they are scaled by 8/world, so that
  the ranks together hold what JAX's 8 devices hold (:func:`frame_caps`),
  and printed. Its node pool of 4096 holds the scene's surface only
  below 256³: the greedy subsample wants 4,255 nodes at 256³ and 17,187
  at 512³ (measured on the card), so the frame drops new nodes and its
  ``overflow`` (which counts them) fails the gate at any world size.
  The pool here is :func:`node_cap` (32,768 at 512³), with which nothing
  drops.

As in the JAX package, the sharded path runs no kernel (no kernel takes a
slab offset): both modes run the plain forms, on the card too.

The last line of standard output is the JAX script's JSON (``metric``,
``res``, ``n_devices``, the mode's keys, ``ok``); times are synced walls
in seconds (the sharded arm's from a barrier to the last rank's end);
``#`` lines on standard error carry the card's name and power limit, the
caps and the peak memory. The process exits 1 when ``ok`` is false.
NCCL takes one card a rank: a ``--world`` above the card count raises.

``--res`` (for tests on the CPU) scales the scene with it, as the JAX
script does, and the caps with the surface, (res/512)², as the port's
``bench512 --res`` does.

    python -m dynamicfusion_body_tpu_torch.benchmarks.bench512_sharded
    python -m dynamicfusion_body_tpu_torch.benchmarks.bench512_sharded \\
        --full-frame --world 4
    python -m dynamicfusion_body_tpu_torch.benchmarks.bench512_sharded \\
        --res 32 --world 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..parallel import launch, ranks
from ..pipeline.fusion import resolve_device
from ..tools._timing import device_label

RES = 512
GATE_DEV = 1e-5
# bench512_sharded.py:141-144: the per-device caps of an 8-device mesh
JAX_DEVICES = 8
JAX_CAPS = dict(vert_cap=1 << 15, face_cap=1 << 16, live_vert_cap=1 << 17,
                live_face_cap=1 << 18)
INIT = dict(subsample_rate=1.5, mc_step=2)
JAX_NODE_CAP = 4096
FRAME = dict(regularization_weight=0.5, knn_k=3, mc_step=2, solve_iters=3,
             gn_iters=4, cg_iters=8, tolerance=5.0, n_candidates=16)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def frame_caps(res: int, world: int) -> dict:
    """The per-rank mesh caps: the JAX script's per-device caps times
    8/world (the same total over the ranks), times (res/512)² below 512³
    (at least 2048 vertices, 4096 faces)."""
    s = JAX_DEVICES / world * (res / RES) ** 2
    return {k: max(int(v * s), 4096 if "face" in k else 2048)
            for k, v in JAX_CAPS.items()}


def node_cap(res: int) -> int:
    """The graph's node pool: 8192·(res/256)², at least the JAX script's
    4096 (module docstring)."""
    return max(JAX_NODE_CAP, 8192 * res * res // (256 * 256))


def run_equivalence(res: int = RES, world: int = 1, backend: str = "nccl",
                    seed: int = 0) -> dict:
    """The dense and the sharded update on ``world`` ranks; returns the
    JAX script's dict (and the arms' peak memory)."""
    return launch.run(ranks.bench512_equivalence, world, (res, seed),
                      backend=backend)


def run_full_frame(res: int = RES, world: int = 1, backend: str = "nccl",
                   frame_kw: dict | None = None) -> dict:
    """Init and one sharded frame on ``world`` ranks at :func:`frame_caps`
    and :func:`node_cap`; ``frame_kw`` overrides the frame's settings (the
    tests cut the iterations). Returns the JAX script's dict (and the caps
    and peak)."""
    caps = frame_caps(res, world)
    init = dict(INIT, node_cap=node_cap(res))
    log(f"# per-rank caps at world {world}: {caps} (the JAX script's "
        f"{JAX_CAPS} per device of {JAX_DEVICES}, x {JAX_DEVICES}/{world}"
        + (f" x ({res}/{RES})^2" if res != RES else "") + "); node pool "
        f"{init['node_cap']} (the JAX script's {JAX_NODE_CAP})")
    out = launch.run(ranks.bench512_full_frame, world,
                     (res, caps, init, dict(FRAME, **(frame_kw or {}))),
                     backend=backend)
    out["caps"] = caps
    return out


def gate(out: dict, full: bool) -> bool:
    """The JAX script's gate (``bench512_sharded.py:202-207``)."""
    if full:
        return (out["descended"] and not out["overflow"]
                and bool(np.isfinite(out["cost_after_r0"])))
    return (out["max_dev_values"] <= GATE_DEV
            and out["max_dev_weights"] <= GATE_DEV)


def result(out: dict, full: bool) -> dict:
    """The JAX script's JSON line from a mode's dict: its keys, in its
    order, then ``metric`` and ``ok``."""
    keys = (("res", "n_devices", "n_corr", "n_nodes", "cost_before_r0",
             "cost_after_r0", "descended", "pool_risk", "corr_risk",
             "overflow", "t_setup_s", "t_frame_s") if full else
            ("res", "n_devices", "max_dev_values", "max_dev_weights",
             "esc_dropped", "pool_risk", "t_dense_s", "t_sharded_s"))
    line = {k: out[k] for k in keys}
    line["metric"] = (f"sharded_full_frame_{out['res']}" if full
                      else f"sharded_equivalence_{out['res']}")
    line["ok"] = gate(out, full)
    return line


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=RES,
                    help="volume resolution, a multiple of 8 x world, at "
                         "least 32 (default 512; smaller sizes are for "
                         "tests)")
    ap.add_argument("--world", type=int, default=1,
                    help="ranks (default 1): one card each on NCCL")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="nccl (default on cuda) or gloo (the CPU's)")
    ap.add_argument("--full-frame", action="store_true",
                    help="run the whole sharded frame instead of the "
                         "update's equivalence")
    args = ap.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    if (backend == "nccl") != (args.device == "cuda"):
        ap.error("NCCL runs on cuda, gloo on the cpu")
    if args.world < 1 or args.res < 32 or args.res % (8 * args.world):
        ap.error("--res must be a multiple of 8 x --world, at least 32")
    dev = resolve_device(args.device)
    label = device_label(dev)
    if dev.type == "cuda":
        label += f"; {torch.cuda.device_count()} card(s)"
    log(f"# bench512_sharded at {args.res}^3 on {args.world} rank(s), "
        f"{backend}: {label}")
    if args.full_frame:
        out = run_full_frame(args.res, args.world, backend)
    else:
        out = run_equivalence(args.res, args.world, backend)
    peaks = {k: out[k] for k in ("peak_dense_gib", "peak_sharded_gib",
                                 "peak_gib") if k in out}
    log("# rank 0's peak device memory: " + (
        ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items())
        if dev.type == "cuda" else "not measured (cpu)"))
    line = result(out, args.full_frame)
    print(json.dumps(line), flush=True)
    return dict(out, **line)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
