"""The CNN correspondence path's benchmark — the port of the repository's
``benchmarks/bench_cnn.py``.

Times the learned ``setupCorrespondences`` at the reference's operating
point: 24 views of 512², the descriptors of both meshes (the bench
canonical at stride 2, caps 2^15/2^16; the live mesh at stride 1, caps
2^17/2^18; both from ``bumpy_sdf`` at 256³) and the feature-space match
(core/sdf.py:95-150's 24 GL renders and session runs, twice, plus the
kd-tree match). The canonical's descriptors are timed at (view batch,
samples) = (1, 8), (8, 8), (8, 4) and (8, 2), each with its vertex
coverage (the share of valid vertices that at least one pixel sees: a
sample grid too sparse for the triangles punches holes), then the full
``match``. The weights are random (``CnnCorrespondence``'s init): the
time does not depend on them.

Each row is timed by ``tools/_timing.py:Timer``: the median synced wall
of 3 calls after a warm one (a caller's wait; the path has no host sync
inside) and the CUDA-event mean of 3 chained calls; the JSON line takes
the walls. The (8, 4) call is split into its renders, network and
scatter, each timed alone on the same inputs. ``--res``,
``--size`` and ``--views`` scale the scene for the tests
(``tools/_scene.py:bumpy``/``cap``); at their defaults they are the JAX
bench's.

The last line of standard output is the JAX bench's JSON line
(``cnn_setup_corr_512`` and its keys); the rest goes to standard error.

    python -m dynamicfusion_body_tpu_torch.benchmarks.bench_cnn
    python -m dynamicfusion_body_tpu_torch.benchmarks.bench_cnn \\
        --res 32 --size 32 --views 4 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from ..ops.marching_cubes import marching_cubes
from ..pipeline.cnn_correspondence import (CnnCorrespondence, network,
                                           regularize_verts, render_views,
                                           scatter)
from ..pipeline.fusion import resolve_device
from ..tools._scene import bumpy, cap
from ..tools._timing import Timer, device_label
from .bench import log

# (view batch, samples) of the descriptor rows, as the JAX bench's
ROWS = ((1, 8), (8, 8), (8, 4), (8, 2))
REPS = 3  # timed calls per row, after a warm one
RESULT_KEYS = (
    "metric", "value", "unit", "descriptors_ms_b1_s8", "descriptors_ms_s8",
    "descriptors_ms_s4", "descriptors_ms_s2", "coverage_s8", "coverage_s4",
    "coverage_s2", "speedup_vs_round4")


def scene(res: int, dev: torch.device):
    """The bench canonical at stride 2 and the live sphere at stride 1
    (``benchmarks/bench_cnn.py:43-56``), with their valid masks."""
    canonical = torch.from_numpy(bumpy(res, (128, 128, 128), 0.0)).to(dev)
    live = torch.from_numpy(bumpy(res, (130, 129, 128), 0.05)).to(dev)
    use_kernels = dev.type == "cuda"
    cmesh = marching_cubes(canonical, 0.0, vert_cap=cap(1 << 15, res),
                           face_cap=cap(1 << 16, res, 4096), step_size=2,
                           use_kernels=use_kernels)
    lmesh = marching_cubes(live, 0.0, vert_cap=cap(1 << 17, res),
                           face_cap=cap(1 << 18, res, 4096), step_size=1,
                           use_kernels=use_kernels)

    def mask(m, n):
        return torch.arange(n, device=dev) < m["n_verts"]

    return (cmesh, mask(cmesh, cmesh["verts"].shape[0]), lmesh,
            mask(lmesh, lmesh["verts"].shape[0]))


def run(res: int, size: int, views: int, dev: torch.device):
    """The bench at ``res``³ with ``views`` views of ``size``²: returns the
    JSON line's dict and a report (the rows of ``tools/_timing.py:Timer``,
    the match count, the mesh sizes)."""
    cmesh, vmask, lmesh, lmask = scene(res, dev)
    log(f"# verts canon={int(cmesh['n_verts'])} "
        f"live={int(lmesh['n_verts'])}; {device_label(dev)}")
    cnn = CnnCorrespondence(image_size=size, n_views=views, device=dev)
    fmask = (torch.arange(cmesh["faces"].shape[0], device=dev)
             < cmesh["n_faces"])
    timer = Timer(dev, REPS)

    def describe():
        return cnn.compute_correspondence(cmesh["verts"], cmesh["faces"],
                                          fmask, vmask)

    cover = {}
    with contextlib.redirect_stdout(sys.stderr):
        for vb, S in ROWS:
            cnn.view_batch, cnn.samples = vb, S
            _, cnt = describe()
            cover[vb, S] = float(torch.sum((cnt > 0) & vmask)
                                 / torch.sum(vmask))
            timer(f"descriptors B={vb} S={S}", describe,
                  coverage=cover[vb, S])
        # the (8, 4) call's parts, each timed alone on the same inputs
        reg = regularize_verts(cmesh["verts"], vmask)

        def render():
            return render_views(reg, cmesh["faces"], fmask, cnn.mvps,
                                cnn.znear, cnn.zfar, size, size,
                                cnn.samples)

        ids, depth8 = render()
        feats = network(cnn.model, cnn.params, depth8, cnn.view_batch)
        timer("renders", render)
        timer("network", lambda: network(cnn.model, cnn.params, depth8,
                                          cnn.view_batch))
        timer("scatter", lambda: scatter(ids, feats, vmask.shape[0]))
        timer("match", lambda: cnn.match(cmesh, lmesh, vmask, lmask))
    n_matched = int(torch.sum(cnn.match(cmesh, lmesh, vmask, lmask)[1]))
    log(f"# coverage (B, S): {cover}; match: n_matched={n_matched}")
    ms = {k: r["wall_ms"] for k, r in timer.rows.items()}
    line = {
        "metric": f"cnn_setup_corr_{size}",
        "value": ms["match"],
        "unit": "ms",
        "descriptors_ms_b1_s8": ms["descriptors B=1 S=8"],
        "descriptors_ms_s8": ms["descriptors B=8 S=8"],
        "descriptors_ms_s4": ms["descriptors B=8 S=4"],
        "descriptors_ms_s2": ms["descriptors B=8 S=2"],
        "coverage_s8": cover[8, 8],
        "coverage_s4": cover[8, 4],
        "coverage_s2": cover[8, 2],
        "speedup_vs_round4": (ms["descriptors B=1 S=8"]
                              / max(ms["descriptors B=8 S=4"], 1e-9)),
    }
    report = dict(rows=timer.rows, n_matched=n_matched,
                  n_canon=int(cmesh["n_verts"]),
                  n_live=int(lmesh["n_verts"]))
    return line, report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=256,
                    help="volume resolution, a multiple of 16 (default 256)")
    ap.add_argument("--size", type=int, default=512,
                    help="render size, a multiple of 32 (default 512)")
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.res < 32 or args.res % 16:
        ap.error("--res must be a multiple of 16, at least 32")
    if args.size < 32 or args.size % 32:
        ap.error("--size must be a multiple of 32")
    dev = resolve_device(args.device)
    line, report = run(args.res, args.size, args.views, dev)
    print(json.dumps(line), flush=True)
    return line, report


if __name__ == "__main__":
    main()
