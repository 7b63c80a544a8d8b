"""The 512³ bench: full non-rigid frames through the multi-dispatch
``Fusion`` driver — the port of the repository's ``benchmarks/bench512.py``.

Call for call as ``benchmarks/bench512.py:36-70``: four bumpy spheres of
``tools/_scene.py:bumpy_sdf`` (centres (256+2i, 256+i, 256), radius 140,
bump amplitude 8, frequency 3, phase 0.1·i), tdist the first volume's
largest value, all four uploaded before timing, ``Fusion(subsample_rate=3,
knn=3, marching_cubes_step_size=4, write_warpfield=False, node_cap=8192,
vert_cap=2^17, face_cap=2^18)``, and per frame
``setupCorrespondences(method="clpts", tolerance=10, live_mc_step=2)`` →
``solve(regularization_weight=0.5, method="clpts")`` → ``updateTSDF()`` →
``update_graph()`` → a device sync. The metric is the median over frames
2-3 (frame 1 is kept out, as the JAX bench keeps out its compiles).

Each phase ends with a device sync, so the split on the ``#`` lines
(standard error) is of synced walls: setup (``Fusion``'s construction,
of which ``construct_graph`` is printed apart), then per frame
correspondences, solve, update and graph. The peak device memory, the K1
and K2 launches and the card's name and power limit are printed there
too. The last line of standard output is the JAX bench's
``{"metric": "frame_ms_512", ...}``.

``--fused`` runs one fused frame instead (``pipeline/frame.py:
fusion_frame(allow_large=True)``, the bench's settings: k = 3, canonical
MC at stride 4, live at stride 2, ``Fusion``'s caps, 3 relaxation rounds
of gn 8 / cg 32, fresh correspondences every round), after
``init_canonical`` on the first volume, and prints its wall and peak
memory, or the allocation that failed.

``--res`` (for tests on the CPU) scales the centres, radius and bump
amplitude by res/512, and the caps with the surface, (res/512)², as the
lattice overrides of the port's ``suite`` do; the metric keeps its name.

    python -m dynamicfusion_body_tpu_torch.benchmarks.bench512
    python -m dynamicfusion_body_tpu_torch.benchmarks.bench512 --fused
    python -m dynamicfusion_body_tpu_torch.benchmarks.bench512 \\
        --res 64 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..ops.mc_cuda import mc_case_cross
from ..ops.trilerp_cuda import warp_trilerp_bricks_cached
from ..pipeline.fusion import Fusion, resolve_device
from ..tools._scene import bumpy_sdf
from ..tools._timing import device_label

RES = 512
N_VOLS = 4
DRIVER = dict(subsample_rate=3.0, knn=3, marching_cubes_step_size=4,
              write_warpfield=False)
CAPS = dict(node_cap=8192, vert_cap=1 << 17, face_cap=1 << 18)
FRAME = dict(method="clpts", tolerance=10.0, live_mc_step=2)
SOLVE = dict(regularization_weight=0.5, method="clpts")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def caps(res: int) -> dict:
    """``Fusion``'s caps at ``res``: 512³'s scaled with the surface."""
    s = (res / RES) ** 2
    return {k: max(int(v * s), 256 if k == "node_cap" else 2048)
            for k, v in CAPS.items()}


def volumes(res: int = RES):
    """The four host volumes of ``benchmarks/bench512.py:43-47`` at
    ``res`` (centres, radius and amplitude scaled by res/512)."""
    s = res / RES
    return [bumpy_sdf(res, ((256 + 2 * i) * s, (256 + i) * s, 256 * s),
                      140.0 * s, 8.0 * s, 3.0, 0.1 * i)
            for i in range(N_VOLS)]


class TimedFusion(Fusion):
    """``Fusion`` that records the synced wall of ``construct_graph``."""

    graph_s = 0.0

    def construct_graph(self):
        t0 = time.perf_counter()
        super().construct_graph()
        _sync(self.device)
        self.graph_s = time.perf_counter() - t0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(res: int = RES, dev=None, n_frames: int = N_VOLS - 1):
    """Build ``Fusion`` on volume 0 and run ``n_frames`` frames on volumes
    1.. (at most 3). Returns a namespace with ``result`` (the JSON line),
    ``fus``, ``vols`` (the four volumes on the device), ``frames`` (per
    frame the phase walls in s), ``walls``, ``setup_s``, ``graph_s``,
    ``peak_gib`` and ``launches`` (K1, K2 over the frames)."""
    dev = resolve_device("cuda" if dev is None else dev)
    cuda = dev.type == "cuda"
    log(f"# device: {device_label(dev)}")
    host = volumes(res)
    tdist = float(host[0].max())
    vols = [torch.from_numpy(v).to(dev) for v in host]
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fus = TimedFusion(vols[0], tdist, device=dev, **DRIVER, **caps(res))
    _sync(dev)
    setup_s = time.perf_counter() - t0
    log(f"# setup {setup_s:.3f} s, of which construct_graph "
        f"{fus.graph_s:.3f} s: nodes {int(fus._warp.num_active)}, radius "
        f"{fus._radius:.4f}")

    k1, k2 = mc_case_cross.launches, warp_trilerp_bricks_cached.launches
    frames, walls = [], []
    for i, vol in enumerate(vols[1:1 + n_frames], 1):
        ph = {}
        t_frame = t = time.perf_counter()
        for name, call in (
                ("correspondences",
                 lambda vol=vol: fus.setupCorrespondences(vol, **FRAME)),
                ("solve", lambda: fus.solve(**SOLVE)),
                ("update", fus.updateTSDF),
                ("graph", fus.update_graph)):
            call()
            _sync(dev)
            now = time.perf_counter()
            ph[name] = now - t
            t = now
        wall = time.perf_counter() - t_frame
        frames.append(ph)
        walls.append(wall)
        log(f"# frame {i}: {wall:.3f} s (" + ", ".join(
            f"{k} {v:.3f} s" for k, v in ph.items())
            + f"); nodes {int(fus._warp.num_active)}")
    launches = (mc_case_cross.launches - k1,
                warp_trilerp_bricks_cached.launches - k2)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    log("# peak device memory "
        + (f"{peak:.2f} GiB" if cuda else "not measured (cpu)")
        + f"; launches K1 {launches[0]} K2 {launches[1]}")
    if cuda and not all(launches):
        raise RuntimeError(f"bench512: a kernel of the frame never launched "
                           f"(K1, K2: {launches})")
    timed = walls[1:] if len(walls) > 1 else walls
    result = {"metric": "frame_ms_512",
              "value": round(float(np.median(timed) * 1000), 1),
              "unit": "ms/frame"}
    return SimpleNamespace(result=result, fus=fus, vols=vols, frames=frames,
                           walls=walls, setup_s=setup_s,
                           graph_s=fus.graph_s, peak_gib=peak,
                           launches=launches)


def run_fused(res: int = RES, dev=None, vols=None):
    """One ``fusion_frame(allow_large=True)`` at ``res``³ with the bench's
    settings, after ``init_canonical`` on volume 0, on volume 1 (``vols``:
    the volumes already on the device, else made here). Returns a
    namespace with ``ok``, ``wall_s``, ``init_s``, ``peak_gib``, ``stats``
    and, on an out-of-memory error, ``error`` (its message)."""
    from ..pipeline.frame import fusion_frame, init_canonical

    dev = resolve_device("cuda" if dev is None else dev)
    cuda = dev.type == "cuda"
    log(f"# device: {device_label(dev)}")
    if vols is None:
        vols = [torch.from_numpy(v).to(dev) for v in volumes(res)[:2]]
    values, live = vols[:2]
    tdist = float(values.max())
    c = caps(res)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    wf, _ = init_canonical(values, subsample_rate=DRIVER["subsample_rate"],
                           node_cap=c["node_cap"], vert_cap=c["vert_cap"],
                           face_cap=c["face_cap"], mc_step=4)
    _sync(dev)
    init_s = time.perf_counter() - t0
    lw = torch.tensor([1, 0, 0, 0, 0, 0.1, 0, 0], dtype=torch.float32,
                      device=dev)
    out = SimpleNamespace(ok=False, init_s=init_s, wall_s=None, stats=None,
                          error=None, peak_gib=None)
    t0 = time.perf_counter()
    try:
        res_ = fusion_frame(
            values, torch.zeros_like(values), live, wf, lw, 0.5, knn_k=3,
            tdist=tdist, vert_cap=c["vert_cap"], face_cap=c["face_cap"],
            mc_step=4, live_mc_step=2, solve_iters=3, gn_iters=8,
            cg_iters=32, tolerance=10.0, use_kernels=cuda, reuse_corr=False,
            allow_large=True)
        _sync(dev)
        out.ok, out.stats = True, res_[4]
        out.wall_s = time.perf_counter() - t0
    except torch.OutOfMemoryError as exc:
        out.error = str(exc).splitlines()[0]
    if cuda:
        out.peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    peak = ("not measured (cpu)" if out.peak_gib is None
            else f"{out.peak_gib:.2f} GiB")
    if out.ok:
        st = out.stats
        log(f"# fused frame {res}^3: init_canonical {init_s:.3f} s, frame "
            f"{out.wall_s:.3f} s, peak device memory {peak}; n_corr "
            f"{int(st.n_corr)} nodes {int(st.n_nodes)} cost "
            f"{float(st.cost_before_h[0]):.3f} -> "
            f"{float(st.cost_after[st.cost_after > 0][-1]):.3f}")
    else:
        log(f"# fused frame {res}^3: out of memory after init_canonical "
            f"({init_s:.3f} s), peak device memory {peak}: {out.error}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=RES,
                    help="volume resolution, a multiple of 32 (default "
                         "512; smaller sizes are for tests)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "twins run")
    ap.add_argument("--fused", action="store_true",
                    help="run one fused frame (fusion_frame) instead")
    args = ap.parse_args(argv)
    if args.res < 32 or args.res % 32:
        ap.error("--res must be a multiple of 32, at least 32")
    dev = resolve_device(args.device)
    if args.fused:
        out = run_fused(args.res, dev)
        print(json.dumps({"fused_frame_ok": out.ok, "wall_s": out.wall_s,
                          "peak_gib": out.peak_gib, "error": out.error}))
        return out
    report = run(args.res, dev)
    print(json.dumps(report.result), flush=True)
    return report


if __name__ == "__main__":
    main()
