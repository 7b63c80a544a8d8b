"""Cumulative timing of marching cubes' stages at the LIVE caps (2^17
vertices, 2^18 faces) on the 256³ bench canonical — the port of
``tools/profile_mc2.py``, which isolates the cap-sized costs.

Each row runs the extraction of ``ops/marching_cubes.py`` up to and
including one stage (a smaller ``--res`` scales the sphere and the caps
with the surface):

* ``upto_case_cross``: K1 (``mc_case_cross``) alone;
* ``upto_edges``: + the crossing edges, ``nonzero`` of the three flag
  planes (sorted edge ids);
* ``upto_verts``: + their zero crossings (the vertex stage,
  ``mc_vertices``);
* ``upto_ntris``: + the triangles per cell (``TRI_COUNT`` of the case
  bytes) and the cells that emit any;
* ``upto_faces``: + the faces, each corner's vertex ranked by
  ``searchsorted`` among the crossing edges (``mc_faces``);
* ``upto_normals``: the whole extraction (``marching_cubes`` with
  normals).

The JAX rows ``upto_ranks``, ``upto_franks``, ``upto_f_unrank`` and
``upto_f_meta`` time the TPU's rank/unrank compaction (hierarchical
prefix sums, binary-search unranking and per-face metadata), which the
port replaced with ``nonzero``, ``repeat_interleave`` and
``searchsorted``; they have no counterpart and no row.

Rows report the median synced wall, the CUDA-event mean, a bound (the
bytes each cumulative prefix must move: the volume and K1's words once,
each stage's outputs written once, over 3.35 TB/s) and its share
(``tools/_timing.py:Timer``); every stage after K1 reads a count on the
host, so only K1's row can be captured in a CUDA graph.

    python -m dynamicfusion_body_tpu_torch.tools.profile_mc2
    python -m dynamicfusion_body_tpu_torch.tools.profile_mc2 \\
        --device cpu --res 32 --reps 1
"""

from __future__ import annotations

import torch

from ..ops.marching_cubes import (
    crossing_edges, emitting_cells, index_widths, marching_cubes, mc_faces,
    mc_vertices)
from ..ops.mc_cuda import mc_case_cross
from ..pipeline.fusion import resolve_device
from ._scene import bumpy, cap
from ._timing import Timer, bound, device_label, parse_args

LEVEL = 0.0


def upto(stage: str, vol, vert_cap: int, face_cap: int):
    """The extraction of ``vol`` up to and including ``stage``."""
    if stage == "normals":
        return marching_cubes(vol, LEVEL, vert_cap=vert_cap,
                              face_cap=face_cap, use_kernels=True)
    fused = mc_case_cross(vol, LEVEL).reshape(-1)
    if stage == "case_cross":
        return fused
    if stage == "edges":
        return crossing_edges(fused)
    edges, *_, verts = mc_vertices(vol, fused, LEVEL, vert_cap)
    if stage == "verts":
        return verts
    if stage == "ntris":
        return verts, emitting_cells(
            fused & 255, index_widths(vol.shape, vert_cap, face_cap)[0])
    return verts, mc_faces(fused, edges, vol.shape, face_cap, vert_cap)


STAGES = ("case_cross", "edges", "verts", "ntris", "faces", "normals")


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=8)
    dev = resolve_device(args.device)
    vol = torch.from_numpy(bumpy(args.res, (128, 128, 128), 0.0)).to(dev)
    vert_cap = cap(1 << 17, args.res)
    face_cap = cap(1 << 18, args.res, 4096)
    m = marching_cubes(vol, LEVEL, vert_cap=vert_cap, face_cap=face_cap,
                       use_kernels=True)
    nv, nf = int(m["n_verts"]), int(m["n_faces"])
    n = vol.numel()
    ncells = int(emitting_cells(
        mc_case_cross(vol, LEVEL).reshape(-1) & 255,
        index_widths(vol.shape, vert_cap, face_cap)[0])[0].numel())
    t = Timer(dev, args.reps, args.trace)
    print(f"# profile_mc2: {args.res}^3, verts {nv} faces {nf} (live caps "
          f"{vert_cap}/{face_cap}) on {device_label(dev)}; reps "
          f"{args.reps}", flush=True)
    # bytes of each cumulative prefix: the volume and K1's words, then
    # each stage's reads of them and its outputs
    nbytes = dict(case_cross=8 * n)
    nbytes["edges"] = nbytes["case_cross"] + 4 * n + 8 * nv
    nbytes["verts"] = nbytes["edges"] + 8 * nv + 12 * vert_cap
    nbytes["ntris"] = nbytes["verts"] + 4 * n + 8 * ncells
    nbytes["faces"] = nbytes["ntris"] + 4 * 3 * nf + 12 * face_cap
    nbytes["normals"] = nbytes["faces"] + 4 * n + 3 * 8 * nv + 12 * vert_cap
    for st in STAGES:
        t(f"upto_{st}", lambda st=st: upto(st, vol, vert_cap, face_cap),
          graph=st == "case_cross", **bound(nbytes[st], 0))
    return t.rows


if __name__ == "__main__":
    main()
