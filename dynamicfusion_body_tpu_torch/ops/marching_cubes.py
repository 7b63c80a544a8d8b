"""Marching cubes with fixed-capacity outputs — counterpart of
``dynamicfusion_body_tpu/ops/marching_cubes.py:marching_cubes``.

The front end is K1 (``ops/mc_cuda.py``): one int32 per lattice cell
holding the case byte and the three edge-crossing flags. From there:

* every crossing lattice edge owns one vertex (linear interpolation of
  the zero crossing), numbered in ascending edge-id order, edge id =
  axis·XYZ + (i·Y + j)·Z + k — row-major ``nonzero`` keeps that order;
* cells emit ``TRI_COUNT[case]`` triangles each, in ascending cell order;
  a face's vertex index is the rank of its edge among the crossing edges
  (``searchsorted`` on the sorted edge list).

The JAX package reaches the same numbering through static-shape
workarounds for the TPU (one-hot matmul table lookups, a hierarchical
prefix sum and binary-search compaction); here they are direct gathers,
``nonzero`` and ``repeat_interleave``.

Normals follow skimage's default ``gradient_direction='descent'``: the
normalized negative gradient at each vertex, a 2-tap lerp of the edge
endpoints' central-difference gradients.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.profiling import host_read, span, traced
from . import mc_tables
from .mc_cuda import mc_case_cross, mc_case_cross_ref


INT32_MAX = 2**31 - 1


def index_dtype(n: int) -> torch.dtype:
    """int32 where every index below ``n`` fits (n <= 2^31 - 1), else
    int64."""
    return torch.int32 if n <= INT32_MAX else torch.int64


def index_widths(shape, vert_cap: int, face_cap: int):
    """(the width of the faces stage's cells and edge ids on an (X,Y,Z)
    lattice, the width of the faces, face positions and counts): a pure
    function of the shape and the caps."""
    X, Y, Z = shape
    return index_dtype(3 * X * Y * Z), index_dtype(max(vert_cap, face_cap))


@functools.cache
def _tables(device: torch.device):
    """(TRI_TABLE flat (256·15,), TRI_COUNT (256,)) as int32 tensors on
    ``device``."""
    tri = torch.as_tensor(mc_tables.TRI_TABLE.reshape(-1))
    return tri.to(device), torch.as_tensor(mc_tables.TRI_COUNT).to(device)


@functools.cache
def _edge_delta(device: torch.device, shape, dtype):
    """(12,) ``dtype`` on ``device``: each cube edge's id less its cell's
    flat index on an (X,Y,Z) lattice, axis·XYZ + dx·YZ + dy·Z + dz of the
    edge's base corner."""
    X, Y, Z = shape
    base = mc_tables.EDGE_BASE.astype(np.int64)
    delta = (mc_tables.EDGE_AXIS.astype(np.int64) * (X * Y * Z)
             + (base & 1) * (Y * Z) + ((base >> 1) & 1) * Z + ((base >> 2) & 1))
    return torch.as_tensor(delta).to(device=device, dtype=dtype)


def _pad_to(x, cap):
    """First ``cap`` entries of ``x`` (dim 0), zero-padded to ``cap``."""
    out = x.new_zeros((cap,) + tuple(x.shape[1:]))
    n = min(cap, x.shape[0])
    out[:n] = x[:n]
    return out


@traced("marching_cubes")
def marching_cubes(
    vol: torch.Tensor,
    level: float = 0.0,
    vert_cap: int = 65536,
    face_cap: int = 131072,
    step_size: int = 1,
    with_normals: bool = True,
    use_kernels: bool = False,
    cell_x_lo=None,
    cell_x_hi=None,
    x_index_offset: int = 0,
):
    """Extract the ``level`` isosurface of ``vol`` (X,Y,Z).

    Returns a dict:
      verts   (vert_cap, 3) f32 lattice coordinates (scaled by step_size)
      normals (vert_cap, 3) f32 normalized -gradient (zeros when
              ``with_normals=False``)
      values  (vert_cap,)  f32 ``level`` at valid slots
      faces   (face_cap, 3) int32 vertex indices (int64 only when a cap
              is 2^31 or more), as the JAX contract
      n_verts, n_faces  0-d, faces' dtype, saturated at capacity
      overflow          0-d bool: the surface exceeded vert_cap or
                        face_cap (faces touching a dropped vertex are
                        zeroed)
      edge_axis, edge_x (vert_cap,) int64: each vertex's lattice edge,
                        its axis and its x index (after x_index_offset),
                        which the sharded extraction reads to mark its
                        seam copies (``parallel/mc_sharded.py``)
    Slots >= count are zero.

    ``use_kernels`` (the JAX ``use_pallas``): front end through the K1
    wrapper (kernel on CUDA tensors, twin on CPU ones) instead of the
    twin directly.

    ``cell_x_lo``/``cell_x_hi`` (ints): the x-slab a sharded extraction
    owns. Only cells with x in [lo, hi) emit triangles, only x-edges
    with base x in [lo, hi) and y/z-edges with base x in [lo, hi] emit
    vertices: the edges the owned cells reference. ``vol`` is then the
    slab with its halo planes, which the normals' gradient reads.
    ``x_index_offset`` is added to each vertex's integer x index before
    the interpolation fraction, so that slabs give the whole volume's
    coordinates bit for bit.

    Spans: ``case_cross`` (K1), ``vertices``, ``faces``, ``normals`` and
    ``pack`` (the masking and padding over the caps, and the counts).
    """
    if step_size > 1:
        vol = vol[::step_size, ::step_size, ::step_size]
    dev = vol.device
    with span("case_cross"):
        fused = (mc_case_cross if use_kernels else mc_case_cross_ref)(
            vol, level)
        fused = fused.reshape(-1)
        if cell_x_lo is not None:
            fused = _own_slab(fused, vol.shape[0], cell_x_lo, cell_x_hi)
    with span("vertices"):
        edges, elin, lin1, et, verts = mc_vertices(vol, fused, level,
                                                   vert_cap, x_index_offset)
    n_verts = edges.numel()
    vmask = torch.arange(vert_cap, device=dev) < n_verts
    with span("faces"):
        faces, n_faces = mc_faces(fused, edges, vol.shape, face_cap,
                                  vert_cap)
    nf = min(n_faces, face_cap)
    with span("normals"):
        if with_normals:
            normals = mc_normals(vol, elin, lin1, et)
        else:
            normals = torch.zeros((vert_cap, 3), dtype=torch.float32,
                                  device=dev)

    with span("pack"):
        if step_size > 1:
            verts = verts * step_size
        verts = torch.where(vmask[:, None], verts, 0.0)
        normals = torch.where(vmask[:, None], normals, 0.0)
        values = torch.where(vmask, torch.full_like(et, float(level)), 0.0)
        ev = _pad_to(edges, vert_cap)
        nyz = vol.shape[1] * vol.shape[2]
        edge_axis = torch.where(vmask, ev // (vol.shape[0] * nyz), 0)
        edge_x = torch.where(vmask, elin // nyz + x_index_offset, 0)
        # the counts are copied from host memory: each copy waits
        counts = []
        for c, dt in ((min(n_verts, vert_cap), faces.dtype),
                      (nf, faces.dtype),
                      (n_verts > vert_cap or n_faces > face_cap, torch.bool)):
            with host_read():
                counts.append(torch.tensor(c, dtype=dt, device=dev))
    return {
        "verts": verts,
        "normals": normals,
        "values": values,
        "faces": faces,
        "n_verts": counts[0],
        "n_faces": counts[1],
        "overflow": counts[2],
        "edge_axis": edge_axis,
        "edge_x": edge_x,
    }


def _own_slab(fused, X: int, lo: int, hi: int):
    """The K1 words ``fused`` (flat) with everything outside the owned
    slab cleared: case bytes and x-edge flags outside x in [lo, hi),
    y/z-edge flags outside x in [lo, hi]."""
    ix = torch.arange(X, device=fused.device)
    keep = (torch.where((ix >= lo) & (ix < hi), 0x1FF, 0)
            | torch.where((ix >= lo) & (ix <= hi), 0x600, 0))
    return (fused.reshape(X, -1) & keep[:, None].to(fused.dtype)).reshape(-1)


def crossing_edges(fused):
    """The sorted ids of the crossing lattice edges of the K1 words
    ``fused`` (flat): ``nonzero`` of the x, y and z flag planes in turn."""
    flat_mask = torch.cat([((fused >> (8 + a)) & 1).bool() for a in range(3)])
    with host_read():
        return torch.nonzero(flat_mask).flatten()


def mc_vertices(vol, fused, level: float, vert_cap: int,
                x_index_offset: int = 0):
    """The vertex stage: one vertex per crossing lattice edge of the K1
    words ``fused`` (flat), in ascending edge id, at the linear zero
    crossing (x index shifted by ``x_index_offset``). Returns (edges
    (sorted crossing edge ids, all of them), elin, lin1 (the edges' low
    and high lattice voxels), et (crossing fraction), verts (vert_cap,
    3)), the last four padded or cut to ``vert_cap``."""
    X, Y, Z = vol.shape
    nxyz = X * Y * Z
    edges = crossing_edges(fused)
    ev = _pad_to(edges, vert_cap)
    ea = ev // nxyz
    elin = ev % nxyz
    ei = elin // (Y * Z)
    ej = (elin // Z) % Y
    ek = elin % Z
    vol_flat = vol.reshape(-1)
    stride = torch.where(ea == 0, Y * Z, torch.where(ea == 1, Z, 1))
    lin1 = torch.clamp_max(elin + stride, nxyz - 1)
    vlo = vol_flat[elin]
    vhi = vol_flat[lin1]
    denom = vlo - vhi
    et = torch.where(torch.abs(denom) > 1e-30, (vlo - level) / denom,
                     torch.full_like(denom, 0.5))
    zero = torch.zeros_like(et)
    verts = torch.stack([
        (ei + x_index_offset).float() + torch.where(ea == 0, et, zero),
        ej.float() + torch.where(ea == 1, et, zero),
        ek.float() + torch.where(ea == 2, et, zero),
    ], dim=-1)
    return edges, elin, lin1, et, verts


def emitting_cells(case, dtype):
    """(the cells whose ``case`` emits triangles, as ``dtype``; their
    int32 triangle counts, ``TRI_COUNT[case]``)."""
    ntris = _tables(case.device)[1].index_select(0, case)
    with host_read():
        cells = torch.nonzero(ntris).flatten().to(dtype)
    return cells, ntris.index_select(0, cells)


def mc_faces(fused, edges, shape, face_cap: int, vert_cap: int):
    """The face stage: ``TRI_COUNT[case]`` triangles per cell in ascending
    cell id; a corner's vertex is its edge's rank among ``edges``. Faces
    touching a vertex beyond ``vert_cap`` are zeroed. Returns (faces
    (face_cap, 3) int32, or int64 when a cap is 2^31 or more, the
    uncapped face count).

    A corner's edge id is its cell's flat index plus the edge's delta
    (``_edge_delta``). The widths are ``index_widths``'s: int32 on every
    lattice of the repo, 512³ included (3·X·Y·Z <= 2^31 - 1). Each corner
    reads its one ``TRI_TABLE`` entry, at case·15 + slot·3 + corner."""
    dev = fused.device
    ew, fw = index_widths(shape, vert_cap, face_cap)
    tri_flat = _tables(dev)[0]
    case = fused & 255
    cells, counts = emitting_cells(case, ew)
    with host_read():
        n_faces = int(counts.sum())
    nf = min(n_faces, face_cap)
    # without an output size, repeat_interleave reads its size and checks
    # the repeats' sign on the host: two waits
    with host_read(2):
        cell_of_face = torch.repeat_interleave(cells, counts)[:nf]
    # a cell's first face, exact below face_cap (the only ones kept)
    starts = torch.clamp_max(torch.cumsum(counts, 0) - counts,
                             face_cap).to(fw)
    first = torch.arange(nf, dtype=fw, device=dev)
    with host_read(2):
        slot = first - torch.repeat_interleave(starts, counts)[:nf]
    row = case.index_select(0, cell_of_face) * 15 + slot * 3
    corner = torch.arange(3, dtype=row.dtype, device=dev)
    el = tri_flat.index_select(0, (row[:, None] + corner).reshape(-1))
    eid = (cell_of_face[:, None]
           + _edge_delta(dev, tuple(shape), ew).index_select(0, el)
           .reshape(nf, 3))
    faces = torch.searchsorted(edges.to(ew), eid, out_int32=ew == torch.int32)
    face_ok = torch.all(faces < vert_cap, dim=-1, keepdim=True)
    return _pad_to(torch.where(face_ok, faces, 0).to(fw), face_cap), n_faces


def mc_normals(vol, elin, lin1, et):
    """The normal stage: the normalized negative gradient at each vertex,
    a 2-tap lerp of its edge's endpoint central-difference gradients."""
    comps = []
    for g in torch.gradient(vol):
        gf = g.reshape(-1)
        g0 = gf[elin]
        g1 = gf[lin1]
        comps.append(g0 + et * (g1 - g0))
    nrm = -torch.stack(comps, dim=-1)
    nn = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    return nrm / torch.clamp_min(nn, 1e-20)
