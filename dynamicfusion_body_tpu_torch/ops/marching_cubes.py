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

import torch

from . import mc_tables
from .mc_cuda import mc_case_cross, mc_case_cross_ref


@functools.cache
def _tables(device: torch.device):
    """(TRI_TABLE (256,15), TRI_COUNT (256,), edge offsets (12,4) =
    base-corner dx, dy, dz and axis) as int64 tensors on ``device``."""
    tri = torch.as_tensor(mc_tables.TRI_TABLE.reshape(256, 15)).long()
    cnt = torch.as_tensor(mc_tables.TRI_COUNT).long()
    base = torch.as_tensor(mc_tables.EDGE_BASE).long()
    off = torch.stack(
        [base & 1, (base >> 1) & 1, (base >> 2) & 1,
         torch.as_tensor(mc_tables.EDGE_AXIS).long()], dim=1)
    return tri.to(device), cnt.to(device), off.to(device)


def _pad_to(x, cap):
    """First ``cap`` entries of ``x`` (dim 0), zero-padded to ``cap``."""
    out = x.new_zeros((cap,) + tuple(x.shape[1:]))
    n = min(cap, x.shape[0])
    out[:n] = x[:n]
    return out


def marching_cubes(
    vol: torch.Tensor,
    level: float = 0.0,
    vert_cap: int = 65536,
    face_cap: int = 131072,
    step_size: int = 1,
    with_normals: bool = True,
    use_kernels: bool = False,
):
    """Extract the ``level`` isosurface of ``vol`` (X,Y,Z).

    Returns a dict:
      verts   (vert_cap, 3) f32 lattice coordinates (scaled by step_size)
      normals (vert_cap, 3) f32 normalized -gradient (zeros when
              ``with_normals=False``)
      values  (vert_cap,)  f32 ``level`` at valid slots
      faces   (face_cap, 3) int64 vertex indices
      n_verts, n_faces  0-d int64, saturated at capacity
      overflow          0-d bool: the surface exceeded vert_cap or
                        face_cap (faces touching a dropped vertex are
                        zeroed)
    Slots >= count are zero.

    ``use_kernels`` (the JAX ``use_pallas``): front end through the K1
    wrapper (kernel on CUDA tensors, twin on CPU ones) instead of the
    twin directly. The lattice-edge identity outputs the sharded
    extraction needs (``edge_axis``/``edge_x``) and its ``cell_x_lo``/
    ``x_index_offset`` arguments wait for the ``parallel/`` port.
    """
    if step_size > 1:
        vol = vol[::step_size, ::step_size, ::step_size]
    X, Y, Z = vol.shape
    nxyz = X * Y * Z
    dev = vol.device
    tri_table, tri_count, edge_off = _tables(dev)
    fused = (mc_case_cross if use_kernels else mc_case_cross_ref)(vol, level)
    fused = fused.reshape(-1)

    # ---- vertices: one per crossing edge, ascending edge id ------------
    flat_mask = torch.cat([((fused >> (8 + a)) & 1).bool() for a in range(3)])
    edges = torch.nonzero(flat_mask).flatten()      # sorted edge ids
    n_verts = edges.numel()
    ev = _pad_to(edges, vert_cap)
    vmask = torch.arange(vert_cap, device=dev) < n_verts
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
        ei.float() + torch.where(ea == 0, et, zero),
        ej.float() + torch.where(ea == 1, et, zero),
        ek.float() + torch.where(ea == 2, et, zero),
    ], dim=-1)

    # ---- faces: TRI_COUNT[case] per cell, ascending cell id -------------
    case = fused & 255
    ntris = tri_count[case]
    cells = torch.nonzero(ntris).flatten()
    counts = ntris[cells]
    n_faces = int(counts.sum())
    nf = min(n_faces, face_cap)
    cell_of_face = torch.repeat_interleave(cells, counts)[:nf]
    starts = torch.cumsum(counts, 0) - counts
    slot = (torch.arange(nf, device=dev)
            - torch.repeat_interleave(starts, counts)[:nf])
    ci = cell_of_face // (Y * Z)
    cj = (cell_of_face // Z) % Y
    ck = cell_of_face % Z
    row15 = tri_table[case[cell_of_face]]
    cols = []
    for c in range(3):
        el = torch.gather(row15, 1, (slot * 3 + c)[:, None])[:, 0]
        off = edge_off[el]
        eid = (off[:, 3] * nxyz
               + ((ci + off[:, 0]) * Y + cj + off[:, 1]) * Z + ck + off[:, 2])
        cols.append(torch.searchsorted(edges, eid))
    faces = torch.stack(cols, dim=-1)
    face_ok = torch.all(faces < vert_cap, dim=-1)
    faces = _pad_to(torch.where(face_ok[:, None], faces, 0), face_cap)

    # ---- normals ---------------------------------------------------------
    if with_normals:
        comps = []
        for g in torch.gradient(vol):
            gf = g.reshape(-1)
            g0 = gf[elin]
            g1 = gf[lin1]
            comps.append(g0 + et * (g1 - g0))
        nrm = -torch.stack(comps, dim=-1)
        nn = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
        normals = nrm / torch.clamp_min(nn, 1e-20)
    else:
        normals = torch.zeros((vert_cap, 3), dtype=torch.float32, device=dev)

    if step_size > 1:
        verts = verts * step_size
    verts = torch.where(vmask[:, None], verts, 0.0)
    normals = torch.where(vmask[:, None], normals, 0.0)
    values = torch.where(vmask, torch.full_like(et, float(level)), 0.0)
    return {
        "verts": verts,
        "normals": normals,
        "values": values,
        "faces": faces,
        "n_verts": torch.tensor(min(n_verts, vert_cap), device=dev),
        "n_faces": torch.tensor(nf, device=dev),
        "overflow": torch.tensor(n_verts > vert_cap or n_faces > face_cap,
                                 device=dev),
    }
