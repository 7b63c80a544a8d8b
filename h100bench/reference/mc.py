"""Plain marching cubes: the mesh that a volume's zero set should give.

The output order is the one the program documents for its meshes: one
vertex per lattice edge whose end points lie on different sides of the
level (inside = value < level), in ascending edge id (axis·XYZ + flat
index of the edge's low voxel), at the linear crossing; then, cell by
cell in ascending flat index, the triangles of the cell's case in table
order, each corner the rank of its edge among the crossing edges. So two
correct extractions of one volume agree vertex for vertex and face for
face. Normals are the normalized negative gradient (central differences,
one-sided at the borders), interpolated along each vertex's edge.

Everything is plain PyTorch on the volume's device; ``dtype`` sets the
precision of the arithmetic (the control runs it in bfloat16).
"""

from __future__ import annotations

import functools

import torch

from .mc_tables import build_tables


@functools.cache
def _tables_np():
    return build_tables()


def _tables(dev):
    t = _tables_np()
    tri = torch.as_tensor(t["TRI_TABLE"].reshape(256, 15), device=dev).long()
    cnt = torch.as_tensor(t["TRI_COUNT"], device=dev).long()
    base = torch.as_tensor(t["EDGE_BASE"], device=dev).long()
    off = torch.stack([base & 1, (base >> 1) & 1, (base >> 2) & 1,
                       torch.as_tensor(t["EDGE_AXIS"], device=dev).long()], 1)
    return tri, cnt, off


def _gradient(vol, axis):
    """Central differences along ``axis``, one-sided at the two ends."""
    n = vol.shape[axis]
    g = torch.empty_like(vol)
    mid = (vol.narrow(axis, 2, n - 2) - vol.narrow(axis, 0, n - 2)) / 2
    g.narrow(axis, 1, n - 2).copy_(mid)
    g.narrow(axis, 0, 1).copy_(vol.narrow(axis, 1, 1) - vol.narrow(axis, 0, 1))
    g.narrow(axis, n - 1, 1).copy_(vol.narrow(axis, n - 1, 1)
                                   - vol.narrow(axis, n - 2, 1))
    return g


def marching_cubes(vol, level: float = 0.0, step: int = 1,
                   with_normals: bool = True, dtype=torch.float32):
    """Mesh of ``vol`` (X,Y,Z) sampled every ``step`` voxels. Returns
    {verts (n,3), normals (n,3) or None, faces (m,3) int64} in lattice
    coordinates of the full volume, uncapped."""
    if step > 1:
        vol = vol[::step, ::step, ::step]
    vol = vol.to(dtype).contiguous()
    dev = vol.device
    X, Y, Z = vol.shape
    n = X * Y * Z
    ins = vol < level
    flat = ins.reshape(-1)
    strides = (Y * Z, Z, 1)
    masks = []
    for axis, s in enumerate(strides):
        m = torch.zeros((X, Y, Z), dtype=torch.bool, device=dev)
        sl = [slice(None)] * 3
        sl[axis] = slice(0, vol.shape[axis] - 1)
        hi = [slice(None)] * 3
        hi[axis] = slice(1, None)
        m[tuple(sl)] = ins[tuple(sl)] != ins[tuple(hi)]
        masks.append(m.reshape(-1))
    edges = torch.nonzero(torch.cat(masks)).flatten()      # ascending ids
    axis = edges // n
    lo = edges % n
    step_of = torch.tensor(strides, device=dev)[axis]
    hi = lo + step_of
    vf = vol.reshape(-1)
    vlo, vhi = vf[lo], vf[hi]
    denom = vlo - vhi
    et = torch.where(torch.abs(denom) > 1e-30, (vlo - level) / denom,
                     torch.full_like(denom, 0.5))
    ijk = torch.stack([lo // (Y * Z), (lo // Z) % Y, lo % Z], 1).to(dtype)
    verts = ijk + torch.nn.functional.one_hot(axis, 3).to(dtype) * et[:, None]
    verts = verts * step
    normals = None
    if with_normals:
        comps = []
        for a in range(3):
            g = _gradient(vol, a).reshape(-1)
            g0, g1 = g[lo], g[hi]
            comps.append(g0 + et * (g1 - g0))
        nrm = -torch.stack(comps, 1)
        nn = torch.linalg.vector_norm(nrm.float(), dim=1, keepdim=True)
        normals = (nrm.float() / torch.clamp_min(nn, 1e-20)).to(dtype)

    tri, cnt, off = _tables(dev)
    case = torch.zeros((X - 1, Y - 1, Z - 1), dtype=torch.long, device=dev)
    for b in range(8):
        dx, dy, dz = b & 1, (b >> 1) & 1, (b >> 2) & 1
        case |= ins[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz].long() << b
    ntri = cnt[case.reshape(-1)]
    cells_c = torch.nonzero(ntri).flatten()                 # compact index
    counts = ntri[cells_c]
    ci = cells_c // ((Y - 1) * (Z - 1))
    cj = (cells_c // (Z - 1)) % (Y - 1)
    ck = cells_c % (Z - 1)
    cell_case = case.reshape(-1)[cells_c]
    face_cell = torch.repeat_interleave(torch.arange(cells_c.numel(),
                                                     device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(face_cell.numel(), device=dev) - first[face_cell]
    row = tri[cell_case[face_cell]]
    cols = []
    for c in range(3):
        le = torch.gather(row, 1, (slot * 3 + c)[:, None])[:, 0]
        o = off[le]
        eid = (o[:, 3] * n + ((ci[face_cell] + o[:, 0]) * Y
                              + cj[face_cell] + o[:, 1]) * Z
               + ck[face_cell] + o[:, 2])
        cols.append(torch.searchsorted(edges, eid))
    faces = torch.stack(cols, 1)
    return {"verts": verts, "normals": normals, "faces": faces}


def compare(prog_verts, prog_normals, prog_faces, ref) -> dict:
    """The gaps between a program's mesh (its valid rows, as tensors on
    any device) and :func:`marching_cubes`'s: the widest vertex distance
    and the widest normal difference. A mesh with another vertex or face
    count, or any face that differs, is another surface: its gaps are
    infinite."""
    rv, rf = ref["verts"].float(), ref["faces"]
    inf = {"mesh_vertex_gap": float("inf")}
    if prog_normals is not None:
        inf["mesh_normal_gap"] = float("inf")
    if prog_verts.shape[0] != rv.shape[0] or prog_faces.shape[0] != rf.shape[0]:
        return inf
    if bool(torch.any(prog_faces.to(rf.device).long() != rf)):
        return inf
    if not rv.numel():
        return {k: 0.0 for k in inf}
    out = {"mesh_vertex_gap": float(torch.max(torch.abs(
        prog_verts.to(rv.device).float() - rv)))}
    if prog_normals is not None:
        out["mesh_normal_gap"] = float(torch.max(torch.abs(
            prog_normals.to(rv.device).float() - ref["normals"].float())))
    return out
