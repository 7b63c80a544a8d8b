"""Whole-array entry points of the sharded functions, for
:func:`.launch.run`: each takes the rank's :class:`~.mesh.Mesh` and whole
(unsharded) numpy inputs, runs the sharded function on this rank's part
(its x-slab of a volume, its block of V / world vertex rows) and returns
the whole outputs, the per-rank blocks all-gathered in rank order. A
warp field goes in and out as a dict of numpy arrays under the JAX field
names (``convert.warp_field_from_jax``/``warp_field_to_numpy``).

They are what the tests and the chip smoke run on several ranks; a
spawned rank imports this module by name, never a test file.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..convert import warp_field_from_jax, warp_field_to_numpy
from . import frame_sharded, mc_sharded, sharded
from .mesh import Mesh


def _t(mesh: Mesh, a):
    return torch.as_tensor(np.asarray(a), device=mesh.device)


def _rows(mesh: Mesh, a):
    """This rank's block of rows of a whole array (rows % world == 0)."""
    a = _t(mesh, a)
    n = a.shape[0] // mesh.world
    return a[mesh.rank * n:(mesh.rank + 1) * n]


def _sync(mesh: Mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def fuse_depth(mesh: Mesh, values, weights, depth, proj, kinv, tdist,
               wmax=100.0):
    """``sharded.fuse_depth_sharded`` → whole (values, weights)."""
    fuse = sharded.fuse_depth_sharded(mesh, tdist, wmax)
    v, w = fuse(_rows(mesh, values), _rows(mesh, weights), _t(mesh, depth),
                _t(mesh, proj), _t(mesh, kinv))
    return mesh.all_gather(v), mesh.all_gather(w)


def update_tsdf_rigid(mesh: Mesh, values, weights, live, lw_dq, tdist,
                      wmax=100.0):
    """``sharded.update_tsdf_rigid_sharded`` → whole (values, weights)."""
    upd = sharded.update_tsdf_rigid_sharded(mesh, tdist, wmax)
    v, w = upd(_rows(mesh, values), _rows(mesh, weights), _t(mesh, live),
               _t(mesh, lw_dq))
    return mesh.all_gather(v), mesh.all_gather(w)


def update_tsdf_nonrigid(mesh: Mesh, values, weights, live, wf, lw_dq, k,
                         tdist, wmax=100.0, brick=8, n_candidates=8):
    """``sharded.update_tsdf_nonrigid_sharded`` → whole (values, weights,
    esc_dropped, pool_risk)."""
    upd = sharded.update_tsdf_nonrigid_sharded(mesh, k, tdist, wmax, brick,
                                               n_candidates)
    v, w, esc, risk = upd(_rows(mesh, values), _rows(mesh, weights),
                          _t(mesh, live),
                          warp_field_from_jax(wf, device=mesh.device),
                          _t(mesh, lw_dq))
    return mesh.all_gather(v), mesh.all_gather(w), esc, risk


def solve_nonrigid(mesh: Mesh, node_dq, verts, normals, corrs, corr_mask,
                   nbr_idx, blend_wts, pair_i, pair_j, pair_v, pair_scale,
                   pair_mask, lw_dq, gn_iters=8, cg_iters=32):
    """``sharded.solve_nonrigid_sharded`` with the vertex arrays split into
    per-rank blocks → (node_dq, cost0_raw, cost0, cost1, dmp, ell_overflow),
    replicated."""
    solve = sharded.solve_nonrigid_sharded(mesh, gn_iters, cg_iters)
    vert_args = [_rows(mesh, a) for a in (verts, normals, corrs, corr_mask,
                                          nbr_idx, blend_wts)]
    vert_args[3] = vert_args[3].bool()
    vert_args[4] = vert_args[4].long()
    return solve(_t(mesh, node_dq), *vert_args, _t(mesh, pair_i).long(),
                 _t(mesh, pair_j).long(), _t(mesh, pair_v),
                 _t(mesh, pair_scale), _t(mesh, pair_mask).bool(),
                 _t(mesh, lw_dq))


def _gather_blocks(mesh: Mesh, d: dict, keys) -> dict:
    out = dict(d)
    for key in keys:
        x = d[key]
        g = mesh.all_gather(x.to(torch.uint8) if x.dtype == torch.bool
                            else x)
        out[key] = g.bool() if x.dtype == torch.bool else g
    return out


def marching_cubes(mesh: Mesh, vol, vert_cap, face_cap, step_size=1,
                   with_normals=True):
    """``mc_sharded.marching_cubes_sharded`` → the global mesh dict (the
    per-rank blocks in rank order, JAX's sharded output layout)."""
    out = mc_sharded.marching_cubes_sharded(
        mesh, vert_cap=vert_cap, face_cap=face_cap, step_size=step_size,
        with_normals=with_normals)(_rows(mesh, vol))
    return _gather_blocks(mesh, out, ("verts", "normals", "faces",
                                      "vert_valid", "face_valid",
                                      "vert_owned"))


def mc_replicated(mesh: Mesh, vol, vert_cap, face_cap):
    """``mc_local_slab(replicated_vol=True)`` on the whole ``vol`` →
    (verts, valid) of every rank's block in rank order."""
    m = mc_sharded.mc_local_slab(_t(mesh, vol), mesh, vert_cap=vert_cap,
                                 face_cap=face_cap, with_normals=False,
                                 replicated_vol=True)
    valid = torch.arange(vert_cap, device=mesh.device) < m["n_verts"]
    return _gather_blocks(mesh, {"verts": m["verts"], "valid": valid},
                          ("verts", "valid"))


def fusion_frames(mesh: Mesh, canonical, lives, lw_dq, init_kw: dict,
                  frame_kw: dict):
    """``make_init_canonical_sharded(**init_kw)`` on the canonical volume,
    then one ``make_fusion_frame_sharded(**frame_kw)`` frame per live
    volume of ``lives``, the state carried. Returns {"radius", "wf" (the
    init field), "frames": per frame {"values", "weights" (whole), "stats"
    (FrameStats), "wf" (numpy dict), "lw", "wall_s" (the synced wall)}}."""
    values = _rows(mesh, canonical)
    weights = torch.zeros_like(values)
    init = frame_sharded.make_init_canonical_sharded(mesh, **init_kw)
    wf, radius = init(values)
    out = {"radius": radius, "wf": warp_field_to_numpy(wf), "frames": []}
    frame = frame_sharded.make_fusion_frame_sharded(mesh, **frame_kw)
    lw = _t(mesh, lw_dq)
    for live in lives:
        live = _t(mesh, live)
        _sync(mesh)
        t0 = time.perf_counter()
        values, weights, wf, lw, stats, _ = frame(values, weights, live, wf,
                                                  lw)
        _sync(mesh)
        wall = time.perf_counter() - t0
        out["frames"].append({
            "values": mesh.all_gather(values),
            "weights": mesh.all_gather(weights), "stats": stats,
            "wf": warp_field_to_numpy(wf), "lw": lw, "wall_s": wall})
    return out
