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
from types import SimpleNamespace

import numpy as np
import torch

from ..convert import warp_field_from_jax, warp_field_to_numpy
from ..models import warp_field as WF
from ..tools._scene import (
    sharded_field, sharded_pose, sharded_volumes)
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


def _barrier(mesh: Mesh):
    """Every rank's work so far done: a synced all-reduce."""
    _sync(mesh)
    float(mesh.psum(torch.zeros((), device=mesh.device)))


def _reset_peak(mesh: Mesh):
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(mesh.device)


def _peak_gib(mesh: Mesh):
    """This rank's peak device memory since :func:`_reset_peak`, in GiB
    (None on the CPU)."""
    if mesh.device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30


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


def bench512_scene(device, res: int, seed: int = 0) -> SimpleNamespace:
    """The equivalence's scene on ``device`` (``tools/_scene.py:
    sharded_volumes``/``sharded_field``/``sharded_pose``): ``canonical``
    and canonical weights ``w0`` (numpy, each rank takes its slab),
    ``live``, the warp field ``wf`` (the graph of radius 0.05·res on the
    seeded vertices, the perturbed node DQs), the pose ``lw`` and
    ``tdist``."""
    canonical, live = sharded_volumes(res)
    verts, dqs, w0 = sharded_field(res, canonical, seed)

    def t(a):
        return torch.as_tensor(a, device=device)

    wf = WF.construct_graph(t(verts), 0.05 * res, len(verts))
    return SimpleNamespace(canonical=canonical, w0=w0, live=t(live),
                           wf=wf.replace(node_dq=t(dqs)),
                           lw=t(sharded_pose(res)),
                           tdist=float(canonical.max()))


def bench512_dense(v0, w0, sc, k: int = 3, brick: int = 8,
                   n_candidates: int = 16):
    """The equivalence's dense arm: ``update_tsdf_nonrigid`` of the whole
    volume (``bench512_sharded.py:76-77``) → (values, weights)."""
    out = WF.update_tsdf_nonrigid(v0, w0, sc.live, sc.wf, sc.lw, k=k,
                                  tdist=sc.tdist, brick=brick,
                                  n_candidates=n_candidates)
    return out[:2]


def bench512_equivalence(mesh: Mesh, res: int, seed: int = 0, k: int = 3,
                         brick: int = 8, n_candidates: int = 16):
    """``benchmarks/bench512_sharded.py:run_equivalence`` on this rank:
    every rank builds the scene from (res, seed) on its own device
    (:func:`bench512_scene`: no volume crosses a process); rank 0 runs the
    dense arm (:func:`bench512_dense`) and keeps only its (values,
    weights); then every rank runs
    ``sharded.update_tsdf_nonrigid_sharded`` on its x-slab and the slabs
    are all-gathered. Returns (on rank 0) the deviations, counts, synced
    walls (the sharded one from a barrier to the last rank's end) and
    each arm's peak device memory."""
    sc = bench512_scene(mesh.device, res, seed)
    kw = dict(k=k, brick=brick, n_candidates=n_candidates)
    out = {"res": res, "n_devices": mesh.world}
    want = None
    if mesh.rank == 0:
        v0, w0 = _t(mesh, sc.canonical), _t(mesh, sc.w0)
        _reset_peak(mesh)
        _sync(mesh)
        t0 = time.perf_counter()
        want = bench512_dense(v0, w0, sc, **kw)
        _sync(mesh)
        out["t_dense_s"] = time.perf_counter() - t0
        out["peak_dense_gib"] = _peak_gib(mesh)
        del v0, w0
    v_s, w_s = _rows(mesh, sc.canonical), _rows(mesh, sc.w0)
    del sc.canonical, sc.w0
    upd = sharded.update_tsdf_nonrigid_sharded(mesh, tdist=sc.tdist, **kw)
    _reset_peak(mesh)
    _barrier(mesh)
    t0 = time.perf_counter()
    got_v, got_w, esc, risk = upd(v_s, w_s, sc.live, sc.wf, sc.lw)
    _barrier(mesh)
    out["t_sharded_s"] = time.perf_counter() - t0
    out["peak_sharded_gib"] = _peak_gib(mesh)
    del v_s, w_s
    got_v, got_w = mesh.all_gather(got_v), mesh.all_gather(got_w)
    if mesh.rank == 0:
        out["max_dev_values"] = float(torch.max(torch.abs(got_v - want[0])))
        out["max_dev_weights"] = float(torch.max(torch.abs(got_w
                                                           - want[1])))
    out["esc_dropped"], out["pool_risk"] = int(esc), int(risk)
    return out


def bench512_full_frame(mesh: Mesh, res: int, caps: dict, init_kw: dict,
                        frame_kw: dict):
    """``benchmarks/bench512_sharded.py:run_full_frame`` on this rank: the
    scene's canonical slab and the whole live volume built here,
    ``make_init_canonical_sharded(**init_kw)`` and the frame's
    construction (``t_setup_s``), then one
    ``make_fusion_frame_sharded(**frame_kw)`` frame (``t_frame_s``), both
    synced walls, with ``caps`` the per-rank mesh caps. Returns (on rank
    0) the frame's stats, the walls and the peak device memory."""
    canonical, live = sharded_volumes(res)
    tdist = float(canonical.max())
    values = _rows(mesh, canonical)
    weights = torch.zeros_like(values)
    live = _t(mesh, live)
    del canonical
    _reset_peak(mesh)
    _barrier(mesh)
    t0 = time.perf_counter()
    init = frame_sharded.make_init_canonical_sharded(
        mesh, vert_cap=caps["vert_cap"], face_cap=caps["face_cap"],
        **init_kw)
    wf, _ = init(values)
    lw = torch.tensor([1, 0, 0, 0, 0, 0.1, 0, 0], dtype=torch.float32,
                      device=mesh.device)
    frame = frame_sharded.make_fusion_frame_sharded(
        mesh, tdist=tdist, **caps, **frame_kw)
    _barrier(mesh)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, _, _, stats, _ = frame(values, weights, live, wf, lw)
    _barrier(mesh)
    t_frame = time.perf_counter() - t0
    cb = stats.cost_before.cpu().numpy()
    ca = stats.cost_after.cpu().numpy()
    return {
        "res": res, "n_devices": mesh.world, "n_corr": int(stats.n_corr),
        "n_nodes": int(stats.n_nodes), "cost_before_r0": float(cb[0]),
        "cost_after_r0": float(ca[0]), "descended": bool(ca[0] < cb[0]),
        "pool_risk": int(stats.pool_risk),
        "corr_risk": int(stats.corr_risk),
        "overflow": bool(stats.overflow), "t_setup_s": t_setup,
        "t_frame_s": t_frame, "peak_gib": _peak_gib(mesh)}
