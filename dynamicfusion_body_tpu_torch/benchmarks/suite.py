"""BASELINE configs 1-7 on the port — the counterpart of the repository's
``benchmarks/suite.py``, with the same metric names:

  1. rigid projective fusion of 8 rendered depth maps into 64³ and 256³
     (``config1_rigid_fusion_64``, ``config1_rigid_fusion_256``);
  2. marching cubes with normals at 256³ (``config2_marching_cubes_256``);
  3. rigid ICP tracking of 5 rotated live volumes at 96³
     (``config3_rigid_icp_tracking``, with ``median_rot_err_deg``);
  4. the cache-less non-rigid TSDF update at 256³
     (``config4_nonrigid_update_256``);
  5. the frame bench (:mod:`.bench`, called in this process);
  6. rigid fusion of ``meshes/original.obj``'s 8 views at 64³ and 256³,
     scored against the mesh (``config6_mesh_vertex_error_{64,256}``);
  7. the non-rigid ``Fusion`` loop on that mesh bent over 3 frames, at 64³
     and 256³ (``config7_nonrigid_surface_error_{64,256}``; ``CONFIG7_RES``
     = 64 or 256 runs one of them).

Each config prints one JSON line per metric on standard output; phase
splits and the device go to standard error as ``#`` lines. Wall times end
with ``torch.cuda.synchronize()``. Each config function takes a lattice
and view-size override, which only the tests use (a line then carries its
lattice in ``res``). The meshes of configs 6 and 7 are read from the
repository's ``meshes/original.obj``.

    python -m dynamicfusion_body_tpu_torch.benchmarks.suite [--config N]
    python -m dynamicfusion_body_tpu_torch.benchmarks.suite --config 2 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..io.mesh_io import load_obj, regularize_mesh
from ..models.tsdf_volume import TsdfVolume
from ..models.warp_field import update_tsdf_nonrigid
from ..ops.interp import trilinear
from ..ops.marching_cubes import marching_cubes
from ..ops.se3 import dq_to_se3
from ..ops.transforms import rotation_matrix
from ..pipeline.fusion import IDENTITY_DQ, Fusion, FusionDM, resolve_device
from ..render.raster import render_depth
from ..tools._scene import bench_scene, bumpy, bumpy_sdf, make_bend
from ..tools._timing import device_label
from ..utils.profiling import PhaseTimer
from . import bench
from .bench import log, sync

REF_MESH = Path(__file__).resolve().parents[2] / "meshes" / "original.obj"
IMG = 512
N_VIEWS = 8
ICP_ANGLES = tuple(np.linspace(0.02, 0.1, 5))
BEND_ANGLES = (0.08, 0.16, 0.24)


def camera(img: int = IMG) -> np.ndarray:
    """The suite's pinhole (f 400, centre 256 at 512²), scaled to
    ``img``²."""
    s = img / IMG
    return np.array([[400.0 * s, 0, 256.0 * s], [0, 400.0 * s, 256.0 * s],
                     [0, 0, 1]], np.float32)


def _emit(name, ms, extra=None):
    out = {"metric": name, "value": round(ms, 2), "unit": "ms"}
    out.update(extra or {})
    print(json.dumps(out), flush=True)
    return out


def _body_mesh(dev, res=128, vert_cap=1 << 15, face_cap=1 << 16):
    """The synthetic body stand-in (``suite.py:41-50``): the bumpy sphere's
    surface from the port's MC, in ~metric units."""
    sdf = bumpy_sdf(res, (res / 2,) * 3, res * 0.27, res / 64, 3.0)
    m = marching_cubes(torch.from_numpy(sdf).to(dev), vert_cap=vert_cap,
                       face_cap=face_cap, use_kernels=dev.type == "cuda")
    nv, nf = int(m["n_verts"]), int(m["n_faces"])
    verts = m["verts"][:nv].cpu().numpy() / res * 1.8 - 0.9
    faces = m["faces"][:nf].cpu().numpy()
    return verts.astype(np.float32), faces


def _render_views(verts, faces, K, n_views, h, w, dev, dist=2.5):
    """``n_views`` yaw views of a mesh at distance ``dist``
    (``suite.py:53-72``), rendered on ``dev``: (depth maps as numpy, as a
    caller hands them, extrinsics (3,4))."""
    tv = torch.from_numpy(np.ascontiguousarray(verts, np.float32)).to(dev)
    tf = torch.tensor(np.asarray(faces), dtype=torch.long, device=dev)
    fmask = torch.ones(len(faces), dtype=torch.bool, device=dev)
    tK = torch.from_numpy(np.asarray(K, np.float32)).to(dev)
    depths, lws = [], []
    for i in range(n_views):
        R = rotation_matrix(2 * np.pi * i / n_views, [0, 1, 0])[:3, :3]
        t = np.array([0, 0, dist]) - R @ np.zeros(3)
        lw = np.concatenate([R, t[:, None]], 1).astype(np.float32)
        d = render_depth(tv, tf, fmask, tK, torch.from_numpy(lw).to(dev), h,
                         w, S=8)
        depths.append(d.cpu().numpy())
        lws.append(lw)
    return depths, lws


def _sample_surface(verts, faces, n, seed=0):
    """~n points uniformly on the triangle surface (area-weighted)."""
    rng = np.random.RandomState(seed)
    tri = verts[faces]  # (F, 3, 3)
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1
    )
    p = area / area.sum()
    fi = rng.choice(len(faces), size=n, p=p)
    u, v = rng.rand(n), rng.rand(n)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    t = tri[fi]
    return (
        t[:, 0]
        + u[:, None] * (t[:, 1] - t[:, 0])
        + v[:, None] * (t[:, 2] - t[:, 0])
    ).astype(np.float32)


def reference_mesh():
    """``meshes/original.obj``, regularized to 1.8 units tall."""
    if not REF_MESH.exists():
        raise FileNotFoundError(f"configs 6 and 7 need {REF_MESH}")
    verts, faces = load_obj(str(REF_MESH))
    return regularize_mesh(verts), faces


def config1(dev, res=(64, 256), img=IMG):
    """Rigid projective fusion of 8 rendered depth maps into res[0]³ and
    res[1]³ (``suite.py:84-119``), each ingest timed after a warm one."""
    K = camera(img)
    verts, faces = _body_mesh(dev)
    depths, lws = _render_views(verts, faces, K, N_VIEWS, img, img, dev)
    out = []
    for name, r, tdist, caps in (
            ("config1_rigid_fusion_64", res[0], 0.05, (1 << 15, 1 << 16)),
            ("config1_rigid_fusion_256", res[1], 8.0 / res[1] * 1.3,
             (1 << 17, 1 << 18))):
        fus = FusionDM(tdist, K, tsdf_res=r, vert_cap=caps[0],
                       face_cap=caps[1], device=dev)
        fus.compute_live_tsdf(depths, lws, UseAutoAlignment=True,
                              as_numpy=False)  # warm
        sync(dev)
        t0 = time.perf_counter()
        fus.compute_live_tsdf(depths, lws, UseAutoAlignment=True,
                              as_numpy=False)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        out.append(_emit(name, ms, {"n_views": N_VIEWS, "res": r}))
    return out


def config2(dev, res=256):
    """Marching cubes with normals of the bench canonical at res³
    (``suite.py:122-141``): 5 timed calls after a warm one."""
    vol = torch.from_numpy(bumpy(res, (128, 128, 128), 0.0)).to(dev)

    def f():
        return marching_cubes(vol, vert_cap=1 << 17, face_cap=1 << 18,
                              use_kernels=dev.type == "cuda")

    nv = int(f()["n_verts"])
    t0 = time.perf_counter()
    for _ in range(5):
        nv = int(f()["n_verts"])  # a host read of the count: synced
    ms = (time.perf_counter() - t0) / 5 * 1e3
    return [_emit("config2_marching_cubes_256", ms,
                  {"n_verts": nv, "res": res})]


def rotated_live(values, Rg):
    """The live volume of config 3: ``values`` resampled under the grid
    rotation ``Rg`` (4x4), 0.05 (the truncation) outside
    (``suite.py:166-176``)."""
    r = values.shape[0]
    g = np.arange(r, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    inv = np.linalg.inv(Rg)
    pts_t = pts @ inv[:3, :3].T + inv[:3, 3]
    vals, ok = trilinear(values, torch.from_numpy(pts_t).to(
        device=values.device, dtype=torch.float32))
    return torch.where(ok, vals, 0.05).reshape(r, r, r)


def rigid_icp(depths, lws, K, dev, res=96, caps=(1 << 15, 1 << 16),
              angles=ICP_ANGLES):
    """Config 3's tracking (``suite.py:144-190``): the views fused rigidly
    into res³, then per angle a live volume rotated about the grid
    centre and ``FusionDM.solve`` from the identity. Returns (solve ms,
    rotation errors in degrees, the live volumes)."""
    fus = FusionDM(0.05, K, tsdf_res=res, vert_cap=caps[0],
                   face_cap=caps[1], device=dev)
    fus.compute_live_tsdf(depths, lws, UseAutoAlignment=True,
                          as_numpy=False)
    fus.marching_cubes()
    times, errs, lives = [], [], []
    for ang in angles:
        Rg = rotation_matrix(ang, [0, 1, 0], point=[res / 2] * 3)
        lv = rotated_live(fus.volume.values, Rg)
        sync(dev)
        t0 = time.perf_counter()
        fus._lw = fus._tensor(IDENTITY_DQ)
        fus.solve(lv)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        est = dq_to_se3(fus._lw).cpu().numpy()
        cosang = (np.trace(est[:3, :3] @ Rg[:3, :3].T) - 1) / 2
        errs.append(abs(np.degrees(np.arccos(np.clip(cosang, -1, 1)))))
        lives.append(lv)
    return times, errs, lives


def config3(dev, res=96, img=IMG, caps=(1 << 15, 1 << 16),
            angles=ICP_ANGLES):
    """Rigid ICP tracking over 5 rotated live volumes at res³
    (``FusionDM`` pads nothing: K5 and MC take the 96³ lattice as it
    is)."""
    K = camera(img)
    verts, faces = _body_mesh(dev)
    depths, lws = _render_views(verts, faces, K, N_VIEWS, img, img, dev)
    times, errs, _ = rigid_icp(depths, lws, K, dev, res, caps, angles)
    log(f"# config 3 at {res}^3: solve ms {[round(t, 1) for t in times]}; "
        f"rotation error deg {[round(float(e), 4) for e in errs]}")
    return [_emit("config3_rigid_icp_tracking", float(np.median(times)),
                  {"median_rot_err_deg": round(float(np.median(errs)), 3),
                   "res": res})]


def config4_update(sc, weights, use_kernels: bool):
    """Config 4's call: the cache-less non-rigid update of the bench scene
    ``sc`` (``tools/_scene.py:bench_scene``) with ``weights``."""
    return update_tsdf_nonrigid(
        sc.canonical, weights, sc.live, sc.wf, sc.lw, k=3, tdist=sc.tdist,
        brick=8, n_candidates=16, use_kernels=use_kernels)


def config4(dev, res=256, scene=None):
    """The cache-less non-rigid TSDF update at res³ (``suite.py:193-226``):
    3 timed calls after a warm one, on ``scene`` when given (a
    ``bench_scene`` at res³ already built)."""
    sc = bench_scene(res, dev) if scene is None else scene
    use_kernels = dev.type == "cuda"
    zeros = torch.zeros_like(sc.canonical)

    def f():
        return config4_update(sc, zeros, use_kernels)

    f()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        f()
        sync(dev)
    ms = (time.perf_counter() - t0) / 3 * 1e3
    return [_emit("config4_nonrigid_update_256", ms,
                  {"kernels": use_kernels, "res": res})]


def config5(dev, res=256):
    """The frame bench (:mod:`.bench`), in this process."""
    return [bench.main(["--res", str(res), "--device", dev.type]).result]


def run_config6(dev, res, depths, lws, K, tree, caps):
    """Config 6 at one lattice: the 8 views ``depths`` fused rigidly at
    res³ with mesh ``caps``, extracted, and scored against the mesh's
    surface samples in ``tree``: the vertices seen with fused weight ≥ 3,
    their distance to the mesh in voxels. Returns (the metric's line,
    the ``FusionDM``, the scored vertices in world units)."""
    fus = FusionDM(8.0 / res * 1.3, K, tsdf_res=res, vert_cap=caps[0],
                   face_cap=caps[1], device=dev)
    fus.compute_live_tsdf(depths, lws, UseAutoAlignment=True,
                          as_numpy=False)
    fus.marching_cubes()
    m = fus._mesh
    nv = int(m["n_verts"])
    gv = m["verts"][:nv]
    ind = fus._IND
    wv = gv.cpu().numpy() @ ind[:3, :3].T + ind[:3, 3]
    d, _ = tree.query(wv, k=1)
    voxel = float(ind[0, 0])
    wts, _ = trilinear(fus.volume.weights, gv)
    obs = (wts >= 3.0).cpu().numpy()
    do = d[obs] if obs.any() else d
    line = {
        "metric": f"config6_mesh_vertex_error_{res}",
        "value": round(float(np.mean(do) / voxel), 3),
        "unit": "voxels",
        "mean_err_world": round(float(np.mean(do)), 5),
        "p95_err_voxels": round(float(np.percentile(do, 95) / voxel), 3),
        "n_verts": nv,
        "observed_frac": round(float(obs.mean()), 3),
    }
    return line, fus, wv[obs] if obs.any() else wv


def config6(dev, res=(64, 256), img=IMG):
    """``meshes/original.obj`` rendered from 8 views, fused rigidly at
    res[0]³ and res[1]³, extracted, and scored (``suite.py:261-316``):
    :func:`run_config6` at each lattice."""
    from scipy.spatial import cKDTree

    verts, faces = reference_mesh()
    K = camera(img)
    depths, lws = _render_views(verts, faces, K, N_VIEWS, img, img, dev)
    tree = cKDTree(_sample_surface(verts, faces, 300_000))
    out = []
    for r, caps in ((res[0], (1 << 15, 1 << 16)),
                    (res[1], (1 << 17, 1 << 18))):
        line, _, _ = run_config6(dev, r, depths, lws, K, tree, caps)
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def config7_caps(res: int):
    """(canonical vert, face, live vert, live face, node) caps of
    ``suite.py:378-383``: 256³'s above 64³; 64³'s at and below it, scaled
    with the surface (res²) below it."""
    if res > 64:
        return (1 << 17, 1 << 18, 1 << 18, 1 << 19, 4096)
    s = (res / 64) ** 2
    return tuple(max(int(c * s), 256) for c in
                 (1 << 15, 1 << 16, 1 << 15, 1 << 16, 1024))


class _TimedFusion(Fusion):
    """``Fusion`` that times its ``construct_graph`` into ``timer``."""

    def __init__(self, *args, timer: PhaseTimer, **kw):
        self._timer = timer
        super().__init__(*args, **kw)

    def construct_graph(self):
        with self._timer.phase("construct_graph", sync=self._mesh["verts"]):
            super().construct_graph()


def run_config7(dev, res, verts, faces, img=IMG, tolerance=5.0,
                live_mc_step=None, mc_step=None, gn_iters=8, cg_iters=32,
                solve_iters=3, reg=0.5, angles=BEND_ANGLES):
    """Config 7 at res³ (``suite.py:341-496``) with its knobs: the mesh's
    8-view canonical TSDF, a ``Fusion`` on it, then per bend angle a live
    TSDF fused on the same lattice and setupCorrespondences → solve →
    updateTSDF → update_graph. ``mc_step`` and ``live_mc_step`` default
    to the suite's (2 and 1 up to 64³, 3 and 2 above). Returns a dict of
    the per-frame surface and vertex errors (voxels), the untracked
    error, whether each frame's TSDF is finite, the construction split
    and the per-frame phase means (s)."""
    from scipy.spatial import cKDTree

    mc_step = mc_step or (2 if res <= 64 else 3)
    live_mc_step = live_mc_step or (1 if res <= 64 else 2)
    vcap, fcap, lvcap, lfcap, node_cap = config7_caps(res)
    bend = make_bend(verts)
    K = camera(img)
    tdist = 8.0 / res * 1.3
    build = PhaseTimer()
    t_start = time.perf_counter()
    with build.phase("render canonical views"):
        depths0, lws = _render_views(verts, faces, K, N_VIEWS, img, img,
                                     dev)
    dm = FusionDM(tdist, K, tsdf_res=res, vert_cap=vcap, face_cap=fcap,
                  device=dev)
    with build.phase("canonical fusion", sync=dm.volume.values):
        canon_v, canon_w = dm.compute_live_tsdf(depths0, lws,
                                                UseAutoAlignment=True,
                                                as_numpy=False)
    ind = dm._IND
    voxel = float(ind[0, 0])
    # node density a property of the body, not of the lattice
    # (suite.py:400-409)
    ssr = 2.0 * (res / 64) / (mc_step / 2)
    with build.phase("Fusion construction", sync=canon_v):
        fus = _TimedFusion(
            canon_v, tdist, subsample_rate=ssr, knn=3,
            marching_cubes_step_size=mc_step, write_warpfield=False,
            vert_cap=vcap, face_cap=fcap, node_cap=node_cap,
            live_vert_cap=lvcap, live_face_cap=lfcap, device=dev,
            timer=build)
    build_s = time.perf_counter() - t_start
    m = fus._mesh
    nv = int(m["n_verts"])
    gv = m["verts"][:nv]
    obs = (trilinear(canon_w, gv)[0] >= 3.0).cpu().numpy()
    gv = gv.cpu().numpy()
    wv = gv @ ind[:3, :3].T + ind[:3, 3]
    if not obs.any():
        obs[:] = True
    surf = np.concatenate([verts, verts[faces].mean(1),
                           0.5 * (verts[faces[:, 0]] + verts[faces[:, 1]])])

    def p2s(pts, ang):
        """Distance of each point to the bent surface's samples."""
        return cKDTree(bend(surf, ang)).query(pts, k=1)[0]

    timer = PhaseTimer()
    t0 = time.perf_counter()
    verr, serr, finite = [], [], []
    for ang in angles:
        with timer.phase("render+fuse live", sync=canon_v):
            depths, _ = _render_views(bend(verts, ang), faces, K, N_VIEWS,
                                      img, img, dev)
            fresh = TsdfVolume.create(res, tdist, ind=dm.volume.ind)
            live_v, _ = dm._fuse(fresh.values, fresh.weights,
                                 dm._stack(depths), lws)
        with timer.phase("setupCorrespondences", sync=canon_v):
            fus.setupCorrespondences(live_v, method="clpts",
                                     tolerance=tolerance,
                                     live_mc_step=live_mc_step)
        with timer.phase("solve", sync=fus._lw):
            fus.solve(regularization_weight=reg, method="clpts",
                      iterations=solve_iters, gn_iters=gn_iters,
                      cg_iters=cg_iters)
        with timer.phase("updateTSDF", sync=fus.volume.values):
            fus.updateTSDF()
        with timer.phase("update_graph", sync=fus._lw):
            fus.update_graph()
        finite.append(bool(torch.isfinite(fus.volume.values).all()
                           & torch.isfinite(fus.volume.weights).all()))
        tracked = fus.warp(gv, m_lw=fus._lw) @ ind[:3, :3].T + ind[:3, 3]
        verr.append(np.linalg.norm(tracked - bend(wv, ang), axis=1)[obs])
        serr.append(p2s(tracked[obs], ang))
    return dict(
        res=res, voxel=voxel, serr=serr, verr=verr, finite=finite,
        untracked=p2s(wv[obs], angles[-1]), n_tracked=int(obs.sum()),
        frames_s=time.perf_counter() - t0, build_s=build_s,
        build=build.summary(), phases=timer.summary(),
        settings=dict(tolerance=tolerance, live_mc_step=live_mc_step,
                      mc_step=mc_step, gn_iters=gn_iters, cg_iters=cg_iters,
                      solve_iters=solve_iters, reg=reg,
                      angles=list(angles)))


def config7(dev, res=(64, 256), img=IMG):
    """The non-rigid ``Fusion`` loop on ``meshes/original.obj`` bent by
    0.08, 0.16 and 0.24 rad, at each lattice of ``res`` (``CONFIG7_RES``
    picks one): the tracked canonical surface's point-to-surface error
    (the primary metric) and its material-point error, in voxels."""
    only = int(os.environ.get("CONFIG7_RES", "0"))  # 0 = all
    verts, faces = reference_mesh()
    out = []
    for r in res:
        if only and r != only:
            continue
        c = run_config7(dev, r, verts, faces, img=img)
        vox = c["voxel"]
        b = {k: v["total_s"] for k, v in c["build"].items()}
        log(f"# config 7 at {r}^3: construction {c['build_s']:.3f} s: "
            f"render canonical views {b['render canonical views']:.3f} s; "
            f"canonical fusion {b['canonical fusion']:.3f} s; Fusion "
            f"construction {b['Fusion construction']:.3f} s, of which "
            f"construct_graph {b['construct_graph']:.3f} s and the first "
            f"canonical MC with the sampling radius "
            f"{b['Fusion construction'] - b['construct_graph']:.3f} s")
        log("# config 7 per-frame phase means: " + "; ".join(
            f"{k} {v['mean_s']:.3f} s" for k, v in c["phases"].items()))
        s, e = c["serr"][-1], c["verr"][-1]
        line = {
            "metric": f"config7_nonrigid_surface_error_{r}",
            "value": round(float(np.mean(s) / vox), 3),
            "unit": "voxels",
            "mean_err_world": round(float(np.mean(s)), 5),
            "p95_err_voxels": round(float(np.percentile(s, 95) / vox), 3),
            "per_frame_voxels": [round(float(np.mean(x) / vox), 3)
                                 for x in c["serr"]],
            "untracked_voxels": round(float(np.mean(c["untracked"]) / vox),
                                      3),
            "vertex_err_voxels": round(float(np.mean(e) / vox), 3),
            "vertex_err_per_frame": [round(float(np.mean(x) / vox), 3)
                                     for x in c["verr"]],
            "final_bend_rad": BEND_ANGLES[-1],
            "n_tracked": c["n_tracked"],
            "total_s": round(c["frames_s"], 1),
        }
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5,
           6: config6, 7: config7}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, default=0, choices=[0, *CONFIGS],
                    help="0 = all (default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "twins run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    log(f"# suite on {device_label(dev)}")
    out = {}
    for c in ([args.config] if args.config else sorted(CONFIGS)):
        out[c] = CONFIGS[c](dev)
    return out


if __name__ == "__main__":
    main()
