"""Ingest cells: ``pipeline/fusion.py:FusionDM`` fusing one multi-view
capture after another into a fresh TSDF, ``compute_live_tsdf(...,
UseAutoAlignment=True, as_numpy=False)``, and with the traffic's
``mesh`` the mesh of it, ``FusionDM.marching_cubes`` at stride 1 with
normals, copied to the host.

Set-up renders the traffic's pool of captures on the card with the
benchmark's own rasterizer: the configuration's body mesh under the
analytic bend, its angle sweeping up and back, seen by a ring of cameras
whose yaw and the sweep's start come from the seed. The depth maps are
handed over in host memory, as a capture rig's frames arrive. A request
is one capture, complete when its mesh is on the host (or its TSDF is
synced on the card).

The check, for a sample of captures drawn from the seed and the last:

* ``calib_gap``: the program's grid calibration against the reference's
  (float64), as the widest distance between the two grids' corners, in
  voxels;
* ``tsdf_gap``/``weight_gap``: the fused TSDF against the reference
  fusion of the same maps on the program's grid (the fusion follows the
  program's calibration, which ``calib_gap`` holds on its own);
* ``mesh_*`` (with ``mesh``): the host mesh against the reference
  marching cubes of the program's TSDF.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import torch

from dynamicfusion_body_tpu_torch.pipeline.fusion import FusionDM

from .. import counts
from ..reference import fuse as ref_fuse
from ..reference import mc as ref_mc
from ..scene import (
    intrinsics,
    load_mesh,
    make_bend,
    regularize,
    render_capture,
    ring_extrinsics,
)

UNIT = "capture"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev):
        self.cfg, self.dev = cfg, dev
        rng = np.random.default_rng(seed)
        u0 = float(rng.uniform())
        yaw0 = float(rng.uniform(0.0, 2 * math.pi))
        cam = cfg["cameras"]
        self.K = intrinsics(cam["f"], cam["img"])
        verts, faces = load_mesh(Path(__file__).resolve().parents[1]
                                 / cfg["mesh"])
        tv = torch.as_tensor(regularize(verts), device=dev)
        tf = torch.as_tensor(faces, device=dev)
        bend = make_bend(tv)
        sweep, n_pool = traffic["sweep_captures"], traffic["pool"]
        self.pool = []
        for j in range(n_pool):
            x = (j / sweep + u0) % 1.0
            angle = traffic["bend_max_rad"] * (1.0 - abs(2.0 * x - 1.0))
            yaw = yaw0 + traffic["yaw_step_rad"] * (j // sweep)
            lws = ring_extrinsics(cam["views"], cam["dist"], yaw)
            d = render_capture(bend(tv, angle), tf, self.K, lws, cam["img"])
            self.pool.append(([m.cpu().numpy() for m in d], lws))
        self.tdist = cfg["tdist_x_res"] / cfg["res"]
        caps = cfg["caps"]
        self.fus = FusionDM(self.tdist, self.K, tsdf_res=cfg["res"],
                            vert_cap=caps["vert_cap"],
                            face_cap=caps["face_cap"], device=dev.type)
        self.mesh = bool(traffic["mesh"])
        # the captures of the first pool cycle kept for the check (the
        # last capture is kept too)
        pick = np.random.default_rng(seed ^ 0x5EED).choice(
            n_pool, size=min(2, n_pool), replace=False)
        self.sampled = set(pick.tolist())
        self.kept = {}
        self.overflow = 0
        self.n = 0

    def warm_up(self):
        for i in range(self.cfg["warmup_captures"]):
            self._capture(i % len(self.pool))

    def _capture(self, pi):
        """One capture of pool entry ``pi``; keeps its outputs as
        ``last`` and returns its host mesh (None without ``mesh``)."""
        depths, lws = self.pool[pi]
        v, w = self.fus.compute_live_tsdf(depths, lws, UseAutoAlignment=True,
                                          as_numpy=False)
        out = None
        if self.mesh:
            m = self.fus.marching_cubes(v, step_size=1, with_normals=True)
            nv, nf = int(m["n_verts"]), int(m["n_faces"])
            out = (m["verts"][:nv].cpu(), m["normals"][:nv].cpu(),
                   m["faces"][:nf].cpu(), bool(m["overflow"]))
        else:
            _sync(self.dev)
        self.last = (pi, v, w, self.fus.volume.ind, out)
        return out

    def request(self, i: int):
        out = self._capture(i % len(self.pool))
        if out is not None and out[3]:
            self.overflow += 1
        if i in self.sampled:
            self.kept[i] = self.last
        self.n = i + 1

    # ------------------------------------------------------------ after
    def failed(self) -> int:
        """Captures whose mesh overflowed its caps."""
        return self.overflow

    def sample(self):
        """The captures to check: those drawn from the seed and the
        last."""
        self.kept[self.n - 1] = self.last
        return sorted(self.kept)

    def release(self, keep_idx):
        self.fus = None
        self.last = None

    def check(self, idx, control: bool = False) -> dict:
        pi, v, w, ind, mesh = self.kept[idx]
        depths, lws = self.pool[pi]
        maps = torch.as_tensor(np.stack(depths), device=self.dev)
        dt = torch.bfloat16 if control else torch.float64
        c, s = ref_fuse.alignment(maps, self.K, lws, dtype=dt)
        ref_ind = ref_fuse.ind_matrix(self.cfg["res"], c, s)
        prog_ind = ind.double().cpu().numpy()
        r = self.cfg["res"]
        corners = np.array([[x, y, z, 1.0] for x in (0, r) for y in (0, r)
                            for z in (0, r)])
        gap = np.abs(corners @ prog_ind.T - corners @ ref_ind.T)[:, :3].max()
        if control:
            f64 = ref_fuse.alignment(maps, self.K, lws)
            good = ref_fuse.ind_matrix(r, *f64)
            gap = np.abs(corners @ ref_ind.T - corners @ good.T)[:, :3].max()
            ref_ind = good
        nums = {"calib_gap": float(gap / ref_ind[0, 0])}
        projs = ref_fuse.projections(self.K, lws, prog_ind)
        kinv = np.linalg.inv(self.K.astype(np.float64)).astype(np.float32)
        v0 = torch.full_like(v, self.tdist)
        w0 = torch.zeros_like(w)
        rv, rw = ref_fuse.fuse(v0, w0, maps, projs, kinv[2], self.tdist)
        if control:
            v, w = ref_fuse.fuse(v0, w0, maps, projs, kinv[2], self.tdist,
                                 dtype=torch.bfloat16)
        nums["tsdf_gap"] = float(torch.max(torch.abs(v - rv)))
        nums["weight_gap"] = float(torch.max(torch.abs(w - rw)))
        del rv, rw, v0, w0
        if self.mesh:
            ref = ref_mc.marching_cubes(self.kept[idx][1], 0.0, 1)
            if control:
                pm = ref_mc.marching_cubes(self.kept[idx][1], 0.0, 1,
                                           dtype=torch.bfloat16)
                mesh = (pm["verts"], pm["normals"], pm["faces"])
            nums.update(ref_mc.compare(mesh[0], mesh[1], mesh[2], ref))
            log(f"# capture {idx} (pool {pi}): {ref['verts'].shape[0]} "
                f"vertices, {ref['faces'].shape[0]} faces")
        return nums

    def kernel_bounds(self, idx) -> dict:
        """{kernel: [bound ms of each launch]} of capture ``idx``: K5 once
        (the in-image voxel-views and updates counted by the reference
        fusion of its maps), and K1 once with ``mesh``."""
        pi = idx % len(self.pool)
        depths, lws = self.pool[pi]
        maps = torch.as_tensor(np.stack(depths), device=self.dev)
        r = self.cfg["res"]
        c, s = ref_fuse.alignment(maps, self.K, lws)
        projs = ref_fuse.projections(self.K, lws, ref_fuse.ind_matrix(r, c, s))
        kinv = np.linalg.inv(self.K.astype(np.float64)).astype(np.float32)
        v0 = torch.full((r,) * 3, self.tdist, device=self.dev)
        _, _, n_inb, n_upd = ref_fuse.fuse(v0, torch.zeros_like(v0), maps,
                                           projs, kinv[2], self.tdist,
                                           counts=True)
        n, h, w = maps.shape
        out = {"k5": [counts.k5_bound_ms((r,) * 3, n, h, w, n_inb, n_upd)]}
        if self.mesh:
            out["k1"] = [counts.k1_bound_ms((r,) * 3)]
        return out
