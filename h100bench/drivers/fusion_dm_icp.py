"""The ICP ingest cell: ``pipeline/fusion.py:FusionDM`` with
``compute_live_tsdf(..., UseAutoAlignment=True, useICP=True,
as_numpy=False)``, one multi-view capture after another. View 0 is fused
into a fresh TSDF and meshed; each later view is fused alone and
registered to view 0's mesh by 3 rounds of rigid ICP (live marching
cubes, the closest points, a 12-step Gauss-Newton solve), then folded in
rigidly at its pose.

Set-up renders the pool as the ingest cells do (``fusion_dm.py``), with
the true extrinsics; the extrinsics handed to the program for views 1..
carry a calibration error drawn from the seed per pool entry: a rotation
of the traffic's ``calib_rot_deg`` about a random axis through the world
origin and a shift of ``calib_shift`` units in a random direction. A
request is one capture, complete when its TSDF is synced on the card (no
mesh leaves it). Set-up refuses a program that keeps no per-view poses
(``FusionDM.icp_poses``), before the first capture.

The check, for one capture drawn from the seed and the last:

* ``calib_gap``: as in the ingest cells;
* ``pose_gap``: the widest displacement of the volume's 8 corners between
  the program's pose and the reference's (``reference/icp.py``, float64)
  over views 1.., in voxels;
* ``tsdf_gap``/``weight_gap``: the program's volume against the reference
  chain (float32) run with the program's own poses.

A capture fails when one of its meshes overflowed its caps (the program
warns of it).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .. import counts, counts_icp
from ..reference import fuse as ref_fuse
from ..reference import icp as ref_icp
from . import fusion_dm

UNIT = "capture"
log = fusion_dm.log


def _rot(axis, angle):
    a = axis / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


def miscalibrate(lws, rng, rot_deg: float, shift: float):
    """Extrinsics (n,3,4) with views 1.. moved by a rigid error in the
    world frame: x_cam = R (E x + e) + t."""
    out = np.array(lws, dtype=np.float64)
    for i in range(1, len(out)):
        E = _rot(rng.normal(size=3), math.radians(rot_deg))
        d = rng.normal(size=3)
        e = shift * d / np.linalg.norm(d)
        R, t = out[i, :, :3].copy(), out[i, :, 3].copy()
        out[i, :, :3] = R @ E
        out[i, :, 3] = R @ e + t
    return out.astype(np.float32)


class Driver(fusion_dm.Driver):
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev):
        super().__init__(cfg, traffic, seed, dev)
        if not hasattr(self.fus, "icp_poses") or not hasattr(
                self.fus, "icp_settings"):
            raise RuntimeError("the program keeps no per-view ICP poses "
                               "(FusionDM.icp_poses) or states no ICP "
                               "settings (FusionDM.icp_settings): this "
                               "cell cannot check it")
        # one capture of the first pool cycle is checked, and the last (a
        # capture's reference is ~80 s on the card)
        self.sampled = set(np.random.default_rng(seed ^ 0x5EED).choice(
            len(self.pool), size=1).tolist())
        rng = np.random.default_rng([seed, 0x1C9])
        self.pool = [(d, miscalibrate(lws, rng, traffic["calib_rot_deg"],
                                      traffic["calib_shift"]))
                     for d, lws in self.pool]
        # k, rounds, GN steps and tolerance as the program runs them
        self.icp = self.fus.icp_settings()

    def _capture(self, pi):
        depths, lws = self.pool[pi]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            v, w = self.fus.compute_live_tsdf(
                depths, lws, UseAutoAlignment=True, useICP=True,
                as_numpy=False)
        fusion_dm._sync(self.dev)
        over = any("capacity overflow" in str(c.message) for c in caught)
        self.last = (pi, v, w, self.fus.volume.ind, list(self.fus.icp_poses),
                     over)
        return None

    def request(self, i: int):
        self._capture(i % len(self.pool))
        self.overflow += self.last[5]
        if i in self.sampled:
            self.kept[i] = self.last
        self.n = i + 1

    def _inputs(self, pi, ind=None):
        """(maps on the device, K·lw·IND (n,3,4), K⁻¹'s row 2, the grid
        matrix) of pool entry ``pi`` on the program's grid ``ind`` (the
        reference's calibration when None)."""
        depths, lws = self.pool[pi]
        maps = torch.as_tensor(np.stack(depths), device=self.dev)
        if ind is None:
            ind = ref_fuse.ind_matrix(self.cfg["res"],
                                      *ref_fuse.alignment(maps, self.K, lws))
        projs = ref_fuse.projections(self.K, lws, ind)
        kinv = np.linalg.inv(self.K.astype(np.float64)).astype(np.float32)
        return maps, projs, kinv[2], ind

    def check(self, idx, control: bool = False) -> dict:
        pi, v, w, ind, poses, _ = self.kept[idx]
        depths, lws = self.pool[pi]
        maps = torch.as_tensor(np.stack(depths), device=self.dev)
        r = self.cfg["res"]
        dt = torch.bfloat16 if control else torch.float64
        c, s = ref_fuse.alignment(maps, self.K, lws, dtype=dt)
        ref_ind = ref_fuse.ind_matrix(r, c, s)
        prog_ind = ind.double().cpu().numpy()
        corners = np.array([[x, y, z, 1.0] for x in (0, r) for y in (0, r)
                            for z in (0, r)])
        gap = np.abs(corners @ prog_ind.T - corners @ ref_ind.T)[:, :3].max()
        if control:
            good = ref_fuse.ind_matrix(r, *ref_fuse.alignment(maps, self.K,
                                                              lws))
            gap = np.abs(corners @ ref_ind.T - corners @ good.T)[:, :3].max()
            ref_ind = good
        nums = {"calib_gap": float(gap / ref_ind[0, 0])}
        _, projs, kr, _ = self._inputs(pi, prog_ind)
        p = self.icp
        args = (maps, projs, kr, r, self.tdist)
        kw = dict(k=p["k"], tolerance=p["tolerance"], rounds=p["rounds"],
                  iters=p["iters"])
        truth = ref_icp.poses(*args, **kw)
        if control:
            poses = ref_icp.poses(*args, **kw, dtype=torch.bfloat16)
        nums["pose_gap"] = ref_icp.pose_gap(poses, truth, r)
        if len(poses) == len(truth):
            rv, rw = ref_icp.chain(*args, poses)
            if control:
                v, w = ref_icp.chain(*args, poses, dtype=torch.bfloat16)
            nums["tsdf_gap"] = _finite(torch.max(torch.abs(v - rv)))
            nums["weight_gap"] = _finite(torch.max(torch.abs(w - rw)))
        else:
            nums["tsdf_gap"] = nums["weight_gap"] = float("inf")
        log(f"# capture {idx} (pool {pi}): pose_gap {nums['pose_gap']:.6g} "
            f"voxels over {len(truth)} views")
        return nums

    def kernel_bounds(self, idx) -> dict:
        """{kernel: [bound ms of each launch]} of capture ``idx``: K5 once
        a view (its in-image voxel-views and updates counted by the
        reference fusion of that view), K1 once for the canonical mesh and
        3 times a later view, K7 3 times a later view (view 0's vertices
        against that view's, counted on the reference's meshes)."""
        pi = idx % len(self.pool)
        maps, projs, kr, _ = self._inputs(pi)
        r = self.cfg["res"]
        n, h, w = maps.shape
        out = {"k5": [], "k1": [counts.k1_bound_ms((r,) * 3)], "k7": []}
        n_verts = []
        for i in range(n):
            v0 = torch.full((r,) * 3, self.tdist, device=self.dev)
            vol, _, n_inb, n_upd = ref_fuse.fuse(
                v0, torch.zeros_like(v0), maps[i:i + 1], projs[i:i + 1], kr,
                self.tdist, counts=True)
            out["k5"].append(counts.k5_bound_ms((r,) * 3, 1, h, w, n_inb,
                                                n_upd))
            n_verts.append(counts_icp.crossing_edges(vol))
            del vol, v0
        for i in range(1, n):
            out["k1"] += [counts.k1_bound_ms((r,) * 3)] * self.icp["rounds"]
            out["k7"] += [counts_icp.k7_bound_ms(
                n_verts[0], n_verts[i], self.icp["k"])] * self.icp["rounds"]
        return out


def _finite(t) -> float:
    x = float(t)
    return x if math.isfinite(x) else float("inf")
