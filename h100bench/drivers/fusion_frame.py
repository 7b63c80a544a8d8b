"""Tracking cells: ``pipeline/frame.py:fusion_frame`` chained frame after
frame, each synced, on the configuration's canonical and the traffic's
live volumes.

Set-up makes the canonical (the bumpy sphere at phase φ0, drawn from the
seed) and every distinct live volume of the traffic on the card, builds
the deformation graph with ``init_canonical`` and runs the warm-up
frames. A request is one frame on the next live volume of the schedule.

The check follows the program frame by frame from its own state, since a
tracker's output depends on all it fused before: for a sample of frames
drawn from the seed, and the last one, it takes the state the frame
started from and judges what the frame made of it:

* ``tsdf_gap``/``weight_gap``: the updated canonical TSDF (K2's path)
  against the reference update under the frame's solved warp, over the
  voxels within ``tsdf_band_voxels`` of the surface (farther out, the
  blend of far nodes underflows to the identity and the volume's border
  cuts the samples off: one rounding step there flips a voxel between
  two answers, and neither reaches the mesh);
* ``mesh_*``: the canonical mesh the frame returns (K1 and the
  compaction) against the reference marching cubes of its TSDF;
* ``warp_fit_mean``/``warp_fit_p99``: the solved warp (node DQs and
  global pose) by how far it leaves the canonical surface from the live
  one, the mean and the 99th percentile of |live SDF| at the moved
  canonical vertices, in voxels.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from dynamicfusion_body_tpu_torch.pipeline.frame import (
    fusion_frame,
    init_canonical,
)

from .. import counts
from ..reference import mc as ref_mc
from ..reference import nonrigid as ref_nr
from ..scene import bumpy_volume

UNIT = "frame"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, dev):
        self.cfg, self.dev, self.seed = cfg, dev, seed
        rng = np.random.default_rng(seed)
        self.phase0 = float(rng.uniform(0.0, 2 * np.pi))
        res = cfg["res"]
        sph = cfg["sphere"]
        canon = dict(center=tuple(sph["canonical_center"]),
                     radius=sph["radius"], amp=sph["amp"], freq=sph["freq"],
                     phase=self.phase0)
        # request i: bump phase step steps[i % L] and centre jitter draw
        # i % P; one live volume per distinct pair of one period
        steps = traffic["phase_steps"]
        jit = traffic["centre_jitter_voxels"]
        n_jit = traffic["jitter_pool"]
        centre = np.asarray(sph["live_center"], np.float64)
        centres = [centre + (rng.uniform(-jit, jit, 3) if jit else 0.0)
                   for _ in range(n_jit)]
        period = len(steps) * n_jit // math.gcd(len(steps), n_jit)
        pairs = [(steps[i % len(steps)], i % n_jit) for i in range(period)]
        distinct = list(dict.fromkeys(pairs))
        self.schedule = [distinct.index(p) for p in pairs]
        self.live_params = [dict(
            center=tuple(float(x) for x in centres[j]), radius=sph["radius"],
            amp=sph["amp"], freq=sph["freq"],
            phase=self.phase0 + traffic["phase_step"] * st)
            for st, j in distinct]
        self.canonical = bumpy_volume(res, dev, **canon)
        self.lives = [bumpy_volume(res, dev, **p) for p in self.live_params]
        self.tdist = float(self.canonical.max())
        ic = cfg["init_canonical"]
        caps = cfg["caps"]
        self.wf, _ = init_canonical(
            self.canonical, subsample_rate=ic["subsample_rate"],
            node_cap=ic["node_cap"], mc_step=ic["mc_step"],
            vert_cap=caps["vert_cap"], face_cap=caps["face_cap"])
        self.hyper = dict(cfg["frame"], tdist=self.tdist, **caps)
        self.state = (self.canonical, torch.zeros_like(self.canonical),
                      self.wf, torch.tensor(cfg["global_pose"],
                                            dtype=torch.float32, device=dev),
                      None)
        self.records = []       # (live index, entry state, output state)

    def warm_up(self):
        for _ in range(self.cfg["warmup_frames"]):
            self._frame(self.schedule[0], record=False)

    def _frame(self, li, record=True):
        values, weights, wf, lw, mesh = self.state
        v, w, wf2, lw2, _, mesh2 = fusion_frame(
            values, weights, self.lives[li], wf, lw, canon_mesh=mesh,
            **self.hyper)
        _sync(self.dev)
        out = (v, w, wf2, lw2, mesh2)
        if record:
            self.records.append((li, self.state, out))
        self.state = out

    def request(self, i: int):
        self._frame(self.schedule[i % len(self.schedule)])

    # ------------------------------------------------------------ after
    def failed(self) -> int:
        """Frames whose canonical mesh overflowed its caps, or whose live
        surface exceeds the live caps (by the reference's count of
        crossing edges and faces)."""
        bad = sum(bool(r[2][4]["overflow"]) for r in self.records)
        caps = self.cfg["caps"]
        for li, live in enumerate(self.lives):
            m = ref_mc.marching_cubes(live, 0.0, 1, with_normals=False)
            if (m["verts"].shape[0] > caps["live_vert_cap"]
                    or m["faces"].shape[0] > caps["live_face_cap"]):
                bad += sum(r[0] == li for r in self.records)
        return bad

    def sample(self):
        """Record indices to check: two drawn from the seed and the
        last."""
        m = len(self.records)
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        pick = set(rng.choice(max(m - 1, 1), size=min(2, max(m - 1, 1)),
                              replace=False).tolist()) if m > 1 else set()
        return sorted(pick | {m - 1})

    def release(self, keep_idx):
        """Drop every record but ``keep_idx`` and the live state."""
        self.records = [r if i in keep_idx else None
                        for i, r in enumerate(self.records)]
        self.state = None
        self.wf = None
        self.canonical = None

    def check(self, idx, control: bool = False) -> dict:
        """The compared numbers of record ``idx`` (module docstring); with
        ``control`` the reference computed in bfloat16 stands in for the
        program's outputs."""
        li, entry, out = self.records[idx]
        v0, w0, wf0, lw0, _ = entry
        v1, w1, wf1, lw1, mesh1 = out
        f = self.hyper
        k, live = f["knn_k"], self.lives[li]
        upd = dict(k=k, tdist=self.tdist, brick=8, C=f["n_candidates"])
        warp = (wf0.node_pos, wf1.node_dq, wf0.node_w, wf0.active, lw1)
        rv, rw = ref_nr.update_tsdf(v0, w0, live, *warp, **upd)
        if control:
            v1, w1 = ref_nr.update_tsdf(v0, w0, live, *warp, **upd,
                                        dtype=torch.bfloat16)
        band = torch.abs(rv) <= self.cfg["tsdf_band_voxels"]
        dv = torch.abs(v1 - rv)
        dw = torch.abs(w1 - rw)
        nums = {"tsdf_gap": float(torch.max(torch.where(band, dv, 0.0))),
                "weight_gap": float(torch.max(torch.where(band, dw, 0.0)))}
        log(f"# frame {idx}: outside the band (|v| > "
            f"{self.cfg['tsdf_band_voxels']}) the widest value gap "
            f"{float(torch.max(torch.where(band, 0.0, dv))):.4g}, weight gap "
            f"{float(torch.max(torch.where(band, 0.0, dw))):.4g}; voxels off "
            f"by more than 1e-3 {int(torch.sum((dv > 1e-3) & ~band))} outside,"
            f" {int(torch.sum((dv > 1e-3) & band))} inside of "
            f"{int(band.sum())}")
        del rv, rw, dv, dw, band
        ref = ref_mc.marching_cubes(v1 if not control else out[0], 0.0,
                                    f["mc_step"])
        if control:
            pm = ref_mc.marching_cubes(out[0], 0.0, f["mc_step"],
                                       dtype=torch.bfloat16)
            pv, pn, pf = pm["verts"], pm["normals"], pm["faces"]
        else:
            nv, nf = int(mesh1["n_verts"]), int(mesh1["n_faces"])
            pv, pn = mesh1["verts"][:nv], mesh1["normals"][:nv]
            pf = mesh1["faces"][:nf]
        nums.update(ref_mc.compare(pv, pn, pf, ref))
        fit_kw = dict(k=k, live_params=self.live_params[li],
                      mc_step=f["mc_step"])
        fit = ref_nr.surface_fit(v0, *warp, **fit_kw,
                                 dtype=torch.bfloat16 if control
                                 else torch.float32)
        nums["warp_fit_mean"] = float(fit.mean())
        nums["warp_fit_p99"] = float(torch.quantile(fit, 0.99))
        entry_fit = ref_nr.surface_fit(v0, wf0.node_pos, wf0.node_dq,
                                       wf0.node_w, wf0.active, lw0, **fit_kw)
        log(f"# frame {idx} (live {li}): warp fit mean "
            f"{float(fit.mean()):.4f} p99 {nums['warp_fit_p99']:.4f} max "
            f"{float(fit.max()):.4f} voxels over {fit.numel()} vertices; "
            f"at the frame's entry warp mean {float(entry_fit.mean()):.4f} "
            f"p99 {float(torch.quantile(entry_fit, 0.99)):.4f}")
        return nums

    def kernel_bounds(self, idx) -> dict:
        """{kernel: [bound ms of each launch]} of record ``idx``'s frame, in
        launch order: K1 on the live volume and on the stride-``mc_step``
        canonical, K2 once."""
        li, entry, out = self.records[idx]
        v0, w0, wf0, lw0, _ = entry
        f = self.hyper
        live = self.lives[li]
        _, _, (wx, wy, wz, valid) = ref_nr.update_tsdf(
            v0, w0, live, wf0.node_pos, out[2].node_dq, wf0.node_w,
            wf0.active, out[3], k=f["knn_k"], tdist=self.tdist, brick=8,
            C=f["n_candidates"], coords=True)
        k2 = counts.k2_bound_ms(live, wx, wy, wz, valid, self.tdist,
                                n_nodes=wf0.capacity, k=f["knn_k"],
                                C=f["n_candidates"])
        step = f["mc_step"]
        canon = tuple(-(-s // step) for s in v0.shape)
        return {"k1": [counts.k1_bound_ms(live.shape),
                       counts.k1_bound_ms(canon)], "k2": [k2]}

