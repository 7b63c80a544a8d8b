"""DynamicFusion drivers with the reference's entry-point surface —
counterparts of ``dynamicfusion_body_tpu/pipeline/fusion.py``:

``FusionDM`` — multi-view rigid depth fusion into a canonical TSDF with
optional rigid-ICP alignment (reference core/fusion_dm.py:53-561; the
OpenCL ``FusionDM_GPU`` is the same class). All depth views fuse in one
pass of the K5 kernel (``ops/fusion_cuda.py``). K5 samples the depth maps
from global memory, so the JAX FusionDM's sampling-window sizing, escape
fallback and 64 MB depth-stack guard (``_fuse_all``) have no counterpart.

``Fusion`` — the non-rigid DynamicFusion loop: warp-field solve →
canonical TSDF fusion → deformation-graph update (reference
core/fusion.py:49-598, with the constructor repaired to the intended
``Fusion(tsdf, trunc_distance, …)`` signature that the harness calls,
test.py:110; SURVEY §2.4). Its TSDF update samples through K2 (with the
driver's warp caches), its marching cubes through K1.

Both run on the card unless built with ``device="cpu"``; they raise when
asked for the card and none is present. The kernels run iff the volume
lies on the card, where the JAX package tests for the TPU; on CPU tensors
the wrappers use their plain twins.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..io.mesh_io import save_obj
from ..io.warpfield_io import load_warp_field_nodes, save_warp_field
from ..models import warp_field as WF
from ..models.tsdf_volume import TsdfVolume, update_tsdf_rigid
from ..ops.dualquat import dq_blend as _dq_blend
from ..ops.dualquat import dq_transform_point
from ..ops.fusion_cuda import fuse_depth_multi
from ..ops.icp_pick_cuda import rigid_correspondences_lattice
from ..ops.knn import knn as _knn
from ..ops.marching_cubes import marching_cubes
from ..ops.projection import estimate_alignment, make_ind_matrix
from ..ops.se3 import dq_to_se3
from ..solvers import nonrigid as _nonrigid
from ..solvers.nonrigid import gn_solve_core, make_reg_pairs, relaxation_step
from ..solvers.rigid import solve_rigid, solve_rigid_rows
from ..utils.profiling import host_read, span, traced
from .correspondence import (
    closest_point_correspondences,
    prune_by_plane_cost,
)
from .frame import _build_caches

IDENTITY_DQ = np.array([1, 0, 0, 0, 0, 0, 0, 0], dtype=np.float32)
WMAX = 100.0


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a CUDA device raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def _as_tensor(a, device):
    """A float32 tensor on ``device`` from an array or tensor; an array, or
    a host tensor bound for the card, is a host read (the copy waits for
    the card's queue; an array counts on the CPU too)."""
    if isinstance(a, torch.Tensor):
        if a.device.type == "cuda" or a.device == torch.device(device):
            return a.to(device=device, dtype=torch.float32)
        with host_read():
            return a.to(device=device, dtype=torch.float32)
    with host_read():
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=device)


def _pad_to_multiple(vol, mult, fill):
    """Pad every axis up to a multiple of ``mult``; returns (padded,
    original shape) so callers can slice back."""
    shape = tuple(vol.shape)
    pads = [(-s) % mult for s in shape]
    if not any(pads):
        return vol, shape
    return torch.nn.functional.pad(
        vol, (0, pads[2], 0, pads[1], 0, pads[0]), value=fill), shape


def _warn_mesh_overflow(mesh, vert_cap, face_cap):
    """Capacity saturation is loud: a truncated isosurface silently corrupts
    correspondences and exported meshes downstream."""
    with host_read():
        overflow = bool(mesh["overflow"])
    if overflow:
        warnings.warn(
            f"marching_cubes capacity overflow (vert_cap={vert_cap}, "
            f"face_cap={face_cap}): surface truncated — grow the caps",
            RuntimeWarning,
        )


class FusionDM:
    """Multi-view depth-map fusion (rigid), on ``device`` (default the
    card).

    After a ``compute_live_tsdf(useICP=True)``, ``icp_poses`` holds the
    solved pose of each view after the first, in order (8-vector DQ
    tensors on the device); the reference keeps only the last, in
    ``_lw``."""

    # the rigid ICP of compute_live_tsdf(useICP=True) (reference
    # core/fusion_dm.py:219-283): rounds of correspondence and GN, GN
    # steps a round, the point-to-plane cost a correspondence may have
    ICP_ROUNDS = 3
    ICP_ITERS = 12
    ICP_TOLERANCE = 1.0

    def __init__(
        self,
        trunc_distance,
        K,
        tsdf_res=256,
        subsample_rate=5.0,
        knn=4,
        marching_cubes_step_size=3,
        verbose=False,
        write_warpfield=True,
        vert_cap=1 << 17,
        face_cap=1 << 18,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self._itercounter = 0
        self._tdist = abs(trunc_distance)
        self._tsdf_res = tsdf_res
        self._K = np.asarray(K, dtype=np.float32)
        self._Kinv = np.linalg.inv(self._K).astype(np.float32)
        self._lw = self._tensor(IDENTITY_DQ)
        self._knn = knn
        self._marching_cubes_step_size = marching_cubes_step_size
        self._subsample_rate = subsample_rate
        self._verbose = verbose
        self._write_warpfield = write_warpfield
        self._vert_cap = vert_cap
        self._face_cap = face_cap
        self.volume = TsdfVolume.create(tsdf_res, self._tdist,
                                        device=self.device)
        self._mesh = None
        self._mesh_rows = None
        self.icp_poses = []

    def _tensor(self, a):
        """A float32 tensor on this FusionDM's device from an array or
        tensor."""
        return _as_tensor(a, self.device)

    def _stack(self, arrays):
        """(n, ...) float32 tensor on this FusionDM's device from a sequence
        of arrays or tensors."""
        return torch.stack([self._tensor(a) for a in arrays])

    # ------------------------------------------------------------------ #
    def _fuse(self, v, w, maps, lws, wmax=WMAX):
        """Fuse the (n,H,W) depth maps ``maps`` on this FusionDM's device
        (taken with extrinsics ``lws``) into (v, w) in one K5 pass, in
        order."""
        with span("calibrate"):
            projs = self._tensor(np.stack([self._proj(lw) for lw in lws]))
            kinv_row2 = self._tensor(self._Kinv[2])
        with span("fuse"):
            return fuse_depth_multi(v, w, maps, projs, kinv_row2,
                                    self._tdist, wmax)

    @property
    def _tsdf(self):
        return self.volume.values

    @property
    def _tsdfw(self):
        return self.volume.weights

    @property
    def _IND(self):
        with host_read():
            return self.volume.ind.cpu().numpy()

    def _proj(self, lw):
        """K·lw·IND in numpy float32, exactly as the JAX FusionDM builds it,
        so both packages feed the same matrices to the fusion."""
        lw4 = np.eye(4, dtype=np.float32)
        lw4[:3] = np.asarray(lw, dtype=np.float32)
        return self._K @ lw4[:3] @ self._IND

    # ------------------------------------------------------------------ #
    @traced("compute_live_tsdf")
    def compute_live_tsdf(
        self, depths, lws, UseAutoAlignment=False, useICP=False,
        outputMesh=False, as_numpy=True,
    ):
        """Fuse N depth maps (+3x4 extrinsics) into the canonical TSDF.

        Reference core/fusion_dm.py:95-178: grid calibration from depth
        statistics (or the hardcoded defaults), then either straight
        accumulation or per-map rigid-ICP alignment. Returns numpy arrays
        (values, weights), or the device tensors with ``as_numpy=False``.

        Spans: ``upload`` (the maps' copy to the device), ``calibrate``
        (the grid calibration, the volume, the per-view projections with
        their reads of the grid matrix) and ``fuse`` (K5); with ``useICP``
        the branch is ``icp``, which holds each view's ``calibrate`` and
        ``fuse``, the canonical ``marching_cubes``, and per later view
        ``correspondences`` (the live ``marching_cubes`` and ``knn``, K7)
        and ``rigid`` three times, then ``update``.
        """
        if len(depths) != len(lws):
            raise ValueError(
                "length of camera matrix array Ks must equal that of depth maps"
            )
        with span("upload"):
            maps = self._stack(depths)  # one host-to-card copy of the maps
        with span("calibrate"):
            avg = self._tensor([-0.03, -0.43, -5.6])
            std = self._tensor(1.3)
            if UseAutoAlignment:
                avg, std = estimate_alignment(
                    maps, self._tensor(self._Kinv), self._stack(lws))
            ind = make_ind_matrix(self._tsdf_res, avg, std, factor=8.0)
            self.volume = TsdfVolume.create(self._tsdf_res, self._tdist,
                                            ind=ind)
        if self._verbose:
            print("estimate center pt of input depth maps:", avg.cpu().numpy())
            print("estimate std of input depth maps:", float(std))

        self.icp_poses = []
        if useICP:
            with span("icp"):
                for idx, (dm, lw) in enumerate(zip(maps, lws)):
                    if self._verbose:
                        print("fusing depth map ", idx)
                    fresh = TsdfVolume.create(self._tsdf_res, self._tdist,
                                              ind=ind)
                    v, w = self._fuse(fresh.values, fresh.weights, dm[None],
                                      [lw])
                    if idx == 0:
                        self.volume = self.volume.replace(values=v, weights=w)
                        self.marching_cubes()
                    else:
                        self._lw = self._tensor(IDENTITY_DQ)
                        self.icp_poses.append(self.solve(v))
                        with span("update"):
                            self.updateTSDF(v)
        else:
            if self._verbose:
                for idx in range(len(depths)):
                    print("fusing depth map ", idx)
            v, w = self._fuse(self.volume.values, self.volume.weights,
                              maps, lws)
            self.volume = self.volume.replace(values=v, weights=w)

        if outputMesh:
            with host_read():
                values = self.volume.values.cpu().numpy()
            np.save("tsdf_temp", values)
            self.write_canonical_mesh(os.getcwd(), "test.obj")
        if as_numpy:
            with host_read(2):
                return (self.volume.values.cpu().numpy(),
                        self.volume.weights.cpu().numpy())
        return self.volume.values, self.volume.weights

    def fuseDepths(self, dm, lw, tsdf, tsdf_w, wmax=WMAX):
        """Single-map projective update on explicit arrays (functional).
        Returns numpy (values, weights)."""
        v, w = self._fuse(self._tensor(tsdf), self._tensor(tsdf_w),
                          self._tensor(dm)[None], [lw], wmax)
        with host_read(2):
            return v.cpu().numpy(), w.cpu().numpy()

    # ------------------------------------------------------------------ #
    @traced("marching_cubes")
    def marching_cubes(self, tsdf=None, step_size=1, with_normals=True):
        """Extract a surface; with no args, caches the canonical mesh like
        the reference (core/fusion_dm.py:319-331)."""
        if step_size < 1:
            step_size = self._marching_cubes_step_size
        target = self.volume.values if tsdf is None else self._tensor(tsdf)
        out = marching_cubes(
            target, level=0.0, vert_cap=self._vert_cap,
            face_cap=self._face_cap, step_size=step_size,
            with_normals=with_normals, use_kernels=True,
        )
        _warn_mesh_overflow(out, self._vert_cap, self._face_cap)
        if tsdf is None:
            self._mesh = out
            self._mesh_rows = None
            if self._verbose:
                print("Marching Cubes result: number of extracted vertices "
                      "is %d" % int(out["n_verts"]))
            return None
        return out

    def icp_settings(self) -> dict:
        """The rigid ICP as ``solve`` runs it: k nearest live vertices, the
        rounds, the GN steps a round and the correspondence tolerance."""
        return dict(k=self._knn, rounds=self.ICP_ROUNDS,
                    iters=self.ICP_ITERS, tolerance=self.ICP_TOLERANCE)

    # ------------------------------------------------------------------ #
    @traced("correspondences")
    def setupCorrespondences(self, curr_tsdf, prune_result=True,
                             tolerance=ICP_TOLERANCE):
        """Closest-point correspondences against the live TSDF surface
        (reference core/fusion_dm.py:219-244: canonical verts are warped by
        the global DQ only). The search is exact over the valid rows of
        both meshes (K7, ``pipeline/correspondence.py:
        closest_point_correspondences_lattice``), the warp and the pick
        on the card are K9 (``ops/icp_pick_cuda.py``): no host read, and
        none of the flat search's all-slots cost."""
        if self._mesh is None:
            self.marching_cubes()
        # live normals are unused (correspondences target positions only)
        live = self.marching_cubes(curr_tsdf, step_size=1, with_normals=False)
        corr, valid, _ = rigid_correspondences_lattice(
            self._lw, self._mesh["verts"], self._mesh["normals"],
            self._mesh["n_verts"], live["verts"], live["n_verts"],
            self._knn, tolerance, extent=self._tsdf_res)
        self._correspondences = corr
        self._corr_valid = valid
        return corr, valid

    def solve(self, curr_tsdf):
        """Rigid ICP: ICP_ROUNDS outer iterations of correspondence +
        8-dof DQ GN of ICP_ITERS steps (reference core/fusion_dm.py:
        264-283), the GN over the canonical
        mesh's valid rows in closed form (``solvers/rigid.py:
        solve_rigid_rows``; their count is read on the host once a
        mesh)."""
        self._itercounter += 1
        if self._mesh is None:
            self.marching_cubes()
        if self._mesh_rows is None:
            with host_read():
                self._mesh_rows = int(self._mesh["n_verts"])
        n = self._mesh_rows
        for _ in range(self.ICP_ROUNDS):
            self.setupCorrespondences(curr_tsdf)
            self._lw, _ = solve_rigid_rows(
                self._lw, self._mesh["verts"][:n], self._mesh["normals"][:n],
                self._correspondences[:n], self._corr_valid[:n],
                iterations=self.ICP_ITERS)
            if self._verbose:
                print("global transformation found:",
                      dq_to_se3(self._lw).cpu().numpy())
        return self._lw

    def updateTSDF(self, curr_tsdf, wmax=WMAX):
        v, w = update_tsdf_rigid(
            self.volume.values, self.volume.weights, self._tensor(curr_tsdf),
            self._lw, self._tdist, wmax)
        self.volume = self.volume.replace(values=v, weights=w)

    # ------------------------------------------------------------------ #
    def write_canonical_mesh(self, path, filename):
        out = marching_cubes(
            self.volume.values, level=0.0, vert_cap=self._vert_cap,
            face_cap=self._face_cap, step_size=1, use_kernels=True,
        )
        nv, nf = int(out["n_verts"]), int(out["n_faces"])
        save_obj(
            os.path.join(path, filename),
            out["verts"][:nv].cpu().numpy(),
            out["faces"][:nf].cpu().numpy(),
            normals=out["normals"][:nv].cpu().numpy(),
            ind=self._IND,
        )

    def write_warp_field(self, path, filename):
        """No-op: the rigid FusionDM has no warp field (as in the JAX
        package, whose FusionDM never sets one)."""


class Fusion:
    """Non-rigid DynamicFusion driver (canonical TSDF + DQ warp field), on
    ``device`` (default the card).

    ``tsdf`` is the canonical volume (a 3-D numpy array or tensor); its
    shape need not be a multiple of the brick (``updateTSDF`` pads the
    canonical volume and hands the live one over as it is).
    ``use_cnn=True`` builds the learned correspondences
    (``pipeline/cnn_correspondence.py``) on this device from
    ``cnn_weights`` (an npz, or None for random weights),
    ``cnn_image_size`` and ``cnn_normalize_input`` (None: the npz's
    recorded input scale)."""

    def __init__(
        self,
        tsdf,
        trunc_distance,
        subsample_rate=5.0,
        knn=4,
        marching_cubes_step_size=3,
        verbose=False,
        use_cnn=False,
        write_warpfield=True,
        vert_cap=1 << 16,
        face_cap=1 << 17,
        node_cap=2048,
        warpfield_path=None,
        cnn_image_size=512,
        cnn_weights=None,
        cnn_normalize_input=None,
        live_vert_cap=None,
        live_face_cap=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        tsdf = self._tensor(tsdf)
        if tsdf.dim() != 3:
            raise ValueError("Only 3D numpy array is accepted as tsdf")
        self._itercounter = 0
        self._curr_tsdf = None
        self._tdist = abs(float(trunc_distance))
        # reference initial global pose (core/fusion.py:57)
        self._lw = self._tensor([1, 0, 0, 0, 0, 0.1, 0, 0])
        self._knn = knn
        self._marching_cubes_step_size = marching_cubes_step_size
        self._subsample_rate = subsample_rate
        self._verbose = verbose
        self._write_warpfield = write_warpfield
        self._warpfield_path = warpfield_path or os.getcwd()
        self._vert_cap = vert_cap
        self._face_cap = face_cap
        # the live (step-1) mesh is denser than the canonical one and feeds
        # only the correspondence search: its own caps keep the solver
        # tables (sized by vert_cap) snug, as in fusion_frame
        self._live_vert_cap = live_vert_cap or vert_cap
        self._live_face_cap = live_face_cap or face_cap
        self._node_cap = node_cap
        self._cnn = None
        if use_cnn:
            from .cnn_correspondence import CnnCorrespondence

            self._cnn = CnnCorrespondence(
                weights_npz=cnn_weights, image_size=cnn_image_size,
                normalize_input=cnn_normalize_input, device=self.device)
        self.volume = TsdfVolume(
            values=tsdf, weights=torch.zeros_like(tsdf),
            ind=torch.eye(4, dtype=torch.float32, device=self.device))
        self._mesh = None
        self._correspondences = None
        self._corr_valid = None
        self._corr_tolerance = 0.2   # reference default, core/fusion.py:243
        self._corr_live_mc_step = 1
        self._upd_cache = None       # (key, cand, risk, warp_cache)
        self.InitializeCanonicalSpace()

    def _tensor(self, a):
        """A float32 tensor on this Fusion's device from an array or
        tensor."""
        return _as_tensor(a, self.device)

    def _vmask(self, mesh, cap):
        return torch.arange(cap, device=self.device) < mesh["n_verts"]

    # ------------------------------------------------------------------ #
    @property
    def _tsdf(self):
        return self.volume.values

    def InitializeCanonicalSpace(self):
        """MC + sampling-radius estimate + initial graph (reference
        core/fusion.py:73-96 intent)."""
        self.marching_cubes()
        self._radius = float(self._subsample_rate) * self._mean_edge_length()
        if self._verbose:
            print("sampling radius:", self._radius)
        self.construct_graph()

    def _mean_edge_length(self):
        m = self._mesh
        tri = m["verts"][m["faces"]]                          # (F, 3, 3)
        e = (torch.linalg.vector_norm(tri[:, 0] - tri[:, 1], dim=1)
             + torch.linalg.vector_norm(tri[:, 0] - tri[:, 2], dim=1)
             + torch.linalg.vector_norm(tri[:, 1] - tri[:, 2], dim=1)) / 3.0
        nf = m["n_faces"]
        mask = torch.arange(e.shape[0], device=self.device) < nf
        return float(torch.sum(torch.where(mask, e, 0.0))
                     / torch.clamp_min(nf, 1))

    def construct_graph(self):
        m = self._mesh
        self._warp = WF.construct_graph(
            m["verts"], self._radius, self._node_cap,
            valid=self._vmask(m, self._vert_cap))
        if self._verbose:
            print("%d deformation nodes sampled, with average radius of %f"
                  % (int(self._warp.num_active), self._radius))
        self._refresh_neighbors()

    def _refresh_neighbors(self):
        m, wf = self._mesh, self._warp
        self._nbr_idx = WF.neighbor_lookup(wf, m["verts"], self._knn)
        npos = wf.node_pos[self._nbr_idx]
        nw = wf.node_w[self._nbr_idx]
        d = torch.linalg.vector_norm(m["verts"][:, None, :] - npos, dim=-1)
        self._blend_wts = torch.where(wf.active[self._nbr_idx],
                                      torch.exp(-((d / (2.0 * nw)) ** 2)),
                                      0.0)

    # ------------------------------------------------------------------ #
    @traced("marching_cubes")
    def marching_cubes(self, tsdf=None, step_size=0, with_normals=True):
        """Extract a surface through K1; with no ``tsdf``, the canonical
        mesh (solver-sized caps), cached; else the live caps."""
        if step_size < 1:
            step_size = self._marching_cubes_step_size
        vcap = self._vert_cap if tsdf is None else self._live_vert_cap
        fcap = self._face_cap if tsdf is None else self._live_face_cap
        target = self.volume.values if tsdf is None else self._tensor(tsdf)
        out = marching_cubes(target, level=0.0, vert_cap=vcap, face_cap=fcap,
                             step_size=step_size, with_normals=with_normals,
                             use_kernels=True)
        _warn_mesh_overflow(out, vcap, fcap)
        if tsdf is None:
            self._mesh = out
            if self._verbose:
                print("Marching Cubes result: number of extracted vertices "
                      "is %d" % int(out["n_verts"]))
            return None
        return out

    # ------------------------------------------------------------------ #
    def _warped_mesh(self, m_lw=None):
        m = self._mesh
        return WF.warp_points(self._warp, m["verts"], self._nbr_idx,
                              normals=m["normals"], m_lw=m_lw)

    @traced("correspondences")
    def setupCorrespondences(self, curr_tsdf, method="cnn",
                             prune_result=True, tolerance=0.2,
                             live_mc_step=1):
        """Correspondences against the live surface (reference
        core/fusion.py:243-313). Closest points on the warped canonical
        mesh, unless ``method`` is not "clpts" and the driver was built
        with ``use_cnn=True``: then feature-space matches of the UNWARPED
        canonical mesh against the live one, pruned by the point-to-plane
        cost on the warped mesh when ``prune_result`` is set.
        ``live_mc_step`` is the live mesh's extraction stride (the
        reference's 1; 2 bounds the live vertex pool at 256³).
        ``tolerance`` and ``live_mc_step`` are reused by ``solve``'s
        refreshes."""
        self._corr_tolerance = float(tolerance)
        self._corr_live_mc_step = int(live_mc_step)
        self._curr_tsdf = self._tensor(curr_tsdf)
        # live normals are unused (correspondences target positions only)
        live = self.marching_cubes(self._curr_tsdf, step_size=live_mc_step,
                                   with_normals=False)
        vmask = self._vmask(self._mesh, self._vert_cap)
        lmask = self._vmask(live, self._live_vert_cap)
        wv, wn = self._warped_mesh(m_lw=self._lw)
        if self._cnn is None or method == "clpts":
            if self._verbose:
                print("Using closest pts method for finding "
                      "correspondences...")
            corr, valid, _ = closest_point_correspondences(
                wv, wn, vmask, live["verts"], lmask, self._knn, tolerance)
        else:
            if self._verbose:
                print("Using cnn method for finding correspondences...")
            corr, valid = self._cnn.match(self._mesh, live, vmask, lmask)
            if prune_result:
                valid, _ = prune_by_plane_cost(wv, wn, corr, valid,
                                               tolerance)
        self._correspondences = corr
        self._corr_valid = valid
        if self._verbose:
            n = int(torch.sum(vmask))
            rej = int(torch.sum(vmask & ~valid))
            print("ratio of correspondence outlier rejection", rej / max(n, 1))
        return corr, valid

    # ------------------------------------------------------------------ #
    @traced("solve")
    def solve(
        self,
        correspondences=None,
        method="cnn",
        precompute_lw=True,
        tukey_data_weight=0.2,
        huber_regularization_weight=0.001,
        regularization_weight=1.0,
        iterations=None,
        gn_iters=8,
        cg_iters=32,
    ):
        """Warp-field estimation for the current frame (reference
        core/fusion.py:327-412): optional global-pose presolve, then GN
        over node DQs with the regularization-relaxation schedule.

        ``method="clpts"`` runs 3 relaxation rounds and refreshes the
        correspondences before each later round; another method runs one.
        ``iterations``/``gn_iters``/``cg_iters`` override the round count
        and per-round solver depth. ``tukey_data_weight`` and
        ``huber_regularization_weight`` are accepted and ignored, as in the
        JAX package (the robust loss is the solver's fixed huber IRLS)."""
        if correspondences is not None:
            self._correspondences = self._tensor(correspondences)
            self._corr_valid = torch.ones(self._correspondences.shape[0],
                                          dtype=torch.bool,
                                          device=self.device)
        if self._correspondences is None:
            raise ValueError(
                "Please first call setupCorrespondences to compute point to "
                "point correspondences between canonical and live frame "
                "vertices!")
        iteration = ((3 if method == "clpts" else 1) if iterations is None
                     else int(iterations))
        self._itercounter += 1

        if precompute_lw:
            if self._verbose:
                print("estimating global transformation lw...")
            pv, pn = self._warped_mesh(m_lw=None)
            self._lw, _ = solve_rigid(self._lw, pv, pn, self._correspondences,
                                      self._corr_valid, iterations=12)
            if self._verbose:
                print("global transformation found:",
                      dq_to_se3(self._lw).cpu().numpy())
            if method == "clpts":
                self.setupCorrespondences(
                    self._curr_tsdf, method="clpts",
                    tolerance=self._corr_tolerance,
                    live_mc_step=self._corr_live_mc_step)

        m = self._mesh
        rw = float(regularization_weight)
        for it in range(iteration):
            if it > 0 and correspondences is None:
                self.setupCorrespondences(
                    self._curr_tsdf, method="clpts",
                    tolerance=self._corr_tolerance,
                    live_mc_step=self._corr_live_mc_step)
            wf = self._warp
            with host_read():
                rw_t = torch.tensor(rw, dtype=torch.float32,
                                    device=self.device)
            pair_i, pair_j, pair_scale, pair_mask = make_reg_pairs(
                wf.node_vert_idx, self._nbr_idx, wf.node_w, wf.active, rw_t)
            data_args = (m["verts"], m["normals"], self._correspondences,
                         self._corr_valid, self._nbr_idx, self._blend_wts)
            reg_args = (pair_i, pair_j, wf.node_pos[pair_j], pair_scale,
                        pair_mask)
            new_dq, cost_before, _, cost_after, _, ell_over = gn_solve_core(
                wf.node_dq, data_args, reg_args, self._lw, gn_iters,
                cg_iters, damping=1e-4, ftol=1e-5)
            with host_read():
                ell_over = int(ell_over)
            if ell_over > 0:
                warnings.warn(
                    "solve: %d JtWJ contributions exceeded the block-ELL "
                    "degree cap (ELL_DEGREE_CAP=%d) and were dropped — the "
                    "CG operator is under-assembled and convergence may "
                    "stall; raise solvers.nonrigid.ELL_DEGREE_CAP for this "
                    "graph density" % (ell_over, _nonrigid.ELL_DEGREE_CAP),
                    RuntimeWarning, stacklevel=2)
            with host_read():
                cost_before = float(cost_before)
            if self._verbose:
                print("Cost before optimization:", cost_before)
                print("Current regularization weight:", rw)
            self._warp = wf.replace(node_dq=new_dq)
            with host_read():
                cost_after = float(cost_after)
            if self._verbose:
                print("Optimized cost at %d iteration: %f"
                      % (self._itercounter, cost_after))
            cont, rw_new = relaxation_step(cost_before, cost_after, rw)
            if not bool(cont):
                break
            rw = float(rw_new)
            if self._verbose:
                print("Cost reduction rate:",
                      (cost_before - cost_after) / max(cost_before, 1e-30))

    # ------------------------------------------------------------------ #
    @traced("tsdf_update")
    def updateTSDF(self, curr_tsdf=None, wmax=100.0):
        """Non-rigid canonical fusion (reference core/fusion.py:153-198).

        The canonical volume is padded up to a multiple of the brick
        (values with +tdist, weights with 0) and sliced back; the live
        volume goes in as it is. The brick-candidate and warp-selection
        caches depend only on the node set, so they are built once and
        kept until ``update_graph`` changes it; the sample stage is then
        K2 on the card (its twin on the CPU)."""
        if curr_tsdf is not None:
            self._curr_tsdf = self._tensor(curr_tsdf)
        if self._curr_tsdf is None:
            raise ValueError("tsdf of live frame has not been loaded")
        if self._curr_tsdf.dim() != 3:
            raise ValueError("Only accept 3D np array as tsdf")
        brick = 8 if min(self.volume.values.shape) >= 8 else 4
        vals, shape0 = _pad_to_multiple(self.volume.values, brick,
                                        self._tdist)
        wts, _ = _pad_to_multiple(self.volume.weights, brick, 0.0)
        C = min(16, self._node_cap)
        if self._upd_cache is None or self._upd_cache[0] != (brick, C):
            (cand, pool_risk0), wc = _build_caches(
                self._warp, vals.shape, brick, C, self._knn,
                exact_candidates=False)
            self._upd_cache = ((brick, C), cand, pool_risk0, wc)
        _, cand, pool_risk0, wc = self._upd_cache
        v, w, esc_dropped, pool_risk = WF.update_tsdf_nonrigid(
            vals, wts, self._curr_tsdf, self._warp, self._lw, k=self._knn,
            tdist=self._tdist, wmax=wmax, brick=brick, n_candidates=C,
            use_kernels=self.device.type == "cuda",
            cand_cache=(cand, pool_risk0), warp_cache=wc)
        with host_read(2):
            esc_dropped, pool_risk = int(esc_dropped), int(pool_risk)
        if esc_dropped > 0:
            warnings.warn(
                f"updateTSDF: {esc_dropped} in-volume samples exceeded "
                "the re-sample capacity and were skipped")
        if pool_risk > 0:
            warnings.warn(
                f"updateTSDF: {pool_risk} node-influenced voxels "
                "could not certify the 2-level node-candidate pool covers "
                "their exact kNN (clustered/irregular node distribution); "
                "fusion blend weights may drift from the flat search there")
        sx, sy, sz = shape0
        self.volume = self.volume.replace(values=v[:sx, :sy, :sz],
                                          weights=w[:sx, :sy, :sz])

    # ------------------------------------------------------------------ #
    @traced("graph_update")
    def update_graph(self):
        """Graph maintenance after fusion (reference core/fusion.py:201-239)."""
        self.marching_cubes()
        m = self._mesh
        with host_read():
            n_before = int(self._warp.num_active)
        self._warp, n_dropped = WF.update_graph(
            self._warp, m["verts"], self._vmask(m, self._vert_cap), self._knn)
        self._upd_cache = None  # node set changed: kNN caches invalid
        with host_read():
            n_dropped = int(n_dropped)
        if n_dropped > 0:
            warnings.warn(
                f"deformation-node pool saturated: {n_dropped} new "
                f"nodes dropped (node_cap={self._warp.capacity}); grow "
                "node_cap", RuntimeWarning)
        self._refresh_neighbors()
        if self._verbose:
            n_after = int(self._warp.num_active)
            print("Inserted %d new deformation nodes. Current number of "
                  "deformation nodes: %d" % (n_after - n_before, n_after))
        self._curr_tsdf = None
        self._correspondences = None
        if self._write_warpfield:
            self.write_warp_field(self._warpfield_path, "test")

    # ------------------------------------------------------------------ #
    def _nearest_nodes(self, p):
        return _knn(p, self._warp.node_pos, self._knn,
                    valid=self._warp.active)[1]

    def warp(self, pos, normal=None, m_lw=None):
        """Warp points (and normals) through the current field (reference
        ``warp`` with KDTree lookup, core/fusion.py:502-520). Returns
        numpy arrays."""
        pos = self._tensor(pos)
        single = pos.dim() == 1
        p = pos[None] if single else pos
        idx = self._nearest_nodes(p)
        lw = None if m_lw is None else self._tensor(m_lw)
        if normal is not None:
            nrm = self._tensor(normal)
            nrm = nrm[None] if single else nrm
            out, n = WF.warp_points(self._warp, p, idx, normals=nrm, m_lw=lw)
            out, n = out.cpu().numpy(), n.cpu().numpy()
            return (out[0], n[0]) if single else (out, n)
        out = WF.warp_points(self._warp, p, idx, m_lw=lw).cpu().numpy()
        return out[0] if single else out

    def dq_blend(self, pos):
        """Blend the field at points (reference core/fusion.py:527-551).
        Returns numpy."""
        pos = self._tensor(pos)
        single = pos.dim() == 1
        p = pos[None] if single else pos
        out = WF.blend_at(self._warp, p, self._nearest_nodes(p)).cpu().numpy()
        return out[0] if single else out

    # ------------------------------------------------------------------ #
    def write_warp_field(self, path, filename):
        save_warp_field(self._warp, path, filename, self._itercounter)

    def write_canonical_mesh(self, path, filename):
        out = marching_cubes(self.volume.values, level=0.0,
                             vert_cap=self._vert_cap, face_cap=self._face_cap,
                             step_size=1, use_kernels=True)
        nv, nf = int(out["n_verts"]), int(out["n_faces"])
        save_obj(os.path.join(path, filename),
                 out["verts"][:nv].cpu().numpy(),
                 out["faces"][:nf].cpu().numpy(),
                 normals=out["normals"][:nv].cpu().numpy())

    def write_live_frame_mesh(self, path, filename, warpfield_path):
        """Warp the canonical mesh by a checkpointed field and export —
        the stub the reference left empty (core/fusion.py:589-590)."""
        pos, dq, w, _ = load_warp_field_nodes(warpfield_path)
        if self._mesh is None:
            self.marching_cubes()
        m = self._mesh
        nv = int(m["n_verts"])
        verts = m["verts"][:nv]
        pos, dq, w = (self._tensor(a) for a in (pos, dq, w))
        idx = _knn(verts, pos, min(self._knn, len(pos)))[1]
        se3 = _dq_blend(verts, pos[idx], dq[idx], w[idx])
        warped = dq_transform_point(self._lw, dq_transform_point(se3, verts))
        nf = int(m["n_faces"])
        save_obj(os.path.join(path, filename), warped.cpu().numpy(),
                 m["faces"][:nf].cpu().numpy())

    def average_edge_dist_in_face(self, f):
        v = self._mesh["verts"].cpu().numpy()
        v1, v2, v3 = v[f[0]], v[f[1]], v[f[2]]
        return (np.linalg.norm(v1 - v2) + np.linalg.norm(v1 - v3)
                + np.linalg.norm(v2 - v3)) / 3.0


FusionDM_GPU = FusionDM  # the reference's OpenCL class name
