"""Canonical TSDF volume state and projective depth fusion — counterpart of
``dynamicfusion_body_tpu/models/tsdf_volume.py``.

Reference semantics: the OpenCL kernel ``fuse_depth``
(core/fusion_dm.py:630-673) — per voxel: project through
``proj = K·lw·IND``, bilinearly sample the (negative-valued) depth map,
convert to a signed distance along the camera ray via row 2 of K⁻¹,
truncate, and apply the weighted running average with the ``WMAX`` clamp.

:func:`fuse_depth` is the plain PyTorch form and the formula the K5 kernel
(``ops/fusion_cuda.py``) evaluates per voxel, in the same operation order.
``x_offset`` is the global x index of a block's first plane: the sharded
path (``parallel/sharded.py``) gives each rank its x-slab.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops.rigid_update_cuda import rigid_update


@dataclass
class TsdfVolume:
    """values: signed distances (R,R,R); weights: accumulation weights
    (R,R,R); ind: 4x4 grid-index→world matrix (reference ``_IND``,
    core/fusion_dm.py:70,136-141)."""

    values: torch.Tensor
    weights: torch.Tensor
    ind: torch.Tensor

    @classmethod
    def create(cls, res: int, tdist: float, ind=None, device="cuda"):
        """Empty volume (values |tdist|, weights 0) on ``ind``'s device, or
        on ``device`` when no ``ind`` is given (identity then)."""
        if ind is None:
            ind = torch.eye(4, dtype=torch.float32, device=device)
        dev = ind.device
        return cls(
            values=torch.full((res, res, res), abs(tdist),
                              dtype=torch.float32, device=dev),
            weights=torch.zeros((res, res, res), dtype=torch.float32,
                                device=dev),
            ind=ind,
        )

    @property
    def res(self) -> int:
        return self.values.shape[0]

    def replace(self, **changes) -> "TsdfVolume":
        return dataclasses.replace(self, **changes)

    def grid_to_world(self, pts: torch.Tensor) -> torch.Tensor:
        """Voxel-index coords (...,3) → world coords via ``ind``."""
        return (torch.einsum("ij,...j->...i", self.ind[:3, :3], pts)
                + self.ind[:3, 3])

    def world_to_grid(self, pts: torch.Tensor) -> torch.Tensor:
        inv = torch.linalg.inv(self.ind)
        return torch.einsum("ij,...j->...i", inv[:3, :3], pts) + inv[:3, 3]


def _grid_axes(shape, device, x_offset=0):
    """Voxel index coordinates as broadcastable (X,1,1), (1,Y,1), (1,1,Z)
    float32 tensors, x starting at ``x_offset``."""
    rx, ry, rz = shape
    f32 = torch.float32
    return (torch.arange(rx, dtype=f32, device=device)[:, None, None]
            + x_offset,
            torch.arange(ry, dtype=f32, device=device)[None, :, None],
            torch.arange(rz, dtype=f32, device=device)[None, None, :])


def fuse_depth(values, weights, depth, proj, kinv, tdist: float,
               wmax: float = 100.0, x_offset=0):
    """One projective TSDF update from one depth map.

    values/weights (R,R,R); depth (H,W) negative-depth map; proj (3,4) =
    K·lw·IND; kinv (3,3), of which row 2 is read; x_offset the global x
    index of the block's first plane. Returns the updated
    (values, weights). Functional spec: reference OpenCL kernel
    core/fusion_dm.py:630-673 (the JAX package checks its counterpart
    against a NumPy transcription, tests/test_fusion_kernels.py)."""
    h, w = depth.shape
    xs, ys, zs = _grid_axes(values.shape, values.device, x_offset)

    u = proj[0, 0] * xs + proj[0, 1] * ys + proj[0, 2] * zs + proj[0, 3]
    v = proj[1, 0] * xs + proj[1, 1] * ys + proj[1, 2] * zs + proj[1, 3]
    pw = proj[2, 0] * xs + proj[2, 1] * ys + proj[2, 2] * zs + proj[2, 3]

    px = u / pw
    py = v / pw
    inb = (px >= 0.0) & (py >= 0.0) & (px < w - 1) & (py < h - 1)

    # clamped bilinear sample (invalid voxels masked by ``inb``)
    pxc = torch.where(inb, px, 0.0)
    pyc = torch.where(inb, py, 0.0)
    x0 = torch.floor(pxc).long()
    y0 = torch.floor(pyc).long()
    wx = pxc - x0.float()
    wy = pyc - y0.float()
    dflat = depth.reshape(-1)

    def g(iy, ix):
        return dflat[iy * w + ix]

    up = g(y0, x0) * (1 - wx) + g(y0, x0 + 1) * wx
    bot = g(y0 + 1, x0) * (1 - wx) + g(y0 + 1, x0 + 1) * wx
    pz = -(up * (1 - wy) + bot * wy)

    # signed distance along the camera principal axis; invalid/too-close
    # depth carves free space at -tdist (GPU kernel lines 650-659)
    behind = pz <= tdist
    dz_open = -(kinv[2, 0] * (px * pz - u) + kinv[2, 1] * (py * pz - v)
                + kinv[2, 2] * (pz - pw))
    dz = torch.where(behind, -tdist, dz_open)

    upd = inb & (dz < tdist)
    wi = 1.0
    new_w = torch.clamp_max(wi + weights, wmax)
    new_vals = ((new_w - wi) * values
                + wi * torch.clamp_min(dz, -tdist)) / new_w
    return torch.where(upd, new_vals, values), torch.where(upd, new_w, weights)


def update_tsdf_rigid(values, weights, live, lw_dq, tdist: float,
                      wmax: float = 100.0, x_offset=0):
    """Rigid TSDF-to-TSDF fusion: warp each canonical voxel center by the
    global DQ, trilerp the live TSDF, running-average update (reference
    FusionDM.updateTSDF, core/fusion_dm.py:300-316: skip when the sample is
    out of volume or <= -tdist; wi = 1). ``x_offset`` as in
    :func:`fuse_depth`. K8 on the card, its plain twin on the CPU
    (``ops/rigid_update_cuda.py``)."""
    return rigid_update(values, weights, live, lw_dq, tdist, wmax, x_offset)
