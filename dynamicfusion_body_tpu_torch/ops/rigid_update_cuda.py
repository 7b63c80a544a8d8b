"""K8 — the rigid TSDF-to-TSDF update (``csrc/rigid_update.cu``).

Replaces no TPU kernel: the JAX package runs the plain ``jnp``
``models/tsdf_volume.py:update_tsdf_rigid`` (reference
``FusionDM.updateTSDF``, core/fusion_dm.py:300-316). Each canonical voxel
centre is moved by the global DQ through the sandwich ``dq·v·conj(dq)``,
the live TSDF is trilerped there, and the voxel takes the running average
with weight 1 (clamped to ``wmax``) where the sample lies in the live
volume and above ``-tdist``. :func:`rigid_update_ref` is that formula in
plain PyTorch, the twin the CPU takes; the kernel evaluates it in the same
order of operations in one pass, so the two agree bit for bit on finite
inputs. The kernel is bound by bytes (20 a voxel: values and weights read
and written, live read once); its note says how it streams them.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .cuda_lib import BUF, FLOAT, INT, PTR
from .dualquat import dq_transform_point
from .interp import trilinear

# the kernel's index math is 32-bit
MAX_ELEMENTS = 2**31 - 1


def rigid_update_ref(values, weights, live, lw_dq, tdist: float,
                     wmax: float = 100.0, x_offset: int = 0):
    """Plain PyTorch twin (module docstring): values/weights (X,Y,Z), live
    (rx,ry,rz), lw_dq (8,); x_offset the global x index of the block's first
    plane. Returns the updated (values, weights)."""
    axes = [torch.arange(n, dtype=torch.float32, device=values.device)
            for n in values.shape]
    axes[0] = axes[0] + x_offset
    pos = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    warped = dq_transform_point(lw_dq, pos.reshape(-1, 3))
    tsdf_l, valid = trilinear(live, warped)
    tsdf_l = tsdf_l.reshape(values.shape)
    valid = valid.reshape(values.shape)

    upd = valid & (tsdf_l > -tdist)
    wi = 1.0
    new_w = weights + wi
    new_vals = (values * weights + torch.clamp_max(tsdf_l, tdist) * wi) / new_w
    return (torch.where(upd, new_vals, values),
            torch.where(upd, torch.clamp_max(new_w, wmax), weights))


def check_args(values, weights, live, lw_dq) -> None:
    """Raise ValueError unless the arguments fit the kernel: one device,
    float32, values and weights of one (X,Y,Z), a 3-D live volume, a DQ of
    8, all contiguous, each volume under 2^31 elements."""
    args = (values, weights, live, lw_dq)
    if any(a.device != values.device for a in args):
        raise ValueError("rigid_update: all tensors must be on one device")
    if any(a.dtype != torch.float32 for a in args):
        raise ValueError("rigid_update: all tensors must be float32")
    if values.dim() != 3 or weights.shape != values.shape:
        raise ValueError(f"rigid_update: values {tuple(values.shape)} and "
                         f"weights {tuple(weights.shape)} must be one (X,Y,Z)")
    if live.dim() != 3:
        raise ValueError(f"rigid_update: live {tuple(live.shape)} must be "
                         f"(X,Y,Z)")
    if tuple(lw_dq.shape) != (8,):
        raise ValueError(f"rigid_update: lw_dq {tuple(lw_dq.shape)} must be "
                         f"(8,)")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("rigid_update: all tensors must be contiguous")
    if max(values.numel(), live.numel()) > MAX_ELEMENTS:
        raise ValueError(f"rigid_update: {values.numel()} voxels or "
                         f"{live.numel()} live cells: the kernel indexes at "
                         f"most {MAX_ELEMENTS} with 32 bits")


def _vec(values, weights) -> int:
    """4 (the float4 instantiation) where Z is a multiple of 4 and values
    and weights start on 16 bytes (the outputs, fresh, do), else 1."""
    ok = (values.shape[-1] % 4 == 0 and values.data_ptr() % 16 == 0
          and weights.data_ptr() % 16 == 0)
    return 4 if ok else 1


# (vals, wts, live, dq, X, Y, Z, rx, ry, rz, x_offset, tdist, wmax,
#  vals_out, wts_out, vec (4: float4, 1: scalar), stream)
_LAUNCH = cuda_lib.KERNELS.entry(
    "dfb_rigid_update", PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT,
    FLOAT, FLOAT, PTR, PTR, INT, PTR, kernel="rigid_update_kernel")
# (vec, out[6])
_INFO = cuda_lib.KERNELS.entry("dfb_rigid_update_info", INT, BUF)


def launch(values, weights, live, lw_dq, tdist: float, wmax: float,
           x_offset: int, vec: int):
    """K8 on CUDA tensors that passed :func:`check_args`, with the ``vec``
    instantiation (4: float4 accesses, which need what :func:`_vec` checks;
    1: scalar). Returns new (values, weights)."""
    out_v = torch.empty_like(values)
    out_w = torch.empty_like(weights)
    X, Y, Z = values.shape
    rx, ry, rz = live.shape
    _LAUNCH(values.data_ptr(), weights.data_ptr(), live.data_ptr(),
            lw_dq.data_ptr(), X, Y, Z, rx, ry, rz, int(x_offset),
            float(tdist), float(wmax), out_v.data_ptr(), out_w.data_ptr(),
            vec, cuda_lib.stream_ptr(values.device))
    return out_v, out_w


@cuda_lib.wrapper(
    _LAUNCH, twin=rigid_update_ref,
    check=lambda v, w, live, dq, *_, **__: check_args(v, w, live, dq))
def rigid_update(values, weights, live, lw_dq, tdist: float,
                 wmax: float = 100.0, x_offset: int = 0):
    """The rigid update of ``values``/``weights`` (X,Y,Z) by ``live``
    (rx,ry,rz) under the DQ ``lw_dq`` (8,), the block's first plane at
    global x ``x_offset``. Returns new (values, weights): the inputs are
    not written."""
    vec = _vec(values, weights)
    return launch(values, weights, live, lw_dq, tdist, wmax, x_offset, vec)


def kernel_info(vec: int = 4) -> dict:
    """What the card makes of the ``vec`` instantiation, as
    :func:`cuda_lib.info` reads it, with static shared bytes. Needs the
    card."""
    return cuda_lib.info(_INFO, vec, last=("static_smem",))
