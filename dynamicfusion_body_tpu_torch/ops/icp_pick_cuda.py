"""K9 — the rigid ICP's canonical warp and point-to-plane pick
(``csrc/icp_pick.cu``).

Replaces no TPU kernel: the JAX package's rigid ICP warps the canonical
mesh by the one pose DQ and picks each row's closest-point
correspondence in plain array code, as the port's CPU path still does
(``pipeline/correspondence.py:rigid_correspondences_twin``:
``dq_transform_point``, ``dq_transform_normal``, then
``closest_point_correspondences_lattice``). On the card that composition
is ~390 launches a search over every slot of the mesh's caps, most of
them broadcast elementwise passes over (V, 8) temporaries, and two
blocking uploads of the conjugate's sign vector.
:func:`rigid_correspondences_lattice` runs it as two kernels around K7's
search: the warp of the counted rows (the queries), then the pick over
K7's (dists, idx), both reading the DQ and the count on the card. They
evaluate the composition's float32 expression tree literally
(``csrc/icp_pick.cu`` says how), so the outputs are its outputs bit for
bit. The pick's policy (the cost, the 1.0 fallback, the tolerance) is
the pipeline's; this module imports only its plain twin from there.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .cuda_lib import BUF, FLOAT, INT, PTR
from .knn_grid_cuda import MAX_K, _count, knn_grid
from ..pipeline.correspondence import rigid_correspondences_twin
from ..utils.profiling import span

# (dq, verts, n_verts (int32 on the card), V, warped, stream)
_WARP = cuda_lib.KERNELS.entry(
    "dfb_icp_warp", PTR, PTR, PTR, INT, PTR, PTR, kernel="icp_warp_kernel")
# (dq, warped, normals, n_verts, V, live, dists, idx, k, tolerance, corr,
#  valid, cost, stream)
_PICK = cuda_lib.KERNELS.entry(
    "dfb_icp_pick", PTR, PTR, PTR, PTR, INT, PTR, PTR, PTR, INT, FLOAT, PTR,
    PTR, PTR, PTR, kernel="icp_pick_kernel")
# (which: 0 the warp, 1 the pick; out[6])
_INFO = cuda_lib.KERNELS.entry("dfb_icp_pick_info", INT, BUF)


def check_args(dq, verts, normals, n_verts, live_verts, n_live, k: int,
               *_, **__) -> None:
    """Raise ValueError unless the arguments fit the kernels: one device,
    float32, a DQ of 8, verts and normals of one (V,3), live (P,3), k in
    1..MAX_K, V·k and 3·V under 2^31 (the kernels' int row index)."""
    args = (dq, verts, normals, live_verts)
    if any(a.device != dq.device for a in args):
        raise ValueError("rigid_correspondences: all tensors must be on one "
                         "device")
    if any(a.dtype != torch.float32 for a in args):
        raise ValueError("rigid_correspondences: all tensors must be float32")
    if tuple(dq.shape) != (8,):
        raise ValueError(f"rigid_correspondences: dq {tuple(dq.shape)} must "
                         f"be (8,)")
    if verts.dim() != 2 or verts.shape[1] != 3 or normals.shape != verts.shape:
        raise ValueError(f"rigid_correspondences: verts "
                         f"{tuple(verts.shape)} and normals "
                         f"{tuple(normals.shape)} must be one (V,3)")
    if live_verts.dim() != 2 or live_verts.shape[1] != 3:
        raise ValueError(f"rigid_correspondences: live "
                         f"{tuple(live_verts.shape)} must be (P,3)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"rigid_correspondences: k = {k}, need 1..{MAX_K}")
    if max(verts.shape[0] * k, 3 * verts.shape[0]) >= 2**31:
        raise ValueError(f"rigid_correspondences: {verts.shape[0]} rows of "
                         f"{k}: the kernels index at most 2^31 slots")


@cuda_lib.wrapper(_WARP)
def warp(dq, verts, n_verts):
    """The first ``n_verts`` (0-d int32 on the card) of ``verts`` (V,3)
    moved by ``dq`` (``icp_warp_kernel``); the other rows of the (V,3)
    result are not written."""
    out = torch.empty_like(verts)
    _WARP(dq.data_ptr(), verts.data_ptr(), n_verts.data_ptr(),
          verts.shape[0], out.data_ptr(), cuda_lib.stream_ptr(verts.device))
    return out


@cuda_lib.wrapper(_PICK, twin=rigid_correspondences_twin, check=check_args)
def rigid_correspondences_lattice(dq, verts, normals, n_verts, live_verts,
                                  n_live, k: int, tolerance: float,
                                  extent: float):
    """``closest_point_correspondences_lattice`` of the canonical
    ``verts``/``normals`` (V,3) moved by the one pose ``dq`` (8,), against
    the first ``n_live`` of ``live_verts`` (P,3): (corr (V,3), valid (V,)
    bool, best_cost (V,)); rows past ``n_verts`` come out invalid. The
    counts are 0-d tensors on the device (or ints). On the card: the warp,
    K7 (span ``knn``) and the pick; no host read."""
    dq, verts = dq.contiguous(), verts.contiguous()
    normals, live_verts = normals.contiguous(), live_verts.contiguous()
    n = _count(n_verts, verts.device)
    wv = warp(dq, verts, n)
    with span("knn"):
        dists, idx = knn_grid(wv, live_verts, k, n, n_live, extent)
    return pick(dq, wv, normals, n, live_verts, dists, idx, tolerance)


def pick(dq, wv, normals, n_verts, live_verts, dists, idx, tolerance: float):
    """The pick (``icp_pick_kernel``) over every row of K7's ``dists``
    (V,k) and ``idx`` (V,k) for the warped rows ``wv`` (V,3) and the
    canonical ``normals`` (V,3), on contiguous CUDA tensors; ``n_verts``
    0-d int32 on the card. Returns (corr, valid, best_cost). Its launches
    count in ``rigid_correspondences_lattice.launches``."""
    dev = wv.device
    V, k = dists.shape
    corr = torch.empty_like(wv)
    valid = torch.empty(V, dtype=torch.bool, device=dev)
    cost = torch.empty(V, dtype=torch.float32, device=dev)
    _PICK(dq.data_ptr(), wv.data_ptr(), normals.data_ptr(),
          n_verts.data_ptr(), V, live_verts.data_ptr(), dists.data_ptr(),
          idx.data_ptr(), k, float(tolerance), corr.data_ptr(),
          valid.data_ptr(), cost.data_ptr(), cuda_lib.stream_ptr(dev))
    return corr, valid, cost


def kernel_info(which: int) -> dict:
    """What the card makes of the warp (``which`` 0) or the pick (1), as
    :func:`cuda_lib.info` reads it, with static shared bytes. Needs the
    card."""
    return cuda_lib.info(_INFO, which, last=("static_smem",))
