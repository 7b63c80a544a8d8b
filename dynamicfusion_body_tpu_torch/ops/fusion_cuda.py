"""K5 — multi-view projective depth fusion (``csrc/fuse_depth_multi.cu``).

Counterpart of ``dynamicfusion_body_tpu/ops/fusion_pallas.py:
fuse_depth_multi_bricks``: all depth views fused in one pass over the
volume, the volume read and written once for the whole sequence. The
kernel computes the sequential spec — ``models/tsdf_volume.py:fuse_depth``
view after view — on the dense (X,Y,Z) volume. The TPU kernel's brick
layout, static sampling window (``fuse_window_for``), escape count and
shape gate (``fuse_depth_multi_supported``) have no counterpart: the
kernel samples the depth maps from global memory, so no sample can leave
a window and there is nothing to fall back to.

The kernel culls views per warp tile of ``CULL_TILE`` voxels with a
predicate that is provably conservative (``csrc/fuse_depth_multi.cu:
cull_views``); :func:`fuse_cull_tiles` is that predicate in PyTorch, for the
tests and the smoke's count of what it skips.
"""

from __future__ import annotations

import torch

from ..models.tsdf_volume import fuse_depth
from . import cuda_lib
from .cuda_lib import BUF, FLOAT, INT, PTR

# the n x 12 projection entries and K⁻¹'s row 2 sit in the 48 KiB of
# dynamic shared memory a launch gets without an opt-in
SMEM_BYTES = 48 * 1024
MAX_VIEWS = (SMEM_BYTES // 4 - 3) // 12  # 1023
# the kernel's index math is 32-bit
MAX_ELEMENTS = 2**31 - 1
# a warp's tile (x, y, z): the unit of the view cull
CULL_TILE = (8, 4, 32)
# csrc/fuse_depth_multi.cu:kRoundMargin, 8 x 2^-24
ROUND_MARGIN = 2.0**-21


def fuse_depth_multi_ref(values, weights, depths, projs, kinv_row2,
                         tdist: float, wmax: float = 100.0):
    """Plain PyTorch twin: :func:`fuse_depth` once per view, in order."""
    kinv = kinv_row2.reshape(1, 3).expand(3, 3)  # fuse_depth reads row 2
    for depth, proj in zip(depths, projs):
        values, weights = fuse_depth(values, weights, depth, proj, kinv,
                                     tdist, wmax)
    return values, weights


def check_args(values, weights, depths, projs, kinv_row2) -> None:
    """Raise ValueError unless the arguments fit the kernel: one device,
    float32, matching shapes and at most MAX_VIEWS views."""
    args = (values, weights, depths, projs, kinv_row2)
    if any(a.device != values.device for a in args):
        raise ValueError("fuse_depth_multi: all tensors must be on one device")
    if any(a.dtype != torch.float32 for a in args):
        raise ValueError("fuse_depth_multi: all tensors must be float32")
    if values.dim() != 3 or weights.shape != values.shape:
        raise ValueError(f"fuse_depth_multi: values {tuple(values.shape)} and "
                         f"weights {tuple(weights.shape)} must be one (X,Y,Z)")
    if depths.dim() != 3 or min(depths.shape[1:]) < 2:
        raise ValueError(f"fuse_depth_multi: depths must be (n,H,W) with H, "
                         f"W >= 2, got {tuple(depths.shape)}")
    n = depths.shape[0]
    if not 1 <= n <= MAX_VIEWS:
        raise ValueError(f"fuse_depth_multi: {n} views, need 1..{MAX_VIEWS}")
    if tuple(projs.shape) != (n, 3, 4) or tuple(kinv_row2.shape) != (3,):
        raise ValueError(f"fuse_depth_multi: projs {tuple(projs.shape)} must "
                         f"be ({n},3,4) and kinv_row2 "
                         f"{tuple(kinv_row2.shape)} (3,)")
    if max(values.numel(), depths.numel()) > MAX_ELEMENTS:
        raise ValueError(f"fuse_depth_multi: {values.numel()} voxels or "
                         f"{depths.numel()} depth pixels: the kernel indexes "
                         f"at most {MAX_ELEMENTS} with 32 bits")


def cull_grid(shape) -> tuple:
    """The number of warp tiles along each axis of an (X,Y,Z) volume."""
    return tuple(-(-int(n) // t) for n, t in zip(shape, CULL_TILE))


def fuse_cull_tiles(shape, projs, h: int, w: int) -> torch.Tensor:
    """(n_views, *cull_grid(shape)) bool: True where the kernel's cull skips
    the view for that warp tile, because no voxel of the tile can pass the
    twin's image test (``csrc/fuse_depth_multi.cu:cull_views`` has the proof).

    The same float64 operations in the same order as the kernel's, on
    ``projs``' device. Used by the tests and the smoke; the fusion path
    does not call it."""
    dev = projs.device
    f64 = torch.float64

    def ends(n, t, view):  # each tile's first and last index, clipped
        lo = torch.arange(0, n, t, device=dev, dtype=f64)
        return (lo.reshape(view),
                torch.clamp(lo + (t - 1), max=n - 1).reshape(view))

    (x0, x1), (y0, y1), (z0, z1) = (
        ends(int(n), t, v) for n, t, v in zip(
            shape, CULL_TILE, ((1, -1, 1, 1), (1, 1, -1, 1), (1, 1, 1, -1))))
    p = projs.to(f64)

    def q(r, c):
        return p[:, r, c].reshape(-1, 1, 1, 1)

    e = [(((q(r, 0).abs() * x1 + q(r, 1).abs() * y1) + q(r, 2).abs() * z1)
          + q(r, 3).abs()) * ROUND_MARGIN for r in range(3)]
    eg = (e[0] + e[2], e[0] + w * e[2], e[1] + e[2], e[1] + h * e[2])
    wmin = wmax = None
    gmin, gmax = [None] * 4, [None] * 4
    for c in range(8):
        x, y, z = (x1 if c & 1 else x0), (y1 if c & 2 else y0), \
            (z1 if c & 4 else z0)
        t = [((q(r, 0) * x + q(r, 1) * y) + q(r, 2) * z) + q(r, 3)
             for r in range(3)]
        g = (t[0] + t[2], w * t[2] - t[0], t[1] + t[2], h * t[2] - t[1])
        wmin = t[2] if wmin is None else torch.minimum(wmin, t[2])
        wmax = t[2] if wmax is None else torch.maximum(wmax, t[2])
        for a in range(4):
            gmin[a] = g[a] if c == 0 else torch.minimum(gmin[a], g[a])
            gmax[a] = g[a] if c == 0 else torch.maximum(gmax[a], g[a])
    front = (gmax[0] < -eg[0]) | (gmax[1] < -eg[1]) | (gmax[2] < -eg[2]) \
        | (gmax[3] < -eg[3])
    back = (gmin[0] > eg[0]) | (gmin[1] > eg[1]) | (gmin[2] > eg[2]) \
        | (gmin[3] > eg[3])
    return torch.where(wmin > e[2], front, (wmax < -e[2]) & back)


def _check_cull_map(values, weights, depths, projs, kinv_row2, tdist,
                    wmax=100.0, cull_map=None) -> None:
    if cull_map is None:
        return
    want = (depths.shape[0], *cull_grid(values.shape))
    if (tuple(cull_map.shape) != want or cull_map.dtype != torch.uint8
            or cull_map.device != values.device
            or not cull_map.is_contiguous()):
        raise ValueError(f"fuse_depth_multi: cull_map must be a "
                         f"contiguous uint8 {want} on {values.device}")


def _twin(values, weights, depths, projs, kinv_row2, tdist, wmax=100.0,
          cull_map=None):
    """The CPU's fuse_depth_multi: the plain twin, and ``cull_map`` the
    PyTorch predicate."""
    if cull_map is not None:
        cull_map.copy_(fuse_cull_tiles(values.shape, projs,
                                       *depths.shape[1:]))
    return fuse_depth_multi_ref(values, weights, depths, projs, kinv_row2,
                                tdist, wmax)


# (vals, wts, depths, projs, kinv_row2, n_views, h, w, X, Y, Z, tdist,
#  wmax, vals_out, wts_out, cull_out (null: none), stream)
_LAUNCH = cuda_lib.KERNELS.entry(
    "dfb_fuse_depth_multi", PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
    INT, FLOAT, FLOAT, PTR, PTR, PTR, PTR, kernel="fuse_depth_multi_kernel")
# (vec, n_views, out[6])
_INFO = cuda_lib.KERNELS.entry("dfb_fuse_depth_multi_info", INT, INT, BUF)


@cuda_lib.wrapper(_LAUNCH, twin=_twin, check=_check_cull_map)
def fuse_depth_multi(values, weights, depths, projs, kinv_row2,
                     tdist: float, wmax: float = 100.0, cull_map=None):
    """Fuse ``n`` depth maps into a TSDF in one pass.

    values/weights (X,Y,Z) f32; depths (n,H,W) f32 negative-depth maps;
    projs (n,3,4) f32 = K·lw·IND; kinv_row2 (3,) f32, row 2 of K⁻¹.
    Returns new (values, weights). ``cull_map``, a uint8 tensor of shape
    (n, *cull_grid(values.shape)) on the volume's device, receives 1 where
    the view was culled for that warp tile (the fusion path passes none;
    on the CPU it receives :func:`fuse_cull_tiles`). The kernel takes
    strided views made contiguous."""
    args = (values, weights, depths, projs, kinv_row2)
    check_args(*args)
    vals_c, wts_c, dep_c, proj_c, kr_c = (a.contiguous() for a in args)
    out_v = torch.empty_like(vals_c)
    out_w = torch.empty_like(wts_c)
    n, h, w = depths.shape
    X, Y, Z = values.shape
    _LAUNCH(vals_c.data_ptr(), wts_c.data_ptr(), dep_c.data_ptr(),
            proj_c.data_ptr(), kr_c.data_ptr(), n, h, w, X, Y, Z,
            float(tdist), float(wmax), out_v.data_ptr(), out_w.data_ptr(),
            None if cull_map is None else cull_map.data_ptr(),
            cuda_lib.stream_ptr(values.device))
    return out_v, out_w


def kernel_info(n_views: int = 8) -> dict:
    """What the card makes of K5's two instantiations (``vec``: 16-byte
    loads where Z % 4 == 0; ``scalar``: any Z), as :func:`cuda_lib.info`
    reads it at ``n_views`` views, with the dynamic shared bytes that
    takes. Needs the card."""
    return {name: cuda_lib.info(_INFO, vec, n_views,
                                last=("dynamic_smem", "grid"))
            for name, vec in (("vec", 1), ("scalar", 0))}
