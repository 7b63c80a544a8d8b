"""The live-TSDF sampling kernels of the non-rigid update, counterparts of
``dynamicfusion_body_tpu/ops/trilerp_pallas.py``:

* K2 ``warp_trilerp_bricks_cached`` (``csrc/warp_trilerp_cached.cu``), with
  its helpers ``live_brick_mip`` and ``mip_skip_supported``: per canonical
  brick, blend the node DQs of the cached per-voxel top-k selection
  (``models/warp_field.py:build_warp_cache``), normalize, warp every voxel
  centre and apply the global pose; then sample the live TSDF at the warped
  positions, except where the live-space mip certificate proves the
  brick's samples constant (see :func:`mip_short_bricks`);
* K3 ``warp_trilerp_bricks`` (``csrc/warp_trilerp_bricks.cu``): the same
  without a cache — the per-voxel top-k among the brick's candidates, its
  Gaussian weights and ``wi`` are computed in the kernel; no mip
  certificate;
* K4 ``trilerp_bricks`` (``csrc/trilerp_bricks.cu``): the trilerp alone,
  at given coordinates;
* K6 ``trilerp_ablation`` (``csrc/trilerp_ablation.cu``): K4 taken apart
  into its tap loads and its weights, counterpart of the TPU ablation in
  ``tools/profile_trilerp.py:142``, for the profiling tools; it stages each
  row's tap box in shared memory (:func:`trilerp_box_rows`), as the TPU
  kernel stages its VMEM box.

All four share one device trilerp (``csrc/trilerp.cuh``), the formula of
``ops/interp.py:trilinear_c`` (the JAX package's ``_trilinear_c``). What
the TPU mechanisms become here:
* the (16, 24, Z) VMEM staging box and its escape output are gone: K2-K4
  read taps straight from global memory, and K6 stages a row's box in
  shared memory where it fits and reads global memory where it does not,
  so no sample escapes and ``valid`` is exactly "inside the live volume";
* the bf16 hi/lo MXU contraction becomes the plain f32 formula (so the
  JAX update's near-threshold re-sample has no counterpart, see
  ``models/warp_field.py:update_tsdf_nonrigid``);
* the packed (M, 16) node table becomes the WarpField's own arrays: K2
  reads the (M, 8) node DQs, K3 also the positions, supports and active
  flags;
* the ``group``, ``precise``, ``interpret`` and ``x_offset`` arguments
  have no counterpart (no shared DMA box, one f32 path, no interpreter;
  the sharded path, ``parallel/``, runs the plain form with its offset,
  ``warp_voxels(x_offset=...)``, as the JAX package's runs no Pallas
  kernel).

The canonical lattice ``vol_shape`` (which the caller may pad up to a
multiple of the brick) sets the brick grid and the voxel centres; the
live volume's own shape sets the in-volume test and the tap clamps, as in
the JAX kernels and ``_trilinear_c``. K2 and K3 write the warped
coordinates only with ``coords=True`` (the default, for the tools and the
tests); the TSDF update asks for none.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .compwise import dq_normalize8_c, dq_point_c
from .cuda_lib import BUF, FLOAT, INT, LLONG, PTR
from .interp import trilinear_c, trilinear_index

# brick edges K2 and K3 take on the card: each thread owns a voxel pair,
# 256 threads a brick of at most 512 voxels
KERNEL_BRICKS = (2, 4, 6, 8)
# the last two fields of the _info entries of K2, K3 and K6
_GRID_SMEM = ("grid", "dynamic_smem")


def _axis_windowred(v, axis, red):
    """Reduction over the window [8b, 8b+8] (inclusive, edge-clamped)
    along one axis: the 8-block reduction combined with the next block's
    first plane."""
    n = v.shape[axis]
    nb = n // 8
    shp = v.shape[:axis] + (nb, 8) + v.shape[axis + 1:]
    blk = red(v.reshape(shp), dim=axis + 1)
    nxt = torch.clamp_max(torch.arange(nb, device=v.device) * 8 + 8, n - 1)
    nxt = torch.index_select(v, axis, nxt)
    return (torch.minimum if red is torch.amin else torch.maximum)(blk, nxt)


def live_brick_mip(live: torch.Tensor):
    """Per-live-brick min/max over the brick's 8³ voxels plus a one-voxel
    high-side halo (window [8b, 8b+8] inclusive — both taps of any sample
    whose floor lands in the brick). Returns (mn, mx), each (nlx·nly, nlz)
    f32. Plain tensor code, as in the JAX package (XLA there)."""
    rx, ry, rz = live.shape
    mn = mx = live
    for a in (2, 1, 0):
        mn = _axis_windowred(mn, a, torch.amin)
        mx = _axis_windowred(mx, a, torch.amax)
    return (mn.reshape((rx // 8) * (ry // 8), rz // 8),
            mx.reshape((rx // 8) * (ry // 8), rz // 8))


def mip_skip_supported(shape) -> bool:
    """The 3×3×3 mip window needs ≥ 3 live bricks per axis and
    8-divisible extents."""
    return all(s % 8 == 0 and s >= 24 for s in shape)


def warp_voxels(node_dq, cand, sel, selw, lw_dq, shape, brick: int,
                x_offset=0):
    """Warped live-space coordinates (wx, wy, wz), each (NB, V), of every
    canonical voxel centre in brick-row layout: cached-selection DQ blend
    → 8-norm normalize → sandwich → global pose. The K2 kernel's first
    stage, in the same operation order. The lattice's x starts at
    ``x_offset`` (a sharded slab's origin; the kernels take none)."""
    NB = cand.shape[0]
    V = brick ** 3
    k = selw.shape[1]
    nby, nbz = shape[1] // brick, shape[2] // brick
    dev = cand.device
    b = torch.arange(NB, device=dev)[:, None]
    v = torch.arange(V, device=dev)[None, :]
    px = ((b // (nby * nbz)) * brick + x_offset
          + v // (brick * brick)).float()
    py = (((b // nbz) % nby) * brick + (v // brick) % brick).float()
    pz = ((b % nbz) * brick + v % brick).float()
    acc = None
    for j in range(k):
        slot = ((sel >> (5 * j)) & 31).long()
        dq = node_dq[torch.gather(cand, 1, slot)]           # (NB, V, 8)
        w = selw[:, j, :]
        terms = [w * dq[..., e] for e in range(8)]
        acc = terms if acc is None else [a + t for a, t in zip(acc, terms)]
    se3 = dq_normalize8_c(tuple(acc))
    wx, wy, wz = dq_point_c(se3, (px, py, pz))
    lw = tuple(lw_dq[e] for e in range(8))
    return dq_point_c(lw, (wx, wy, wz))


def mip_short_bricks(wx, wy, wz, invol, shape, tdist: float, live_mip):
    """The live-space uniformity certificate per brick (JAX
    ``_mip_class``). Returns (short (NB,) bool, cval (NB,) f32): a short
    brick's samples all take the value cval exactly —

    * covered (every in-volume sample's taps inside a 3×3×3 live-brick
      window) and all taps ≤ -tdist → cval = -tdist, which the running
      average's strict ``> -tdist`` test skips;
    * covered and all taps one value → that value (a convex combination
      of equal taps);
    * no in-volume sample → -tdist (nothing is fused there).
    """
    mn, mx = live_mip
    nl = [s // 8 for s in shape]
    big = 1e9
    lo, hi = [], []
    for w, n in zip((wx, wy, wz), nl):
        wlo = torch.where(invol, w, big).amin(dim=1)
        whi = torch.where(invol, w, -big).amax(dim=1)
        lo.append(torch.clamp(torch.div(torch.floor(wlo).int(), 8,
                                        rounding_mode="floor"), 0, n - 1))
        hi.append(torch.clamp(torch.div(torch.floor(whi).int(), 8,
                                        rounding_mode="floor"), 0, n - 1))
    covered = ((hi[0] - lo[0] <= 2) & (hi[1] - lo[1] <= 2)
               & (hi[2] - lo[2] <= 2))
    amin = torch.full_like(wx[:, 0], big)
    amax = torch.full_like(wx[:, 0], -big)
    for i in range(3):
        xi = lo[0] + i
        for j in range(3):
            yi = lo[1] + j
            for t in range(3):
                zi = lo[2] + t
                m = (xi <= hi[0]) & (yi <= hi[1]) & (zi <= hi[2])
                flat = ((torch.clamp_max(xi, nl[0] - 1) * nl[1]
                         + torch.clamp_max(yi, nl[1] - 1)) * nl[2]
                        + torch.clamp_max(zi, nl[2] - 1)).long()
                amin = torch.where(m, torch.minimum(amin, mn.reshape(-1)[flat]),
                                   amin)
                amax = torch.where(m, torch.maximum(amax, mx.reshape(-1)[flat]),
                                   amax)
    is_skip = covered & (amax <= -tdist)
    is_const = covered & (amin == amax)
    short = ~invol.any(dim=1) | is_skip | is_const
    cval = torch.where(is_skip, torch.full_like(amin, -tdist), amin)
    return short, cval


def warp_trilerp_bricks_cached_ref(live, node_dq, cand, sel, selw, lw_dq,
                                   brick: int = 8, tdist=None, live_mip=None,
                                   vol_shape=None, coords: bool = True):
    """Plain PyTorch twin of K2: (vals, valid, wx, wy, wz), each (NB, V);
    valid is bool; wx, wy, wz are None unless ``coords``."""
    vol_shape = tuple(live.shape) if vol_shape is None else tuple(vol_shape)
    wx, wy, wz = warp_voxels(node_dq, cand, sel, selw, lw_dq, vol_shape,
                             brick)
    vals, valid = trilinear_c(live, wx, wy, wz)
    if tdist is not None and live_mip is not None:
        short, cval = mip_short_bricks(wx, wy, wz, valid, live.shape, tdist,
                                       live_mip)
        vals = torch.where(short[:, None], cval[:, None], vals)
    if not coords:
        wx = wy = wz = None
    return vals, valid, wx, wy, wz


def _check_lattice(name, live, vol_shape, brick, NB):
    """The brick grid of ``vol_shape`` must hold NB bricks of an edge the
    kernels take, and ``live`` fewer than 2^31 cells; returns vol_shape as
    a tuple."""
    vol_shape = tuple(live.shape) if vol_shape is None else tuple(vol_shape)
    if len(vol_shape) != 3 or live.dim() != 3:
        raise ValueError(f"{name}: live and vol_shape must be 3-D")
    vx, vy, vz = vol_shape
    if (vx % brick or vy % brick or vz % brick
            or NB != (vx // brick) * (vy // brick) * (vz // brick)):
        raise ValueError(f"{name}: brick grid of vol_shape {vol_shape} does "
                         f"not match NB={NB}")
    if brick not in KERNEL_BRICKS:
        raise ValueError(f"{name}: brick={brick} is not one of "
                         f"{KERNEL_BRICKS}")
    if live.numel() >= 2 ** 31:
        raise ValueError(f"{name}: live {tuple(live.shape)} has 2^31 cells "
                         "or more (the taps take 32-bit offsets)")
    return vol_shape


def _aligned(t):
    """``t`` itself when its data is 16-byte aligned, else a copy: the
    kernels fetch rows with 16-byte asynchronous copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _coord_outputs(coords, shape, dev):
    """K2's and K3's coordinate outputs: three (NB, V) f32 tensors, or
    Nones (null pointers for the kernel) when not asked for."""
    if not coords:
        return (None,) * 3
    return tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for _ in range(3))


def _ptr(t):
    return None if t is None else t.data_ptr()


# (live, node_dq, cand, sel, selw, lw, mip_mn, mip_mx, use_mip, tdist, rx,
#  ry, rz, vy, vz, brick, NB, C, k, M (nodes), vals, valid, wx, wy, wz (all
#  three null: no coordinates), stream)
_K2 = cuda_lib.KERNELS.entry(
    "dfb_warp_trilerp_cached", PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT,
    FLOAT, INT, INT, INT, INT, INT, INT, INT, INT, INT, INT,
    PTR, PTR, PTR, PTR, PTR, PTR, kernel="warp_trilerp_cached_kernel")
# (brick, k, out[6])
_K2_INFO = cuda_lib.KERNELS.entry("dfb_warp_trilerp_cached_info", INT, INT,
                                  BUF)


@cuda_lib.wrapper(_K2, twin=warp_trilerp_bricks_cached_ref)
def warp_trilerp_bricks_cached(live, node_dq, cand, sel, selw, lw_dq,
                               brick: int = 8, tdist=None, live_mip=None,
                               vol_shape=None, coords: bool = True):
    """K2: fused per-frame sample stage of the non-rigid TSDF update.

    live (rx, ry, rz) f32; ``vol_shape`` the canonical lattice (default
    ``live.shape``), whose ``vol_shape // brick`` grid holds the NB bricks;
    node_dq (M, 8) f32; cand (NB, C) node ids (the kernel clamps an id
    outside [0, M) into it); sel (NB, V) int32 packed
    slots and selw (NB, k, V) f32 from ``build_warp_cache``; lw_dq (8,)
    f32. With ``tdist`` and ``live_mip`` (from :func:`live_brick_mip`)
    certified bricks emit exact constants; that needs ``vol_shape`` equal
    to ``live.shape``. Returns (vals, valid, wx, wy, wz), each (NB, V);
    without ``coords`` the kernel writes no coordinates and wx, wy, wz are
    None. On the card ``brick`` is one of ``KERNEL_BRICKS``."""
    rx, ry, rz = live.shape
    NB, C = cand.shape
    V = brick ** 3
    k = selw.shape[1]
    M = node_dq.shape[0]
    vol_shape = _check_lattice("warp_trilerp_bricks_cached", live, vol_shape,
                               brick, NB)
    if C > 32 or not 1 <= k <= 6:
        raise ValueError(f"unsupported C={C}, k={k}")
    if tuple(sel.shape) != (NB, V) or tuple(selw.shape) != (NB, k, V):
        raise ValueError(f"sel {tuple(sel.shape)} / selw {tuple(selw.shape)}"
                         f" do not match (NB={NB}, V={V})")
    if node_dq.shape != (M, 8) or lw_dq.shape != (8,):
        raise ValueError("node_dq must be (M, 8) and lw_dq (8,)")
    use_mip = tdist is not None and live_mip is not None
    if use_mip and not (mip_skip_supported(live.shape)
                        and vol_shape == tuple(live.shape)):
        raise ValueError(f"mip certificate needs mip_skip_supported "
                         f"{tuple(live.shape)} and vol_shape {vol_shape} "
                         "equal to it")
    dev = live.device
    f32 = torch.float32
    live_c = live.to(f32).contiguous()
    dq_c = _aligned(node_dq.to(f32).contiguous())
    cand_c = cand.to(torch.int32).contiguous()
    sel_c = _aligned(sel.to(torch.int32).contiguous())
    selw_c = _aligned(selw.to(f32).contiguous())
    lw_c = lw_dq.to(f32).contiguous()
    if use_mip:
        mn, mx = (t.to(f32).contiguous() for t in live_mip)
    else:
        mn = mx = torch.zeros(1, dtype=f32, device=dev)
    vals = torch.empty((NB, V), dtype=f32, device=dev)
    valid = torch.empty((NB, V), dtype=torch.bool, device=dev)
    wx, wy, wz = _coord_outputs(coords, (NB, V), dev)
    _K2(live_c.data_ptr(), dq_c.data_ptr(), cand_c.data_ptr(),
        sel_c.data_ptr(), selw_c.data_ptr(), lw_c.data_ptr(), mn.data_ptr(),
        mx.data_ptr(), int(use_mip), float(tdist) if use_mip else 0.0, rx,
        ry, rz, vol_shape[1], vol_shape[2], brick, NB, C, k, M,
        vals.data_ptr(), valid.data_ptr(), _ptr(wx), _ptr(wy), _ptr(wz),
        cuda_lib.stream_ptr(dev))
    warp_trilerp_bricks_cached.coord_launches += int(coords)
    return vals, valid, wx, wy, wz


# the launches that wrote wx, wy, wz
warp_trilerp_bricks_cached.coord_launches = 0


def warp_trilerp_bricks_ref(live, node_pos, node_w, active, node_dq, cand,
                            lw_dq, vol_shape=None, brick: int = 8, k: int = 3,
                            coords: bool = True):
    """Plain PyTorch twin of K3: ``build_warp_cache``'s selection (k argmin
    passes, first-min tie-break; needs C <= 32, k <= 6) followed by K2's
    twin without the mip certificate. Returns (vals, valid, wi, wx, wy,
    wz), each (NB, V); wx, wy, wz are None unless ``coords``."""
    # models/ imports this module; the selection lives there
    from ..models.warp_field import WarpField, build_warp_cache

    vol_shape = tuple(live.shape) if vol_shape is None else tuple(vol_shape)
    wf = WarpField(node_pos=node_pos, node_dq=node_dq, node_w=node_w,
                   node_vert_idx=torch.zeros_like(node_w, dtype=torch.long),
                   active=active, radius=node_w.new_zeros(()))
    sel, selw, wi = build_warp_cache(wf, vol_shape, cand, k, brick)
    vals, valid, wx, wy, wz = warp_trilerp_bricks_cached_ref(
        live, node_dq, cand, sel, selw, lw_dq, brick, vol_shape=vol_shape,
        coords=coords)
    return vals, valid, wi, wx, wy, wz


# (live, node_pos, node_w, active (int32), node_dq, cand, lw, rx, ry, rz,
#  vy, vz, brick, NB, C, k, M (nodes), vals, valid, wi, wx, wy, wz (all
#  three null: no coordinates), stream)
_K3 = cuda_lib.KERNELS.entry(
    "dfb_warp_trilerp_bricks", PTR, PTR, PTR, PTR, PTR, PTR, PTR,
    INT, INT, INT, INT, INT, INT, INT, INT, INT, INT,
    PTR, PTR, PTR, PTR, PTR, PTR, PTR, kernel="warp_trilerp_bricks_kernel")
# (C, out[6])
_K3_INFO = cuda_lib.KERNELS.entry("dfb_warp_trilerp_bricks_info", INT, BUF)


@cuda_lib.wrapper(_K3, twin=warp_trilerp_bricks_ref)
def warp_trilerp_bricks(live, node_pos, node_w, active, node_dq, cand,
                        lw_dq, vol_shape=None, brick: int = 8, k: int = 3,
                        coords: bool = True):
    """K3: the sample stage of the non-rigid TSDF update without a warp
    cache — per voxel, the exact top-k of the brick's C candidate nodes
    (first-min tie-break), Gaussian weights, ``wi`` (mean distance), DQB
    blend in selection order, normalize, warp, global pose, live trilerp.

    live (rx, ry, rz) f32; ``vol_shape`` the canonical lattice (default
    ``live.shape``); node_pos (M, 3), node_w (M,), active (M,) bool and
    node_dq (M, 8): the WarpField's arrays; cand (NB, C) node ids, C <= 32
    (the kernel clamps an id outside [0, M) into it); lw_dq (8,);
    1 <= k <= min(C, 6). Returns (vals, valid, wi, wx, wy, wz), each
    (NB, V); valid (bool) is "inside the live volume" — the JAX kernel's
    escape output has no counterpart. Without ``coords`` the kernel writes
    no coordinates and wx, wy, wz are None. On the card ``brick`` is one
    of ``KERNEL_BRICKS``."""
    rx, ry, rz = live.shape
    NB, C = cand.shape
    V = brick ** 3
    M = node_dq.shape[0]
    vol_shape = _check_lattice("warp_trilerp_bricks", live, vol_shape, brick,
                               NB)
    if not 1 <= C <= 32 or not 1 <= k <= min(C, 6):
        raise ValueError(f"warp_trilerp_bricks: unsupported C={C}, k={k}")
    if (tuple(node_pos.shape) != (M, 3) or tuple(node_w.shape) != (M,)
            or tuple(active.shape) != (M,) or tuple(node_dq.shape) != (M, 8)
            or tuple(lw_dq.shape) != (8,)):
        raise ValueError("warp_trilerp_bricks: node arrays must be (M, 3), "
                         "(M,), (M,), (M, 8) and lw_dq (8,)")
    dev = live.device
    f32 = torch.float32
    ins = [live.to(f32).contiguous(), node_pos.to(f32).contiguous(),
           node_w.to(f32).contiguous(), active.to(torch.int32).contiguous(),
           _aligned(node_dq.to(f32).contiguous()),
           cand.to(torch.int32).contiguous(), lw_dq.to(f32).contiguous()]
    vals, wi = (torch.empty((NB, V), dtype=f32, device=dev)
                for _ in range(2))
    valid = torch.empty((NB, V), dtype=torch.bool, device=dev)
    wx, wy, wz = _coord_outputs(coords, (NB, V), dev)
    _K3(*(t.data_ptr() for t in ins), rx, ry, rz, vol_shape[1],
        vol_shape[2], brick, NB, C, k, M, vals.data_ptr(), valid.data_ptr(),
        wi.data_ptr(), _ptr(wx), _ptr(wy), _ptr(wz), cuda_lib.stream_ptr(dev))
    warp_trilerp_bricks.coord_launches += int(coords)
    return vals, valid, wi, wx, wy, wz


# the launches that wrote wx, wy, wz
warp_trilerp_bricks.coord_launches = 0


def kernel_info(brick: int = 8, k: int = 3, C: int = 16) -> dict:
    """What the card makes of K2 (at ``brick``, ``k``) and of the K3
    instantiation that ``C`` candidates take, as :func:`cuda_lib.info`
    reads it, with the persistent grid and the dynamic shared bytes.
    Needs the card."""
    return {"warp_trilerp_bricks_cached": cuda_lib.info(
                _K2_INFO, brick, k, last=_GRID_SMEM),
            "warp_trilerp_bricks": cuda_lib.info(_K3_INFO, C,
                                                 last=_GRID_SMEM)}


def trilerp_bricks_supported(shape, brick: int = 8) -> bool:
    """Every 3-D live volume the kernel takes: it reads taps from global
    memory, so the TPU kernel's box and lane-tiling gates have no
    counterpart (``brick`` is accepted for the JAX signature)."""
    return len(shape) == 3 and all(int(s) >= 1 for s in shape)


def _trilerp_args(name, live, wx, wy, wz):
    """K4's and K6's inputs checked (a 3-D volume, coordinates of one
    shape) and made contiguous f32: (live, [wx, wy, wz])."""
    if not trilerp_bricks_supported(live.shape):
        raise ValueError(f"{name}: live {tuple(live.shape)} is not a 3-D "
                         "volume")
    if wx.shape != wy.shape or wx.shape != wz.shape:
        raise ValueError(f"{name}: wx, wy, wz differ in shape")
    f32 = torch.float32
    return (live.to(f32).contiguous(),
            [w.to(f32).contiguous() for w in (wx, wy, wz)])


def trilerp_bricks_ref(live, wx, wy, wz):
    """Plain PyTorch twin of K4: (vals, valid, escaped); escaped is all
    False."""
    vals, valid = trilinear_c(live, wx, wy, wz)
    return vals, valid, torch.zeros_like(valid)


# (live, wx, wy, wz, n, rx, ry, rz, vals, valid, stream)
_K4 = cuda_lib.KERNELS.entry(
    "dfb_trilerp_bricks", PTR, PTR, PTR, PTR, LLONG, INT, INT, INT, PTR, PTR,
    PTR, kernel="trilerp_bricks_kernel")


@cuda_lib.wrapper(_K4, twin=trilerp_bricks_ref)
def trilerp_bricks(live, wx, wy, wz):
    """K4: sample ``live`` (rx, ry, rz) at the coordinates wx/wy/wz (any one
    shape, e.g. the (NB, V) brick rows). Returns (vals f32, valid bool,
    escaped bool) of that shape; valid is "inside the live volume" and
    escaped is all False (nothing is staged; it is kept so the JAX
    signature returns the same triple). The JAX arguments ``group``,
    ``precise`` and ``interpret`` have no counterpart."""
    live_c, coords = _trilerp_args("trilerp_bricks", live, wx, wy, wz)
    rx, ry, rz = live.shape
    dev = live.device
    vals = torch.empty(wx.shape, dtype=torch.float32, device=dev)
    valid = torch.empty(wx.shape, dtype=torch.bool, device=dev)
    _K4(live_c.data_ptr(), *(c.data_ptr() for c in coords), wx.numel(), rx,
        ry, rz, vals.data_ptr(), valid.data_ptr(), cuda_lib.stream_ptr(dev))
    return vals, valid, torch.zeros_like(valid)


ABLATION_MODES = ("loads", "weights", "full")
ABLATION_THREADS = (128, 256, 512)
# K6's rows hold at most ABLATION_ROW samples; a row whose taps fit
# ABLATION_BOX cells along (x, y, z) from its least cell (z rounded down to
# a multiple of 4), none of them clamped at a far face of the volume, is
# staged in shared memory (csrc/trilerp_ablation.cu: kMaxRow, kBoxX,
# kBoxY, kBoxZ)
ABLATION_ROW = 512
ABLATION_BOX = (10, 10, 16)


def _check_mode(mode):
    if mode not in ABLATION_MODES:
        raise ValueError(f"trilerp_ablation: mode {mode!r} is not one of "
                         f"{ABLATION_MODES}")


def ablation_rows(shape) -> tuple:
    """(rows, V): how K6 cuts samples of coordinate ``shape`` into rows of
    V consecutive samples, the last one possibly shorter. V is the last
    axis when there are two or more axes and it is at most
    ``ABLATION_ROW`` (the (NB, V) brick rows), else ``ABLATION_ROW``."""
    n = 1
    for d in shape:
        n *= int(d)
    V = int(shape[-1]) if len(shape) >= 2 else ABLATION_ROW
    if not 1 <= V <= ABLATION_ROW:
        V = ABLATION_ROW
    return -(-n // V), V


def trilerp_box_rows(shape, wx, wy, wz):
    """K6's per-row box, the predicate its row_map follows, in plain
    PyTorch: for the rows of :func:`ablation_rows` over samples of a live
    volume of ``shape``, the origin (the least x0, y0, z0, z rounded down
    to a multiple of 4) and the extent (nx, ny, nz from the origin) of the
    cells the rows' taps read
    (:func:`trilinear_index`'s clamped floors and upper taps), each
    (rows, 3) int64, and whether the row is staged, (rows,) bool: its
    extent fits ``ABLATION_BOX`` and no upper tap is clamped (every
    x0 <= rx - 2, and so on), so that the 8 taps of every sample lie at
    fixed offsets from its first."""
    rows, V = ablation_rows(wx.shape)
    lo, hi = [], []
    for (i0, _), w in zip(trilinear_index(shape, wx, wy, wz)[:3],
                          (wx, wy, wz)):
        i0 = i0.reshape(-1)
        pad = rows * V - i0.numel()  # the short last row: neutral values
        i0 = torch.cat([i0, i0[-1:].expand(pad)]).reshape(rows, V)
        lo.append(i0.amin(1))
        hi.append(i0.amax(1))
    lo[2] = lo[2] - lo[2] % 4
    origin, top = torch.stack(lo, 1), torch.stack(hi, 1)
    last = torch.tensor(shape, device=top.device) - 1
    extent = torch.minimum(top + 1, last) - origin + 1
    fits = torch.all((top < last) & (extent <= torch.tensor(
        ABLATION_BOX, device=top.device)), 1)
    return origin, extent, fits


def trilerp_ablation_ref(live, wx, wy, wz, mode: str):
    """Plain PyTorch twin of K6, in the kernel's operation order: ``full``
    is :func:`trilinear_c`'s value; ``loads`` the sum of the 8 taps and
    ``weights`` the sum of the 8 products (1-xd|xd)·(1-yd|yd)·(1-zd|zd),
    both over the corners x fastest, then y, then z."""
    _check_mode(mode)
    if mode == "full":
        return trilinear_c(live, wx, wy, wz)[0]
    xs, ys, zs, (xd, yd, zd) = trilinear_index(live.shape, wx, wy, wz)
    _, ry, rz = live.shape
    flat = live.reshape(-1)
    ax, ay, az = (1 - xd, xd), (1 - yd, yd), (1 - zd, zd)
    out = None
    for c in range(8):
        a, b, d = c & 1, (c >> 1) & 1, c >> 2
        if mode == "loads":
            term = flat[(xs[a] * ry + ys[b]) * rz + zs[d]]
        else:
            term = ax[a] * ay[b] * az[d]
        out = term if out is None else out + term
    return out


def _check_ablation(live, wx, wy, wz, mode: str, threads: int = 256,
                    row_map=None) -> None:
    _check_mode(mode)
    if threads not in ABLATION_THREADS:
        raise ValueError(f"trilerp_ablation: {threads} threads per block is "
                         f"not one of {ABLATION_THREADS}")
    rows, _ = ablation_rows(wx.shape)
    if row_map is not None and mode == "weights":
        raise ValueError("trilerp_ablation: the weights mode stages no box "
                         "and writes no row_map")
    if row_map is not None and (
            tuple(row_map.shape) != (rows,) or row_map.dtype != torch.uint8
            or row_map.device != live.device
            or not row_map.is_contiguous()):
        raise ValueError(f"trilerp_ablation: row_map must be a contiguous "
                         f"({rows},) uint8 tensor on {live.device}")


def _ablation_twin(live, wx, wy, wz, mode: str, threads: int = 256,
                   row_map=None):
    """The CPU's trilerp_ablation: the plain twin, and ``row_map`` the
    predicate."""
    if row_map is not None:
        row_map.copy_(trilerp_box_rows(live.shape, wx, wy, wz)[2])
    return trilerp_ablation_ref(live, wx, wy, wz, mode)


# (mode, threads, live, wx, wy, wz, n, V (samples a row), rx, ry, rz, out,
#  row_map (null: none), stream)
_K6 = cuda_lib.KERNELS.entry(
    "dfb_trilerp_ablation", INT, INT, PTR, PTR, PTR, PTR, LLONG, INT, INT,
    INT, INT, PTR, PTR, PTR, kernel="trilerp_ablation_kernel")
# (mode, threads, V, out[6])
_K6_INFO = cuda_lib.KERNELS.entry("dfb_trilerp_ablation_info", INT, INT, INT,
                                  BUF)


@cuda_lib.wrapper(_K6, twin=_ablation_twin, check=_check_ablation)
def trilerp_ablation(live, wx, wy, wz, mode: str, threads: int = 256,
                     row_map=None):
    """K6: one of K4's parts at the coordinates wx/wy/wz (any one shape)
    on ``live`` (rx, ry, rz) f32, on persistent CTAs of ``threads`` (128,
    256 or 512; the TPU kernel's ``group``) that walk the rows of
    :func:`ablation_rows`. ``mode``: ``loads`` (the tap loads alone,
    summed), ``weights`` (the weights alone, summed; reads nothing of
    ``live``) or ``full`` (K4's vals). In ``loads`` and ``full`` each
    row's tap box is staged in shared memory where
    :func:`trilerp_box_rows` says it fits, and the other rows read their
    taps from global memory. Returns f32 of the coordinates' shape.
    ``row_map``, a (rows,) uint8 tensor on the volume's device, receives
    1 for each staged row and 0 for the others (``loads`` and ``full``
    only: ``weights`` stages nothing; on the CPU it receives the
    predicate). The TPU kernel's bf16 pass count and tent weights have no
    counterpart (f32, no matrix unit)."""
    live_c, coords = _trilerp_args("trilerp_ablation", live, wx, wy, wz)
    rx, ry, rz = live.shape
    if ry * rz >= 2 ** 31 or max(live.shape) > 2 ** 22:
        raise ValueError(f"trilerp_ablation: live {tuple(live.shape)}: the "
                         "kernel takes planes of fewer than 2^31 cells and "
                         "axes of at most 2^22")
    _, V = ablation_rows(wx.shape)
    dev = live.device
    out = torch.empty(wx.shape, dtype=torch.float32, device=dev)
    _K6(ABLATION_MODES.index(mode), threads, live_c.data_ptr(),
        *(c.data_ptr() for c in coords), wx.numel(), V, rx, ry, rz,
        out.data_ptr(), _ptr(row_map), cuda_lib.stream_ptr(dev))
    return out


def ablation_kernel_info(V: int = ABLATION_ROW) -> dict:
    """What the card makes of each K6 instantiation, {(mode, threads):
    info} at rows of ``V`` samples, as :func:`cuda_lib.info` reads it,
    with the persistent grid and the dynamic shared bytes. Needs the
    card."""
    return {(mode, threads): cuda_lib.info(
                _K6_INFO, ABLATION_MODES.index(mode), threads, V,
                last=_GRID_SMEM)
            for mode in ABLATION_MODES for threads in ABLATION_THREADS}
