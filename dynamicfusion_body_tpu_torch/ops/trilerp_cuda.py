"""K2 — cached warp + live trilerp per 8³ brick (``csrc/warp_trilerp_cached.cu``).

Counterpart of ``dynamicfusion_body_tpu/ops/trilerp_pallas.py:
warp_trilerp_bricks_cached`` and its helpers ``live_brick_mip`` and
``mip_skip_supported``. Per canonical brick: blend the node DQs of the
cached per-voxel top-k selection (``models/warp_field.py:
build_warp_cache``), normalize, warp every voxel centre and apply the
global pose; then sample the live TSDF at the warped positions, except
where the live-space mip certificate proves the brick's samples constant
(see :func:`mip_short_bricks`).

What the TPU mechanisms become here:
* the (16, 24, Z) VMEM staging box and its escape output are gone: the
  kernel reads taps straight from global memory, so no sample escapes and
  ``valid`` is exactly "inside the live volume";
* the bf16 hi/lo MXU contraction becomes the plain f32 formula of
  ``_trilinear_c`` (the caller's near-threshold re-sample stays, see
  ``models/warp_field.py:update_tsdf_nonrigid``);
* the packed (M, 16) node table becomes the (M, 8) node DQ array — the
  cached kernel reads only the DQ columns.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .compwise import dq_normalize8_c, dq_point_c
from .interp import trilinear_c


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


def warp_voxels(node_dq, cand, sel, selw, lw_dq, shape, brick: int):
    """Warped live-space coordinates (wx, wy, wz), each (NB, V), of every
    canonical voxel centre in brick-row layout: cached-selection DQ blend
    → 8-norm normalize → sandwich → global pose. The K2 kernel's first
    stage, in the same operation order."""
    NB = cand.shape[0]
    V = brick ** 3
    k = selw.shape[1]
    nby, nbz = shape[1] // brick, shape[2] // brick
    dev = cand.device
    b = torch.arange(NB, device=dev)[:, None]
    v = torch.arange(V, device=dev)[None, :]
    px = ((b // (nby * nbz)) * brick + v // (brick * brick)).float()
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
                                   brick: int = 8, tdist=None, live_mip=None):
    """Plain PyTorch twin of the kernel: (vals, valid, wx, wy, wz), each
    (NB, V); valid is bool."""
    wx, wy, wz = warp_voxels(node_dq, cand, sel, selw, lw_dq, live.shape,
                             brick)
    vals, valid = trilinear_c(live, wx, wy, wz)
    if tdist is not None and live_mip is not None:
        short, cval = mip_short_bricks(wx, wy, wz, valid, live.shape, tdist,
                                       live_mip)
        vals = torch.where(short[:, None], cval[:, None], vals)
    return vals, valid, wx, wy, wz


def warp_trilerp_bricks_cached(live, node_dq, cand, sel, selw, lw_dq,
                               brick: int = 8, tdist=None, live_mip=None):
    """Fused per-frame sample stage of the non-rigid TSDF update.

    live (R³) f32 — the brick grid is ``live.shape // brick``, which must
    be the canonical volume's; node_dq (M, 8) f32; cand (NB, C) node ids;
    sel (NB, V) int32 packed slots and selw (NB, k, V) f32 from
    ``build_warp_cache``; lw_dq (8,) f32. With ``tdist`` and ``live_mip``
    (from :func:`live_brick_mip`) certified bricks emit exact constants.
    Returns (vals, valid, wx, wy, wz), each (NB, V).

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    or raises."""
    if live.device.type == "cpu":
        return warp_trilerp_bricks_cached_ref(
            live, node_dq, cand, sel, selw, lw_dq, brick, tdist, live_mip)
    if live.device.type != "cuda":
        raise ValueError(f"warp_trilerp_bricks_cached: device {live.device}")
    rx, ry, rz = live.shape
    NB, C = cand.shape
    V = brick ** 3
    k = selw.shape[1]
    M = node_dq.shape[0]
    if (rx % brick or ry % brick or rz % brick
            or NB != (rx // brick) * (ry // brick) * (rz // brick)):
        raise ValueError(f"brick grid of {live.shape} does not match NB={NB}")
    if V > 1024 or C > 32 or not 1 <= k <= 6:
        raise ValueError(f"unsupported brick={brick}, C={C}, k={k}")
    if tuple(sel.shape) != (NB, V) or tuple(selw.shape) != (NB, k, V):
        raise ValueError(f"sel {tuple(sel.shape)} / selw {tuple(selw.shape)}"
                         f" do not match (NB={NB}, V={V})")
    if node_dq.shape != (M, 8) or lw_dq.shape != (8,):
        raise ValueError("node_dq must be (M, 8) and lw_dq (8,)")
    if NB and (int(cand.min()) < 0 or int(cand.max()) >= M):
        raise ValueError("cand holds node ids outside the node pool")
    use_mip = tdist is not None and live_mip is not None
    if use_mip and not (mip_skip_supported(live.shape) and V % 32 == 0):
        raise ValueError(f"mip certificate needs mip_skip_supported "
                         f"{live.shape} and whole warps (brick={brick})")
    dev = live.device
    f32 = torch.float32
    live_c = live.to(f32).contiguous()
    dq_c = node_dq.to(f32).contiguous()
    cand_c = cand.to(torch.int32).contiguous()
    sel_c = sel.to(torch.int32).contiguous()
    selw_c = selw.to(f32).contiguous()
    lw_c = lw_dq.to(f32).contiguous()
    if use_mip:
        mn, mx = (t.to(f32).contiguous() for t in live_mip)
    else:
        mn = mx = torch.zeros(1, dtype=f32, device=dev)
    vals, wx, wy, wz = (torch.empty((NB, V), dtype=f32, device=dev)
                        for _ in range(4))
    valid = torch.empty((NB, V), dtype=torch.bool, device=dev)
    err = cuda_lib.lib().dfb_warp_trilerp_cached(
        live_c.data_ptr(), dq_c.data_ptr(), cand_c.data_ptr(),
        sel_c.data_ptr(), selw_c.data_ptr(), lw_c.data_ptr(),
        mn.data_ptr(), mx.data_ptr(), int(use_mip),
        float(tdist) if use_mip else 0.0, rx, ry, rz, brick, NB, C, k,
        vals.data_ptr(), valid.data_ptr(), wx.data_ptr(), wy.data_ptr(),
        wz.data_ptr(), cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check("warp_trilerp_bricks_cached", err)
    warp_trilerp_bricks_cached.launches += 1
    return vals, valid, wx, wy, wz


warp_trilerp_bricks_cached.launches = 0
