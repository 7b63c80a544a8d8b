"""Parity of the port's TSDF volume, projective fusion and K5 twin with the
JAX package (dynamicfusion_body_tpu.models.tsdf_volume, ops/fusion_pallas).

Tolerances: weights are compared exactly and values at atol 2e-5 (the
JAX-vs-OpenCL-oracle tolerance, tests/test_fusion_kernels.py:57), except
on voxels where a decision of the update (pixel in bounds, ``pz <=
tdist``, ``dz < tdist``) lies within a rounding error of its threshold:
XLA may contract the projection into FMAs, and such a voxel then updates
in one package and not the other, differing by up to tdist. Those voxels
are masked (``flip_mask``) and their count is held below ``FLIP_MAX``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.models import tsdf_volume as JT
from dynamicfusion_body_tpu.ops.bricks import vol_from_bricks, vol_to_bricks
from dynamicfusion_body_tpu.ops.dualquat import dq_normalize8 as j_norm8
from dynamicfusion_body_tpu.ops.fusion_pallas import fuse_depth_multi_bricks
from dynamicfusion_body_tpu_torch.models import tsdf_volume as TT
from dynamicfusion_body_tpu_torch.ops.fusion_cuda import (
    MAX_ELEMENTS, MAX_VIEWS, SMEM_BYTES, check_args, fuse_depth_multi,
    fuse_depth_multi_ref)

# One intra-op thread (see tests/test_torch_marching_cubes.py)
torch.set_num_threads(1)

VAL_ATOL = 2e-5
FLIP_MAX = 8     # masked near-threshold voxels allowed per case
NEAR_PX = 1e-3   # pixels: distance of px/py to an image-bounds threshold
NEAR_Z = 1e-4    # world units: distance of pz/dz to tdist


def T(a):
    return torch.from_numpy(np.array(a))


def make_camera(cx=32.0, cy=32.0):
    K = np.array([[200.0, 0, cx], [0, 200, cy], [0, 0, 1]])
    return K, np.linalg.inv(K)


def synth_depth(h=64, w=64, z0=5.0, hole=(10, 14, 10, 14)):
    """Negative-depth map of a slanted plane with a hole (zero depth), as
    tests/test_fusion_kernels.py makes it."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d = z0 + 0.01 * xx + 0.005 * yy
    d[hole[0]:hole[1], hole[2]:hole[3]] = 0.0
    return (-d).astype(np.float32)


def grid_ind(scale, origin):
    ind = np.eye(4)
    ind[0, 0] = ind[1, 1] = ind[2, 2] = scale
    ind[:3, 3] = origin
    return ind


def _view_samples(shape, depth, proj):
    """Per voxel of ``shape``, in float64: the projection (u, v, pw, px,
    py), the in-bounds test, and the 4 bilinear taps (4, N) with their
    weights (wx, wy) — fuse_depth's steps."""
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float64)
    P = np.concatenate([g, np.ones((len(g), 1))], 1)
    h, w = depth.shape
    u, v, pw = (P @ np.asarray(proj, np.float64).T).T
    with np.errstate(divide="ignore", invalid="ignore"):
        px, py = u / pw, v / pw
    inb = (px >= 0) & (py >= 0) & (px < w - 1) & (py < h - 1)
    pxc, pyc = np.where(inb, px, 0), np.where(inb, py, 0)
    x0, y0 = np.floor(pxc).astype(int), np.floor(pyc).astype(int)
    d = depth.astype(np.float64)
    taps = np.stack([d[y0, x0], d[y0, x0 + 1], d[y0 + 1, x0],
                     d[y0 + 1, x0 + 1]])
    return u, v, pw, px, py, inb, taps, pxc - x0, pyc - y0


def flip_mask(shape, depths, projs, kinv_row2, tdist):
    """Voxels where any view's update decision lies within NEAR_PX/NEAR_Z
    of its threshold, evaluated in float64."""
    near = np.zeros(int(np.prod(shape)), bool)
    k = np.asarray(kinv_row2, np.float64)
    for d, p in zip(depths, projs):
        h, w = d.shape
        u, v, pw, px, py, inb, t, wx, wy = _view_samples(shape, d, p)
        for a, thr in ((px, 0), (py, 0), (px, w - 1), (py, h - 1)):
            near |= np.abs(a - thr) < NEAR_PX
        pz = -((t[0] * (1 - wx) + t[1] * wx) * (1 - wy)
               + (t[2] * (1 - wx) + t[3] * wx) * wy)
        dz = -(k[0] * (px * pz - u) + k[1] * (py * pz - v) + k[2] * (pz - pw))
        near |= inb & ((np.abs(pz - tdist) < NEAR_Z)
                       | (np.abs(dz - tdist) < NEAR_Z))
    return near.reshape(shape)


def edge_mask(shape, depths, projs, jump=0.5):
    """Voxels whose bilinear taps straddle a depth edge (taps spanning more
    than ``jump``) in some view, evaluated in float64."""
    out = np.zeros(int(np.prod(shape)), bool)
    for d, p in zip(depths, projs):
        inb, taps = _view_samples(shape, d, p)[5:7]
        out |= inb & (taps.max(0) - taps.min(0) > jump)
    return out.reshape(shape)


def assert_fused_close(got, want, mask, atol=VAL_ATOL):
    (gv, gw), (wv, ww) = got, want
    assert int(mask.sum()) <= FLIP_MAX, int(mask.sum())
    np.testing.assert_array_equal(gw[~mask], ww[~mask])
    np.testing.assert_allclose(gv[~mask], wv[~mask], rtol=0, atol=atol)


def single_view_case(res):
    """tests/test_fusion_kernels.py:28's camera, grid and plane-with-hole
    depth (res 8), and the same scene at a finer grid (res 16)."""
    K, Kinv = make_camera()
    ind = grid_ind(0.8 / res, [-0.4, -0.4, 4.8])
    proj = (K @ np.eye(4)[:3] @ ind).astype(np.float32)
    return synth_depth(), proj, Kinv.astype(np.float32)


@pytest.mark.parametrize("res", [8, 16])
def test_fuse_depth_twice_matches_jax(res):
    """Fused twice, to run the running average and the weight path."""
    tdist, wmax = 0.2, 100.0
    depth, proj, Kinv = single_view_case(res)
    v0 = np.full((res,) * 3, tdist, np.float32)
    w0 = np.zeros((res,) * 3, np.float32)
    jv, jw = jnp.asarray(v0), jnp.asarray(w0)
    tv, tw = T(v0), T(w0)
    for _ in range(2):
        jv, jw = JT.fuse_depth(jv, jw, jnp.asarray(depth), jnp.asarray(proj),
                               jnp.asarray(Kinv), tdist, wmax)
        tv, tw = TT.fuse_depth(tv, tw, T(depth), T(proj), T(Kinv), tdist,
                               wmax)
    mask = flip_mask((res,) * 3, [depth], [proj], Kinv[2], tdist)
    assert_fused_close((tv.numpy(), tw.numpy()),
                       (np.asarray(jv), np.asarray(jw)), mask)
    assert tw.numpy().max() == 2.0  # some voxels were updated twice


def multi_view_case(n=3, res=16):
    """tests/test_fusion_kernels.py:104's three slanted-plane views with a
    hole, each from a slightly shifted camera."""
    K = np.array([[200.0, 0, 64], [0, 200, 32], [0, 0, 1]])
    Kinv = np.linalg.inv(K)
    ind = grid_ind(0.05, [-0.4, -0.4, 4.8])
    h, w = 64, 128
    rng = np.random.RandomState(3)
    depths, projs = [], []
    for i in range(n):
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        d = 5.0 + 0.01 * xx + 0.005 * yy + 0.1 * i
        d[20:24, 30:34] = 0.0  # hole carves free space
        depths.append((-d).astype(np.float32))
        lw4 = np.eye(4)
        lw4[:3, 3] = rng.randn(3) * 0.02
        projs.append((K @ lw4[:3] @ ind).astype(np.float32))
    return (np.stack(depths), np.stack(projs),
            Kinv[2].astype(np.float32), (res,) * 3)


def jax_sequential(v, w, depths, projs, kinv_row2, tdist, wmax):
    kinv = np.zeros((3, 3), np.float32)
    kinv[2] = kinv_row2
    jv, jw = jnp.asarray(v), jnp.asarray(w)
    for d, p in zip(depths, projs):
        jv, jw = JT.fuse_depth(jv, jw, jnp.asarray(d), jnp.asarray(p),
                               jnp.asarray(kinv), tdist, wmax)
    return np.asarray(jv), np.asarray(jw)


@pytest.mark.parametrize("start", ["empty", "half_fused"])
def test_fuse_depth_multi_ref_matches_jax_sequential(start):
    tdist, wmax = 0.2, 100.0
    depths, projs, kr, shape = multi_view_case()
    v = np.full(shape, tdist, np.float32)
    w = np.zeros(shape, np.float32)
    if start == "half_fused":  # a running average already under way
        rng = np.random.RandomState(4)
        v = rng.uniform(-tdist, tdist, shape).astype(np.float32)
        w = rng.randint(0, 4, shape).astype(np.float32)
    want = jax_sequential(v, w, depths, projs, kr, tdist, wmax)
    got = fuse_depth_multi_ref(T(v), T(w), T(depths), T(projs), T(kr), tdist,
                               wmax)
    mask = flip_mask(shape, depths, projs, kr, tdist)
    assert_fused_close(tuple(a.numpy() for a in got), want, mask)
    # the wrapper takes the twin for CPU tensors and counts no launch
    n0 = fuse_depth_multi.launches
    wrapped = fuse_depth_multi(T(v), T(w), T(depths), T(projs), T(kr), tdist,
                               wmax)
    assert fuse_depth_multi.launches == n0
    for a, b in zip(wrapped, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fuse_depth_multi_ref_matches_pallas_interpret():
    """Against the TPU kernel in interpret mode: its sampling is a bf16
    hi/lo split, ~2⁻¹⁶ of the metre-scale depths, hence atol 5e-4
    (tests/test_fusion_kernels.py:153-155)."""
    tdist, wmax = 0.2, 100.0
    depths, projs, kr, shape = multi_view_case()
    v = np.full(shape, tdist, np.float32)
    w = np.zeros(shape, np.float32)
    vb, wb, esc = fuse_depth_multi_bricks(
        vol_to_bricks(jnp.asarray(v), 8), vol_to_bricks(jnp.asarray(w), 8),
        jnp.asarray(depths), jnp.asarray(projs), jnp.asarray(kr),
        vol_shape=shape, brick=8, tdist=tdist, wmax=wmax, interpret=True)
    assert int(esc) == 0
    want_v = np.asarray(vol_from_bricks(vb, shape, 8))
    want_w = np.asarray(vol_from_bricks(wb, shape, 8))
    gv, gw = fuse_depth_multi_ref(T(v), T(w), T(depths), T(projs), T(kr),
                                  tdist, wmax)
    mask = flip_mask(shape, depths, projs, kr, tdist)
    assert_fused_close((gv.numpy(), gw.numpy()), (want_v, want_w), mask,
                       atol=5e-4)


def test_fuse_depth_multi_wmax_clamp():
    """Five passes of three views with WMAX 3: the weight saturates and the
    average keeps moving, as in JAX."""
    tdist, wmax = 0.2, 3.0
    depths, projs, kr, shape = multi_view_case()
    depths5 = np.concatenate([depths] * 5)
    projs5 = np.concatenate([projs] * 5)
    v = np.full(shape, tdist, np.float32)
    w = np.zeros(shape, np.float32)
    want = jax_sequential(v, w, depths5, projs5, kr, tdist, wmax)
    got = fuse_depth_multi(T(v), T(w), T(depths5), T(projs5), T(kr), tdist,
                           wmax)
    mask = flip_mask(shape, depths, projs, kr, tdist)
    assert_fused_close(tuple(a.numpy() for a in got), want, mask)
    assert float(got[1].max()) == wmax


def test_fuse_depth_multi_rejects_other_devices():
    z = torch.zeros((8, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fuse_depth_multi(z, z, z, z, z, 0.2)


@pytest.mark.parametrize("n_views", [MAX_VIEWS, MAX_VIEWS + 1])
def test_fuse_depth_multi_view_limit(n_views):
    # the kernel keeps n·12 + 3 floats in 48 KiB of dynamic shared memory
    assert 4 * (MAX_VIEWS * 12 + 3) <= SMEM_BYTES
    assert 4 * ((MAX_VIEWS + 1) * 12 + 3) > SMEM_BYTES
    vol = torch.zeros((4, 4, 4), device="meta")
    args = (vol, vol, torch.zeros((n_views, 2, 2), device="meta"),
            torch.zeros((n_views, 3, 4), device="meta"),
            torch.zeros(3, device="meta"))
    if n_views <= MAX_VIEWS:
        check_args(*args)
    else:
        with pytest.raises(ValueError, match="views, need"):
            check_args(*args)


@pytest.mark.parametrize("case", ["fits", "volume", "depths"])
def test_fuse_depth_multi_index_limit(case):
    """The kernel's 32-bit offsets: a volume or a depth stack of 2^31
    elements is refused (meta tensors, so nothing is allocated)."""
    big = (2, 1024, 1 << 20)
    assert 2 * 1024 * (1 << 20) == MAX_ELEMENTS + 1
    vol = torch.zeros(big if case == "volume" else (4, 4, 4), device="meta")
    dep = torch.zeros(big if case == "depths" else (2, 2, 2), device="meta")
    args = (vol, vol, dep, torch.zeros((dep.shape[0], 3, 4), device="meta"),
            torch.zeros(3, device="meta"))
    if case == "fits":
        check_args(*args)
    else:
        with pytest.raises(ValueError, match="32 bits"):
            check_args(*args)


@pytest.mark.parametrize("pose", ["identity", "moved"])
def test_update_tsdf_rigid_matches_jax(rng, pose):
    tdist = 0.5
    res = 12
    live = rng.uniform(-1.0, 1.0, (res,) * 3).astype(np.float32)
    vals = rng.uniform(-tdist, tdist, (res,) * 3).astype(np.float32)
    w = rng.randint(0, 3, (res,) * 3).astype(np.float32)
    dq = np.array([1, 0, 0, 0, 0, 0, 0, 0], np.float32)
    if pose == "moved":  # a small rotation and a sub-voxel translation
        dq = np.asarray(j_norm8(jnp.asarray(
            [1, 0.02, -0.03, 0.01, 0.1, 0.2, -0.15, 0.05], jnp.float32)))
    jv, jw = JT.update_tsdf_rigid(jnp.asarray(vals), jnp.asarray(w),
                                  jnp.asarray(live), jnp.asarray(dq), tdist)
    tv, tw = TT.update_tsdf_rigid(T(vals), T(w), T(live), T(dq), tdist)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-5)
    if pose == "identity":  # fused exactly min(tdist, live) into empty voxels
        upd = (live > -tdist) & (w == 0)
        np.testing.assert_allclose(tv.numpy()[upd],
                                   np.minimum(tdist, live)[upd], atol=1e-6)


def test_volume_create_and_grid_world_match_jax():
    ind = np.array([[0.1, 0, 0, -1.0], [0, 0.1, 0, 2.0], [0, 0, 0.1, 3.0],
                    [0, 0, 0, 1.0]], np.float32)
    jvol = JT.TsdfVolume.create(8, -0.2, ind=jnp.asarray(ind))
    tvol = TT.TsdfVolume.create(8, -0.2, ind=T(ind))
    np.testing.assert_array_equal(tvol.values.numpy(), np.asarray(jvol.values))
    np.testing.assert_array_equal(tvol.weights.numpy(),
                                  np.asarray(jvol.weights))
    assert tvol.res == jvol.res == 8
    p = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0], [7.5, 0.25, 6.0]],
                 np.float32)
    np.testing.assert_allclose(tvol.grid_to_world(T(p)).numpy(),
                               np.asarray(jvol.grid_to_world(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-6)
    back = tvol.world_to_grid(tvol.grid_to_world(T(p)))
    np.testing.assert_allclose(back.numpy(), p, atol=1e-5)
    eye = TT.TsdfVolume.create(4, 0.2, device="cpu")
    np.testing.assert_array_equal(eye.ind.numpy(), np.eye(4))
