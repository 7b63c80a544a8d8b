"""Conservativeness of K5's per-tile view cull
(``dynamicfusion_body_tpu_torch/ops/fusion_cuda.py:fuse_cull_tiles``, the
PyTorch form of ``csrc/fuse_depth_multi.cu:cull_views``).

The kernel skips a view for a warp tile only where the predicate says no
voxel of the tile can pass the image test of ``fuse_depth``. Over seeded
numpy cameras (in front of the volume, inside it, looking away from it,
and with the volume across an image edge), each view is fused alone from
empty weights with a depth map that is all holes: every voxel that passes
the image test then updates (``pz = 0 <= tdist`` carves ``-tdist``), so
the updated voxels are exactly the admitted voxel-views. No admitted
voxel of the port's twin, nor of the JAX package's ``fuse_depth``, may lie
in a culled (tile, view) pair. Exact: the predicate has a one-pixel
margin and an f32 rounding bound, so nothing is toleranced here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu.models import tsdf_volume as JT
from dynamicfusion_body_tpu_torch.ops.fusion_cuda import (
    CULL_TILE, cull_grid, fuse_cull_tiles, fuse_depth_multi,
    fuse_depth_multi_ref)

# One intra-op thread (see tests/test_torch_marching_cubes.py)
torch.set_num_threads(1)

TDIST = 0.05
SCENES = ("front", "inside", "away", "edge")
SEEDS = range(6)


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """World→camera [R | t] of a camera at ``eye`` looking along +z at
    ``target``."""
    f = np.asarray(target, float) - np.asarray(eye, float)
    f /= np.linalg.norm(f)
    r = np.cross(up, f)
    if np.linalg.norm(r) < 1e-6:
        r = np.cross((1.0, 0.0, 0.0), f)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    R = np.stack([r, d, f])
    return np.concatenate([R, (-R @ np.asarray(eye, float))[:, None]], 1)


def scene(kind, seed):
    """(shape, projs (n,3,4) f32, h, w) of one seeded case: a volume of at
    most 64³ cells of size 1/64 around the origin and 4 views."""
    rs = np.random.RandomState(seed)
    shape = tuple(int(n) for n in rs.randint(2, 65, size=3))
    if seed == 0:  # whole tiles along every axis
        shape = (64, 64, 64)
    scale = 1.0 / 64
    ind = np.eye(4)
    ind[:3, :3] *= scale
    ind[:3, 3] = -scale * np.asarray(shape) / 2
    h, w = (int(n) for n in rs.randint(2, 160, size=2))
    projs = []
    for _ in range(4):
        f = rs.uniform(0.3, 2.0) * max(h, w)
        K = np.array([[f, 0, rs.uniform(0, w)], [0, f, rs.uniform(0, h)],
                      [0, 0, 1]])
        ext = 0.5 * scale * np.asarray(shape)  # the volume's half extents
        if kind == "front":
            d = rs.normal(size=3)
            eye = d / np.linalg.norm(d) * rs.uniform(1.0, 3.0)
            lw = look_at(eye, rs.uniform(-ext, ext))
        elif kind == "inside":  # pw changes sign inside the volume
            eye = rs.uniform(-ext, ext)
            lw = look_at(eye, eye + rs.normal(size=3))
        elif kind == "away":  # the volume behind the camera
            d = rs.normal(size=3)
            eye = d / np.linalg.norm(d) * rs.uniform(1.0, 3.0)
            lw = look_at(eye, 2 * eye)
        else:  # "edge": the volume's centre on an image border
            d = rs.normal(size=3)
            eye = d / np.linalg.norm(d) * rs.uniform(1.0, 2.0)
            lw = look_at(eye, np.zeros(3))
            side = rs.randint(4)
            K[0, 2] = (0.0, w - 1.0, K[0, 2], K[0, 2])[side]
            K[1, 2] = (K[1, 2], K[1, 2], 0.0, h - 1.0)[side]
        # K·lw·IND in float32, as FusionDM._proj
        projs.append(K.astype(np.float32) @ lw.astype(np.float32)
                     @ ind.astype(np.float32))
    return shape, np.stack(projs).astype(np.float32), h, w


def admitted_port(shape, proj, h, w):
    """Voxels of the port's twin that pass the image test of one view."""
    v = torch.full(shape, TDIST)
    wt = torch.zeros(shape)
    _, got = fuse_depth_multi_ref(v, wt, torch.zeros((1, h, w)),
                                  torch.from_numpy(proj[None]),
                                  torch.tensor([0.0, 0.0, 1.0]), TDIST)
    return got > 0


def admitted_jax(shape, proj, h, w):
    """The same from the JAX package's fuse_depth."""
    kinv = jnp.asarray(np.eye(3, dtype=np.float32))
    _, got = JT.fuse_depth(jnp.full(shape, TDIST, jnp.float32),
                           jnp.zeros(shape, jnp.float32),
                           jnp.zeros((h, w), jnp.float32), jnp.asarray(proj),
                           kinv, TDIST)
    return torch.from_numpy(np.asarray(got) > 0)


def tile_of(mask):
    """Per warp tile: does any voxel of ``mask`` lie in it."""
    X, Y, Z = mask.shape
    gx, gy, gz = cull_grid(mask.shape)
    tx, ty, tz = CULL_TILE
    pad = torch.zeros((gx * tx, gy * ty, gz * tz), dtype=torch.bool)
    pad[:X, :Y, :Z] = mask
    return pad.reshape(gx, tx, gy, ty, gz, tz).any(5).any(3).any(1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", SCENES)
def test_cull_skips_no_admitted_voxel(kind, seed):
    shape, projs, h, w = scene(kind, seed)
    culled = fuse_cull_tiles(shape, torch.from_numpy(projs), h, w)
    assert culled.shape == (len(projs), *cull_grid(shape))
    for view, proj in enumerate(projs):
        for admitted in (admitted_port, admitted_jax):
            hit = tile_of(admitted(shape, proj, h, w))
            bad = int((hit & culled[view]).sum())
            assert bad == 0, (f"{kind} seed {seed} view {view}: {bad} "
                              f"culled tiles hold voxels {admitted.__name__} "
                              "admits")


@pytest.mark.parametrize("kind", SCENES)
def test_cull_skips_most_unseen_tiles(kind):
    """The cull is not empty: of the (tile, view) pairs in which the twin
    admits no voxel it skips more than half (measured over the seeds: 486
    of 550 in front, 459 of 530 looking away, 921 of 1053 across an edge),
    and more than a quarter with the camera inside the volume, where tiles
    across pw = 0 are always kept (1238 of 2106)."""
    empty = culled = 0
    for seed in SEEDS:
        shape, projs, h, w = scene(kind, seed)
        cull = fuse_cull_tiles(shape, torch.from_numpy(projs), h, w)
        for view, proj in enumerate(projs):
            hit = tile_of(admitted_port(shape, proj, h, w))
            empty += int((~hit).sum())
            culled += int(cull[view].sum())
    assert culled > (0.25 if kind == "inside" else 0.5) * empty


def test_cpu_cull_map_is_the_predicate():
    """On the CPU the wrapper's cull_map receives the PyTorch predicate
    and the fusion is the twin's."""
    shape, projs, h, w = scene("front", 3)
    rs = np.random.RandomState(3)
    depths = torch.from_numpy(
        -rs.uniform(1.0, 3.0, (len(projs), h, w)).astype(np.float32))
    v = torch.full(shape, TDIST)
    wt = torch.zeros(shape)
    kr = torch.tensor([0.0, 0.0, 1.0])
    p = torch.from_numpy(projs)
    cull = torch.empty((len(projs), *cull_grid(shape)), dtype=torch.uint8)
    got = fuse_depth_multi(v, wt, depths, p, kr, TDIST, cull_map=cull)
    want = fuse_depth_multi_ref(v, wt, depths, p, kr, TDIST)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(cull.bool(), fuse_cull_tiles(shape, p, h, w))
    with pytest.raises(ValueError, match="cull_map must be"):
        fuse_depth_multi(v, wt, depths, p, kr, TDIST, cull_map=cull[:1])



@pytest.mark.parametrize("case", ["quotient_underflows", "sum_rounds_up"])
def test_cull_keeps_rounding_edges(case):
    """Voxels that pass the twin's test only through f32 rounding keep
    their tile: px = fl(u / pw) rounds a tiny negative quotient to -0,
    which passes px >= 0 (the one-pixel margin keeps it); and at voxel
    (1, 1, k) fl(fl(2^24 + 1.5) - (2^24 + 2)) = 0 where the exact u is
    -0.5, negative at every corner, with a pw too small for the pixel
    margin to cover (the rounding margin keeps it)."""
    h = w = 8
    p = np.zeros((1, 3, 4), np.float32)
    if case == "quotient_underflows":
        p[0, 0, 3], p[0, 1, 3], p[0, 2, 3] = -1e-30, 1e20, 1e20
    else:
        p[0, 0, 0], p[0, 0, 1], p[0, 0, 3] = 2.0**24, 1.5, -(2.0**24 + 2)
        p[0, 1, 3] = p[0, 2, 3] = 0.01
    shape = (2, 2, 2)
    admitted = admitted_port(shape, p[0], h, w)
    assert bool(admitted.any())
    culled = fuse_cull_tiles(shape, torch.from_numpy(p), h, w)
    assert not bool(culled.any())
