"""The profiling tools' and the chip smoke's inputs, made from seeds:
bench.py's scene (the bumpy canonical sphere, the live sphere of
``benchmarks/suite.py`` config 4 and the 4096-node field of
``init_canonical``), the JAX trilerp profiler's random samples, and config
7's ground-truth bend. At ``res`` = 256 they are the JAX tools' own; a
smaller ``res`` scales the spheres and the caps with it so that a CPU run
at 32³ stays small. ``bumpy_sdf`` and ``make_bend`` are copies of
``bench.py:bumpy_sdf`` and ``benchmarks/suite.py:_make_bend`` (numpy), so
the port imports nothing of the JAX side."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..models.warp_field import neighbor_lookup
from ..ops.marching_cubes import marching_cubes
from ..pipeline.frame import _blend_weights, init_canonical
from ..solvers.nonrigid import make_reg_pairs

LW_REF = (1.0, 0.0, 0.0, 0.0, 0.0, 0.1, 0.0, 0.0)  # config 4's global pose
KNN_K = 3


def cap(base: int, res: int, floor: int = 2048) -> int:
    """A mesh or node cap given at 256³, scaled with the surface (res²),
    at least ``floor``."""
    return max(base * res * res // (256 * 256), floor)


def bumpy_sdf(res, center, radius, amp, freq, phase=0.0):
    """Sphere with angular bumps — a deformable body stand-in
    (``bench.py:54-63``)."""
    g = np.arange(res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    dx, dy, dz = x - center[0], y - center[1], z - center[2]
    r = np.sqrt(dx * dx + dy * dy + dz * dz) + 1e-6
    theta = np.arccos(np.clip(dz / r, -1, 1))
    phi = np.arctan2(dy, dx)
    bump = amp * np.sin(freq * theta + phase) * np.cos(freq * phi + phase)
    return (r - (radius + bump)).astype(np.float32)


def make_bend(ref_verts):
    """Analytic smooth bend about x through the centroid, blended by
    height, with its parameters frozen from ``ref_verts`` so that it
    applies to any points: config 7's ground truth
    (``benchmarks/suite.py:319-338``). Returns ``bend(pts, angle)``."""
    c = ref_verts.mean(0)
    y = ref_verts[:, 1] - c[1]
    h = (y.max() - y.min()) + 1e-6

    def bend(pts, angle):
        p = pts - c
        t = 1.0 / (1.0 + np.exp(-8.0 * (p[:, 1] / h)))
        ca, sa = np.cos(angle * t), np.sin(angle * t)
        out = np.empty_like(p)
        out[:, 0] = p[:, 0]
        out[:, 1] = ca * p[:, 1] - sa * p[:, 2]
        out[:, 2] = sa * p[:, 1] + ca * p[:, 2]
        return (out + c).astype(np.float32)

    return bend


def bumpy(res: int, center, phase: float):
    """:func:`bumpy_sdf` with the 256³ scene's centre, radius and bump
    amplitude scaled to ``res``."""
    s = res / 256
    return bumpy_sdf(res, tuple(c * s for c in center), 70.0 * s, 4.0 * s,
                     3.0, phase)


def bench_scene(res: int, dev: torch.device):
    """The bench canonical (``bench.py:77``), config 4's live volume
    (``benchmarks/suite.py:193-226``), tdist, the global pose and the
    ``init_canonical`` field of the bench settings (subsample rate 1.5,
    stride-2 MC)."""
    canonical = torch.from_numpy(bumpy(res, (128, 128, 128), 0.0)).to(dev)
    live = torch.from_numpy(bumpy(res, (130, 129, 128), 0.1)).to(dev)
    caps = dict(vert_cap=cap(1 << 15, res),
                face_cap=cap(1 << 16, res, 4096))
    wf, _ = init_canonical(canonical, subsample_rate=1.5,
                           node_cap=cap(4096, res, 256), mc_step=2, **caps)
    lw = torch.tensor(LW_REF, dtype=torch.float32, device=dev)
    return SimpleNamespace(canonical=canonical, live=live,
                           tdist=float(canonical.max()), wf=wf, lw=lw,
                           shape=(res,) * 3, **caps)


def meshes(sc):
    """The canonical mesh at stride 2 and the live mesh at stride 1 (the
    frame's caps), their valid masks, the canonical vertices' node
    neighbours and blend weights."""
    dev = sc.canonical.device
    mesh = marching_cubes(sc.canonical, 0.0, vert_cap=sc.vert_cap,
                          face_cap=sc.face_cap, step_size=2, use_kernels=True)
    vmask = torch.arange(sc.vert_cap, device=dev) < mesh["n_verts"]
    live_cap = (cap(1 << 17, sc.shape[0]),
                cap(1 << 18, sc.shape[0], 4096))
    live_mesh = marching_cubes(sc.live, 0.0, vert_cap=live_cap[0],
                               face_cap=live_cap[1], step_size=1,
                               use_kernels=True)
    lmask = torch.arange(live_cap[0], device=dev) < live_mesh["n_verts"]
    nbr_idx = neighbor_lookup(sc.wf, mesh["verts"], KNN_K)
    blend = _blend_weights(sc.wf, mesh["verts"], nbr_idx)
    return SimpleNamespace(mesh=mesh, vmask=vmask, live_mesh=live_mesh,
                           lmask=lmask, live_cap=live_cap, nbr_idx=nbr_idx,
                           blend=blend)


def reg_pairs(sc, ms, rw: float = 0.5):
    """(pair_i, pair_j, pair_v, pair_scale, pair_mask) of the field at
    regularization weight ``rw``."""
    wf = sc.wf
    pair_i, pair_j, pair_scale, pmask = make_reg_pairs(
        wf.node_vert_idx, ms.nbr_idx, wf.node_w, wf.active, rw)
    return pair_i, pair_j, wf.node_pos[pair_j], pair_scale, pmask


def trilerp_inputs(res: int, dev: torch.device):
    """``tools/profile_trilerp.py:37-46``: ``np.random.RandomState(0)``,
    live ``rand(R, R, R)`` and per-brick coordinates ``base + offs`` of
    shape ((R/8)³, 512) each (16.8 M samples at 256³)."""
    rng = np.random.RandomState(0)
    live = rng.rand(res, res, res).astype(np.float32)
    nb = (res // 8) ** 3
    base = rng.rand(nb, 1, 3).astype(np.float32) * (res - 12)
    offs = rng.rand(nb, 512, 3).astype(np.float32) * 8.0
    w = base + offs
    return (torch.from_numpy(live).to(dev),
            *(torch.from_numpy(np.ascontiguousarray(w[..., a])).to(dev)
              for a in range(3)))


def sharded_volumes(res: int):
    """The canonical and live volumes of ``benchmarks/bench512_sharded.py
    :51-55`` at ``res`` (numpy): bumpy spheres of radius 0.27·res and bump
    amplitude 0.02·res at the centre and 2, 1, 0 voxels off it, bump
    phases 0 and 0.05."""
    canonical = bumpy_sdf(res, (res // 2,) * 3, 0.27 * res, 0.02 * res, 3.0,
                          0.0)
    live = bumpy_sdf(res, (res // 2 + 2, res // 2 + 1, res // 2),
                     0.27 * res, 0.02 * res, 3.0, 0.05)
    return canonical, live


SHARDED_NODE_CAP = 1024


def sharded_field(res: int, canonical, seed: int = 0):
    """The seeded part of ``bench512_sharded.py:49-70`` (numpy), in its
    draw order from ``RandomState(seed)``: 8·1024 random lattice points,
    the 1024 nearest the canonical's zero set as graph vertices, node DQs
    perturbed by 0.02·randn about the identity, and canonical weights
    ``rand(res³)·4``. Returns (verts (1024, 3), node_dq (1024, 8),
    weights (res³)); the graph radius is 0.05·res and the global pose
    :func:`sharded_pose`."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(8 * SHARDED_NODE_CAP, 3) * (res - 1)
    vals = canonical[tuple(pts.astype(np.int32).T)]
    near = np.argsort(np.abs(vals))[:SHARDED_NODE_CAP]
    verts = pts[near].astype(np.float32)
    dqs = (rng.randn(SHARDED_NODE_CAP, 8) * 0.02).astype(np.float32)
    dqs[:, 0] += 1.0
    weights = (rng.rand(res, res, res) * 4).astype(np.float32)
    return verts, dqs, weights


def sharded_pose(res: int):
    """The equivalence's global pose: a 0.02·res translation in the DQ's
    dual part (``bench512_sharded.py:71``)."""
    return np.array([1.0, 0, 0, 0, 0, 0.02 * res, 0, 0], np.float32)
