"""benchmarks/suite.py config 7 in small through both ``Fusion`` drivers on
the CPU: the reference's result mesh ``meshes/original.obj`` bent by a
known smooth warp (suite.py:_make_bend), fused from 8 yaw views into a
32³ canonical and per-frame live TSDFs on one lattice, then tracked by the
full loop per frame (setupCorrespondences → solve → updateTSDF →
update_graph, suite.py:341-496). The views are 256² (suite: 512²), there
are two frames (suite: three) and the solves run half the default GN/CG
depth, to keep the file near a minute and a half.

Both drivers get JAX's fused volumes (the port's own fusion is held to
JAX's in test_torch_config6.py); the test holds the port's final
point-to-surface error of the observed canonical vertices to JAX's.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import torch

from dynamicfusion_body_tpu.io.mesh_io import load_obj, regularize_mesh
from dynamicfusion_body_tpu.models.tsdf_volume import TsdfVolume
from dynamicfusion_body_tpu.ops.interp import trilinear as j_trilinear
from dynamicfusion_body_tpu.ops.transforms import rotation_matrix
from dynamicfusion_body_tpu.pipeline.fusion import Fusion as JFusion
from dynamicfusion_body_tpu.pipeline.fusion import FusionDM as JFusionDM
from dynamicfusion_body_tpu.render.raster import render_depth
from dynamicfusion_body_tpu_torch.pipeline.fusion import Fusion as TFusion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
from suite import _make_bend  # noqa: E402  (config 7's ground truth)

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)

RES, IMG = 32, 256
K = np.array([[200.0, 0, 128], [0, 200, 128], [0, 0, 1]], np.float32)
ANGLES = (0.08, 0.16)


def render(verts, faces):
    depths, lws = [], []
    fmask = jnp.ones(len(faces), bool)
    for i in range(8):
        R = rotation_matrix(2 * np.pi * i / 8, [0, 1, 0])[:3, :3]
        t = np.array([0, 0, 2.5]) - R @ np.zeros(3)
        lw = np.concatenate([R, t[:, None]], 1).astype(np.float32)
        depths.append(np.asarray(render_depth(
            jnp.asarray(verts), jnp.asarray(faces), fmask, jnp.asarray(K),
            jnp.asarray(lw), IMG, IMG, S=8)))
        lws.append(lw)
    return depths, lws


def p2s(pts, surf):
    """Distance of each point to the nearest surface sample."""
    d2 = np.sum((pts[:, None, :] - surf[None]) ** 2, -1)
    return np.sqrt(d2.min(1))


def test_config7_bend_tracks_as_jax():
    verts, faces = load_obj(os.path.join(ROOT, "meshes", "original.obj"))
    verts = np.asarray(regularize_mesh(jnp.asarray(verts)))
    bend = _make_bend(verts)
    tdist = 8.0 / RES * 1.3
    dm = JFusionDM(tdist, K, tsdf_res=RES, vert_cap=1 << 15,
                   face_cap=1 << 16)
    depths0, lws = render(verts, faces)
    canon_v, canon_w = dm.compute_live_tsdf(depths0, lws,
                                            UseAutoAlignment=True)
    ind = np.asarray(dm._IND)
    voxel = float(ind[0, 0])
    lives = []
    for ang in ANGLES:
        depths, _ = render(bend(verts, ang), faces)
        fresh = TsdfVolume.create(RES, tdist, ind=jnp.asarray(ind))
        lives.append(np.asarray(dm._fuse_all(fresh.values, fresh.weights,
                                             depths, lws)[0]))

    # suite.py's 64³ settings scaled to 32³: mc_step 2, subsample_rate
    # 2·(res/64)/(mc_step/2); mesh caps cut to the 32³ surfaces (~800
    # canonical, ~3,000 live vertices), since the correspondence search and
    # the solver's tables scale with the caps, not with the mesh
    kw = dict(subsample_rate=1.0, knn=3, marching_cubes_step_size=2,
              write_warpfield=False, vert_cap=1 << 12, face_cap=1 << 13,
              live_vert_cap=1 << 13, live_face_cap=1 << 14, node_cap=1024)
    jf = JFusion(canon_v, tdist, **kw)
    tf = TFusion(canon_v, tdist, device="cpu", **kw)
    m = jf._mesh
    nv = int(m["n_verts"])
    gv = np.asarray(m["verts"])[:nv]
    assert int(tf._mesh["n_verts"]) == nv
    np.testing.assert_allclose(tf._mesh["verts"][:nv].numpy(), gv, atol=1e-5)
    wts, _ = j_trilinear(jnp.asarray(canon_w), jnp.asarray(gv))
    obs = np.asarray(wts) >= 3.0
    assert obs.sum() > 100
    wv = gv @ ind[:3, :3].T + ind[:3, 3]
    surf = np.concatenate([verts, verts[faces].mean(1)], 0)

    errs = {"jax": [], "port": []}
    for ang, live in zip(ANGLES, lives):
        for name, f in (("jax", jf), ("port", tf)):
            f.setupCorrespondences(live, method="clpts", tolerance=5.0)
            f.solve(regularization_weight=0.5, method="clpts", gn_iters=4,
                    cg_iters=16)
            f.updateTSDF()
            f.update_graph()
            tracked = np.asarray(f.warp(gv, m_lw=np.asarray(f._lw)))
            tw = tracked @ ind[:3, :3].T + ind[:3, 3]
            errs[name].append(
                float(np.mean(p2s(tw[obs], bend(surf, ang))) / voxel))
    untracked = float(np.mean(p2s(wv[obs], bend(surf, ANGLES[-1]))) / voxel)
    print("point-to-surface (voxels):", errs, "untracked", untracked)
    # both track; the port within 0.05 voxel of JAX per frame: the solves
    # differ by f32 summation order and near-tie correspondence picks
    # (test_torch_fusion_driver.py), which move the tracked surface by
    # hundredths of a voxel
    assert errs["jax"][-1] < untracked
    np.testing.assert_allclose(errs["port"], errs["jax"], atol=0.05)
    for f in (jf, tf):
        assert np.isfinite(np.asarray(f.volume.values)).all()
