"""The port's suite configs 6 and 7 (dynamicfusion_body_tpu_torch.
benchmarks.suite.config6 and run_config7, the drivers that the suite, the
chip smoke and tools/diag_config7 run) against the repository's
benchmarks/suite.py code paths (suite.py:261-316 and 341-496) on the CPU,
on ``meshes/original.obj`` in small: 128² views, lattices of 16³ and 32³,
config 7 over two bend frames at half the default GN/CG depth.

Both packages fuse the same JAX renders (the port's renders are held to
JAX's here on the mesh itself, and in test_torch_render.py), and the port
takes JAX's ``estimate_alignment`` (see test_torch_fusion_dm.py for why),
so both drivers start from one lattice. The JAX side's point-to-surface
distances use a k-d tree in place of suite.py's chunked brute-force
minimum: the same nearest distances without its 3 GB intermediate.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from dynamicfusion_body_tpu.io.mesh_io import load_obj
from dynamicfusion_body_tpu.io.mesh_io import regularize_mesh as j_regularize
from dynamicfusion_body_tpu.models.tsdf_volume import TsdfVolume as JVolume
from dynamicfusion_body_tpu.ops.interp import trilinear as j_trilinear
from dynamicfusion_body_tpu.ops.projection import estimate_alignment as j_est
from dynamicfusion_body_tpu.pipeline.fusion import Fusion as JFusion
from dynamicfusion_body_tpu.pipeline.fusion import FusionDM as JFusionDM
from dynamicfusion_body_tpu_torch.benchmarks import suite
from dynamicfusion_body_tpu_torch.pipeline import fusion as TF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
from suite import _make_bend as j_make_bend  # noqa: E402
from suite import _render_views as j_render_views  # noqa: E402
from suite import _sample_surface as j_sample_surface  # noqa: E402

# One intra-op thread (see tests/test_torch_frame.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
IMG = 128
C6_RES = (16, 32)
C7_RES = 32
C7_ANGLES = (0.08, 0.16)
C7_SOLVE = dict(gn_iters=4, cg_iters=16)
# render parity, as test_torch_render.py: equal hit masks, depths one
# 1/1024 z-buffer step apart on at most 1% of the hit pixels
DIFF_SHARE = 0.01
# config 6: the printed lines are rounded to 3 decimals (voxels, shares)
# and 5 (world); the volumes agree to 2e-4 (test_torch_config6.py), so
# the scores agree to a rounding step
C6_ATOL_VOX = 2e-3
C6_ATOL_WORLD = 2e-5
# config 7: the solves differ by f32 summation order and near-tie
# correspondence picks (test_torch_config7.py), which move the tracked
# surface by hundredths of a voxel; the untracked error depends on the
# canonical mesh alone
C7_ATOL_VOX = 0.05
C7_UNTRACKED_ATOL = 1e-4


@pytest.fixture(scope="module")
def mesh():
    verts, faces = load_obj(os.path.join(ROOT, "meshes", "original.obj"))
    return np.asarray(j_regularize(jnp.asarray(verts))), faces


@pytest.fixture
def jax_inputs(monkeypatch):
    """The port's suite renders through JAX's ``_render_views`` and its
    FusionDM takes JAX's alignment."""

    def render(verts, faces, K, n_views, h, w, dev, dist=2.5):
        return j_render_views(verts, faces, K, n_views, h, w, dist)

    def est(depths, Kinv, lws):
        a, s = j_est(jnp.asarray(depths.numpy()), jnp.asarray(Kinv.numpy()),
                     jnp.asarray(lws.numpy()))
        return torch.from_numpy(np.array(a)), torch.from_numpy(np.array(s))

    monkeypatch.setattr(suite, "_render_views", render)
    monkeypatch.setattr(TF, "estimate_alignment", est)


def test_reference_mesh_matches_jax(mesh):
    verts, faces = suite.reference_mesh()
    np.testing.assert_array_equal(faces, mesh[1])
    np.testing.assert_allclose(verts, mesh[0], rtol=0, atol=1e-6)


def test_render_views_match_jax(mesh):
    verts, faces = mesh
    K = suite.camera(IMG)
    want, j_lws = j_render_views(verts, faces, K, 8, IMG, IMG)
    got, lws = suite._render_views(verts, faces, K, 8, IMG, IMG, CPU)
    np.testing.assert_allclose(np.stack(lws), np.stack(j_lws), atol=1e-7)
    for g, w in zip(got, want):
        hit = w != 0
        assert hit.sum() > 1000
        np.testing.assert_array_equal(g != 0, hit)
        diff = np.abs(g - w)
        assert diff.max() <= 1.0 / 1024
        assert (diff > 0).sum() <= DIFF_SHARE * hit.sum()


def j_config6(verts, faces, K, img, res):
    """suite.py:261-316 with the view size and the lattices as
    arguments: one dict per lattice with the printed line's keys."""
    depths, lws = j_render_views(verts, faces, K, n_views=8, h=img, w=img)
    tree = cKDTree(j_sample_surface(verts, faces, 300_000))
    out = []
    for r, caps in ((res[0], (1 << 15, 1 << 16)),
                    (res[1], (1 << 17, 1 << 18))):
        fus = JFusionDM(8.0 / r * 1.3, K, tsdf_res=r, vert_cap=caps[0],
                        face_cap=caps[1])
        fus.compute_live_tsdf(depths, lws, UseAutoAlignment=True)
        fus.marching_cubes()
        m = fus._mesh
        nv = int(m["n_verts"])
        gv = np.asarray(m["verts"])[:nv]
        ind = np.asarray(fus._IND)
        d, _ = tree.query(gv @ ind[:3, :3].T + ind[:3, 3], k=1)
        voxel = float(ind[0, 0])
        wts, _ = j_trilinear(fus.volume.weights, jnp.asarray(gv))
        obs = np.asarray(wts) >= 3.0
        do = d[obs] if obs.any() else d
        out.append({
            "metric": f"config6_mesh_vertex_error_{r}",
            "value": float(np.mean(do) / voxel),
            "mean_err_world": float(np.mean(do)),
            "p95_err_voxels": float(np.percentile(do, 95) / voxel),
            "n_verts": nv,
            "observed_frac": float(obs.mean()),
        })
    return out


def test_config6_matches_jax_suite(mesh, jax_inputs, capsys):
    verts, faces = mesh
    want = j_config6(verts, faces, suite.camera(IMG), IMG, C6_RES)
    got = suite.config6(CPU, res=C6_RES, img=IMG)
    assert [g["metric"] for g in got] == [w["metric"] for w in want]
    for g, w in zip(got, want):
        assert g["unit"] == "voxels"
        assert g["n_verts"] == w["n_verts"] > 100
        for key in ("value", "p95_err_voxels", "observed_frac"):
            assert abs(g[key] - w[key]) <= C6_ATOL_VOX, (key, g, w)
        assert abs(g["mean_err_world"] - w["mean_err_world"]) \
            <= C6_ATOL_WORLD
    assert got[-1]["value"] < 1.0 and got[-1]["p95_err_voxels"] < 2.0
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(p)["metric"] for p in printed] == \
        [g["metric"] for g in got]


def j_config7(verts, faces, K, img, res, caps, angles, gn_iters, cg_iters):
    """suite.py:341-496 at one lattice with the view size, the caps
    ((canonical verts, faces), (live verts, faces), nodes), the angles and
    the solver depth as arguments: (per-frame surface errors, per-frame
    vertex errors, untracked error, voxel, tracked vertices)."""
    (vcap, fcap), (lvcap, lfcap), node_cap = caps
    bend = j_make_bend(verts)
    tdist = 8.0 / res * 1.3
    dm = JFusionDM(tdist, K, tsdf_res=res, vert_cap=vcap, face_cap=fcap)
    depths0, lws = j_render_views(verts, faces, K, n_views=8, h=img, w=img)
    canon_v, canon_w = dm.compute_live_tsdf(depths0, lws,
                                            UseAutoAlignment=True)
    ind = np.asarray(dm._IND)
    voxel = float(ind[0, 0])
    mc_step = 2 if res <= 64 else 3
    ssr = 2.0 * (res / 64) / (mc_step / 2)
    fus = JFusion(canon_v, tdist, subsample_rate=ssr, knn=3,
                  marching_cubes_step_size=mc_step, write_warpfield=False,
                  vert_cap=vcap, face_cap=fcap, node_cap=node_cap,
                  live_vert_cap=lvcap, live_face_cap=lfcap)
    m = fus._mesh
    nv = int(m["n_verts"])
    gv = np.asarray(m["verts"])[:nv]
    wv = gv @ ind[:3, :3].T + ind[:3, 3]
    wts, _ = j_trilinear(jnp.asarray(canon_w), jnp.asarray(gv))
    obs = np.asarray(wts) >= 3.0
    surf = np.concatenate([verts, verts[faces].mean(1),
                           0.5 * (verts[faces[:, 0]] + verts[faces[:, 1]])])

    def p2s(pts, ang):
        return cKDTree(bend(surf, ang)).query(pts, k=1)[0]

    verr, serr = [], []
    for ang in angles:
        depths, _ = j_render_views(bend(verts, ang), faces, K, n_views=8,
                                   h=img, w=img)
        fresh = JVolume.create(res, tdist, ind=jnp.asarray(ind))
        dm.volume = fresh
        live_v, _ = dm._fuse_all(fresh.values, fresh.weights, depths, lws)
        fus.setupCorrespondences(live_v, method="clpts", tolerance=5.0,
                                 live_mc_step=1 if res <= 64 else 2)
        fus.solve(regularization_weight=0.5, method="clpts",
                  gn_iters=gn_iters, cg_iters=cg_iters)
        fus.updateTSDF()
        fus.update_graph()
        tracked = np.asarray(fus.warp(gv, m_lw=fus._lw))
        tracked = tracked @ ind[:3, :3].T + ind[:3, 3]
        err = np.linalg.norm(tracked - bend(wv, ang), axis=1)
        verr.append(err[obs] if obs.any() else err)
        serr.append(p2s(tracked[obs] if obs.any() else tracked, ang))
    untracked = p2s(wv[obs] if obs.any() else wv, angles[-1])
    return serr, verr, untracked, voxel, int(obs.sum())


def test_config7_matches_jax_suite(mesh, jax_inputs):
    """The port's config-7 driver and JAX's on the same renders: the same
    tracked vertices and untracked error, per-frame surface and vertex
    errors within 0.05 voxel, and both track (final below untracked)."""
    verts, faces = mesh
    vcap, fcap, lvcap, lfcap, node_cap = suite.config7_caps(C7_RES)
    serr, verr, untracked, voxel, n_tracked = j_config7(
        verts, faces, suite.camera(IMG), IMG, C7_RES,
        ((vcap, fcap), (lvcap, lfcap), node_cap), C7_ANGLES, **C7_SOLVE)
    c = suite.run_config7(CPU, C7_RES, verts, faces, img=IMG,
                          angles=C7_ANGLES, **C7_SOLVE)

    def vox(errs, v):
        return [float(np.mean(e) / v) for e in errs]

    print("jax", vox(serr, voxel), vox(verr, voxel), untracked.mean() / voxel)
    print("port", vox(c["serr"], c["voxel"]), vox(c["verr"], c["voxel"]),
          c["untracked"].mean() / c["voxel"])
    assert c["voxel"] == pytest.approx(voxel, rel=1e-6)
    assert c["n_tracked"] == n_tracked > 100
    assert abs(c["untracked"].mean() - untracked.mean()) / voxel \
        <= C7_UNTRACKED_ATOL
    np.testing.assert_allclose(vox(c["serr"], voxel), vox(serr, voxel),
                               rtol=0, atol=C7_ATOL_VOX)
    np.testing.assert_allclose(vox(c["verr"], voxel), vox(verr, voxel),
                               rtol=0, atol=C7_ATOL_VOX)
    assert vox(serr, voxel)[-1] < untracked.mean() / voxel
    assert vox(c["serr"], voxel)[-1] < untracked.mean() / voxel
    assert set(c["build"]) == {"render canonical views", "canonical fusion",
                               "Fusion construction", "construct_graph"}
    assert c["build"]["construct_graph"]["count"] == 1
    assert c["build"]["construct_graph"]["total_s"] \
        <= c["build"]["Fusion construction"]["total_s"]
