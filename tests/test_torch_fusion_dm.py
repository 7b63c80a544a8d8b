"""The port's multi-view FusionDM (dynamicfusion_body_tpu_torch.pipeline.
fusion.FusionDM) and CLI against the JAX package, on the CPU.

``estimate_alignment`` sums H·W points per map in float32, in another
order than XLA, so the grid matrix ``IND`` can differ in its last bit and
shift the whole lattice (it is held to rtol 1e-5 alone, in
test_torch_projection.py). The FusionDM-level parity tests therefore hand
the port JAX's alignment, so both packages fuse on one lattice; there the
tolerances of test_torch_tsdf_volume.py apply (weights exact, values atol
2e-5, near-threshold voxels masked).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu import cli as jcli
from dynamicfusion_body_tpu.models.tsdf_volume import TsdfVolume as JVolume
from dynamicfusion_body_tpu.ops.projection import estimate_alignment as j_est
from dynamicfusion_body_tpu.pipeline.fusion import FusionDM as JFusionDM
from dynamicfusion_body_tpu_torch import cli, convert
from dynamicfusion_body_tpu_torch.config import CameraConfig
from dynamicfusion_body_tpu_torch.ops.marching_cubes import marching_cubes
from dynamicfusion_body_tpu_torch.ops.transforms import rotation_matrix
from dynamicfusion_body_tpu_torch.pipeline import fusion as TF
from dynamicfusion_body_tpu_torch.render.raster import render_depth
from fixtures import synthetic_depth_sphere
from test_torch_tsdf_volume import assert_fused_close, flip_mask

# One intra-op thread (see tests/test_torch_marching_cubes.py)
torch.set_num_threads(1)

K_SCENE = np.array([[300.0, 0, 64], [0, 300, 64], [0, 0, 1]], np.float32)
CENTER = np.array([0.0, 0.0, 4.0])


def sphere_scene(angles, K=K_SCENE, h=128, w=128):
    """tests/test_pipeline.py:47-96: a sphere of radius 0.6 at z = 4 seen
    from cameras turned about it."""
    depths, lws = [], []
    for ang in angles:
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        t = CENTER - R @ CENTER
        lw = np.concatenate([R, t[:, None]], 1).astype(np.float32)
        depths.append(synthetic_depth_sphere(h, w, K, CENTER, 0.6, lw))
        lws.append(lw)
    return depths, lws


@pytest.fixture
def jax_alignment(monkeypatch):
    """The port's FusionDM takes JAX's estimate_alignment result."""

    def est(depths, Kinv, lws):
        a, s = j_est(jnp.asarray(depths.numpy()), jnp.asarray(Kinv.numpy()),
                     jnp.asarray(lws.numpy()))
        return torch.from_numpy(np.array(a)), torch.from_numpy(np.array(s))

    monkeypatch.setattr(TF, "estimate_alignment", est)


def obj_parts(path):
    lines = open(path).read().splitlines()
    v = np.array([[float(x) for x in l.split()[1:]] for l in lines
                  if l.startswith("v ")])
    return v, [l for l in lines if l.startswith("f ")]


def test_multiview_matches_jax(tmp_path, monkeypatch, jax_alignment):
    """The straight multi-view branch at 48³, then write_canonical_mesh
    (vertices atol 1e-5, face lines exact) and the outputMesh snapshot."""
    depths, lws = sphere_scene((0.0, np.pi / 2, np.pi))
    jfus = JFusionDM(0.05, K_SCENE, tsdf_res=48, vert_cap=16384,
                     face_cap=32768)
    jv, jw = jfus.compute_live_tsdf(depths, lws, UseAutoAlignment=True)
    tfus = TF.FusionDM(0.05, K_SCENE, tsdf_res=48, vert_cap=16384,
                       face_cap=32768, device="cpu")
    monkeypatch.chdir(tmp_path)
    tv, tw = tfus.compute_live_tsdf(depths, lws, UseAutoAlignment=True,
                                    outputMesh=True)
    np.testing.assert_array_equal(tfus._IND, jfus._IND)
    projs = [tfus._proj(lw) for lw in lws]
    np.testing.assert_array_equal(np.stack(projs),
                                  np.stack([np.asarray(jfus._proj(lw))
                                            for lw in lws]))
    mask = flip_mask(tv.shape, depths, projs, tfus._Kinv[2], 0.05)
    assert_fused_close((tv, tw), (jv, jw), mask)
    assert tw.max() > 0 and tv.min() < 0 < tv.max()

    jfus.write_canonical_mesh(str(tmp_path), "j.obj")
    tfus.write_canonical_mesh(str(tmp_path), "t.obj")
    (jverts, jfaces), (tverts, tfaces) = (obj_parts(tmp_path / "j.obj"),
                                          obj_parts(tmp_path / "t.obj"))
    assert tfaces == jfaces and len(tfaces) > 100
    np.testing.assert_allclose(tverts, jverts, rtol=0, atol=1e-5)
    d = np.linalg.norm(tverts - CENTER, axis=1)
    assert abs(np.median(d) - 0.6) < 0.1, np.median(d)
    # outputMesh=True: tsdf_temp.npy and test.obj in the working directory
    np.testing.assert_array_equal(np.load(tmp_path / "tsdf_temp.npy"), tv)
    assert obj_parts(tmp_path / "test.obj")[1] == tfaces


def test_icp_branch_matches_jax(jax_alignment):
    """useICP=True at 32³ (two views): per-map fusion, live marching cubes,
    closest points and the rigid solve, then the rigid TSDF update.

    The pose comes out of 3 x 12 GN steps whose accept/reject decisions
    flip on f32 noise (ROADMAP Queue 3, rigid presolve gauge): measured
    |Δ| 8e-4 on the dual part (in voxels), held to atol 2e-3. A voxel whose
    live sample sits near -tdist or the volume's edge then updates in one
    package and not the other (2.3% of the weights here, held below 5%).
    So the update itself is checked exactly: JAX's fuse_depth and
    update_tsdf_rigid, run with the port's pose, give the port's volume."""
    from dynamicfusion_body_tpu.models import tsdf_volume as JT

    tdist = 0.05
    depths, lws = sphere_scene((0.0, 0.2))
    jfus = JFusionDM(tdist, K_SCENE, tsdf_res=32, vert_cap=8192,
                     face_cap=16384)
    jv, jw = jfus.compute_live_tsdf(depths, lws, UseAutoAlignment=True,
                                    useICP=True)
    tfus = TF.FusionDM(tdist, K_SCENE, tsdf_res=32, vert_cap=8192,
                       face_cap=16384, device="cpu")
    tv, tw = tfus.compute_live_tsdf(depths, lws, UseAutoAlignment=True,
                                    useICP=True)
    assert tw.max() > 0 and tv.min() < 0
    assert int(tfus._corr_valid.sum()) > 100
    np.testing.assert_allclose(tfus._lw.numpy(), np.asarray(jfus._lw),
                               atol=2e-3)
    assert (tw != jw).mean() < 0.05

    fresh = JVolume.create(32, tdist, ind=jnp.asarray(tfus._IND))
    kinv = jnp.asarray(tfus._Kinv)
    v0, w0 = JT.fuse_depth(fresh.values, fresh.weights,
                           jnp.asarray(depths[0]),
                           jnp.asarray(tfus._proj(lws[0])), kinv, tdist)
    live, _ = JT.fuse_depth(fresh.values, fresh.weights,
                            jnp.asarray(depths[1]),
                            jnp.asarray(tfus._proj(lws[1])), kinv, tdist)
    want_v, want_w = JT.update_tsdf_rigid(v0, w0, live,
                                          jnp.asarray(tfus._lw.numpy()),
                                          tdist)
    np.testing.assert_array_equal(tw, np.asarray(want_w))
    np.testing.assert_allclose(tv, np.asarray(want_v), rtol=0, atol=2e-5)


def test_fuse_from_converted_jax_volume():
    """convert.tsdf_volume_from_jax starts both packages from one state;
    fuseDepths then fuses one more map into it."""
    depths, lws = sphere_scene((0.0, 0.7))
    rng = np.random.RandomState(5)
    ind = np.array([[0.03, 0, 0, -0.5], [0, 0.03, 0, -0.5],
                    [0, 0, 0.03, 3.4], [0, 0, 0, 1]], np.float32)
    jvol = JVolume(values=jnp.asarray(rng.uniform(-0.05, 0.05, (32,) * 3),
                                      jnp.float32),
                   weights=jnp.asarray(rng.randint(0, 5, (32,) * 3),
                                       jnp.float32),
                   ind=jnp.asarray(ind))
    tvol = convert.tsdf_volume_from_jax(
        {k: np.asarray(getattr(jvol, k)) for k in ("values", "weights", "ind")},
        device="cpu")
    jfus = JFusionDM(0.05, K_SCENE, tsdf_res=32)
    tfus = TF.FusionDM(0.05, K_SCENE, tsdf_res=32, device="cpu")
    jfus.volume, tfus.volume = jvol, tvol
    want = jfus.fuseDepths(depths[1], lws[1], jvol.values, jvol.weights)
    got = tfus.fuseDepths(depths[1], lws[1], tvol.values, tvol.weights)
    mask = flip_mask((32,) * 3, depths[1:], [tfus._proj(lws[1])],
                     tfus._Kinv[2], 0.05)
    assert_fused_close(got, want, mask)
    assert (got[1] != np.asarray(jvol.weights)).any()


def test_entry_points_default_to_the_card():
    """No CUDA device here: FusionDM, the converters and the CLI refuse
    to run instead of falling back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.FusionDM(0.05, K_SCENE, tsdf_res=8)
    with pytest.raises((RuntimeError, AssertionError)):
        convert.tsdf_volume_from_jax(
            {"values": np.zeros((2, 2, 2), np.float32),
             "weights": np.zeros((2, 2, 2), np.float32),
             "ind": np.eye(4, dtype=np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["selftest"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["dummy"])
    assert cli.main(["selftest", "--device", "cpu"]) == 0


def test_sphere_accuracy_8_views():
    """tests/test_accuracy.py:36-70 through the port alone: render an
    analytic sphere's mesh from 8 yaw views, fuse at 48³, extract; mean
    vertex error < 1 voxel and p95 < 2 voxels."""
    res_m = 96
    g = np.arange(res_m, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (res_m - 1) / 2.0
    sdf = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) - 0.27 * res_m
    m = marching_cubes(torch.from_numpy(sdf.astype(np.float32)),
                       vert_cap=1 << 14, face_cap=1 << 15)
    assert not bool(m["overflow"])
    nv, nf = int(m["n_verts"]), int(m["n_faces"])
    verts = (m["verts"][:nv] - c) / res_m * 2.0
    faces = m["faces"][:nf]
    world_r = 0.27 * 2.0
    K = np.array([[200.0, 0, 128], [0, 200, 128], [0, 0, 1]], np.float32)
    fmask = torch.ones(nf, dtype=torch.bool)
    depths, lws = [], []
    for i in range(8):
        R = rotation_matrix(2 * np.pi * i / 8, [0, 1, 0])[:3, :3]
        lw = np.concatenate([R, [[0.0], [0.0], [2.5]]], 1).astype(np.float32)
        depths.append(render_depth(verts, faces, fmask, torch.from_numpy(K),
                                   torch.from_numpy(lw), 256, 256, S=8).numpy())
        lws.append(lw)
    res = 48
    fus = TF.FusionDM(8.0 / res * 1.3, K, tsdf_res=res, vert_cap=1 << 14,
                      face_cap=1 << 15, device="cpu")
    fus.compute_live_tsdf(depths, lws, UseAutoAlignment=True)
    fus.marching_cubes()
    nv = int(fus._mesh["n_verts"])
    assert nv > 500, nv
    gv = fus._mesh["verts"][:nv].numpy()
    ind = fus._IND
    wv = gv @ ind[:3, :3].T + ind[:3, 3]
    voxel = float(ind[0, 0])
    err = np.abs(np.linalg.norm(wv, axis=1) - world_r)
    assert float(err.mean()) < 1.0 * voxel, (err.mean(), voxel)
    assert float(np.percentile(err, 95)) < 2.0 * voxel


def test_cli_fusion_dm_and_backproject(tmp_path):
    """`cli fusion-dm --device cpu` and `backproject` on a directory of
    depth .npy files and proj*.txt matrices (P = K·lw) under the CLI's
    default camera; backproject's point files equal the JAX CLI's."""
    K = CameraConfig().matrix()
    depths, lws = sphere_scene((0.0, 0.5, 1.0), K=K.astype(np.float64),
                               h=1200, w=1600)
    data = tmp_path / "data"
    data.mkdir()
    for i, (d, lw) in enumerate(zip(depths, lws)):
        np.save(data / f"depth{i}.npy", d)
        np.savetxt(data / f"proj{i}.txt", K.astype(np.float64) @ lw)
    out_t, out_j = tmp_path / "t", tmp_path / "j"
    out_t.mkdir()
    out_j.mkdir()
    assert cli.main(["fusion-dm", "--data", str(data), "--res", "32",
                     "--auto-align", "--out-dir", str(out_t),
                     "--device", "cpu"]) == 0
    verts, faces = obj_parts(out_t / "test.obj")
    assert len(faces) > 100
    d = np.linalg.norm(verts - CENTER, axis=1)
    assert abs(np.median(d) - 0.6) < 0.1, np.median(d)

    assert cli.main(["backproject", "--data", str(data), "--out-dir",
                     str(out_t)]) == 0
    jcli.main(["backproject", "--data", str(data), "--out-dir", str(out_j)])
    for idx in range(2):
        name = f"transformed_pts{idx}.txt"
        assert (out_t / name).read_text() == (out_j / name).read_text()
        assert os.path.getsize(out_t / name) > 0
