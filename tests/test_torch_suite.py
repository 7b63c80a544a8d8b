"""The port's benchmark suite (dynamicfusion_body_tpu_torch.benchmarks.
suite) and its two diagnosis tools against the repository's
benchmarks/suite.py on the CPU, in small: the body mesh against JAX's,
configs 1 and 2 print the JAX suite's metric names, config 3's live
volumes and recovered rotation errors against the JAX suite's code path
(suite.py:144-190) on the same renders at 32³ (128² views, two angles,
mesh caps cut to the 32³ surfaces), and diag_gate and diag_config7 run
one arm each at 32³."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

from dynamicfusion_body_tpu.ops.interp import trilinear as j_trilinear
from dynamicfusion_body_tpu.ops.marching_cubes import marching_cubes as j_mc
from dynamicfusion_body_tpu.ops.se3 import dq_to_se3 as j_dq_to_se3
from dynamicfusion_body_tpu.ops.transforms import rotation_matrix as j_rot
from dynamicfusion_body_tpu.pipeline.fusion import FusionDM as JFusionDM
from dynamicfusion_body_tpu_torch.benchmarks import suite
from dynamicfusion_body_tpu_torch.tools import diag_config7, diag_gate
from dynamicfusion_body_tpu_torch.tools._scene import bumpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
from suite import _body_mesh as j_body_mesh  # noqa: E402
from suite import _render_views as j_render_views  # noqa: E402

# One intra-op thread (see tests/test_torch_frame.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
RES, IMG = 32, 128
# config 3 at 32³: the fused live surface reaches ~5,000 vertices
ICP_CAPS = (1 << 13, 1 << 14)
ICP_ANGLES = (0.02, 0.06)
# the live volumes: the same trilinear resampling of canonical volumes
# fused in another f32 order (measured 6.2e-6 of the 0.05 truncation)
LIVE_ATOL = 1e-4
# the recovered rotations: 3 rounds of 12-step rigid GN whose sums run in
# another f32 order (measured 4e-4 degrees apart)
ROT_ATOL_DEG = 5e-3


def test_body_mesh_matches_jax():
    verts, faces = suite._body_mesh(CPU, res=64)
    j_verts, j_faces = j_body_mesh(res=64)
    np.testing.assert_array_equal(faces, j_faces)
    np.testing.assert_allclose(verts, j_verts, atol=1e-6)


def test_configs_1_2_metric_names(capsys):
    c1 = suite.config1(CPU, res=(16, RES), img=IMG)
    c2 = suite.config2(CPU, res=RES)
    names = [line["metric"] for line in c1 + c2]
    assert names == ["config1_rigid_fusion_64", "config1_rigid_fusion_256",
                     "config2_marching_cubes_256"]
    assert [line["res"] for line in c1 + c2] == [16, RES, RES]
    for line in c1 + c2:
        assert np.isfinite(line["value"]) and line["value"] > 0
        assert line["unit"] == "ms"
    want = j_mc(jnp.asarray(bumpy(RES, (128, 128, 128), 0.0)),
                vert_cap=1 << 17, face_cap=1 << 18)
    assert c2[0]["n_verts"] == int(want["n_verts"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 3 and all(n in p for n, p in zip(names, printed))


def j_rigid_icp(depths, lws, K, res, caps, angles):
    """suite.py:155-189 with the lattice, caps and angles as arguments."""
    fus = JFusionDM(0.05, K, tsdf_res=res, vert_cap=caps[0],
                    face_cap=caps[1])
    fus.compute_live_tsdf(depths, lws, UseAutoAlignment=True)
    fus.marching_cubes()
    errs, lives = [], []
    for ang in angles:
        Rg = j_rot(ang, [0, 1, 0], point=[res / 2] * 3)
        g = np.arange(res, dtype=np.float32)
        x, y, z = np.meshgrid(g, g, g, indexing="ij")
        pts = np.stack([x, y, z], -1).reshape(-1, 3)
        inv = np.linalg.inv(Rg)
        pts_t = pts @ inv[:3, :3].T + inv[:3, 3]
        vals, ok = j_trilinear(fus.volume.values, jnp.asarray(pts_t))
        lv = jnp.where(ok, vals, 0.05).reshape(res, res, res)
        fus._lw = jnp.array([1, 0, 0, 0, 0, 0, 0, 0], jnp.float32)
        fus.solve(lv)
        est = np.asarray(j_dq_to_se3(fus._lw))
        cosang = (np.trace(est[:3, :3] @ Rg[:3, :3].T) - 1) / 2
        errs.append(abs(np.degrees(np.arccos(np.clip(cosang, -1, 1)))))
        lives.append(np.asarray(lv))
    return errs, lives


def test_config3_matches_jax():
    """Both packages track the same JAX renders of the body: equal live
    volumes and rotation errors within the stated tolerances."""
    K = suite.camera(IMG)
    verts, faces = j_body_mesh()
    depths, lws = j_render_views(verts, faces, K, n_views=8, h=IMG, w=IMG)
    j_errs, j_lives = j_rigid_icp(depths, lws, K, RES, ICP_CAPS, ICP_ANGLES)
    times, errs, lives = suite.rigid_icp(depths, lws, K, CPU, RES, ICP_CAPS,
                                         ICP_ANGLES)
    assert len(times) == len(ICP_ANGLES) and min(times) > 0
    for lv, jlv in zip(lives, j_lives):
        np.testing.assert_allclose(lv.numpy(), jlv, atol=LIVE_ATOL)
    np.testing.assert_allclose(errs, j_errs, atol=ROT_ATOL_DEG)
    assert max(errs) < np.degrees(max(ICP_ANGLES))  # it tracked


def test_diag_gate_one_arm(capsys):
    """The arm of the JAX tool's correspondence mode (cached candidates);
    every arm runs, none is reported as not run."""
    res = diag_gate.main(["--res", str(RES), "--device", "cpu", "--arm",
                          "fast+reuse_corr"])
    assert list(res) == ["fast+reuse_corr"]
    r = res["fast+reuse_corr"]
    assert r["ncorr"] > 0
    assert all(np.isfinite(r[k]) and r[k] >= 0
               for k in ("in_frame", "huber", "raw"))
    assert r["corr_risk"] >= 0 and 0 <= r["corr_refresh"] <= 2
    out = capsys.readouterr().out
    assert "not run" not in out
    assert "common-obj huber" in out and "corr_refresh" in out


def test_diag_config7_one_arm():
    """One arm of config 7 at 32³: one bend frame at a shallow solve
    (128² views, gn 2, cg 8, one round)."""
    verts, faces = suite.reference_mesh()
    arm = diag_config7.run_arm(CPU, RES, verts, faces, label="small",
                               img=IMG, angles=(0.08,), gn_iters=2,
                               cg_iters=8, solve_iters=1)
    assert arm["label"] == "small" and arm["res"] == RES
    assert arm["mc_step"] == 2 and arm["live_mc_step"] == 1  # the suite's
    assert len(arm["per_frame_voxels"]) == 1
    assert 0 < arm["final_voxels"] < arm["untracked_voxels"]
