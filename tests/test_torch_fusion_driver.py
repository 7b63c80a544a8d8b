"""Parity of the port's non-rigid ``Fusion`` driver
(dynamicfusion_body_tpu_torch.pipeline.fusion.Fusion) with the JAX
package's, on ``device="cpu"`` (the kernels' twins stand in for K1/K2):

* the dummy flow of tests/test_pipeline.py (test.py's TEST_FUSION_DUMMY):
  construction, correspondences, solve, updateTSDF with a padded canonical
  and an unpadded live volume, update_graph and the written checkpoint;
* the queries and writers (warp, dq_blend, write_live_frame_mesh).
tests/test_torch_config7.py holds a two-frame bend of the reference mesh.

Stages that follow a solve start both drivers from JAX's state
(``convert.load_fusion_state``), so each comparison holds one stage.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu import Fusion as JFusion
from dynamicfusion_body_tpu.io.warpfield_io import (
    load_warp_field_nodes as j_load_nodes)
from dynamicfusion_body_tpu_torch import Fusion as TFusion
from dynamicfusion_body_tpu_torch import convert
from fixtures import ellipsoid_levelset

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)

WF_FIELDS = ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
             "radius")


def jax_state(jf):
    """A JAX Fusion's state as numpy arrays, for convert.load_fusion_state."""
    return dict(
        values=np.asarray(jf.volume.values),
        weights=np.asarray(jf.volume.weights),
        warp={f: np.asarray(getattr(jf._warp, f)) for f in WF_FIELDS},
        lw=np.asarray(jf._lw),
        mesh={k: np.asarray(v) for k, v in jf._mesh.items()},
        nbr_idx=np.asarray(jf._nbr_idx),
        blend_wts=np.asarray(jf._blend_wts),
    )


def dummy_pair(tmp_path, **kw):
    """Both drivers on the dummy flow's ellipsoid (14, 23, 35): a canonical
    lattice that the update pads to (16, 24, 40)."""
    vol = ellipsoid_levelset(6, 10, 16)[:-1]
    args = dict(marching_cubes_step_size=1, subsample_rate=2, knn=4,
                vert_cap=4096, face_cap=8192, node_cap=128, **kw)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jf = JFusion(vol, float(vol.max()), warpfield_path=str(jdir), **args)
    tf = TFusion(vol, float(vol.max()), warpfield_path=str(tdir),
                 device="cpu", **args)
    return vol, jf, tf, jdir, tdir


def test_dummy_flow_matches_jax(tmp_path):
    vol, jf, tf, jdir, tdir = dummy_pair(tmp_path)
    vol2 = ellipsoid_levelset(6, 10, 16, offset=(0.8, 0.5, 0.0))[:-1]
    assert vol.shape == (14, 23, 35)

    # construction: the canonical mesh, the graph and its neighbour table
    # are computed by the same algorithms from the same volume (MC is
    # bit-identical; the sampling radius within f32 ulps)
    assert int(tf._warp.num_active) == int(jf._warp.num_active) > 3
    np.testing.assert_allclose(tf._radius, jf._radius, rtol=1e-6)
    np.testing.assert_array_equal(tf._warp.active.numpy(),
                                  np.asarray(jf._warp.active))
    np.testing.assert_allclose(tf._warp.node_pos.numpy(),
                               np.asarray(jf._warp.node_pos), atol=1e-5)
    np.testing.assert_array_equal(tf._nbr_idx.numpy(),
                                  np.asarray(jf._nbr_idx))
    np.testing.assert_allclose(tf._blend_wts.numpy(),
                               np.asarray(jf._blend_wts), rtol=1e-5,
                               atol=1e-7)

    # correspondences: the same valid mask
    jf.setupCorrespondences(vol2, method="clpts", tolerance=2.0)
    tf.setupCorrespondences(vol2, method="clpts", tolerance=2.0)
    nv = int(jf._mesh["n_verts"])
    jvalid = np.asarray(jf._corr_valid)
    np.testing.assert_array_equal(tf._corr_valid.numpy(), jvalid)
    assert jvalid[:nv].mean() > 0.5
    # the picked live vertex: the kNN distances are f32 sums in another
    # order, so a near-tie between two live vertices may flip (measured 7
    # of 1,918 rows, one lattice step apart)
    dc = np.abs(tf._correspondences.numpy()
                - np.asarray(jf._correspondences))[jvalid].max(axis=1)
    assert np.mean(dc <= 1e-4) > 0.99 and dc.max() <= 1.0 + 1e-4

    # solve: rigid presolve, clpts refreshes, 3 relaxation rounds (at half
    # the default GN/CG depth, to keep the file near a minute). The solvers
    # take the same steps in f32 with sums in other orders, and every
    # round's refresh may flip the near-tie picks above; the rigid
    # presolve's free 8-dof DQ amplifies that noise (ROADMAP Queue 3,
    # "Rigid presolve gauge": 2.5e-3 after an update_graph frame). Measured
    # here: node DQs 4.2e-4 apart; held to 2e-3
    kw = dict(method="clpts", regularization_weight=10.0, gn_iters=4,
              cg_iters=16)
    jf.solve(**kw)
    tf.solve(tukey_data_weight=1, **kw)
    assert tf._itercounter == jf._itercounter == 1
    np.testing.assert_allclose(tf._lw.numpy(), np.asarray(jf._lw), atol=2e-3)
    np.testing.assert_allclose(tf._warp.node_dq.numpy(),
                               np.asarray(jf._warp.node_dq), atol=2e-3)

    # updateTSDF from JAX's solved state: the padded canonical, the
    # unpadded live volume and the update's caches
    convert.load_fusion_state(tf, jax_state(jf))
    jf.updateTSDF()
    tf.updateTSDF(vol2)
    assert tuple(tf.volume.values.shape) == vol.shape
    # tests/test_torch_tsdf_update.py's bound
    np.testing.assert_allclose(tf.volume.values.numpy(),
                               np.asarray(jf.volume.values), atol=3e-3)
    np.testing.assert_allclose(tf.volume.weights.numpy(),
                               np.asarray(jf.volume.weights), atol=3e-3)
    assert float(tf.volume.weights.max()) > 0

    # update_graph from JAX's fused state: the same nodes inserted, the
    # checkpoint written with the reference's name
    convert.load_fusion_state(tf, jax_state(jf))
    with pytest.warns(RuntimeWarning, match="node pool saturated"):
        jf.update_graph()
    with pytest.warns(RuntimeWarning, match="node pool saturated"):
        tf.update_graph()
    assert int(tf._warp.num_active) == int(jf._warp.num_active)
    np.testing.assert_allclose(tf._warp.node_pos.numpy(),
                               np.asarray(jf._warp.node_pos), atol=1e-5)
    assert tf._curr_tsdf is None and tf._correspondences is None
    assert os.listdir(tdir) == os.listdir(jdir) == ["test__1.p"]
    tp, tdq, tw, tv = j_load_nodes(tdir / "test__1.p")
    jp, jdq, jw, jv = j_load_nodes(jdir / "test__1.p")
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    np.testing.assert_allclose(tdq, jdq, atol=1e-5)
    np.testing.assert_allclose(tw, jw, rtol=1e-6)

    tf.write_canonical_mesh(str(tdir), "mesh.obj")
    assert open(tdir / "mesh.obj").read().count("\nf ") > 10


def test_queries_and_live_mesh_match_jax(tmp_path):
    _, jf, tf, jdir, tdir = dummy_pair(tmp_path, write_warpfield=False)
    rng = np.random.RandomState(3)
    dqs = (rng.randn(128, 8) * 0.05).astype(np.float32)
    dqs[:, 0] += 1.0
    jf._warp = jf._warp.replace(node_dq=jnp.asarray(dqs))
    convert.load_fusion_state(tf, jax_state(jf))
    pts = (rng.rand(50, 3) * [14, 23, 35]).astype(np.float32)
    nrm = rng.randn(50, 3).astype(np.float32)
    lw = np.asarray(jf._lw)
    got_p, got_n = tf.warp(pts, normal=nrm, m_lw=lw)
    want_p, want_n = jf.warp(pts, normal=nrm, m_lw=jnp.asarray(lw))
    np.testing.assert_allclose(got_p, want_p, atol=1e-5)
    np.testing.assert_allclose(got_n, want_n, atol=1e-5)
    np.testing.assert_allclose(tf.warp(pts[0]), jf.warp(pts[0]), atol=1e-5)
    np.testing.assert_allclose(tf.dq_blend(pts), jf.dq_blend(pts), atol=1e-6)

    # the live mesh from one checkpoint, written by JAX and read by both
    ck = jf.write_warp_field(str(jdir), "wf") or str(jdir / "wf__0.p")
    jf.write_live_frame_mesh(str(jdir), "live.obj", ck)
    tf.write_live_frame_mesh(str(tdir), "live.obj", ck)

    def verts(path):
        return np.array([[float(x) for x in ln.split()[1:4]]
                         for ln in open(path) if ln.startswith("v ")])

    jv, tv = verts(jdir / "live.obj"), verts(tdir / "live.obj")
    assert len(jv) == len(tv) > 100
    np.testing.assert_allclose(tv, jv, atol=1e-4)  # printed with %f
    assert tf.average_edge_dist_in_face([0, 1, 2]) == pytest.approx(
        jf.average_edge_dist_in_face([0, 1, 2]), rel=1e-6)


def test_cnn_correspondences_raise():
    """Nothing raises for the CNN path any more: ``use_cnn=True`` builds
    the learned correspondences on the driver's device, and
    ``method="cnn"`` on a driver built without them takes the closest
    points, as the JAX driver does (its ``self._cnn is None`` branch)."""
    vol = ellipsoid_levelset(5, 7, 9)[:-1]
    kw = dict(marching_cubes_step_size=1, subsample_rate=2, vert_cap=2048,
              face_cap=4096, node_cap=64, write_warpfield=False,
              device="cpu")
    cnn = TFusion(vol, float(vol.max()), use_cnn=True, cnn_image_size=32,
                  **kw)
    assert cnn._cnn is not None and cnn._cnn.device.type == "cpu"
    assert cnn._cnn.image_size == 32 and cnn._cnn.normalize_input
    tf = TFusion(vol, float(vol.max()), **kw)
    assert tf._cnn is None
    want = tf.setupCorrespondences(vol, method="clpts")
    got = tf.setupCorrespondences(vol, method="cnn")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
