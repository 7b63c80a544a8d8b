"""Parity of the port's CNN correspondence path
(dynamicfusion_body_tpu_torch.pipeline.cnn_correspondence and
``Fusion(use_cnn=True)``) with the JAX package's, on the CPU, with the
Flax parameters carried across by ``convert.dhbc_state_from_flax``:

* ``view_mvps`` and the masked ``regularize_verts``;
* the descriptors' network and scatter on JAX's own renders (both fed the
  same ID and depth8 images), then the whole ``_descriptors`` at 64² with
  6 views, where the two rasterizers' window depths may differ by a few
  ulps and so flip a depth8 ``floor`` by one on a few pixels;
* ``match`` on the asymmetric tube of tests/test_dhbc.py: the identical-
  mesh self-match, and agreement with JAX's match against a deformed tube;
* one ``Fusion(use_cnn=True)`` frame (setupCorrespondences(method="cnn")
  → solve(method="cnn") → updateTSDF) against JAX's ``Fusion`` on a 32³-
  bounded ellipsoid, each stage from JAX's state
  (``convert.load_fusion_state``), the CNN shrunk to 64² and 6 views in
  both packages alike.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamicfusion_body_tpu import Fusion as JFusion
from dynamicfusion_body_tpu.models.dhbc import init_dhbc as j_init_dhbc
from dynamicfusion_body_tpu.ops.marching_cubes import (
    marching_cubes as j_marching_cubes)
from dynamicfusion_body_tpu.pipeline import cnn_correspondence as jc
from dynamicfusion_body_tpu.render.raster import render_id as j_render_id
from dynamicfusion_body_tpu_torch import Fusion as TFusion
from dynamicfusion_body_tpu_torch import convert
from dynamicfusion_body_tpu_torch.models.dhbc import init_dhbc
from dynamicfusion_body_tpu_torch.pipeline import cnn_correspondence as tc
from fixtures import ellipsoid_levelset

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)

SIZE, N_VIEWS = 64, 6
ZNEAR, ZFAR = 1.0, 3.5
# descriptors on the same renders: relative to the largest magnitude
DESC_RTOL = 1e-4
# the whole _descriptors (each package's own renders): the share of valid
# vertices whose descriptors may differ by more than DESC_RTOL
DESC_SHARE = 0.05
# matched live vertices equal to JAX's on at least this share
MATCH_SHARE = 0.99


def carried_params(jp):
    flat = flax.traverse_util.flatten_dict(jp, sep="/")
    return convert.dhbc_state_from_flax(
        {k: np.asarray(v) for k, v in flat.items()}, device="cpu")


def blob_mesh(res=32):
    """The asymmetric blob of tests/test_dhbc.py, by JAX's MC."""
    g = np.arange(res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (res - 1) / 2
    dx, dy, dz = x - c, y - c, z - c
    r = np.sqrt(dx * dx + dy * dy + dz * dz) + 1e-6
    th = np.arccos(np.clip(dz / r, -1, 1))
    ph = np.arctan2(dy, dx)
    bump = (res / 32) * np.sin(3 * th + 0.5) * np.cos(2 * ph) + (
        res / 48) * np.sin(5 * ph + 1.3)
    sdf = (r - (0.3 * res + bump)).astype(np.float32)
    m = j_marching_cubes(jnp.asarray(sdf), vert_cap=1 << 12,
                         face_cap=1 << 13)
    return {k: np.asarray(v) for k, v in m.items()}


def tube(deform=0.0):
    """tests/test_dhbc.py's asymmetric tube (24 vertices, slots to 32),
    its second ring shifted by ``deform``."""
    t = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    r1 = 0.4 + 0.12 * np.cos(3 * t) + 0.07 * np.sin(t)
    r2 = 0.35 + 0.1 * np.sin(2 * t)
    ring1 = np.stack([r1 * np.cos(t), -0.4 + 0.05 * np.sin(2 * t),
                      r1 * np.sin(t)], 1)
    ring2 = np.stack([r2 * np.cos(t) + deform, 0.4 + 0.06 * np.cos(t),
                      r2 * np.sin(t)], 1)
    verts = np.concatenate([ring1, ring2]).astype(np.float32)
    faces = []
    for i in range(12):
        j = (i + 1) % 12
        faces.append([i, j, 12 + i])
        faces.append([j, 12 + j, 12 + i])
    v = np.zeros((32, 3), np.float32)
    v[:24] = verts
    f = np.zeros((32, 3), np.int32)
    f[:24] = faces
    return v, f, 24


def test_view_mvps_and_regularize_match_jax():
    for n in (24, 6):
        np.testing.assert_array_equal(tc.view_mvps(n), jc.view_mvps(n))
    rng = np.random.RandomState(1)
    v = (rng.randn(40, 3) * [2.0, 5.0, 1.0] + 3.0).astype(np.float32)
    v[30:] = 99.0  # masked slots never count
    mask = np.arange(40) < 30
    for flip in (False, True):
        want = np.asarray(jc.regularize_verts(jnp.asarray(v),
                                              jnp.asarray(mask), flip))
        got = tc.regularize_verts(torch.from_numpy(v),
                                  torch.from_numpy(mask), flip).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[30:], 0.0)
    span = got[:30, 1].max() - got[:30, 1].min()
    assert abs(span - 1.8) < 1e-5


def jax_renders(reg, faces, fmask, mvps, S):
    """JAX's ID and depth8 renders, view by view (JAX _descriptors's
    render_one)."""
    b = ZFAR * ZNEAR / (ZNEAR - ZFAR)
    a = -b / ZNEAR

    @jax.jit
    def one(mvp):
        ids, zwin = j_render_id(reg, faces, fmask, mvp, SIZE, SIZE, S=S)
        return ids, jnp.floor(jnp.clip(
            (ZFAR - b / (zwin - a)) / (ZFAR - ZNEAR) * 255.0, 0, 255))

    out = [one(m) for m in mvps]
    return (np.stack([np.asarray(o[0]) for o in out]),
            np.stack([np.asarray(o[1]) for o in out]))


def test_descriptors_match_jax():
    m = blob_mesh()
    nv, nf = int(m["n_verts"]), int(m["n_faces"])
    cap = m["verts"].shape[0]
    vmask = np.arange(cap) < nv
    fmask = np.arange(m["faces"].shape[0]) < nf
    mvps = jc.view_mvps(N_VIEWS)
    jm, jp = j_init_dhbc(0, SIZE, SIZE)
    tm, _ = init_dhbc(0, device="cpu")
    tp = carried_params(jp)

    # the network and the scatter on JAX's renders; view_batch 4 does not
    # divide 6 views: singles, as in JAX
    reg = jc.regularize_verts(jnp.asarray(m["verts"]), jnp.asarray(vmask))
    ids, depth8 = jax_renders(reg, jnp.asarray(m["faces"]),
                              jnp.asarray(fmask), jnp.asarray(mvps), S=4)
    jfeats = np.asarray(jm.apply(jp, jnp.asarray(depth8[..., None])))
    seg = np.where(ids > 0, ids - 1, cap).reshape(-1)
    wsum = np.asarray(jax.ops.segment_sum(
        jnp.asarray(jfeats.reshape(-1, 16)), jnp.asarray(seg),
        num_segments=cap + 1))[:cap]
    wcnt = np.bincount(seg, minlength=cap + 1)[:cap].astype(np.float32)
    want = wsum / np.maximum(wcnt, 1.0)[:, None]
    for vb in (6, 4):
        feats = tc.network(tm, tp, torch.from_numpy(depth8), vb)
        np.testing.assert_allclose(
            feats.numpy(), jfeats, rtol=0,
            atol=DESC_RTOL * np.abs(jfeats).max())
    got, cnt = tc.scatter(torch.from_numpy(ids), feats, cap)
    np.testing.assert_array_equal(cnt.numpy(), wcnt)
    assert (wcnt[:nv] > 0).mean() > 0.9
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=DESC_RTOL * np.abs(want).max())

    # the whole pipeline, each package rendering for itself
    args = (m["verts"], m["faces"], fmask, vmask)
    jd, jcnt = jc._descriptors(
        jp, *(jnp.asarray(a) for a in args), jnp.asarray(mvps), ZNEAR, ZFAR,
        h=SIZE, w=SIZE, S=4, view_batch=2)
    td, tcnt = tc._descriptors(
        tm, tp, *(torch.from_numpy(a) for a in args),
        torch.from_numpy(mvps), ZNEAR, ZFAR, h=SIZE, w=SIZE, S=4,
        view_batch=2)
    jd, jcnt = np.asarray(jd)[:nv], np.asarray(jcnt)[:nv]
    err = np.abs(td.numpy()[:nv] - jd).max(axis=1)
    off = err > DESC_RTOL * np.abs(jd).max()
    assert off.mean() <= DESC_SHARE, off.mean()
    assert np.mean(tcnt.numpy()[:nv] == jcnt) >= 1 - DESC_SHARE


def test_match_self_and_against_jax():
    """The identical-mesh self-match is exact (JAX's test), and a match
    against a deformed tube picks JAX's live vertices."""
    v, f, n = tube()
    vmask = np.arange(32) < n
    t = torch.from_numpy
    mesh = {"verts": t(v), "faces": t(f).long(), "n_verts": torch.tensor(n),
            "n_faces": torch.tensor(24)}
    cnn = tc.CnnCorrespondence(image_size=128, device="cpu")
    jcnn = jc.CnnCorrespondence(image_size=128)
    cnn.params = carried_params(jcnn.params)
    corr, valid = cnn.match(mesh, mesh, t(vmask), t(vmask))
    corr, seen = corr.numpy()[:n], valid.numpy()[:n]
    assert seen.sum() >= 20
    d = np.linalg.norm(corr[seen] - v[:n][seen], axis=1)
    assert np.median(d) < 1e-5

    lv, _, _ = tube(deform=0.15)
    live = dict(mesh, verts=t(lv))
    jmesh = {k: jnp.asarray(np.asarray(x)) for k, x in mesh.items()}
    jlive = dict(jmesh, verts=jnp.asarray(lv))
    got_c, got_v = cnn.match(mesh, live, t(vmask), t(vmask))
    want_c, want_v = jcnn.match(jmesh, jlive, jnp.asarray(vmask),
                                jnp.asarray(vmask))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    same = np.all(np.abs(got_c.numpy() - np.asarray(want_c)) < 1e-6, axis=1)
    assert same[:n].mean() >= MATCH_SHARE


def jax_state(jf):
    fields = ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
              "radius")
    return dict(
        values=np.asarray(jf.volume.values),
        weights=np.asarray(jf.volume.weights),
        warp={f: np.asarray(getattr(jf._warp, f)) for f in fields},
        lw=np.asarray(jf._lw),
        mesh={k: np.asarray(v) for k, v in jf._mesh.items()},
        nbr_idx=np.asarray(jf._nbr_idx),
        blend_wts=np.asarray(jf._blend_wts),
    )


def test_fusion_cnn_frame_matches_jax(tmp_path):
    vol = ellipsoid_levelset(6, 10, 14)[:-1]               # (14, 23, 31)
    vol2 = ellipsoid_levelset(6, 10, 14, offset=(0.6, 0.4, 0.0))[:-1]
    kw = dict(marching_cubes_step_size=1, subsample_rate=2, knn=4,
              vert_cap=4096, face_cap=8192, node_cap=128, use_cnn=True,
              cnn_image_size=SIZE, write_warpfield=False)
    jf = JFusion(vol, float(vol.max()), **kw)
    tf = TFusion(vol, float(vol.max()), device="cpu", **kw)
    assert tf._cnn is not None and tf._cnn.normalize_input
    mvps = jc.view_mvps(N_VIEWS)
    jf._cnn.mvps = jnp.asarray(mvps)
    tf._cnn.mvps = torch.from_numpy(mvps)
    tf._cnn.params = carried_params(jf._cnn.params)
    convert.load_fusion_state(tf, jax_state(jf))

    # CNN correspondences with the plane-cost prune on the warped mesh
    jf.setupCorrespondences(vol2, method="cnn", tolerance=2.0)
    tf.setupCorrespondences(vol2, method="cnn", tolerance=2.0)
    nv = int(jf._mesh["n_verts"])
    jvalid = np.asarray(jf._corr_valid)[:nv]
    tvalid = tf._corr_valid.numpy()[:nv]
    assert 0.2 < jvalid.mean() < 1.0  # the prune acts, matches survive
    assert np.mean(tvalid == jvalid) >= MATCH_SHARE
    both = jvalid & tvalid
    same = np.all(np.abs(tf._correspondences.numpy()[:nv]
                         - np.asarray(jf._correspondences)[:nv]) < 1e-4, 1)
    assert same[both].mean() >= MATCH_SHARE

    # solve(method="cnn"): the rigid presolve and ONE relaxation round (no
    # refresh), from JAX's correspondences. Measured 4.2e-6 apart (node
    # DQs); held to 1e-4
    tf._correspondences = torch.from_numpy(np.asarray(jf._correspondences))
    tf._corr_valid = torch.from_numpy(np.asarray(jf._corr_valid))
    skw = dict(method="cnn", regularization_weight=10.0, gn_iters=4,
               cg_iters=16)
    jf.solve(**skw)
    tf.solve(**skw)
    np.testing.assert_allclose(tf._lw.numpy(), np.asarray(jf._lw), atol=1e-4)
    np.testing.assert_allclose(tf._warp.node_dq.numpy(),
                               np.asarray(jf._warp.node_dq), atol=1e-4)

    # updateTSDF from JAX's solved state
    convert.load_fusion_state(tf, jax_state(jf))
    jf.updateTSDF()
    tf.updateTSDF()
    np.testing.assert_allclose(tf.volume.values.numpy(),
                               np.asarray(jf.volume.values), atol=3e-3)
    np.testing.assert_allclose(tf.volume.weights.numpy(),
                               np.asarray(jf.volume.weights), atol=3e-3)
    assert torch.isfinite(tf.volume.values).all()
