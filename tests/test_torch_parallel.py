"""The port's sharding arguments and sharded fusion/solve
(dynamicfusion_body_tpu_torch.parallel) against the JAX package's.

* ``x_offset`` of fuse_depth, update_tsdf_rigid, brick_candidates(_2level),
  build_warp_cache and update_tsdf_nonrigid, in process against the JAX
  function at the same offset, and against the port's whole-volume call
  sliced to the slab; ``solve_rigid_core``'s reduce hook and the GN
  solve's psum hook with the sharded block-ELL at one rank;
* the sharded fuse / rigid update / non-rigid update / solve on 4 gloo
  ranks (``parallel/launch.py``) against JAX's on ``make_mesh(4)`` (the
  conftest's virtual devices), with ``tests/test_parallel.py``'s
  tolerances: volumes atol 1e-6 (fuse) and 1e-5 (rigid update), costs
  rtol 1e-5 (before) and 1e-3 (after), node DQs atol 5e-4. The non-rigid
  update's 1e-5 there holds JAX against JAX (one arithmetic); between the
  packages the blend sums its terms in another order, and on this
  scene's random live field (gradients up to ~2 a voxel) that moves a
  few samples by up to 1.25e-5 (measured: 5 of 16384 voxels), so the
  cross-package bound is ``UPD_ATOL``; the port's sharded update is held
  bit-equal to its one-device update.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dynamicfusion_body_tpu.models import tsdf_volume as JT
from dynamicfusion_body_tpu.models import warp_field as JW
from dynamicfusion_body_tpu.parallel import sharded as JS
from dynamicfusion_body_tpu.parallel.mesh import VOXEL_AXIS, make_mesh
from dynamicfusion_body_tpu.solvers import nonrigid as JN
from dynamicfusion_body_tpu.solvers.rigid import solve_rigid_core as j_rigid
from dynamicfusion_body_tpu_torch import convert
from dynamicfusion_body_tpu_torch.models import tsdf_volume as TT
from dynamicfusion_body_tpu_torch.models import warp_field as TW
from dynamicfusion_body_tpu_torch.parallel import launch, ranks
from dynamicfusion_body_tpu_torch.parallel.mesh import make_mesh as t_mesh
from dynamicfusion_body_tpu_torch.solvers import nonrigid as TN
from dynamicfusion_body_tpu_torch.solvers.rigid import (
    solve_rigid, solve_rigid_core)

# One intra-op thread here and in every rank (see
# tests/test_torch_marching_cubes.py)
torch.set_num_threads(1)

WF_FIELDS = ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
             "radius")
N_RANKS = 4
X0 = 16  # the slab origin of the in-process offset checks
UPD_ATOL = 2e-5  # non-rigid update, port against JAX (module docstring)


def T(a):
    return torch.from_numpy(np.array(a))


def wf_np(wf):
    return {f: np.asarray(getattr(wf, f)) for f in WF_FIELDS}


def fuse_scene(rng, res=32):
    """tests/test_parallel.py:25-37: a near-constant depth plane seen by a
    camera in front of a 0.02-scaled grid."""
    K = np.array([[200.0, 0, 32], [0, 200, 32], [0, 0, 1]], np.float32)
    ind = np.eye(4, dtype=np.float32)
    ind[0, 0] = ind[1, 1] = ind[2, 2] = 0.02
    ind[:3, 3] = [-0.3, -0.3, 4.5]
    proj = (K @ np.eye(4, dtype=np.float32)[:3] @ ind).astype(np.float32)
    kinv = np.linalg.inv(K).astype(np.float32)
    depth = -(4.5 + 0.01 * rng.rand(64, 64)).astype(np.float32)
    v0 = np.full((res,) * 3, 0.1, np.float32)
    w0 = np.zeros((res,) * 3, np.float32)
    return v0, w0, depth, proj, kinv


def nonrigid_scene(rng, res=32, k=3):
    """tests/test_parallel.py:47-56: 32 nodes from random points, perturbed
    DQs, random live and canonical volumes."""
    verts = (rng.rand(40, 3) * (res - 1)).astype(np.float32)
    wf = JW.construct_graph(jnp.array(verts), jnp.float32(3.0), 32)
    dqs = (rng.randn(32, 8) * 0.05).astype(np.float32)
    dqs[:, 0] += 1.0
    wf = wf.replace(node_dq=jnp.array(dqs))
    lw = np.array([1.0, 0, 0, 0, 0, 0.02, 0, 0], np.float32)
    live = rng.uniform(-1, 1, (res,) * 3).astype(np.float32)
    v0 = rng.uniform(-0.2, 0.3, (res,) * 3).astype(np.float32)
    w0 = (rng.rand(res, res, res) * 4).astype(np.float32)
    return wf, lw, live, v0, w0


def solve_scene(rng, n_verts=160, k=3):
    """tests/test_parallel.py:70-87: a sphere of vertices, constant-offset
    correspondences, reg pairs at weight 0.3."""
    verts = rng.randn(n_verts, 3).astype(np.float32)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    verts *= 2.0
    normals = (verts / 2.0).astype(np.float32)
    wf = JW.construct_graph(jnp.array(verts), jnp.float32(1.0), 16)
    nbr = np.asarray(JW.neighbor_lookup(wf, jnp.array(verts), k))
    npos = np.asarray(wf.node_pos)[nbr]
    nw = np.asarray(wf.node_w)[nbr]
    d = np.linalg.norm(verts[:, None, :] - npos, axis=-1)
    wts = np.exp(-((d / (2 * nw)) ** 2)).astype(np.float32)
    corrs = (verts + np.array([0.05, 0.02, -0.01], np.float32)).astype(
        np.float32)
    lw = np.array([1.0, 0, 0, 0, 0, 0, 0, 0], np.float32)
    pair_i, pair_j, pair_scale, pair_mask = JN.make_reg_pairs(
        wf.node_vert_idx, jnp.array(nbr), wf.node_w, wf.active,
        jnp.float32(0.3))
    pair_v = jnp.take(wf.node_pos, pair_j, axis=0)
    return dict(node_dq=np.asarray(wf.node_dq), verts=verts, normals=normals,
                corrs=corrs, corr_mask=np.ones(n_verts, bool), nbr_idx=nbr,
                blend_wts=wts, pair_i=np.asarray(pair_i),
                pair_j=np.asarray(pair_j), pair_v=np.asarray(pair_v),
                pair_scale=np.asarray(pair_scale),
                pair_mask=np.asarray(pair_mask), lw=lw)


SOLVE_KEYS = ("node_dq", "verts", "normals", "corrs", "corr_mask", "nbr_idx",
              "blend_wts", "pair_i", "pair_j", "pair_v", "pair_scale",
              "pair_mask", "lw")


# ---------------------------------------------------------------------------
# the sharding arguments, in process


def test_fuse_depth_x_offset(rng):
    v0, w0, depth, proj, kinv = fuse_scene(rng)
    slab = slice(X0, X0 + 8)
    jv, jw = JT.fuse_depth(jnp.asarray(v0[slab]), jnp.asarray(w0[slab]),
                           jnp.asarray(depth), jnp.asarray(proj),
                           jnp.asarray(kinv), 0.1, x_offset=X0)
    tv, tw = TT.fuse_depth(T(v0[slab]), T(w0[slab]), T(depth), T(proj),
                           T(kinv), 0.1, x_offset=X0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert int((tw > 0).sum()) > 0
    # the slab with its offset is the whole volume's call, sliced
    wv, ww = TT.fuse_depth(T(v0), T(w0), T(depth), T(proj), T(kinv), 0.1)
    assert torch.equal(tv, wv[slab]) and torch.equal(tw, ww[slab])


def test_update_tsdf_rigid_x_offset(rng):
    _, lw, live, v0, w0 = nonrigid_scene(rng)
    slab = slice(X0, X0 + 8)
    jv, jw = JT.update_tsdf_rigid(jnp.asarray(v0[slab]),
                                  jnp.asarray(w0[slab]), jnp.asarray(live),
                                  jnp.asarray(lw), 0.3, x_offset=X0)
    tv, tw = TT.update_tsdf_rigid(T(v0[slab]), T(w0[slab]), T(live), T(lw),
                                  0.3, x_offset=X0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    wv, ww = TT.update_tsdf_rigid(T(v0), T(w0), T(live), T(lw), 0.3)
    assert torch.equal(tv, wv[slab]) and torch.equal(tw, ww[slab])


@pytest.mark.parametrize("two_level", [False, True])
def test_candidates_and_cache_x_offset(rng, two_level):
    # the 2-level search needs a pool of n_super = 192 nodes
    pts = (rng.rand(600, 3) * 31).astype(np.float32)
    wf = JW.construct_graph(jnp.asarray(pts), jnp.float32(1.5), 256)
    twf = convert.warp_field_from_jax(wf_np(wf), device="cpu")
    shape, brick, C, k = (16, 32, 32), 4, 16, 3
    if two_level:
        jc, jpool = JW.brick_candidates_2level(wf, shape, brick, C,
                                               x_offset=X0, with_pool=True)
        tc, tpool = TW.brick_candidates_2level(twf, shape, brick, C,
                                               x_offset=X0, with_pool=True)
        np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool),
                                   rtol=1e-6)
        jcache = JW.build_warp_cache(wf, shape, jc, k, brick, x_offset=X0,
                                     pool_ctx=jpool)
        tcache = TW.build_warp_cache(twf, shape, tc, k, brick, x_offset=X0,
                                     pool_ctx=tpool)
        assert int(tcache[3]) == int(jcache[3])
    else:
        jc = JW.brick_candidates(wf, shape, brick, C, x_offset=X0)
        tc = TW.brick_candidates(twf, shape, brick, C, x_offset=X0)
        jcache = JW.build_warp_cache(wf, shape, jc, k, brick, x_offset=X0)
        tcache = TW.build_warp_cache(twf, shape, tc, k, brick, x_offset=X0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tcache[0].numpy(), np.asarray(jcache[0]))
    np.testing.assert_allclose(tcache[1].numpy(), np.asarray(jcache[1]),
                               atol=1e-6)
    np.testing.assert_allclose(tcache[2].numpy(), np.asarray(jcache[2]),
                               rtol=1e-6)
    # the candidates of the offset slab are the whole lattice's there
    whole = TW.brick_candidates(twf, (X0 + 16, 32, 32), brick, C)
    nbs = (32 // brick) ** 2
    if not two_level:
        assert torch.equal(tc, whole[X0 // brick * nbs:])


def test_update_tsdf_nonrigid_x_offset(rng):
    wf, lw, live, v0, w0 = nonrigid_scene(rng)
    twf = convert.warp_field_from_jax(wf_np(wf), device="cpu")
    slab = slice(X0, X0 + 16)
    jv, jw, _, jrisk = JW.update_tsdf_nonrigid(
        jnp.asarray(v0[slab]), jnp.asarray(w0[slab]), jnp.asarray(live), wf,
        jnp.asarray(lw), k=3, tdist=0.3, brick=4, n_candidates=16,
        x_offset=X0)
    tv, tw, _, trisk = TW.update_tsdf_nonrigid(
        T(v0[slab]), T(w0[slab]), T(live), twf, T(lw), k=3, tdist=0.3,
        brick=4, n_candidates=16, x_offset=X0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=UPD_ATOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=UPD_ATOL)
    assert int(trisk) == int(jrisk)
    # the slab with its offset is the whole volume's update, sliced
    wv, ww, _, _ = TW.update_tsdf_nonrigid(
        T(v0), T(w0), T(live), twf, T(lw), k=3, tdist=0.3, brick=4,
        n_candidates=16)
    assert torch.equal(tv, wv[slab]) and torch.equal(tw, ww[slab])
    # the kernels take no offset: asking for both raises
    with pytest.raises(ValueError, match="x_offset"):
        TW.update_tsdf_nonrigid(T(v0[slab]), T(w0[slab]), T(live), twf,
                                T(lw), k=3, tdist=0.3, brick=4,
                                n_candidates=16, x_offset=X0,
                                use_kernels=True)


def test_solve_rigid_core_reduce(rng):
    n = 200
    pts = rng.randn(n, 3).astype(np.float32)
    nrm = rng.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    corrs = (pts + 0.05 * rng.randn(n, 3)).astype(np.float32)
    mask = rng.rand(n) > 0.1
    lw = np.array([1, 0, 0, 0, 0, 0.1, 0, 0], np.float32)
    jx, jc = j_rigid(jnp.asarray(lw), jnp.asarray(pts), jnp.asarray(nrm),
                     jnp.asarray(corrs), jnp.asarray(mask), iterations=6)
    args = (T(lw), T(pts), T(nrm), T(corrs), T(mask))
    tx, tc = solve_rigid_core(*args, iterations=6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=5e-4)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-3)
    # the single-device entry is the core with the identity reduction
    sx, sc = solve_rigid(*args, iterations=6)
    assert torch.equal(sx, tx) and torch.equal(sc, tc)
    # a reduce that doubles every sum (two identical shards) keeps the pose
    dx, dc = solve_rigid_core(*args, iterations=6, reduce=lambda v: 2 * v)
    np.testing.assert_allclose(dx.numpy(), tx.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(dc), 2 * float(tc), rtol=1e-5)


def test_gn_psum_hook_and_sharded_ell_at_one_rank(rng, tmp_path):
    """At one rank the sharded block-ELL equals make_block_ell and the
    solve through it (psum = the identity all-reduce) equals the
    single-device solve."""
    s = solve_scene(rng)
    t = {k: T(s[k]) for k in SOLVE_KEYS}
    M = t["node_dq"].shape[0]
    data = (t["verts"], t["normals"], t["corrs"], t["corr_mask"],
            t["nbr_idx"], t["blend_wts"])
    reg = (t["pair_i"], t["pair_j"], t["pair_v"], t["pair_scale"],
           t["pair_mask"])
    want = TN.gn_solve_core(t["node_dq"], data, reg, t["lw"], 3, 12, 1e-4,
                            1e-5)
    ell = TN.make_ell_dict(t["nbr_idx"], t["corr_mask"], t["pair_i"],
                           t["pair_j"], t["pair_mask"], M, TN.ELL_DEGREE_CAP)
    mesh = t_mesh(1, str(tmp_path / "store"), "gloo")
    try:
        ctx = TN.SolverCtx(TN.make_block_ell_sharded(
            ell, t["nbr_idx"], t["corr_mask"], t["pair_i"], t["pair_j"],
            t["pair_mask"], M, mesh.psum, mesh.world))
        got = TN.gn_solve_core(t["node_dq"], data, reg, t["lw"], 3, 12, 1e-4,
                               1e-5, mesh.psum, solver_ctx=ctx)
    finally:
        mesh.close()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and the single-device solve agrees with the JAX package's
    jx, _, jc0, jc1, _, _ = JN.solve_nonrigid(
        *(jnp.asarray(s[k]) for k in SOLVE_KEYS), gn_iters=3, cg_iters=12,
        use_ell=True)
    np.testing.assert_allclose(float(want[2]), float(jc0), rtol=1e-5)
    np.testing.assert_allclose(float(want[3]), float(jc1), rtol=1e-3)
    np.testing.assert_allclose(want[0].numpy(), np.asarray(jx), atol=5e-4)


# ---------------------------------------------------------------------------
# 4 gloo ranks against JAX's make_mesh(4)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(N_RANKS)


def _vol_put(mesh, arr):
    return jax.device_put(jnp.asarray(arr),
                          NamedSharding(mesh, P(VOXEL_AXIS, None, None)))


def test_fuse_depth_sharded_4_ranks(rng, mesh4):
    v0, w0, depth, proj, kinv = fuse_scene(rng)
    jv, jw = JS.fuse_depth_sharded(mesh4, 0.1)(
        _vol_put(mesh4, v0), _vol_put(mesh4, w0), jnp.asarray(depth),
        jnp.asarray(proj), jnp.asarray(kinv))
    tv, tw = launch.run(ranks.fuse_depth, N_RANKS,
                        (v0, w0, depth, proj, kinv, 0.1), backend="gloo")
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(tw, np.asarray(jw), atol=1e-6)
    assert int((tw > 0).sum()) > 0


def test_update_tsdf_rigid_sharded_4_ranks(rng, mesh4):
    _, lw, live, v0, w0 = nonrigid_scene(rng)
    jv, jw = JS.update_tsdf_rigid_sharded(mesh4, 0.3)(
        _vol_put(mesh4, v0), _vol_put(mesh4, w0), jnp.asarray(live),
        jnp.asarray(lw))
    tv, tw = launch.run(ranks.update_tsdf_rigid, N_RANKS,
                        (v0, w0, live, lw, 0.3), backend="gloo")
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tw, np.asarray(jw), atol=1e-5)


def test_update_nonrigid_sharded_4_ranks(rng, mesh4):
    wf, lw, live, v0, w0 = nonrigid_scene(rng)
    jv, jw, _, jrisk = JS.update_tsdf_nonrigid_sharded(
        mesh4, k=3, tdist=0.3, brick=4, n_candidates=16)(
        _vol_put(mesh4, v0), _vol_put(mesh4, w0), jnp.asarray(live), wf,
        jnp.asarray(lw))
    tv, tw, esc, trisk = launch.run(
        ranks.update_tsdf_nonrigid, N_RANKS,
        (v0, w0, live, wf_np(wf), lw, 3, 0.3, 100.0, 4, 16), backend="gloo")
    np.testing.assert_allclose(tv, np.asarray(jv), atol=UPD_ATOL)
    np.testing.assert_allclose(tw, np.asarray(jw), atol=UPD_ATOL)
    assert int(trisk) == int(jrisk) and int(esc) == 0
    twf = convert.warp_field_from_jax(wf_np(wf), device="cpu")
    ov, ow, _, orisk = TW.update_tsdf_nonrigid(
        T(v0), T(w0), T(live), twf, T(lw), k=3, tdist=0.3, brick=4,
        n_candidates=16)
    np.testing.assert_array_equal(tv, ov.numpy())
    np.testing.assert_array_equal(tw, ow.numpy())


def test_solve_nonrigid_sharded_4_ranks(rng, mesh4):
    s = solve_scene(rng)
    vs = NamedSharding(mesh4, P(VOXEL_AXIS))
    sharded_keys = ("verts", "normals", "corrs", "corr_mask", "nbr_idx",
                    "blend_wts")
    jargs = [jax.device_put(jnp.asarray(s[k]), vs) if k in sharded_keys
             else jnp.asarray(s[k]) for k in SOLVE_KEYS]
    jx, jc0_raw, jc0, jc1, _, _ = JS.solve_nonrigid_sharded(
        mesh4, gn_iters=3, cg_iters=12)(*jargs)
    tx, tc0_raw, tc0, tc1, _, tov = launch.run(
        ranks.solve_nonrigid, N_RANKS,
        tuple(s[k] for k in SOLVE_KEYS) + (3, 12), backend="gloo")
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-5)
    np.testing.assert_allclose(float(tc0_raw), float(jc0_raw), rtol=1e-5)
    np.testing.assert_allclose(float(tc1), float(jc1), rtol=1e-3)
    np.testing.assert_allclose(tx, np.asarray(jx), atol=5e-4)
    assert int(tov) == 0
