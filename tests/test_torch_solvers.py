"""Parity of the port's rigid and non-rigid solvers with the JAX package
on the tests/test_solvers.py fixtures."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu import ops as J
from dynamicfusion_body_tpu.solvers import nonrigid as JN
from dynamicfusion_body_tpu.solvers import rigid as JR
from dynamicfusion_body_tpu_torch.solvers import nonrigid as TN
from dynamicfusion_body_tpu_torch.solvers import rigid as TR
from test_solvers import _build_nonrigid_problem, make_surface, rot_z

# One intra-op thread: with torch 2.13's CPU build on x86-64 (AVX-512),
# worker threads intermittently returned f32 sqrt results ~3e-4 off for
# part of a tensor (2 processes in 24; none in 24 single-threaded), far
# above the tolerances below.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def test_rigid_matches_jax(rng):
    pts, normals = make_surface(rng)
    M = np.eye(4)
    M[:3, :3] = rot_z(0.3)
    M[:3, 3] = [0.05, -0.02, 0.1]
    corrs = (pts @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    mask = np.ones(len(pts), bool)
    mask[::7] = False
    x0 = np.array([1.0, 0, 0, 0, 0, 0, 0, 0], np.float32)
    args = (x0, pts, normals, corrs, mask)
    jx, jc = JR.solve_rigid(*map(jnp.asarray, args), iterations=15)
    tx, tc = TR.solve_rigid(*map(T, args), iterations=15)
    # both converge to the exact pose (cost ~1e-9): compare the pose and
    # the warped points, not the tiny costs' relative values
    assert float(tc) < 1e-7 and float(jc) < 1e-7
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(J.dq_transform_point(jnp.asarray(tx.numpy()),
                                        jnp.asarray(pts))), corrs, atol=1e-3)
    # one step from identity: identical linearization, f32 noise only
    jx1, jc1 = JR.solve_rigid(*map(jnp.asarray, args), iterations=1)
    tx1, tc1 = TR.solve_rigid(*map(T, args), iterations=1)
    np.testing.assert_allclose(tx1.numpy(), np.asarray(jx1), atol=1e-5)
    np.testing.assert_allclose(float(tc1), float(jc1), rtol=1e-3)


def _problem(rng, motion):
    k = 3
    verts, normals, wf, nbr, wts = _build_nonrigid_problem(rng)
    M = np.eye(4)
    M[:3, :3] = rot_z(motion)
    M[:3, 3] = [0.05, 0.03, -0.04]
    corrs = (verts @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    cmask = np.ones(len(verts), bool)
    cmask[::9] = False
    pair_i, pair_j, pair_scale, pair_mask = JN.make_reg_pairs(
        wf.node_vert_idx, jnp.asarray(nbr), wf.node_w, wf.active,
        jnp.float32(0.1))
    pair_v = jnp.take(wf.node_pos, pair_j, axis=0)
    data = (verts, normals, corrs, cmask, nbr, wts)
    reg = tuple(np.asarray(a) for a in (pair_i, pair_j, pair_v, pair_scale,
                                        pair_mask))
    return np.asarray(wf.node_dq), data, reg, k


def test_make_reg_pairs_matches_jax(rng):
    verts, normals, wf, nbr, wts = _build_nonrigid_problem(rng)
    want = JN.make_reg_pairs(wf.node_vert_idx, jnp.asarray(nbr), wf.node_w,
                             wf.active, jnp.float32(0.1))
    got = TN.make_reg_pairs(T(wf.node_vert_idx).long(), T(nbr).long(),
                            T(wf.node_w), T(wf.active), 0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7)


@pytest.mark.parametrize("motion", [0.05, 0.15])
@pytest.mark.parametrize("gn_iters,cg_iters", [(1, 24), (12, 48)])
def test_gn_solve_core_matches_jax(rng, motion, gn_iters, cg_iters):
    x0, data, reg, k = _problem(rng, motion)
    lw = np.array([1.0, 0, 0, 0, 0, 0, 0, 0], np.float32)
    jd = tuple(jnp.asarray(a) for a in data)
    jr = tuple(jnp.asarray(a) for a in reg)
    # solve_nonrigid = the jitted single-chip gn_solve_core
    want = JN.solve_nonrigid(jnp.asarray(x0), *jd, *jr, jnp.asarray(lw),
                             gn_iters=gn_iters, cg_iters=cg_iters)
    td = tuple(T(a).long() if i == 4 else T(a) for i, a in enumerate(data))
    tr = (T(reg[0]).long(), T(reg[1]).long()) + tuple(map(T, reg[2:]))
    got = TN.gn_solve_core(T(x0), td, tr, T(lw), gn_iters, cg_iters, 1e-4,
                           1e-5)
    # energies before the solve: the same residuals, f32 sums
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    for robust in (False, True):
        np.testing.assert_allclose(
            float(TN.nonrigid_energy(T(x0), td, tr, T(lw), robust=robust)),
            float(JN.nonrigid_energy(jnp.asarray(x0), jd, jr,
                                     jnp.asarray(lw), robust=robust)),
            rtol=1e-5)
    # after: CG sums in another order steer to the same optimum
    c0 = float(want[2])
    assert float(got[3]) < 0.05 * c0 or gn_iters == 1
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-3,
                               atol=1e-4 * c0)
    assert int(got[5]) == int(want[5]) == 0
    # node DQs: one GN step is the same linear solve; after many steps the
    # point-to-plane gauge leaves tangential drift free (test_solvers.py:
    # test_ell_matvec_matches_row_path), so compare on the active nodes at
    # the level the energies agree
    n_act = int(np.sum(np.asarray(reg[4]).reshape(len(x0), -1).any(1)))
    atol = 1e-4 if gn_iters == 1 else 2e-2
    np.testing.assert_allclose(got[0].numpy()[:n_act],
                               np.asarray(want[0])[:n_act], atol=atol)


def test_ell_assembly_matches_dense_normal_matrix(rng):
    """The block-ELL operator equals the dense JᵀWJ it encodes
    (tests/test_solvers.py:224, brute-force oracle), and the degree cap
    overflow count equals JAX's."""
    V, Mn, k = 40, 8, 2
    nbr = rng.randint(0, Mn, size=(V, k))
    J_ = rng.randn(V, k, 8).astype(np.float32)
    w = rng.rand(V).astype(np.float32)
    cmask = rng.rand(V) > 0.2
    empty = torch.zeros((0,), dtype=torch.long)
    reduce_ell, ell_nbr, self_ids, present, n_over = TN.make_block_ell(
        T(nbr), T(cmask), empty, empty, empty.bool(), Mn, 16)
    assert int(n_over) == 0
    H = np.zeros((Mn, 8, Mn, 8))
    for v in np.flatnonzero(cmask):
        for a in range(k):
            for b in range(k):
                H[nbr[v, a], :, nbr[v, b], :] += w[v] * np.outer(J_[v, a],
                                                                 J_[v, b])
    Jw = J_ * w[:, None, None]
    contrib = (Jw[:, :, None, :, None] * J_[:, None, :, None, :]).transpose(
        1, 2, 0, 3, 4).reshape(-1, 64)
    Bl = reduce_ell(T(contrib)).numpy().reshape(Mn, 16, 8, 8)
    nbr_ell = ell_nbr.numpy().reshape(Mn, 16)
    p = rng.randn(Mn, 8)
    out = np.einsum("mdab,mdb->ma", Bl, p[nbr_ell])
    np.testing.assert_allclose(out, np.einsum("manb,nb->ma", H, p),
                               rtol=2e-4, atol=2e-4)
    diag = Bl.reshape(-1, 64)[self_ids.numpy()] * present.numpy()[:, None]
    for m in range(Mn):
        np.testing.assert_allclose(diag[m].reshape(8, 8), H[m, :, m, :],
                                   rtol=2e-4, atol=2e-4)
    # a tiny degree cap overflows, counted as JAX counts it
    for D in (2, 3):
        want = JN.make_block_ell(jnp.asarray(nbr), jnp.asarray(cmask),
                                 jnp.zeros(0, jnp.int32),
                                 jnp.zeros(0, jnp.int32),
                                 jnp.zeros(0, bool), Mn, D)[4]
        got = TN.make_block_ell(T(nbr), T(cmask), empty, empty,
                                empty.bool(), Mn, D)[4]
        assert int(got) == int(want) > 0


def test_inv8_spd_and_relaxation(rng):
    A = rng.randn(16, 8, 8).astype(np.float32)
    D = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(8, dtype=np.float32)
    np.testing.assert_allclose(TN._inv8_spd(T(D)).numpy(),
                               np.asarray(JN._inv8_spd(jnp.asarray(D))),
                               rtol=1e-3, atol=1e-4)
    for cb, ca in ((1.0, 0.5), (1.0, 0.99), (1.0, 0.01)):
        jr, jw = JN.relaxation_step(jnp.float32(cb), jnp.float32(ca), 1.0)
        tr, tw = TN.relaxation_step(torch.tensor(cb), torch.tensor(ca), 1.0)
        assert bool(tr) == bool(jr) and float(tw) == float(jw)
