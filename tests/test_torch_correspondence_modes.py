"""The correspondence searches of the port against the JAX package's, on
the same seeded inputs: ``ops/grid_knn.py``, ``ops/knn.py`` (the k > 4
selection, ``approx=True``, ``nearest``, ``knn_2level``) and
``pipeline/correspondence.py`` (every mode, the cached candidates with
their drift certificate, the feature matcher and its prune). The frames
that use them are in tests/test_torch_frame_modes.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.ops.grid_knn import grid_knn as j_grid_knn
from dynamicfusion_body_tpu.ops.knn import (
    knn as j_knn, knn_2level as j_knn_2level, nearest as j_nearest)
from dynamicfusion_body_tpu.pipeline import correspondence as JC
from dynamicfusion_body_tpu_torch.ops import grid_knn as TG
from dynamicfusion_body_tpu_torch.ops import knn as TK
from dynamicfusion_body_tpu_torch.pipeline import correspondence as TC

# One intra-op thread (see tests/test_torch_frame.py)
torch.set_num_threads(1)

DIST_RTOL = 1e-6   # distances of equal picks
CORR_ATOL = 1e-5   # correspondence points and plane costs
APPROX_RECALL = 0.99  # share of queries with JAX's index set, approx=True


def T(a):
    return torch.from_numpy(np.asarray(a))


def _normals(rng, n):
    v = rng.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


# --- grid_knn: the four cases of tests/test_grid_knn.py on the port -----

def test_grid_knn_matches_bruteforce(rng):
    P = 3000
    pts = (rng.rand(P, 3) * 200 + 10).astype(np.float32)
    q = (pts[:200] + rng.randn(200, 3) * 2).astype(np.float32)
    d, i, found, _ = TG.grid_knn(T(q), T(pts), 3, cell=16.0,
                                 cap_per_cell=256, grid_n=16)
    d, i, found = d.numpy(), i.numpy(), found.numpy()
    for j in range(len(q)):
        dd = np.linalg.norm(pts - q[j], axis=1)
        o = np.argsort(dd)[:3]
        # contract: exact for neighbours within cell/2
        for kk in range(3):
            if dd[o[kk]] <= 8.0 - 1e-3:
                assert found[j, kk]
                np.testing.assert_allclose(d[j, kk], dd[o[kk]], atol=1e-4)
                assert i[j, kk] == o[kk] or np.isclose(dd[i[j, kk]],
                                                       dd[o[kk]])


def test_grid_knn_respects_valid_mask(rng):
    pts = (rng.rand(100, 3) * 50 + 5).astype(np.float32)
    valid = np.ones(100, bool)
    valid[:50] = False
    q = pts[:10] + 0.01
    _, i, found, _ = TG.grid_knn(T(q), T(pts), 1, valid=T(valid), cell=16.0,
                                 cap_per_cell=128, grid_n=8)
    assert np.all(i.numpy()[found[:, 0].numpy()] >= 50)


def test_grid_knn_no_neighbors():
    pts = np.full((10, 3), 5.0, np.float32)
    q = np.full((4, 3), 200.0, np.float32)
    _, _, found, _ = TG.grid_knn(T(q), T(pts), 2, cell=16.0,
                                 cap_per_cell=64, grid_n=16)
    assert not found.any()


def test_grid_knn_flags_cell_overflow(rng):
    # 40 points crammed into one cell with cap_per_cell=16 → overflow
    pts = (rng.rand(40, 3) * 4 + 20).astype(np.float32)
    q = pts[:5]
    *_, ovf = TG.grid_knn(T(q), T(pts), 2, cell=16.0, cap_per_cell=16,
                          grid_n=8)
    assert bool(ovf)
    *_, ok = TG.grid_knn(T(q), T(pts), 2, cell=16.0, cap_per_cell=64,
                         grid_n=8)
    assert not bool(ok)


@pytest.mark.parametrize("cap", [16, 64])
def test_grid_knn_matches_jax(rng, cap):
    """Equal indices, found and overflow; distances within DIST_RTOL. Points
    on a half-voxel lattice make equal distances, so the tie order (earlier
    cell, then lower lane) is held too; a quarter of the points are
    invalid, and cap 16 overflows some cells."""
    pts = (rng.randint(0, 128, (1500, 3)) * 0.5 + 2).astype(np.float32)
    valid = rng.rand(1500) > 0.25
    q = (rng.rand(300, 3) * 66).astype(np.float32)
    q[:100] = pts[:100] + 0.25
    args = dict(cell=16.0, cap_per_cell=cap, grid_n=5)
    jd, ji, jf, jo = j_grid_knn(jnp.asarray(q), jnp.asarray(pts), 4,
                                 valid=jnp.asarray(valid), **args)
    td, ti, tf, to = TG.grid_knn(T(q), T(pts), 4, valid=T(valid), **args)
    assert bool(to) == bool(jo) == (cap == 16)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL)
    assert tf.numpy().mean() > 0.5


# --- knn ---------------------------------------------------------------

def test_knn_k16_selection_is_the_stable_sort(rng):
    """The k > 4 branch (``smallest_k``) picks what the stable sort of the
    keys did, and what JAX's top_k picks, on a lattice where distances tie
    exactly (ties to the lower index); ``smallest_k`` equals the stable
    sort on random keys (the float top-k alone), on ties across the k-th
    key and on rows with fewer than k + 1 finite keys (the int64-key
    rows), and with negative keys and -0 taken as +0."""
    pts = rng.randint(0, 6, (400, 3)).astype(np.float32)
    q = rng.randint(0, 6, (50, 3)).astype(np.float32) + 0.5
    valid = rng.rand(400) > 0.2
    tq, tp, tv = T(q), T(pts), T(valid)
    d2 = torch.where(tv[None, :], TK.pairwise_sqdist(tq, tp), torch.inf)
    keys = d2 + torch.arange(400, dtype=torch.float32) * 1e-12
    want = torch.sort(keys, dim=1, stable=True).indices[:, :16]
    np.testing.assert_array_equal(TK.smallest_k(keys, 16).numpy(),
                                  want.numpy())
    td, ti = TK.knn(tq, tp, 16, valid=tv)
    jd, ji = j_knn(jnp.asarray(q), jnp.asarray(pts), 16,
                    valid=jnp.asarray(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), want.numpy())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL)
    rand = T(rng.rand(40, 300).astype(np.float32))
    few = rand.clone()
    few[:5, 10:] = torch.inf                  # 10 finite keys in 5 rows
    tied = T(rng.randint(0, 9, (40, 300)).astype(np.float32))
    for keys in (rand, few, tied, torch.cat([rand, tied, few])):
        for k in (5, 16):
            np.testing.assert_array_equal(
                TK.smallest_k(keys, k).numpy(),
                torch.sort(keys, dim=1, stable=True).indices[:, :k].numpy())
    # negative keys and -0 order as floats (the approximate path's keys):
    # a tie across the k-th key at k = 4 (-0, +0), none at k = 3, all of
    # the row at k = 7
    keys = torch.tensor([[0.5, -0.0, -1.5, 0.0, -1.5, torch.inf, -2e-3]])
    want = [2, 4, 6, 1, 3, 0, 5]
    for k in (3, 4, 7):
        np.testing.assert_array_equal(TK.smallest_k(keys, k).numpy(),
                                      [want[:k]])


@pytest.mark.parametrize("k", [3, 16])
def test_knn_approx_matches_jax(rng, k):
    """approx=True is what the JAX package computes off the TPU (bf16 keys
    less a subsample estimate, exact selection): the index sets agree on
    at least APPROX_RECALL of the queries (an f32 matmul's summation order
    can move a key across a bf16 boundary), and the distances of equal
    picks within DIST_RTOL."""
    pts = (rng.rand(3000, 3) * 120).astype(np.float32)
    valid = rng.rand(3000) > 0.1
    q = (rng.rand(400, 3) * 120).astype(np.float32)
    jd, ji = j_knn(jnp.asarray(q), jnp.asarray(pts), k,
                    valid=jnp.asarray(valid), approx=True)
    td, ti = TK.knn(T(q), T(pts), k, valid=T(valid), approx=True)
    ji, jd, ti, td = np.asarray(ji), np.asarray(jd), ti.numpy(), td.numpy()
    same = np.array([set(a) == set(b) for a, b in zip(ti, ji)])
    assert same.mean() >= APPROX_RECALL, same.mean()
    eq = ti == ji
    np.testing.assert_allclose(td[eq], jd[eq], rtol=DIST_RTOL)
    assert valid[ti].all()
    # the picks are the exact search's nearest on most queries
    _, ei = TK.knn(T(q), T(pts), k, valid=T(valid))
    assert np.mean(np.all(ti == ei.numpy(), 1)) > 0.9


def test_nearest_matches_jax(rng):
    pts = (rng.rand(500, 3) * 30).astype(np.float32)
    valid = rng.rand(500) > 0.3
    q = (rng.rand(80, 3) * 30).astype(np.float32)
    jd, ji = j_nearest(jnp.asarray(q), jnp.asarray(pts),
                        valid=jnp.asarray(valid))
    td, ti = TK.nearest(T(q), T(pts), valid=T(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL)


def _coherent(rng, n_q=700, n_p=2000):
    """Queries in x-major order (as marching cubes emits vertices) near a
    random point cloud; a tenth of the queries and points invalid."""
    pts = (rng.rand(n_p, 3) * [60, 20, 20]).astype(np.float32)
    q = (rng.rand(n_q, 3) * [60, 20, 20]).astype(np.float32)
    q = q[np.argsort(q[:, 0], kind="stable")]
    return q, pts, rng.rand(n_q) > 0.1, rng.rand(n_p) > 0.1


@pytest.mark.parametrize("pool", [4096, 256])
def test_knn_2level_matches_jax(rng, pool):
    """pool >= P (every query certified: the flat search's answer) and
    pool < P (the ball certificate flags some queries): equal indices and
    n_risk to JAX's, and the flat search's indices on every query
    whose certificate holds."""
    q, pts, qv, pv = _coherent(rng)
    k = 4
    jd, ji, jr = j_knn_2level(jnp.asarray(q), jnp.asarray(pts), k,
                               qvalid=jnp.asarray(qv), valid=jnp.asarray(pv),
                               chunk=64, pool=pool)
    td, ti, tr = TK.knn_2level(T(q), T(pts), k, qvalid=T(qv), valid=T(pv),
                               chunk=64, pool=pool)
    assert int(tr) == int(jr)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL)
    # which queries the certificate holds for (knn_2level's own formula)
    nch = len(q) // 64 + 1
    qp = np.concatenate([q, np.zeros((nch * 64 - len(q), 3), np.float32)])
    qm = np.concatenate([qv, np.zeros(nch * 64 - len(q), bool)])
    q3, m3 = qp.reshape(nch, 64, 3), qm.reshape(nch, 64)
    cent = (q3 * m3[..., None]).sum(1) / np.maximum(m3.sum(1), 1)[:, None]
    d2c = np.where(pv[None], ((cent[:, None] - pts[None]) ** 2).sum(-1),
                   np.inf)
    r_pool = np.sqrt(np.sort(d2c, axis=1)[:, min(pool, len(pts)) - 1])
    dq_cent = np.linalg.norm(q3 - cent[:, None], axis=2).reshape(-1)
    risky = ((td.numpy()[:, -1] + dq_cent[:len(q)]
              >= np.repeat(r_pool, 64)[:len(q)] - 1e-3) & qv)
    if pool >= len(pts):
        assert int(tr) == 0
    else:
        assert 0 < int(tr) < qv.sum() and risky.sum() >= int(tr)
    _, fi = TK.knn(T(q), T(pts), k, valid=T(pv))
    ok = qv & ~risky
    np.testing.assert_array_equal(ti.numpy()[ok], fi.numpy()[ok])


# --- pipeline/correspondence.py -----------------------------------------

def _surface_pair(rng, V=600, L=1500):
    verts = (rng.rand(V, 3) * 30 + 1).astype(np.float32)
    verts = verts[np.argsort(verts[:, 0], kind="stable")]
    live = (rng.rand(L, 3) * 30 + 1).astype(np.float32)
    return (verts, _normals(rng, V), rng.rand(V) > 0.1, live,
            rng.rand(L) > 0.1)


def _check_corr(got, want):
    c, v, bc = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[1].numpy(), v)
    np.testing.assert_allclose(got[0].numpy(), c, atol=CORR_ATOL)
    np.testing.assert_allclose(got[2].numpy(), bc, atol=CORR_ATOL)


@pytest.mark.parametrize("approx", [False, True, "2level"],
                         ids=["exact", "approx", "2level"])
def test_closest_point_correspondences_matches_jax(rng, approx):
    verts, nrm, vmask, live, lmask = _surface_pair(rng)
    args = (verts, nrm, vmask, live, lmask)
    want = JC.closest_point_correspondences(*map(jnp.asarray, args), 4, 0.2,
                                            approx=approx)
    got = TC.closest_point_correspondences(*map(T, args), 4, 0.2,
                                           approx=approx)
    _check_corr(got, want)
    assert 0 < got[1].sum() < vmask.sum()


@pytest.mark.parametrize("crowd", [0, 300], ids=["fits", "overflow"])
def test_grid_correspondences_match_jax(rng, crowd):
    """The grid variant (cap 256 a cell); with ``crowd`` more live points
    in one cell it overflows, and every vertex is invalid in both
    packages."""
    verts, nrm, vmask, live, lmask = _surface_pair(rng)
    live = np.concatenate([live, (rng.rand(crowd, 3) * 4 + 20).astype(
        np.float32)])
    lmask = np.concatenate([lmask, np.ones(crowd, bool)])
    args = (verts, nrm, vmask, live, lmask)
    want = JC.closest_point_correspondences_grid(
        *map(jnp.asarray, args), 4, 0.2, grid_n=3)
    got = TC.closest_point_correspondences_grid(*map(T, args), 4, 0.2,
                                                grid_n=3)
    _check_corr(got, want)
    assert (got[1].sum() > 0) == (crowd == 0)


def test_zero_drift_equals_fresh_search(rng):
    """tests/test_correspondence_cache.py:22 on the port, and the cached
    path against JAX's."""
    V, L, k = 257, 511, 4
    verts = (rng.rand(V, 3) * 20).astype(np.float32)
    nrm = _normals(rng, V)
    vmask = rng.rand(V) > 0.1
    live = (rng.rand(L, 3) * 20).astype(np.float32)
    lmask = rng.rand(L) > 0.1
    tol = 2.0
    tv, tn, tvm, tl, tlm = map(T, (verts, nrm, vmask, live, lmask))
    cand, d_kc, n_risk0 = TC.correspondence_candidates(tv, tvm, tl, tlm,
                                                       kc=16)
    assert int(n_risk0) == 0
    got = TC.correspondences_from_candidates(tv, tn, tvm, tl, tlm, cand,
                                             d_kc, tv, k, tol)
    assert int(got[3]) == 0
    want = TC.closest_point_correspondences(tv, tn, tvm, tl, tlm, k, tol)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), atol=1e-5)
    ja = tuple(map(jnp.asarray, (verts, nrm, vmask, live, lmask)))
    jcand, jd_kc, _ = JC.correspondence_candidates(ja[0], ja[2], ja[3],
                                                   ja[4], kc=16)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    np.testing.assert_allclose(d_kc.numpy(), np.asarray(jd_kc),
                               rtol=DIST_RTOL)


def test_drifted_rerank_exact_where_certified(rng):
    """tests/test_correspondence_cache.py:54 on the port — the re-ranked
    cached answer equals a fresh search at the new positions wherever the
    certificate holds — and corr, valid, best_cost and n_risk against
    JAX's from the same candidates; the candidates from the 2-level search
    too."""
    V, L, k = 300, 800, 3
    base = (rng.rand(V, 3) * 20).astype(np.float32)
    drift = rng.randn(V, 3).astype(np.float32) * 0.3
    moved = base + drift
    nrm = _normals(rng, V)
    vmask = np.ones(V, bool)
    live = (rng.rand(L, 3) * 20).astype(np.float32)
    lmask = np.ones(L, bool)
    tol = 1.5
    tb, tm, tn, tvm, tl, tlm = map(T, (base, moved, nrm, vmask, live, lmask))
    cand, d_kc, _ = TC.correspondence_candidates(tb, tvm, tl, tlm, kc=16)
    got = TC.correspondences_from_candidates(tm, tn, tvm, tl, tlm, cand,
                                             d_kc, tb, k, tol)
    want = TC.closest_point_correspondences(tm, tn, tvm, tl, tlm, k, tol)
    delta = np.linalg.norm(drift, axis=1)
    cpts = live[cand.numpy()]
    dk_new = np.sort(np.linalg.norm(cpts - moved[:, None, :], axis=2),
                     axis=1)[:, k - 1]
    certified = dk_new < d_kc.numpy() - delta
    assert certified.sum() > V // 2  # both sides are exercised
    np.testing.assert_array_equal(got[1].numpy()[certified],
                                  want[1].numpy()[certified])
    np.testing.assert_array_equal(got[0].numpy()[certified],
                                  want[0].numpy()[certified])
    assert int(got[3]) >= int((~certified).sum())
    ja = dict(zip("bmnvlk", map(jnp.asarray,
                                (base, moved, nrm, vmask, live, lmask))))
    jgot = JC.correspondences_from_candidates(
        ja["m"], ja["n"], ja["v"], ja["l"], ja["k"], jnp.asarray(cand.numpy()),
        jnp.asarray(d_kc.numpy()), ja["b"], k, tol)
    _check_corr(got[:3], jgot[:3])
    assert int(got[3]) == int(jgot[3])
    tcand, td_kc, trisk = TC.correspondence_candidates(tb, tvm, tl, tlm,
                                                       kc=16, approx="2level")
    jcand, jd_kc, jrisk = JC.correspondence_candidates(
        ja["b"], ja["v"], ja["l"], ja["k"], kc=16, approx="2level")
    assert int(trisk) == int(jrisk)
    np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))
    np.testing.assert_allclose(td_kc.numpy(), np.asarray(jd_kc),
                               rtol=DIST_RTOL)


def test_feature_correspondences_and_prune_match_jax(rng):
    V, L, F = 300, 700, 16
    cf = rng.randn(V, F).astype(np.float32)
    lf = rng.randn(L, F).astype(np.float32)
    vmask, lmask = rng.rand(V) > 0.1, rng.rand(L) > 0.1
    lverts = (rng.rand(L, 3) * 20).astype(np.float32)
    verts = (rng.rand(V, 3) * 20).astype(np.float32)
    nrm = _normals(rng, V)
    args = (cf, vmask, lf, lverts, lmask)
    jc, jv = JC.feature_correspondences(*map(jnp.asarray, args))
    tc, tv = TC.feature_correspondences(*map(T, args))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=CORR_ATOL)
    jpv, jcost = JC.prune_by_plane_cost(jnp.asarray(verts), jnp.asarray(nrm),
                                        jc, jv, 3.0)
    tpv, tcost = TC.prune_by_plane_cost(T(verts), T(nrm), tc, tv, 3.0)
    np.testing.assert_array_equal(tpv.numpy(), np.asarray(jpv))
    np.testing.assert_allclose(tcost.numpy(), np.asarray(jcost),
                               atol=CORR_ATOL)
    assert 0 < tpv.sum() < tv.sum()
