"""Parity of the port's geometry ops (dynamicfusion_body_tpu_torch.ops)
with the JAX package: the same seeded numpy inputs go through both."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracles
from dynamicfusion_body_tpu import ops as J
from dynamicfusion_body_tpu.models.warp_field import _trilinear_c as j_tri_c
from dynamicfusion_body_tpu.ops import bricks as j_bricks
from dynamicfusion_body_tpu.ops import compwise as j_cw
from dynamicfusion_body_tpu.ops import mc_tables as j_tables
from dynamicfusion_body_tpu_torch.ops import bricks as t_bricks
from dynamicfusion_body_tpu_torch.ops import compwise as t_cw
from dynamicfusion_body_tpu_torch.ops import dualquat as t_dq
from dynamicfusion_body_tpu_torch.ops import mc_tables as t_tables
from dynamicfusion_body_tpu_torch.ops.interp import trilinear, trilinear_c
from dynamicfusion_body_tpu_torch.ops.knn import knn
from dynamicfusion_body_tpu_torch.ops.losses import huber_irls_weight
from dynamicfusion_body_tpu_torch.ops.sampling import radius_subsample

# One intra-op thread: with torch 2.13's CPU build on x86-64 (AVX-512),
# worker threads intermittently returned f32 sqrt results ~3e-4 off for
# part of a tensor (2 processes in 24; none in 24 single-threaded), far
# above the tolerances below.
torch.set_num_threads(1)

# f32 results of the same formula in two frameworks: a few ulps of O(1-10)
# values (XLA and ATen may order or fuse the float ops differently)
ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


def _dqs(rng, n):
    dq = rng.randn(n, 8).astype(np.float32) * 0.3
    dq[:, 0] += 1.0
    return dq


@pytest.mark.parametrize("name", ["TRI_TABLE", "TRI_COUNT", "EDGE_BASE",
                                  "EDGE_AXIS"])
def test_mc_tables_equal_jax_copy(name):
    np.testing.assert_array_equal(getattr(t_tables, name),
                                  getattr(j_tables, name))


@pytest.mark.parametrize("fn", ["quat_multiply", "dq_multiply"])
def test_dq_products(rng, fn):
    n = 4 if fn == "quat_multiply" else 8
    a = rng.randn(50, n).astype(np.float32)
    b = rng.randn(50, n).astype(np.float32)
    want = np.asarray(getattr(J, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(t_dq, fn)(T(a), T(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dq_transforms_and_blend(rng):
    dq = _dqs(rng, 60)
    p = rng.randn(60, 3).astype(np.float32) * 5
    for fn in ("dq_transform_point", "dq_transform_normal"):
        want = np.asarray(getattr(J, fn)(jnp.asarray(dq), jnp.asarray(p)))
        got = getattr(t_dq, fn)(T(dq), T(p)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)  # |p| ~ 10
    dq[3] = 0.0  # identity fallback
    np.testing.assert_allclose(t_dq.dq_normalize8(T(dq)).numpy(),
                               np.asarray(J.dq_normalize8(jnp.asarray(dq))),
                               atol=ATOL)
    npos = rng.randn(60, 3, 3).astype(np.float32)
    ndq = _dqs(rng, 180).reshape(60, 3, 8)
    nw = rng.uniform(0.5, 2, (60, 3)).astype(np.float32)
    mask = rng.rand(60, 3) > 0.2
    want = np.asarray(J.dq_blend(*map(jnp.asarray, (p, npos, ndq, nw)),
                                 mask=jnp.asarray(mask)))
    got = t_dq.dq_blend(T(p), T(npos), T(ndq), T(nw), mask=T(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and against the numpy oracle of the reference formula
    for i in range(0, 60, 7):
        np.testing.assert_allclose(
            got[i], oracles.dq_blend_oracle(p[i], npos[i][mask[i]],
                                            ndq[i][mask[i]], nw[i][mask[i]]),
            atol=1e-5)


def test_compwise_normalize_and_point(rng):
    dq = _dqs(rng, 100)
    dq[7] = 0.0
    p = rng.randn(3, 100).astype(np.float32) * 20
    j_se3 = j_cw.dq_normalize8_c(tuple(jnp.asarray(c) for c in dq.T))
    t_se3 = t_cw.dq_normalize8_c(tuple(T(c) for c in dq.T))
    for a, b in zip(t_se3, j_se3):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    j_w = j_cw.dq_point_c(j_se3, tuple(jnp.asarray(c) for c in p))
    t_w = t_cw.dq_point_c(t_se3, tuple(T(c) for c in p))
    for a, b in zip(t_w, j_w):  # |p| ~ 40: a few ulps
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("scale,identity", [(1e-15, False), (1e-21, True)])
def test_normalize_underflow_takes_identity(rng, scale, identity):
    """Blend weights ~1e-21 (far from every node) leave a squared 8-norm
    below the smallest normal f32: both port normalizations then take the
    identity, as the JAX package does through XLA's subnormal flush. At
    1e-15 the squares are normal and the result is dq/‖dq‖ (float64)."""
    dq = _dqs(rng, 50) * np.float32(scale)
    want = (np.tile(np.float32(t_dq.IDENTITY_DQ), (50, 1)) if identity else
            dq / np.linalg.norm(dq.astype(np.float64), axis=1, keepdims=True))
    comp = t_cw.dq_normalize8_c(tuple(T(c) for c in dq.T))
    for got in (t_dq.dq_normalize8(T(dq)).numpy(),
                torch.stack(comp, dim=1).numpy(),
                np.asarray(J.dq_normalize8(jnp.asarray(dq)))):
        np.testing.assert_allclose(got, want, atol=1e-6)  # unit-norm rows


def test_huber_irls_weight(rng):
    r = (rng.randn(500) * 3).astype(np.float32)
    np.testing.assert_allclose(huber_irls_weight(T(r)).numpy(),
                               np.asarray(J.huber_irls_weight(jnp.asarray(r))),
                               rtol=1e-6)


def test_trilinear_both_forms(rng):
    vol = rng.randn(9, 10, 11).astype(np.float32)
    pos = rng.uniform(-1, 11, (400, 3)).astype(np.float32)
    want_v, want_ok = J.trilinear(jnp.asarray(vol), jnp.asarray(pos))
    got_v, got_ok = trilinear(T(vol), T(pos))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL)
    cv, cok = trilinear_c(T(vol), *(T(c) for c in pos.T))
    jv, jok = j_tri_c(jnp.asarray(vol), *(jnp.asarray(c) for c in pos.T))
    np.testing.assert_array_equal(cok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(cv.numpy(), np.asarray(jv), atol=ATOL)
    for i in np.flatnonzero(np.asarray(want_ok))[:20]:
        np.testing.assert_allclose(got_v[i].item(),
                                   oracles.trilerp_oracle(pos[i], vol),
                                   atol=1e-5)


def test_bricks_layout_roundtrip(rng):
    vol = rng.randn(16, 8, 24).astype(np.float32)
    b = t_bricks.vol_to_bricks(T(vol), 8)
    np.testing.assert_array_equal(
        b.numpy(), np.asarray(j_bricks.vol_to_bricks(jnp.asarray(vol), 8)))
    np.testing.assert_array_equal(
        t_bricks.vol_from_bricks(b, vol.shape, 8).numpy(), vol)


@pytest.mark.parametrize("k,masked", [(1, False), (3, True), (16, True)])
def test_knn_matches_jax(rng, k, masked):
    q = rng.uniform(0, 20, (300, 3)).astype(np.float32)
    p = rng.uniform(0, 20, (200, 3)).astype(np.float32)
    valid = rng.rand(200) > 0.3 if masked else None
    jd, ji = J.knn(jnp.asarray(q), jnp.asarray(p), k,
                   valid=None if valid is None else jnp.asarray(valid))
    td, ti = knn(T(q), T(p), k, valid=None if valid is None else T(valid))
    jd, ji = np.asarray(jd), np.asarray(ji)
    # distances are recomputed directly in both: f32 roundoff of ~20
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-4)
    # index sets equal wherever the k-th/(k+1)-th gap leaves no tie
    dist = np.linalg.norm(q[:, None] - p[None], axis=-1)
    if masked:
        dist[:, ~valid] = np.inf
    full = np.sort(dist, axis=1)
    gap = (full[:, k] - full[:, k - 1]) > 1e-4
    same = np.all(np.sort(ti.numpy(), 1) == np.sort(ji, 1), axis=1)
    assert np.all(same | ~gap)
    assert same.mean() > 0.99


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radius_subsample_matches_jax_and_oracle(seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 10, (400, 3)).astype(np.float32)
    valid = rng.rand(400) > 0.1
    jidx, jn = J.radius_subsample(jnp.asarray(pts), jnp.float32(1.3), 128,
                                  valid=jnp.asarray(valid))
    tidx, tn = radius_subsample(T(pts), 1.3, 128, valid=T(valid))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    want = np.flatnonzero(valid)[
        oracles.radius_subsample_oracle(pts[valid], 1.3)]
    np.testing.assert_array_equal(tidx.numpy()[:int(tn)], want[:128])
