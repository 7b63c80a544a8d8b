"""Parity of the port's K2 twin, warp caches and non-rigid TSDF update
with the JAX package (ops/trilerp_pallas.py in interpret mode,
models/warp_field.py). Fixtures follow tests/test_trilerp_escape.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.models import warp_field as JW
from dynamicfusion_body_tpu.ops import trilerp_pallas as JP
from dynamicfusion_body_tpu_torch import convert
from dynamicfusion_body_tpu_torch.models import warp_field as TW
from dynamicfusion_body_tpu_torch.ops import trilerp_cuda as TP
from dynamicfusion_body_tpu_torch.ops.bricks import vol_from_bricks

# One intra-op thread: with torch 2.13's CPU build on x86-64 (AVX-512),
# worker threads intermittently returned f32 sqrt results ~3e-4 off for
# part of a tensor (2 processes in 24; none in 24 single-threaded), far
# above the tolerances below.
torch.set_num_threads(1)

WF_FIELDS = ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
             "radius")


def T(a):
    return torch.from_numpy(np.array(a))


def to_port(wf):
    return convert.warp_field_from_jax(
        {f: np.asarray(getattr(wf, f)) for f in WF_FIELDS}, device="cpu")


def mip_fixture(rng):
    """tests/test_trilerp_escape.py:92-137: a clipped live sphere TSDF
    (saturated +tdist far field, <= -tdist interior) and a perturbed
    random node graph."""
    shape = (32, 32, 128)
    tdist = 3.0
    x, y, z = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                          indexing="ij")
    r = np.sqrt((x - 16) ** 2 + (y - 15) ** 2 + (z - 64) ** 2)
    live = np.clip(r - 9.0, -tdist, tdist).astype(np.float32)
    verts = (rng.rand(40, 3) * 14 + 9).astype(np.float32)
    verts[:, 2] += 48.0
    wf = JW.construct_graph(jnp.asarray(verts), jnp.float32(2.0), 64)
    dqs = (rng.randn(64, 8) * 0.03).astype(np.float32)
    dqs[:, 0] += 1.0
    wf = wf.replace(node_dq=jnp.asarray(dqs))
    lw = np.array([1.0, 0, 0, 0, 0, 0.3, -0.2, 0.1], np.float32)
    values = np.clip(r - 8.0, -tdist, tdist).astype(np.float32)
    weights = (rng.rand(*shape) * 4).astype(np.float32)
    return dict(shape=shape, tdist=tdist, live=live, wf=wf, lw=lw,
                values=values, weights=weights, k=3, C=8)


def tearing_fixture(rng):
    """tests/test_trilerp_escape.py:18-38: two adjacent nodes with
    opposite ±18-voxel translations (differential warp > 30 voxels inside
    single bricks) on a white-noise live volume."""
    shape = (16, 24, 128)
    verts = jnp.asarray(np.array([[6.0, 10.0, 60.0], [10.0, 14.0, 60.0]],
                                 np.float32))
    wf = JW.construct_graph(verts, jnp.float32(1.5), 4)
    dqs = np.tile(np.array([1, 0, 0, 0, 0, 0, 0, 0], np.float32), (4, 1))
    dqs[0, 5:8] = [0.0, 0.0, 9.0]
    dqs[1, 5:8] = [0.0, 0.0, -9.0]
    return dict(
        shape=shape, tdist=0.5, wf=wf.replace(node_dq=jnp.asarray(dqs)),
        live=rng.uniform(-1, 1, shape).astype(np.float32),
        values=rng.uniform(-0.2, 0.3, shape).astype(np.float32),
        weights=(rng.rand(*shape) * 3).astype(np.float32),
        lw=np.array([1.0, 0, 0, 0, 0, 0, 0, 0], np.float32), k=2, C=4)


def ieee_mask(selw):
    """(NB, V) bool: voxels whose blend no subnormal float touches.

    XLA on the CPU (like the TPU) flushes subnormal floats to zero; the
    port keeps them (IEEE, the CUDA default). Far from every node, where
    the largest Gaussian blend weight w is in [1e-24, 1e-16), squares of
    blend components (w·dq_e)² drop below the f32 normal range: JAX leaves
    them out of the 8-norm term by term, while the port keeps them and
    takes the identity only once the whole squared norm underflows
    (``dualquat.NORM2_MIN``). Measured there: warped coordinates up to
    0.02 and fused values up to 0.0034 apart. Those voxels are left out of
    the comparisons; below 1e-24 both take the identity."""
    wmax = np.max(np.asarray(selw), axis=1)
    return (wmax >= 1e-16) | (wmax < 1e-24)


def jax_caches(fx):
    cand, risk = JW.brick_candidates_2level(
        fx["wf"], fx["shape"], 8, fx["C"], with_risk=True, risk_k=fx["k"])
    return (cand, risk), JW.build_warp_cache(fx["wf"], fx["shape"], cand,
                                             fx["k"], 8)


def test_live_brick_mip_matches_jax(rng):
    live = rng.randn(24, 32, 40).astype(np.float32)
    for got, want in zip(TP.live_brick_mip(T(live)),
                         JP.live_brick_mip(jnp.asarray(live))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k2_twin_matches_pallas_interpret(rng):
    fx = mip_fixture(rng)
    (cand, _), (sel, selw, _) = jax_caches(fx)
    wf = fx["wf"]
    M = wf.capacity
    node_table = jnp.concatenate(
        [wf.node_pos, wf.node_w[:, None], wf.active[:, None].astype(
            jnp.float32), wf.node_dq, jnp.zeros((M, 3), jnp.float32)], 1)
    live = jnp.asarray(fx["live"])
    tdist = fx["tdist"]
    jv, jvalid, jesc, jwx, jwy, jwz = (np.asarray(a) for a in
                                       JP.warp_trilerp_bricks_cached(
        live, node_table, cand, sel, selw, jnp.asarray(fx["lw"]),
        vol_shape=fx["shape"], brick=8, group=16, interpret=True,
        precise=True, tdist=tdist, live_mip=JP.live_brick_mip(live)))
    t_mip = TP.live_brick_mip(T(fx["live"]))
    tv, tvalid, twx, twy, twz = (a.numpy() for a in
                                 TP.warp_trilerp_bricks_cached(
        T(fx["live"]), T(wf.node_dq), T(cand).long(), T(sel), T(selw),
        T(fx["lw"]), brick=8, tdist=tdist, live_mip=t_mip))

    m = ieee_mask(selw)
    assert m.mean() > 0.5
    # warped coordinates: the same blend summed in another order, f32 ulps
    # of values up to ~130
    for a, b in ((twx, jwx), (twy, jwy), (twz, jwz)):
        np.testing.assert_allclose(a[m], b[m], atol=1e-4)
    # no staging box in the port: its valid is JAX's valid | escaped, and
    # equals JAX's valid wherever JAX did not escape
    np.testing.assert_array_equal(tvalid[m], (jvalid | jesc)[m])
    np.testing.assert_array_equal(tvalid[m & ~jesc], jvalid[m & ~jesc])
    # values: JAX's precise hi/lo bf16 path errs by ~2^-16·max|live|; the
    # port's f32 trilerp is exact up to f32 rounding
    ok = m & jvalid & ~jesc
    np.testing.assert_allclose(tv[ok], jv[ok],
                               atol=2.0 ** -16 * np.abs(fx["live"]).max())
    # certified bricks carry exact constants in both
    short, cval = TP.mip_short_bricks(T(twx), T(twy), T(twz), T(tvalid),
                                      fx["shape"], tdist, t_mip)
    short = short.numpy()
    assert short.sum() > 0 and (~short).sum() > 0
    np.testing.assert_array_equal(tv[short], np.broadcast_to(
        cval.numpy()[short, None], tv[short].shape))
    both = short & m.all(axis=1)
    np.testing.assert_array_equal(tv[both], jv[both])


@pytest.mark.parametrize("mip", [False, True])
def test_k2_without_coords(rng, mip):
    """coords=False: the same vals and valid as coords=True, and None in
    the coordinates' places; the CPU wrapper is the twin either way."""
    fx = mip_fixture(rng)
    (cand, _), (sel, selw, _) = jax_caches(fx)
    live = T(fx["live"])
    args = (live, T(fx["wf"].node_dq), T(cand).long(), T(sel), T(selw),
            T(fx["lw"]))
    kw = dict(brick=8)
    if mip:
        kw.update(tdist=fx["tdist"], live_mip=TP.live_brick_mip(live))
    full = TP.warp_trilerp_bricks_cached_ref(*args, **kw)
    for fn in (TP.warp_trilerp_bricks_cached_ref,
               TP.warp_trilerp_bricks_cached):
        got = fn(*args, **kw, coords=False)
        assert len(got) == 5 and all(c is None for c in got[2:])
        assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    assert torch.equal(TP.warp_trilerp_bricks_cached(*args, **kw)[2],
                       full[2])


@pytest.mark.parametrize("with_pool", [False, True])
def test_candidates_and_warp_cache_match_jax(rng, with_pool):
    shape = (32, 32, 32)
    verts = (rng.rand(2000, 3) * 28 + 2).astype(np.float32)
    wf = JW.construct_graph(jnp.asarray(verts), jnp.float32(1.2), 256)
    assert int(wf.num_active) > 192  # the 2-level pool engages
    twf = to_port(wf)
    if with_pool:
        jc, jpool = JW.brick_candidates_2level(wf, shape, 8, 16,
                                               with_pool=True)
        tc, tpool = TW.brick_candidates_2level(twf, shape, 8, 16,
                                               with_pool=True)
        np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool),
                                   rtol=1e-6)
        jcache = JW.build_warp_cache(wf, shape, jc, 3, 8, pool_ctx=jpool)
        tcache = TW.build_warp_cache(twf, shape, tc, 3, 8, pool_ctx=tpool)
        assert int(tcache[3]) == int(jcache[3])
    else:
        jc, jrisk = JW.brick_candidates_2level(wf, shape, 8, 16,
                                               with_risk=True, risk_k=3)
        tc, trisk = TW.brick_candidates_2level(twf, shape, 8, 16,
                                               with_risk=True, risk_k=3)
        assert int(trisk) == int(jrisk)
        jcache = JW.build_warp_cache(wf, shape, jc, 3, 8)
        tcache = TW.build_warp_cache(twf, shape, tc, 3, 8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tcache[0].numpy(), np.asarray(jcache[0]))
    for got, want in zip(tcache[1:3], jcache[1:3]):  # weights, distances
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
