"""Parity of the port's K3 (warp_trilerp_bricks) and K4 (trilerp_bricks)
twins with the JAX package's Pallas kernels in interpret mode
(ops/trilerp_pallas.py), and of the non-rigid TSDF update without a warp
cache (K3's path) and with a padded canonical lattice over an unpadded
live volume. Fixtures follow tests/test_trilerp_escape.py and
tests/test_trilerp_pallas.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.models import warp_field as JW
from dynamicfusion_body_tpu.ops import trilerp_pallas as JP
from dynamicfusion_body_tpu_torch.models import warp_field as TW
from dynamicfusion_body_tpu_torch.ops import trilerp_cuda as TP
from dynamicfusion_body_tpu_torch.ops.bricks import vol_from_bricks
from test_torch_warp_trilerp import (
    T, ieee_mask, jax_caches, mip_fixture, tearing_fixture, to_port)

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)


def node_table(wf):
    """The JAX kernels' packed (M, 16) node rows."""
    M = wf.capacity
    return jnp.concatenate(
        [wf.node_pos, wf.node_w[:, None],
         wf.active[:, None].astype(jnp.float32), wf.node_dq,
         jnp.zeros((M, 3), jnp.float32)], 1)


def port_nodes(wf):
    twf = to_port(wf)
    return twf.node_pos, twf.node_w, twf.active, twf.node_dq


@pytest.mark.parametrize("fixture", [mip_fixture, tearing_fixture])
def test_k3_twin_matches_pallas_interpret(rng, fixture):
    fx = fixture(rng)
    (cand, _), (_, selw, _) = jax_caches(fx)
    jv, jvalid, jesc, jwi, jwx, jwy, jwz = (np.asarray(a) for a in
                                            JP.warp_trilerp_bricks(
        jnp.asarray(fx["live"]), node_table(fx["wf"]), cand,
        jnp.asarray(fx["lw"]), vol_shape=fx["shape"], brick=8, k=fx["k"],
        group=16, interpret=True, precise=True))
    tv, tvalid, twi, twx, twy, twz = (a.numpy() for a in
                                      TP.warp_trilerp_bricks(
        T(fx["live"]), *port_nodes(fx["wf"]), T(cand).long(), T(fx["lw"]),
        vol_shape=fx["shape"], brick=8, k=fx["k"]))

    # wi: the same distances of the same selection (first-min tie-break)
    np.testing.assert_allclose(twi, jwi, rtol=1e-6)
    m = ieee_mask(selw)
    assert m.mean() > 0.5
    # coordinates: the same blend summed in another order (the port in
    # selection order, JAX over all C candidates), f32 ulps of ~130; in
    # the tearing fixture two nodes' opposite ±9 dual parts cancel in the
    # blend, which lifts that rounding to a relative 3.5e-5 (measured:
    # 1.6e-3 at z ~ 47 on 2 voxels)
    rtol = 0.0 if fixture is mip_fixture else 5e-5
    for a, b in ((twx, jwx), (twy, jwy), (twz, jwz)):
        np.testing.assert_allclose(a[m], b[m], atol=1e-4, rtol=rtol)
    # no staging box in the port: its valid is JAX's valid | escaped
    np.testing.assert_array_equal(tvalid[m], (jvalid | jesc)[m])
    if fixture is tearing_fixture:
        assert jesc[m].any()  # the escapes JAX re-samples are valid here
    # values: JAX's precise hi/lo bf16 path errs by ~2^-16·max|live|, plus
    # what the coordinates' difference moves the trilerp: at most
    # 3·max|Δlive between neighbours|·max|Δcoordinate| per voxel
    ok = m & jvalid & ~jesc
    live = fx["live"]
    lip = 3 * max(np.abs(np.diff(live, axis=a)).max() for a in range(3))
    dco = np.max([np.abs(twx - jwx), np.abs(twy - jwy), np.abs(twz - jwz)],
                 axis=0)
    bound = 2.0 ** -16 * np.abs(live).max() + lip * dco
    assert np.all(np.abs(tv - jv)[ok] <= bound[ok])


def test_k3_twin_is_cache_plus_k2_twin(rng):
    """K3's twin = build_warp_cache + K2's twin without the mip certificate
    — the identity the chip smoke holds the kernel to."""
    fx = mip_fixture(rng)
    (cand, _), _ = jax_caches(fx)
    twf = to_port(fx["wf"])
    tcand = T(cand).long()
    live, lw = T(fx["live"]), T(fx["lw"])
    sel, selw, wi = TW.build_warp_cache(twf, fx["shape"], tcand, fx["k"], 8)
    want = TP.warp_trilerp_bricks_cached(live, twf.node_dq, tcand, sel, selw,
                                         lw, brick=8)
    got = TP.warp_trilerp_bricks(live, *port_nodes(fx["wf"]), tcand, lw,
                                 brick=8, k=fx["k"])
    assert torch.equal(got[2], wi)
    for g, w in zip(got[:2] + got[3:], want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fixture", [mip_fixture, tearing_fixture])
def test_k3_without_coords(rng, fixture):
    """coords=False: the same vals, valid and wi as coords=True, and None
    in the coordinates' places; the CPU wrapper is the twin either way."""
    fx = fixture(rng)
    (cand, _), _ = jax_caches(fx)
    args = (T(fx["live"]), *port_nodes(fx["wf"]), T(cand).long(),
            T(fx["lw"]))
    kw = dict(vol_shape=fx["shape"], brick=8, k=fx["k"])
    full = TP.warp_trilerp_bricks_ref(*args, **kw)
    for fn in (TP.warp_trilerp_bricks_ref, TP.warp_trilerp_bricks):
        got = fn(*args, **kw, coords=False)
        assert len(got) == 6 and all(c is None for c in got[3:])
        for g, w in zip(got[:3], full[:3]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("cached", [False, True])
def test_update_asks_for_no_coordinates(rng, cached, monkeypatch):
    """update_tsdf_nonrigid(use_kernels=True) calls K3 (no warp cache) or
    K2 (with one) with coords=False: nothing on the update's path reads
    the warped coordinates."""
    fx = mip_fixture(rng)
    (cand, risk), wc = jax_caches(fx)
    seen = []
    for name in ("warp_trilerp_bricks", "warp_trilerp_bricks_cached"):
        def spy(*a, _real=getattr(TW, name), _name=name, **kw):
            seen.append((_name, kw.get("coords", True)))
            return _real(*a, **kw)
        monkeypatch.setattr(TW, name, spy)
    TW.update_tsdf_nonrigid(
        *(T(fx[n]) for n in ("values", "weights", "live")),
        to_port(fx["wf"]), T(fx["lw"]), k=fx["k"], tdist=fx["tdist"],
        brick=8, n_candidates=fx["C"], use_kernels=True,
        cand_cache=(T(cand).long(), T(risk)),
        warp_cache=tuple(T(a) for a in wc) if cached else None)
    want = "warp_trilerp_bricks_cached" if cached else "warp_trilerp_bricks"
    assert seen == [(want, False)]


def test_kernel_lattice_checks():
    """The card's K2/K3 take even bricks of at most 512 voxels (a voxel
    pair per thread, 256 threads) on a brick grid that matches NB."""
    live = torch.zeros(16, 16, 32)
    assert TP._check_lattice("k", live, None, 8, 16) == (16, 16, 32)
    assert TP._check_lattice("k", live, (16, 16, 32), 4, 128) == (16, 16, 32)
    for brick, nb in ((10, 1), (3, 1), (1, 8192), (16, 2)):
        with pytest.raises(ValueError, match="brick"):
            TP._check_lattice("k", live, (16, 16, 32) if brick != 10
                              else (10, 10, 10), brick, nb)
    with pytest.raises(ValueError, match="does not match"):
        TP._check_lattice("k", live, None, 8, 15)


def k4_inputs(rng):
    """tests/test_trilerp_pallas.py:15-31: brick-coherent samples of a
    white-noise 32³ volume, some outside it."""
    R, NB, V = 32, 16, 512
    live = rng.randn(R, R, R).astype(np.float32)
    w = np.zeros((3, NB, V), np.float32)
    g = np.stack(np.meshgrid(*([np.arange(8)] * 3), indexing="ij"), -1)
    for b in range(NB):
        o = rng.rand(3) * (R - 12) + 1
        pos = o + g.reshape(-1, 3) + rng.randn(V, 3) * 0.7
        w[:, b] = pos.T
    w[0, 0, :5] = -2.0
    w[1, 1, 7] = R + 3.0
    w[:, 2, 0] = R - 1.0  # exactly on the far corner
    return live, w


def test_k4_twin_matches_pallas_interpret(rng):
    live, w = k4_inputs(rng)
    jv, jvalid, jesc = (np.asarray(a) for a in JP.trilerp_bricks(
        jnp.asarray(live), *(jnp.asarray(c) for c in w), group=1,
        interpret=True, precise=True))
    tv, tvalid, tesc = (a.numpy() for a in TP.trilerp_bricks(
        T(live), *(T(c) for c in w)))
    assert not tesc.any()
    assert (~tvalid).sum() >= 6 and tvalid[2, 0]
    np.testing.assert_array_equal(tvalid, jvalid | jesc)
    ok = jvalid & ~jesc
    assert ok.mean() > 0.9
    np.testing.assert_allclose(tv[ok], jv[ok],
                               atol=2.0 ** -16 * np.abs(live).max())
    # the twin is the update's exact trilerp, including clamped samples
    want, want_ok = TP.trilinear_c(T(live), *(T(c) for c in w))
    assert torch.equal(T(tv), want) and torch.equal(T(tvalid), want_ok)
    assert TP.trilerp_bricks_supported(live.shape, 8)
    assert TP.trilerp_bricks_supported((14, 23, 35), 8)


@pytest.mark.parametrize("fixture", [mip_fixture, tearing_fixture])
def test_update_without_cache_matches_pallas(rng, fixture):
    """update_tsdf_nonrigid(use_kernels=True) without caches (K3's twin)
    against JAX's Pallas path without caches (its K3 in interpret mode)."""
    fx = fixture(rng)
    kw = dict(k=fx["k"], tdist=fx["tdist"], wmax=100.0, brick=8,
              n_candidates=fx["C"])
    want_v, want_w, _, want_risk = JW.update_tsdf_nonrigid(
        *(jnp.asarray(fx[n]) for n in ("values", "weights", "live")),
        fx["wf"], jnp.asarray(fx["lw"]), use_pallas=True,
        pallas_interpret=True, pallas_precise=True, **kw)
    got_v, got_w, esc, got_risk = TW.update_tsdf_nonrigid(
        *(T(fx[n]) for n in ("values", "weights", "live")),
        to_port(fx["wf"]), T(fx["lw"]), use_kernels=True, **kw)
    assert int(esc) == 0 and int(got_risk) == int(want_risk)
    _, (_, selw, _) = jax_caches(fx)
    m = vol_from_bricks(T(ieee_mask(selw)), fx["shape"], 8).numpy()
    # tests/test_torch_tsdf_update.py's bound
    np.testing.assert_allclose(got_v.numpy()[m], np.asarray(want_v)[m],
                               atol=3e-3)
    np.testing.assert_allclose(got_w.numpy()[m], np.asarray(want_w)[m],
                               atol=3e-3)


@pytest.mark.parametrize("cached", [False, True])
def test_padded_canonical_unpadded_live_matches_jax(rng, cached):
    """A canonical lattice padded to the brick over a smaller live volume,
    as Fusion.updateTSDF hands them over: the kernel path's twins (K2 with
    a cache, K3 without) against JAX's XLA path. The in-volume test and
    the taps follow the live shape."""
    fx = mip_fixture(rng)
    live = fx["live"][:29, :27, :121]
    (cand, risk), wc = jax_caches(fx)
    kw = dict(k=fx["k"], tdist=fx["tdist"], wmax=100.0, brick=8,
              n_candidates=fx["C"], cand_cache=(cand, risk))
    want_v, want_w, _, _ = JW.update_tsdf_nonrigid(
        jnp.asarray(fx["values"]), jnp.asarray(fx["weights"]),
        jnp.asarray(live), fx["wf"], jnp.asarray(fx["lw"]),
        warp_cache=wc if cached else None, **kw)
    kw["cand_cache"] = (T(cand).long(), T(risk))
    got_v, got_w, _, _ = TW.update_tsdf_nonrigid(
        T(fx["values"]), T(fx["weights"]), T(live), to_port(fx["wf"]),
        T(fx["lw"]), use_kernels=True,
        warp_cache=tuple(T(a) for a in wc) if cached else None, **kw)
    m = vol_from_bricks(T(ieee_mask(wc[1])), fx["shape"], 8).numpy()
    changed = np.asarray(want_w) != fx["weights"]
    assert changed[m].any() and (~changed[m]).any()
    np.testing.assert_allclose(got_v.numpy()[m], np.asarray(want_v)[m],
                               atol=3e-3)
    np.testing.assert_allclose(got_w.numpy()[m], np.asarray(want_w)[m],
                               atol=3e-3)
