"""Parity of the port's non-rigid TSDF update
(dynamicfusion_body_tpu_torch.models.warp_field.update_tsdf_nonrigid)
with the JAX package's, through the plain path and through the K2 kernel
(its CPU twin here; the JAX kernel in interpret mode). Fixtures follow
tests/test_trilerp_escape.py and live in test_torch_warp_trilerp.py."""

import numpy as np
import jax.numpy as jnp
import pytest

from dynamicfusion_body_tpu.models import warp_field as JW
from dynamicfusion_body_tpu_torch.models import warp_field as TW
from dynamicfusion_body_tpu_torch.ops.bricks import vol_from_bricks
from test_torch_warp_trilerp import (
    T, ieee_mask, jax_caches, mip_fixture, tearing_fixture, to_port)


@pytest.mark.parametrize("fixture", [mip_fixture, tearing_fixture])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_update_tsdf_nonrigid_matches_jax(rng, fixture, use_kernels):
    fx = fixture(rng)
    (cand, risk), wc = jax_caches(fx)
    kw = dict(k=fx["k"], tdist=fx["tdist"], wmax=100.0, brick=8,
              n_candidates=fx["C"])
    args = [jnp.asarray(fx[n]) for n in ("values", "weights", "live")]
    want_v, want_w, _, _ = JW.update_tsdf_nonrigid(
        *args, fx["wf"], jnp.asarray(fx["lw"]), use_pallas=use_kernels,
        pallas_interpret=True, pallas_precise=True, cand_cache=(cand, risk),
        warp_cache=wc, **kw)
    got_v, got_w, esc, pool_risk = TW.update_tsdf_nonrigid(
        *(T(fx[n]) for n in ("values", "weights", "live")),
        to_port(fx["wf"]), T(fx["lw"]), use_kernels=use_kernels,
        cand_cache=(T(cand).long(), T(risk)),
        warp_cache=tuple(T(a) for a in wc), **kw)
    assert int(esc) == 0 and int(pool_risk) == int(risk)
    m = vol_from_bricks(T(ieee_mask(wc[1])), fx["shape"],
                        8).numpy()
    assert m.mean() > 0.5
    # tests/test_trilerp_escape.py's bound for the kernel path
    np.testing.assert_allclose(got_v.numpy()[m], np.asarray(want_v)[m],
                               atol=3e-3)
    np.testing.assert_allclose(got_w.numpy()[m], np.asarray(want_w)[m],
                               atol=3e-3)


def test_update_without_caches_builds_them(rng):
    """No cand/warp cache: the port builds both (the JAX package's
    uncached per-voxel top-k computes the same selection)."""
    fx = mip_fixture(rng)
    kw = dict(k=3, tdist=fx["tdist"], wmax=100.0, brick=8, n_candidates=8)
    want_v, want_w, _, want_risk = JW.update_tsdf_nonrigid(
        *(jnp.asarray(fx[n]) for n in ("values", "weights", "live")),
        fx["wf"], jnp.asarray(fx["lw"]), **kw)
    got_v, got_w, _, got_risk = TW.update_tsdf_nonrigid(
        *(T(fx[n]) for n in ("values", "weights", "live")),
        to_port(fx["wf"]), T(fx["lw"]), **kw)
    assert int(got_risk) == int(want_risk)
    (cand, _), (sel, selw, _) = jax_caches(fx)
    m = vol_from_bricks(T(ieee_mask(selw)), fx["shape"],
                        8).numpy()
    np.testing.assert_allclose(got_v.numpy()[m], np.asarray(want_v)[m],
                               atol=3e-3)
    np.testing.assert_allclose(got_w.numpy()[m], np.asarray(want_w)[m],
                               atol=3e-3)
