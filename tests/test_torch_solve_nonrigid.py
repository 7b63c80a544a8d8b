"""Parity of the port's ``solve_nonrigid`` (solvers/nonrigid.py) with the
JAX package's on the tests/test_solvers.py fixture, over the arguments the
wrapper takes: the defaults, the TPU layout promise ``dense_pairs`` (ignored
by the port), a warm-started damping, and another damping and ftol."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.solvers import nonrigid as JN
from dynamicfusion_body_tpu_torch.solvers import nonrigid as TN
from test_torch_solvers import T, _problem

# One intra-op thread (see tests/test_torch_solvers.py)
torch.set_num_threads(1)

OPTIONS = {
    "default": {},
    "dense_pairs": dict(dense_pairs=True),
    "warm_damping": dict(damping_init=1e-2),
    "damping_ftol": dict(damping=1e-3, ftol=1e-4),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_solve_nonrigid_matches_jax(rng, name):
    opts = OPTIONS[name]
    x0, data, reg, _ = _problem(rng, 0.15)
    lw = np.array([1.0, 0, 0, 0, 0, 0, 0, 0], np.float32)
    want = JN.solve_nonrigid(
        jnp.asarray(x0), *(jnp.asarray(a) for a in data),
        *(jnp.asarray(a) for a in reg), jnp.asarray(lw), gn_iters=8,
        cg_iters=32, **opts)
    td = tuple(T(a).long() if i == 4 else T(a) for i, a in enumerate(data))
    tr = (T(reg[0]).long(), T(reg[1]).long()) + tuple(map(T, reg[2:]))
    got = TN.solve_nonrigid(T(x0), *td, *tr, T(lw), gn_iters=8, cg_iters=32,
                            **opts)
    # the initial costs are the same residuals' f32 sums
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    # the final cost: CG sums in another order steer to the same optimum
    # (tests/test_torch_solvers.py's tolerance)
    c0 = float(want[2])
    assert float(got[3]) < 0.05 * c0
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-3,
                               atol=1e-4 * c0)
    assert int(got[5]) == int(want[5]) == 0
    # the same accept/reject sequence leaves the same LM damping
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)
    n_act = int(np.sum(np.asarray(reg[4]).reshape(len(x0), -1).any(1)))
    np.testing.assert_allclose(got[0].numpy()[:n_act],
                               np.asarray(want[0])[:n_act], atol=2e-2)

