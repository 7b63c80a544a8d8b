"""The solve tools of the port (dynamicfusion_body_tpu_torch/tools:
profile_solve5, exp_freeze, exp_solver) and the residuals they call by
the JAX names, on the CPU:

* ``data_residual_one`` / ``reg_residual_one`` and their ``jacfwd``
  Jacobians against the JAX package's on seeded inputs (atol 1e-5), one
  vertex / pair at a time under ``vmap`` as both solvers call them;
* each tool at ``--res 32 --device cpu --reps 1`` (exp_freeze's problem
  cut with the lattice, exp_solver's chain at 2 frames and one arm):
  every row it reports finite.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from dynamicfusion_body_tpu.solvers import nonrigid as JN
from dynamicfusion_body_tpu_torch.solvers import nonrigid as TN
from dynamicfusion_body_tpu_torch.tools import (
    exp_freeze, exp_solver, profile_solve5)

torch.set_num_threads(1)

ATOL = 1e-5


def dqs(rng, *shape):
    q = (rng.randn(*shape, 8) * 0.05).astype(np.float32)
    q[..., 0] += 1.0
    return q


def test_residuals_and_jacobians_match_jax(rng):
    V, P, k = 64, 48, 3
    dqs_k = dqs(rng, V, k)
    vert = rng.randn(V, 3).astype(np.float32)
    normal = rng.randn(V, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    corr = vert + 0.05 * rng.randn(V, 3).astype(np.float32)
    wts = rng.rand(V, k).astype(np.float32)
    lw = dqs(rng)
    dq_i, dq_j = dqs(rng, P), dqs(rng, P)
    vj = rng.randn(P, 3).astype(np.float32)
    scale = rng.rand(P).astype(np.float32)

    def jdata(d, v, n, c, w):
        f = lambda dd: JN.data_residual_one(dd, v, n, c, w, jnp.asarray(lw))
        return f(d), jax.jacfwd(f)(d)

    jr, jJ = jax.vmap(jdata)(*(jnp.asarray(a) for a in (dqs_k, vert,
                                                         normal, corr, wts)))

    def tdata(d, v, n, c, w):
        f = lambda dd: TN.data_residual_one(dd, v, n, c, w,
                                            torch.from_numpy(lw))
        return f(d), jacfwd(f)(d)

    tr, tJ = vmap(tdata)(*(torch.from_numpy(a) for a in (dqs_k, vert,
                                                         normal, corr, wts)))
    assert tJ.shape == (V, k, 8)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), atol=ATOL)

    def jreg(a, b, v, s):
        return (JN.reg_residual_one(a, b, v, s),
                jax.jacfwd(JN.reg_residual_one, argnums=(0, 1))(a, b, v, s))

    rr, (jJi, jJj) = jax.vmap(jreg)(*(jnp.asarray(a) for a in (dq_i, dq_j,
                                                              vj, scale)))

    def treg(a, b, v, s):
        return (TN.reg_residual_one(a, b, v, s),
                jacfwd(TN.reg_residual_one, argnums=(0, 1))(a, b, v, s))

    tr_r, (tJi, tJj) = vmap(treg)(*(torch.from_numpy(a) for a in (
        dq_i, dq_j, vj, scale)))
    assert tJi.shape == (P, 3, 8)
    np.testing.assert_allclose(tr_r.numpy(), np.asarray(rr), atol=ATOL)
    np.testing.assert_allclose(tJi.numpy(), np.asarray(jJi), atol=ATOL)
    np.testing.assert_allclose(tJj.numpy(), np.asarray(jJj), atol=ATOL)


def test_solver_jacobians_are_the_residuals_jacobians(rng):
    """``_data_jacobians`` / ``_reg_jacobians`` (the solver's) are the
    Jacobians of ``data_residual_one`` / ``reg_residual_one``."""
    M, V, k = 16, 40, 3
    x = torch.from_numpy(dqs(rng, M))
    verts = torch.from_numpy(rng.randn(V, 3).astype(np.float32))
    nbr = torch.from_numpy(rng.randint(0, M, (V, k)))
    wts = torch.from_numpy(rng.rand(V, k).astype(np.float32))
    lw = torch.from_numpy(dqs(rng))
    data = (verts, verts / verts.norm(dim=1, keepdim=True), verts + 0.01,
            torch.ones(V, dtype=torch.bool), nbr, wts)
    r, J = TN._data_jacobians(x, data, lw)
    want = vmap(jacfwd(TN.data_residual_one),
                in_dims=(0, 0, 0, 0, 0, None))(x[nbr], *data[:3], wts, lw)
    assert torch.equal(J, want)
    assert torch.equal(r, TN.data_residual_one(x[nbr], *data[:3], wts, lw))
    pair_i = torch.arange(M).repeat_interleave(k)
    pair_j = nbr[:M * k // 3].reshape(-1)[:M * k]
    pv = torch.from_numpy(rng.randn(M * k, 3).astype(np.float32))
    ps = torch.from_numpy(rng.rand(M * k).astype(np.float32))
    reg = (pair_i, pair_j, pv, ps, torch.ones(M * k, dtype=torch.bool))
    r_r, Ji, Jj = TN._reg_jacobians(x, reg)
    wi, wj = vmap(jacfwd(TN.reg_residual_one, argnums=(0, 1)))(
        x[pair_i], x[pair_j], pv, ps)
    assert torch.equal(Ji, wi) and torch.equal(Jj, wj)
    assert torch.equal(r_r, TN.reg_residual_one(x[pair_i], x[pair_j], pv,
                                                ps))


def finite(rows):
    vals = [r["wall_ms"] for r in rows.values()]
    return len(vals) > 0 and all(math.isfinite(v) and v > 0 for v in vals)


def test_profile_solve5_rows():
    rows = profile_solve5.main(["--res", "32", "--device", "cpu", "--reps",
                                "1"])
    assert set(rows) == {
        "make_block_ell_dict", "residual_pass", "jacobian_pass_24tangent",
        "solve_8gn16cg_inline_ell", "solve_1gn16cg_inline_ell",
        "solve_8gn16cg_prebuilt_ell", "solve_1gn16cg_prebuilt_ell",
        "solve_8gn16cg_prebuilt_ctx", "solve_1gn16cg_prebuilt_ctx",
        "assembly_gather64_reduce", "corr_rerank_cached",
        "warp_points_mesh"}
    assert finite(rows)


def test_exp_freeze_rows():
    rows = exp_freeze.main(["--res", "32", "--device", "cpu", "--reps",
                            "1"])
    assert len(rows) == 7 and finite(rows)


def test_exp_solver_rows():
    out = exp_solver.main(["--res", "32", "--device", "cpu", "--reps", "1",
                           "--frames", "2", "--arm", "gn2_cg16"])
    assert set(out.rows) == {f"solve_8gn_{cg}cg_flat_exit"
                             for cg in (16, 8, 2)}
    assert finite(out.rows)
    (chain,) = out.chain.values()
    assert math.isfinite(chain["ms"]) and len(chain["walls"]) == 2
    (acc,) = out.acc.values()
    assert all(math.isfinite(v) for v in acc.values())
    assert acc["cost"] > 0
