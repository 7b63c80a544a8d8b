"""Where the GN solve's time goes, and what a step on frozen JᵀWJ blocks
costs — the port of ``tools/exp_freeze.py``.

On the JAX tool's synthetic problem (``exp_freeze.py:37-59``: M = 4096
nodes, V = 32768 vertices, k = 3 neighbours, P = M·k reg pairs; random
points in [-1, 1]³, unit normals, correspondences 0.01 off, 95% valid,
random neighbours and blend weights, node DQs 0.01 off the identity, all
from ``RandomState(0)``), each row times one part of a GN step:

* ``residuals+energies``: data and reg residuals, raw and huberized cost;
* ``jacfwd_build(data+reg)``: the per-vertex and per-pair Jacobians,
  ``jacfwd`` of ``data_residual_one``/``reg_residual_one`` under ``vmap``;
* ``rhs_index_add(jacfwd+index_add_)``: the GN right-hand side as the
  solver forms it, the Jacobians' weighted residuals summed onto the
  nodes by ``index_add_`` (JAX's segment-sum reducers);
* ``vjp_gradient(both terms)``: the same right-hand side by one reverse
  pass (``torch.func.vjp``) of each term, without Jacobians: the
  frozen-step path;
* ``jacfwd+contrib+reduce_ell(assembly)``: Jacobians, JᵀWJ contribution
  rows and their sum into the block-ELL slots;
* ``precond_build+CG16(assembled)``: the block-Jacobi preconditioner and
  16 PCG steps on blocks assembled once (``pcg_solve``);
* ``full_solve gn8 cg16``: ``gn_solve_core`` at gn 8, cg 16.

The JAX tool runs each part 32 times inside one jitted loop to take the
dispatch out; here each row is one eager call, the median synced wall
and the CUDA-event mean (``tools/_timing.py:Timer``), with the busy
share under ``--trace DIR``. ``--res`` scales the problem with the
surface, M = 4096·(res/256)² (at least 64) and V = 8·M, so that the
default 256 is the JAX tool's size and a CPU test can cut it.

    python -m dynamicfusion_body_tpu_torch.tools.exp_freeze
    python -m dynamicfusion_body_tpu_torch.tools.exp_freeze \\
        --device cpu --res 32 --reps 1
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vjp

from ..ops.losses import huber_irls_weight
from ..pipeline.fusion import resolve_device
from ..solvers import nonrigid as NR
from ._timing import Timer, device_label, parse_args

K = 3


def problem(M: int, V: int, dev: torch.device):
    """``exp_freeze.py:37-59`` at (M, V): (node_dq0, lw, data_args,
    reg_args) on ``dev``."""
    P = M * K
    rng = np.random.RandomState(0)
    verts = rng.rand(V, 3).astype(np.float32) * 2 - 1
    normals = rng.randn(V, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    corrs = verts + (0.01 * rng.randn(V, 3)).astype(np.float32)
    corr_mask = rng.rand(V) < 0.95
    nbr_idx = rng.randint(0, M, (V, K))
    blend_wts = rng.rand(V, K).astype(np.float32)
    pair_i = np.repeat(np.arange(M), K)
    pair_j = rng.randint(0, M, P)
    pair_v = rng.rand(P, 3).astype(np.float32)
    pair_scale = np.full(P, 0.7, np.float32)
    node_dq0 = (np.tile(np.array([1, 0, 0, 0, 0, 0, 0, 0], np.float32),
                        (M, 1))
                + (0.01 * rng.randn(M, 8)).astype(np.float32))

    def t(a):
        return torch.as_tensor(a, device=dev)

    data_args = (t(verts), t(normals), t(corrs.astype(np.float32)),
                 t(corr_mask), t(nbr_idx).long(), t(blend_wts))
    reg_args = (t(pair_i).long(), t(pair_j).long(), t(pair_v),
                t(pair_scale), torch.ones(P, dtype=torch.bool, device=dev))
    lw = torch.tensor([1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.float32,
                      device=dev)
    return t(node_dq0), lw, data_args, reg_args


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=8)
    dev = resolve_device(args.device)
    M = max(4096 * args.res * args.res // (256 * 256), 64)
    V = 8 * M
    x0, lw, data_args, reg_args = problem(M, V, dev)
    corr_mask, nbr_idx = data_args[3], data_args[4]
    pair_i, pair_j, _, _, pair_mask = reg_args
    print(f"# exp_freeze: M {M} V {V} k {K} P {M * K} on "
          f"{device_label(dev)}; reps {args.reps}", flush=True)
    t = Timer(dev, args.reps, args.trace)

    t("residuals+energies", lambda: NR._energies(
        *NR._residuals(x0, data_args, reg_args, lw)))

    def jacobians(x):
        r_d, J_d = NR._data_jacobians(x, data_args, lw)
        r_r, J_ri, J_rj = NR._reg_jacobians(x, reg_args)
        return r_d, J_d, r_r, J_ri, J_rj

    t("jacfwd_build(data+reg)", lambda: jacobians(x0))

    def weights(r_d, r_r):
        return (huber_irls_weight(r_d) * corr_mask,
                huber_irls_weight(r_r) * pair_mask[:, None])

    def rhs_index_add(x):
        # solvers/nonrigid.py:gn_solve_core's right-hand side
        r_d, J_d, r_r, J_ri, J_rj = jacobians(x)
        r_d = torch.where(corr_mask, r_d, 0.0)
        J_d = torch.where(corr_mask[:, None, None], J_d, 0.0)
        w_d, w_r = weights(r_d, r_r)
        g = torch.zeros_like(x)
        g.index_add_(0, nbr_idx.reshape(-1),
                     (J_d * (w_d * r_d)[:, None, None]).reshape(-1, 8))
        wrr = w_r * r_r
        g.index_add_(0, pair_i, torch.einsum("pc,pce->pe", wrr, J_ri))
        g.index_add_(0, pair_j, torch.einsum("pc,pce->pe", wrr, J_rj))
        return g

    def rhs_vjp(x):
        r_d, pull_d = vjp(lambda xx: NR._residuals(xx, data_args, reg_args,
                                                   lw)[0], x)
        r_r, pull_r = vjp(lambda xx: NR._residuals(xx, data_args, reg_args,
                                                   lw)[1], x)
        w_d, w_r = weights(r_d, r_r)
        return pull_d(w_d * r_d)[0] + pull_r(w_r * r_r)[0]

    t("rhs_index_add(jacfwd+index_add_)", lambda: rhs_index_add(x0))
    t("vjp_gradient(both terms)", lambda: rhs_vjp(x0))

    reduce_ell, ell_nbr, self_ids, present, _ = NR.make_block_ell(
        nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M, NR.ELL_DEGREE_CAP)

    def build_blocks(x):
        r_d, J_d, r_r, J_ri, J_rj = jacobians(x)
        J_d = torch.where(corr_mask[:, None, None], J_d, 0.0)
        pm = pair_mask[:, None, None]
        J_ri, J_rj = torch.where(pm, J_ri, 0.0), torch.where(pm, J_rj, 0.0)
        w_d, w_r = weights(r_d, r_r)
        return reduce_ell(NR.jtwj_contributions(J_d, w_d, J_ri, J_rj, w_r))

    t("jacfwd+contrib+reduce_ell(assembly)", lambda: build_blocks(x0))

    blocks = build_blocks(x0)
    DC = ell_nbr.shape[0] // M
    Bl = blocks.reshape(M, DC, 8, 8)
    blk = (blocks[self_ids] * present[:, None]).reshape(M, 8, 8)
    g = torch.Generator(device=dev).manual_seed(0)
    rhs0 = torch.rand((M, 8), generator=g, device=dev)
    lam = torch.tensor(1e-4, device=dev)
    t("precond_build+CG16(assembled)", lambda: NR.pcg_solve(
        Bl, blk, ell_nbr, rhs0, lam, 16))
    t("full_solve gn8 cg16", lambda: NR.gn_solve_core(
        x0, data_args, reg_args, lw, 8, 16, 1e-4, 1e-5))
    return t.rows


if __name__ == "__main__":
    main()
