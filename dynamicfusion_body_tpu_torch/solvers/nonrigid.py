"""Non-rigid warp-field solver: block-sparse Gauss-Newton with PCG.

Counterpart of ``dynamicfusion_body_tpu/solvers/nonrigid.py``; it replaces
the reference's scipy ``least_squares(computef, …, loss='huber')``
(core/fusion.py:382-392). The energy has the terms of ``computef``
(core/fusion.py:459-491):

* data: per vertex with a correspondence c_i, r_i = n_i^w·(v_i^w − c_i),
  v^w/n^w DQB-skinned by k nodes (Gaussian weights fixed in the solve),
  then by the global pose ``lw``;
* regularization: per node pair (i, j ∈ kNN of node i's anchor vertex),
  r_ij = rw·max(w_i, w_j)·(W_{dq_i}(v_j) − W_{dq_j}(v_j)) ∈ R³.

Robustification is IRLS with scipy-style huber weights (f_scale = 1).
Per-residual Jacobians are dense blocks from ``torch.func.jacfwd`` under
``vmap``. JᵀWJ is assembled into an (M, D, 8, 8) block-ELL table (D =
``ELL_DEGREE_CAP`` couplings per node; overflow is counted, never silent)
and solved by block-Jacobi PCG inside a Levenberg-Marquardt trust loop:
a rejected step retries with 10× damping on the same blocks, an accepted
one relaxes damping 3×, and a rejection within ``FLAT_FACTOR·ftol`` of
the current energy ends the retries (the solve is at an optimum). The
assembled blocks are frozen until the energy has dropped by
``FREEZE_FRAC`` since the last assembly; a step that fails on frozen
blocks forces a rebuild instead of ending the round. GN stops once a
step's relative reduction falls below ``ftol`` (scipy's ftol).

The TPU workarounds of the JAX package are written in their direct form:
the sorted-segment cumsum reducers are ``index_add_``, the argsort +
searchsorted slot dictionary is ``unique`` + ``bincount``, and
``lax.while_loop``/``lax.cond`` are Python loops whose predicates are read
on the host (one sync per GN step and LM try).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..ops.dualquat import dq_normalize8, dq_transform_normal, dq_transform_point
from ..ops.losses import huber_irls_weight
from ..utils.profiling import host_read, span, traced

# LM retries per GN round: base damping 1e-4 escalates through 1e-3 … 1e-1.
MAX_LM_RETRIES = 4
# The reference's regularization-relaxation schedule (core/fusion.py:405-412).
RELAX_DIV = 8.0
RELAX_LO = 0.05
RELAX_HI = 0.9
ELL_DEGREE_CAP = 24  # 2× the measured bench max coupling degree (12)
FREEZE_FRAC = 0.25   # rebuild the frozen JᵀWJ blocks after this energy drop
FLAT_FACTOR = 100.0  # a rejection within FLAT_FACTOR·ftol is "flat"


def relaxation_step(cost_before, cost_after, rw):
    """One step of the reference's relaxation schedule: (continue, rw')."""
    cb = torch.as_tensor(cost_before, dtype=torch.float32)
    reduct = (cost_before - cost_after) / torch.clamp_min(cb, 1e-30)
    relax = (reduct > RELAX_LO) & (reduct < RELAX_HI)
    rw = torch.as_tensor(rw, dtype=torch.float32, device=relax.device)
    return relax, torch.where(relax, rw / RELAX_DIV, rw)


def _inv8_spd(D):
    """Batched (M, n, n) inverse by Gauss-Jordan without pivoting — the
    preconditioner blocks are SPD (normal blocks + λI), which never need
    pivoting."""
    n = D.shape[-1]
    eye = torch.eye(n, dtype=D.dtype, device=D.device).expand(D.shape)
    aug = torch.cat([D, eye], dim=-1)
    for i in range(n):
        piv = aug[:, i:i + 1, :] / aug[:, i:i + 1, i:i + 1]
        aug = aug - aug[:, :, i:i + 1] * piv
        aug[:, i, :] = piv[:, 0, :]
    return aug[:, :, n:]


def data_residual_one(dqs_k, vert, normal, corr, wts_k, lw_dq):
    """Point-to-plane data residual (JAX ``data_residual_one``): dqs_k
    (...,k,8), vert/normal/corr (...,3), wts_k (...,k) → (...); one
    vertex, or a batch of them."""
    se3 = dq_normalize8(torch.sum(wts_k[..., None] * dqs_k, dim=-2))
    p = dq_transform_point(lw_dq, dq_transform_point(se3, vert))
    n = dq_transform_normal(lw_dq, dq_transform_normal(se3, normal))
    return torch.sum(n * (p - corr), dim=-1)


def reg_residual_one(dq_i, dq_j, vj, scale):
    """Regularization residual (JAX ``reg_residual_one``) (...,3); one
    pair, or a batch of them."""
    return scale[..., None] * (dq_transform_point(dq_i, vj)
                               - dq_transform_point(dq_j, vj))


def _rho(z):
    # scipy huber with f_scale=1, per scalar residual component
    return torch.where(z <= 1.0, z,
                       2.0 * torch.sqrt(torch.clamp_min(z, 1.0)) - 1.0)


def _residuals(node_dq, data_args, reg_args, lw_dq):
    verts, normals, corrs, corr_mask, nbr_idx, blend_wts = data_args
    pair_i, pair_j, pair_v, pair_scale, pair_mask = reg_args
    r_d = data_residual_one(node_dq[nbr_idx], verts, normals, corrs,
                            blend_wts, lw_dq)
    r_d = torch.where(corr_mask, r_d, 0.0)
    r_r = reg_residual_one(node_dq[pair_i], node_dq[pair_j], pair_v,
                           pair_scale)
    r_r = torch.where(pair_mask[:, None], r_r, 0.0)
    return r_d, r_r


def _ident(x):
    return x


def _energies(r_d, r_r, psum=_ident):
    """(raw, huberized) total costs 0.5·Σr² and 0.5·Σρ(r²). The data
    term may be vertex-sharded: ``psum`` folds it over the ranks (the reg
    term is replicated)."""
    zd, zr = r_d ** 2, r_r ** 2
    raw = 0.5 * (psum(torch.sum(zd)) + torch.sum(zr))
    rob = 0.5 * (psum(torch.sum(_rho(zd))) + torch.sum(_rho(zr)))
    return raw, rob


def nonrigid_energy(node_dq, data_args, reg_args, lw_dq, robust: bool = True):
    """0.5·Σρ(r²) (``robust=False``: the raw 0.5·Σr² the reference prints
    as "cost before optimization", core/fusion.py:375-376)."""
    raw, rob = _energies(*_residuals(node_dq, data_args, reg_args, lw_dq))
    return rob if robust else raw


def _coupling_keys(nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M: int):
    """JᵀWJ coupling key a·M + b of every contribution, M² where invalid —
    in assembly order: k² data chunks (ka, kb) of V vertices each, then
    the 4 reg combos (ii, ij, ji, jj) of P pairs each."""
    k = nbr_idx.shape[1]
    a = torch.cat([nbr_idx[:, ka] for ka in range(k) for _ in range(k)]
                  + [pair_i, pair_i, pair_j, pair_j])
    b = torch.cat([nbr_idx[:, kb] for _ in range(k) for kb in range(k)]
                  + [pair_i, pair_j, pair_i, pair_j])
    valid = torch.cat([corr_mask.repeat(k * k), pair_mask.repeat(4)])
    return torch.where(valid, a * M + b, M * M)


def _lookup(slot_key, keys):
    """Slot holding each key in the dictionary ``slot_key``, -1 if none."""
    sk, order = torch.sort(slot_key)
    pos = torch.clamp_max(torch.searchsorted(sk, keys), sk.numel() - 1)
    hit = sk[pos] == keys
    return torch.where(hit, order[pos], -1)


class EllDict(NamedTuple):
    """Block-ELL slot dictionary: slot m·D + d holds node m's d-th
    coupling, in ascending coupled-node order."""

    slot_key: torch.Tensor   # (M·D,) coupling key per slot (M² = empty)
    ell_nbr: torch.Tensor    # (M·D,) coupled node per slot (0 where empty)
    self_ids: torch.Tensor   # (M,) slot of each diagonal block
    present: torch.Tensor    # (M,) the diagonal block exists
    n_overflow: torch.Tensor  # contributions beyond the degree cap D


def make_ell_dict(nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M: int,
                  D: int) -> EllDict:
    """The slot dictionary of the coupling graph. Couplings beyond a
    node's first D (by coupled-node id) get no slot; their contributions
    are counted in ``n_overflow`` and left out of the assembly, which
    under-assembles the CG operator but never corrupts it (every step is
    still accepted on exact energies)."""
    big = M * M
    keys = _coupling_keys(nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M)
    # the sizes of unique's output, of each boolean index and of bincount's
    # (its largest value) are read on the host
    with host_read():
        uniq, counts = torch.unique(keys, return_counts=True)
    with host_read(2):
        counts = counts[uniq < big]
        uniq = uniq[uniq < big]
    node = uniq // M
    with host_read(2):
        per_node = torch.bincount(node, minlength=M)
    d_slot = (torch.arange(uniq.numel(), device=uniq.device)
              - (torch.cumsum(per_node, 0) - per_node)[node])
    keep = d_slot < D
    with host_read(2):
        slot = node[keep] * D + d_slot[keep]
    slot_key = torch.full((M * D,), big, dtype=keys.dtype, device=keys.device)
    with host_read():
        slot_key[slot] = uniq[keep]
    ell_nbr = torch.zeros_like(slot_key)
    with host_read():
        ell_nbr[slot] = uniq[keep] % M
    self_slot = _lookup(slot_key, torch.arange(M, device=keys.device) * (M + 1))
    with host_read():
        n_overflow = torch.sum(counts[~keep])
    return EllDict(slot_key, ell_nbr, torch.clamp_min(self_slot, 0),
                   self_slot >= 0, n_overflow)


def make_block_ell(nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M: int,
                   D: int):
    """(reduce_ell, ell_nbr, self_ids, self_present, n_overflow):
    ``reduce_ell`` sums contribution rows (T, 64), given in
    ``_coupling_keys`` order, into their ELL slots → (M·D, 64) by
    ``index_add_``; the rest is the :class:`EllDict`."""
    ell = make_ell_dict(nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M, D)
    keys = _coupling_keys(nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M)
    slot = _lookup(ell.slot_key, keys)
    slot = torch.where(keys < M * M, slot, -1)
    with host_read():
        rows = torch.nonzero(slot >= 0).flatten()
    slots = slot[rows]

    def reduce_ell(contrib):
        out = contrib.new_zeros((M * D, contrib.shape[1]))
        return out.index_add_(0, slots, contrib[rows])

    return reduce_ell, ell.ell_nbr, ell.self_ids, ell.present, ell.n_overflow


def make_block_ell_sharded(ell_dict: EllDict, nbr_idx, corr_mask, pair_i,
                           pair_j, pair_mask, M: int, psum, n_dev: int):
    """:func:`make_block_ell` for a vertex shard (JAX
    ``solvers/nonrigid.py:make_block_ell_sharded``): ``ell_dict`` is the
    slot dictionary of the GLOBAL coupling graph (:func:`make_ell_dict`
    on every rank's vertices, the same on every rank); this rank sums its
    local contributions into those global slots and ``psum`` (the
    all-reduce over the ``n_dev`` ranks) finishes the table, so
    ``reduce_ell`` returns the global (M·D, 64) blocks. The reg
    contributions, which every rank computes whole, are scaled by
    1/n_dev before the sum (exact for a power-of-two rank count, as in
    the JAX package). Local couplings the degree cap left out of the
    dictionary match no slot; the overflow count is the dictionary's,
    taken on the global key multiset."""
    keys = _coupling_keys(nbr_idx, corr_mask, pair_i, pair_j, pair_mask, M)
    slot = _lookup(ell_dict.slot_key, keys)
    slot = torch.where(keys < M * M, slot, -1)
    rows = torch.nonzero(slot >= 0).flatten()
    slots = slot[rows]
    n_data = nbr_idx.shape[0] * nbr_idx.shape[1] ** 2
    scale = torch.where(rows < n_data, 1.0, 1.0 / n_dev)[:, None]
    D = ell_dict.slot_key.numel() // M

    def reduce_ell(contrib):
        out = contrib.new_zeros((M * D, contrib.shape[1]))
        return psum(out.index_add_(0, slots, contrib[rows] * scale))

    return (reduce_ell, ell_dict.ell_nbr, ell_dict.self_ids,
            ell_dict.present, ell_dict.n_overflow)


class SolverCtx(NamedTuple):
    """Frame-constant solver plumbing shared by every relaxation round:
    the ``make_block_ell`` tuple of the frame's coupling graph. It is built
    with the mesh valid mask (a superset of every round's correspondence
    mask); vertices without a correspondence carry zero Jacobians, so the
    assembled table equals one built from the round's own mask. The
    data- and reg-term segment sums need no plumbing in the direct
    (``index_add_``) form. A vertex-sharded solve passes
    ``SolverCtx(make_block_ell_sharded(...))``."""

    ell: tuple


def make_solver_ctx(nbr_idx, valid_mask, pair_i, pair_j, pair_mask, M: int,
                    D: int | None = None) -> SolverCtx:
    """The frame's :class:`SolverCtx`; ``D`` defaults to the module's
    ``ELL_DEGREE_CAP`` as it is at the call (``tools/diag_config7.py
    --ell-cap`` raises it for one arm)."""
    D = ELL_DEGREE_CAP if D is None else D
    return SolverCtx(make_block_ell(nbr_idx, valid_mask, pair_i, pair_j,
                                    pair_mask, M, D))


def make_reg_pairs(node_vert_idx, nbr_idx, node_w, active, rw):
    """Regularization pairs (core/fusion.py:475-484): node i couples to
    the kNN nodes of its anchor vertex, scale rw·max(w_i, w_j). Returns
    (pair_i, pair_j, pair_scale, pair_mask) with P = M·k rows."""
    M, k = active.shape[0], nbr_idx.shape[1]
    pair_i = torch.arange(M, device=nbr_idx.device).repeat_interleave(k)
    pair_j = nbr_idx[node_vert_idx].reshape(-1)
    pair_scale = rw * torch.maximum(node_w[pair_i], node_w[pair_j])
    pair_mask = active[pair_i] & active[pair_j]
    return pair_i, pair_j, pair_scale, pair_mask


def _data_jacobians(x, data_args, lw_dq):
    """(r_d (V,), J_d (V,k,8)) — jacfwd per vertex under vmap."""
    verts, normals, corrs, _, nbr_idx, blend_wts = data_args

    def f(d, v, n, c, w):
        r = data_residual_one(d, v, n, c, w, lw_dq)
        return r, r

    J, r = vmap(jacfwd(f, has_aux=True))(x[nbr_idx], verts, normals, corrs,
                                         blend_wts)
    return r, J


def _reg_jacobians(x, reg_args):
    """(r_r (P,3), J_i (P,3,8), J_j (P,3,8))."""
    pair_i, pair_j, pair_v, pair_scale, _ = reg_args

    def f(di, dj, v, s):
        r = reg_residual_one(di, dj, v, s)
        return r, r

    (Ji, Jj), r = vmap(jacfwd(f, argnums=(0, 1), has_aux=True))(
        x[pair_i], x[pair_j], pair_v, pair_scale)
    return r, Ji, Jj


def jtwj_contributions(J_d, w_d, J_ri, J_rj, w_r):
    """The JᵀWJ contribution rows (T, 64) in ``_coupling_keys`` order:
    the k² data blocks (ka, kb) of every vertex, J_d (V, k, 8) weighted by
    w_d (V,), then the reg blocks ii, ij, ji, jj of every pair, J_ri/J_rj
    (P, 3, 8) weighted per component by w_r (P, 3)."""
    Jw = J_d * w_d[:, None, None]
    data = (Jw[:, :, None, :, None] * J_d[:, None, :, None, :])
    data = data.permute(1, 2, 0, 3, 4).reshape(-1, 64)

    def reg_outer(Jx, Jy):
        return torch.einsum("pc,pce,pcf->pef", w_r, Jx, Jy).reshape(-1, 64)

    return torch.cat([data, reg_outer(J_ri, J_ri), reg_outer(J_ri, J_rj),
                      reg_outer(J_rj, J_ri), reg_outer(J_rj, J_rj)])


def pcg_solve(Bl, blk, ell_nbr, rhs, lam, cg_iters: int):
    """``cg_iters`` steps of block-Jacobi PCG on (JᵀWJ + lam·I) x = rhs:
    Bl (M, D, 8, 8) the block-ELL table, blk (M, 8, 8) its diagonal
    blocks, ell_nbr (M·D,) the coupled node of each slot, rhs (M, 8)."""
    M, DC = Bl.shape[:2]
    Dinv = _inv8_spd(blk + lam * torch.eye(8, dtype=blk.dtype,
                                           device=blk.device))

    def precond(r):
        return torch.einsum("mab,mb->ma", Dinv, r)

    def matvec(p):
        pg = p[ell_nbr].reshape(M, DC, 8)
        return torch.einsum("mdab,mdb->ma", Bl, pg) + lam * p

    sol = torch.zeros_like(rhs)
    rvec = rhs
    z = precond(rhs)
    d = z
    rz = torch.sum(rhs * z)
    for _ in range(cg_iters):
        Ad = matvec(d)
        alpha = rz / torch.clamp_min(torch.sum(d * Ad), 1e-30)
        sol = sol + alpha * d
        rvec = rvec - alpha * Ad
        z = precond(rvec)
        rz_new = torch.sum(rvec * z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        d = z + beta * d
        rz = rz_new
    return sol


@traced("solve")
def gn_solve_core(node_dq, data_args, reg_args, lw_dq, gn_iters: int,
                  cg_iters: int, damping: float, ftol: float, psum=_ident,
                  damping_init=None, solver_ctx: SolverCtx | None = None):
    """Damped GN outer loop with a block-ELL JᵀWJ and block-Jacobi PCG
    (module docstring). ``data_args`` = (verts, normals, corrs, corr_mask,
    nbr_idx, blend_wts); ``reg_args`` = (pair_i, pair_j, pair_v,
    pair_scale, pair_mask). ``damping_init`` warm-starts the LM damping
    (default ``damping``, which stays the floor); ``solver_ctx`` shares one
    slot dictionary across rounds (built from this round's sparsity when
    omitted).

    ``psum`` is applied to every data-term reduction (the energies and the
    gradient): the identity on one device, the all-reduce over the ranks
    when the data arguments are a vertex shard (``parallel/sharded.py``),
    whose ``solver_ctx`` then holds :func:`make_block_ell_sharded`. The
    reg term and the CG state are replicated, and every predicate read on
    the host comes from all-reduced energies, so all ranks take the same
    branches.

    Returns (node_dq, cost0_raw, cost0, cost1, dmp_out, ell_overflow):
    raw and huberized initial cost, final huberized cost, final LM
    damping, and the JᵀWJ contributions the degree cap dropped.

    Spans: ``solve``, one ``gn_step`` per GN step with ``jacobians``
    (residuals, Jacobians, weights, gradient), ``assemble`` (the JᵀWJ
    blocks, when rebuilt), ``pcg`` and ``lm_try`` (the energy at the
    step and its acceptance) per LM try, and a ``host_read`` at each
    predicate."""
    corr_mask, nbr_idx = data_args[3], data_args[4]
    pair_i, pair_j, _, _, pair_mask = reg_args
    M = node_dq.shape[0]
    dev = node_dq.device
    f32 = torch.float32
    if solver_ctx is None:
        solver_ctx = make_solver_ctx(nbr_idx, corr_mask, pair_i, pair_j,
                                     pair_mask, M)
    reduce_ell, ell_nbr, self_ids, self_present, ell_overflow = solver_ctx.ell
    DC = ell_nbr.shape[0] // M

    def energy(x):
        return _energies(*_residuals(x, data_args, reg_args, lw_dq), psum)[1]

    cost0_raw, cost0 = _energies(*_residuals(node_dq, data_args, reg_args,
                                            lw_dq), psum)

    def run_step(x, e, dmp, Bl, blk, e_asm):
        with span("jacobians"):
            r_d, J_d = _data_jacobians(x, data_args, lw_dq)
            r_d = torch.where(corr_mask, r_d, 0.0)
            J_d = torch.where(corr_mask[:, None, None], J_d, 0.0)
            w_d = huber_irls_weight(r_d) * corr_mask
            r_r, J_ri, J_rj = _reg_jacobians(x, reg_args)
            pm = pair_mask[:, None]
            r_r = torch.where(pm, r_r, 0.0)
            J_ri = torch.where(pm[..., None], J_ri, 0.0)
            J_rj = torch.where(pm[..., None], J_rj, 0.0)
            w_r = huber_irls_weight(r_r) * pm                  # (P, 3)

            g = torch.zeros((M, 8), dtype=f32, device=dev)
            g.index_add_(0, nbr_idx.reshape(-1),
                         (J_d * (w_d * r_d)[:, None, None]).reshape(-1, 8))
            g = psum(g)
            wrr = w_r * r_r
            g.index_add_(0, pair_i, torch.einsum("pc,pce->pe", wrr, J_ri))
            g.index_add_(0, pair_j, torch.einsum("pc,pce->pe", wrr, J_rj))
            rhs = -g

        with host_read():
            fresh = bool(e < (1.0 - FREEZE_FRAC) * e_asm)
        if fresh:
            with span("assemble"):
                blocks = reduce_ell(jtwj_contributions(
                    J_d, w_d, J_ri, J_rj, w_r))                # (M·DC, 64)
                Bl = blocks.reshape(M, DC, 8, 8)
                blk = (blocks[self_ids]
                       * self_present[:, None]).reshape(M, 8, 8)
            e_asm = e
        diag_mean = (torch.sum(torch.diagonal(blk, dim1=1, dim2=2))
                     / (8.0 * M) + 1e-12)

        def cg_solve(lam):
            return pcg_solve(Bl, blk, ell_nbr, rhs, lam, cg_iters)

        # LM trust loop on the blocks just built (or frozen)
        x_b, e_b = x, e
        with host_read():
            e_last = torch.tensor(torch.inf, device=dev)
        accepted = False
        for _ in range(MAX_LM_RETRIES):
            with host_read():
                flat = bool((e_last - e) <= (FLAT_FACTOR * ftol) * e)
            if accepted or flat:
                break
            with span("pcg"):
                step = cg_solve(dmp * diag_mean)
            with span("lm_try"):
                x_new = x + step
                e_new = energy(x_new)
                with host_read():
                    accepted = bool(e_new <= e)
            if accepted:
                x_b, e_b = x_new, e_new
                dmp = torch.clamp_min(dmp / 3.0, damping)
            else:
                dmp = dmp * 10.0
            e_last = e_new
        return x_b, e_b, dmp, Bl, blk, e_asm, fresh

    x = node_dq
    e = cost0
    dmp0 = damping if damping_init is None else damping_init
    if isinstance(dmp0, torch.Tensor) and dmp0.device == dev:
        dmp = dmp0.to(f32)
    else:
        with host_read():
            dmp = torch.as_tensor(dmp0, dtype=f32, device=dev)
    Bl = torch.zeros((M, DC, 8, 8), dtype=f32, device=dev)
    blk = torch.zeros((M, 8, 8), dtype=f32, device=dev)
    with host_read():
        e_asm = torch.tensor(torch.inf, device=dev)
    for _ in range(gn_iters):
        with span("gn_step"):
            x2, e2, dmp2, Bl, blk, e_asm2, fresh = run_step(x, e, dmp, Bl,
                                                            blk, e_asm)
            with host_read():
                reduced = bool((e - e2) > ftol * e)
        if not reduced and fresh:
            x, e, dmp, e_asm = x2, e2, dmp2, e_asm2
            break
        if not reduced:  # failed on frozen blocks: rebuild, keep damping
            with host_read():
                e_asm = torch.tensor(torch.inf, device=dev)
            x, e = x2, e2
        else:
            x, e, dmp, e_asm = x2, e2, dmp2, e_asm2
    return x, cost0_raw, cost0, e, dmp, ell_overflow


def solve_nonrigid(node_dq, verts, normals, corrs, corr_mask, nbr_idx,
                   blend_wts, pair_i, pair_j, pair_v, pair_scale, pair_mask,
                   lw_dq, gn_iters: int = 8, cg_iters: int = 32,
                   damping: float = 1e-4, ftol: float = 1e-5,
                   dense_pairs: bool = False, damping_init=None):
    """Single-device non-rigid GN solve: :func:`gn_solve_core` on the
    argument lists of the JAX package's ``solve_nonrigid``
    (``solvers/nonrigid.py:992``), with a per-call slot dictionary.
    ``ftol`` is the reference's scipy ftol (core/fusion.py:391).
    ``dense_pairs`` is accepted and ignored: in JAX it only promises
    ``pair_i == repeat(arange(M), k)`` so that the TPU's segment sums
    become reshapes, and ``index_add_`` needs no such promise. The JAX
    options its callers leave at their defaults (``cg_rtol``,
    ``use_ell``, ``freeze_frac``, ``flat_factor``) are the module's fixed
    behaviour here.

    Returns (node_dq, cost0_raw, cost0, cost1, dmp_out, ell_overflow)."""
    del dense_pairs  # a layout promise of the TPU reducers
    return gn_solve_core(
        node_dq, (verts, normals, corrs, corr_mask, nbr_idx, blend_wts),
        (pair_i, pair_j, pair_v, pair_scale, pair_mask), lw_dq, gn_iters,
        cg_iters, damping, ftol, damping_init=damping_init)
