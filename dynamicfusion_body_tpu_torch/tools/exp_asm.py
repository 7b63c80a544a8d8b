"""Layouts of the block-ELL JᵀWJ assembly on the card — the port of the
round-4 experiment ``tools/exp_asm.py`` (and of its ``extra()``), at the
bench scale of the JAX docstring: M = 4096 nodes, V = 32,768 vertices,
k = 3, T = V·k² + 4·M·k = 344,064 contribution rows of 64, on the bench
scene's graph at ``--res`` 256 (the inputs of
``tools/profile_solver.py:solver_inputs``).

The assembly sums each (8×8) contribution into the slot of its coupling
(the (M·D, 64) table, D = ``ELL_DEGREE_CAP``). Rows, each printed with
its max |Δ| against the port's current assembly and the table's scale:

* ``A_index_add(T,64)``: the port's current reduce
  (``solvers/nonrigid.py:make_block_ell``: ``index_add_`` of the (T, 64)
  rows into their slots); ``A_full``: with the rows built by
  ``jtwj_contributions`` first — the reference of C, CM and CMB;
* ``B_transpose+row_reduce``: channel-major (64, T) contributions
  transposed once, then the sorted-segment form in rows: gather the rows
  in slot order, ``cumsum`` down the rows, and subtract the cumulative
  sums at each slot's segment ends; ``B2_row_reduce_only``: the same on
  (T, 64) rows;
* ``C_build_rows+row_reduce``: the rows built as (T, 64) (the port's
  ``jtwj_contributions``), then the sorted-segment form;
* ``CM_build_cm+col_reduce``: built channel-major (64, T), as JAX's
  ``gn_solve_core`` did, and reduced along the columns in that layout
  (JAX's ``reduce_ell``); ``CMB``: built channel-major, transposed, row
  reduce;
* ``E_blocked_cumsum_B{256,512,1024,2048}`` (JAX's ``extra()``): the
  channel-major column reduce with a blocked scan (block totals, their
  exclusive prefix, a scan within each block of B columns).

JAX's D (the row reduce in bf16 hi/lo) has no row: the port keeps every
assembly in f32. The sorted-segment forms subtract prefix sums over all
T rows, so their error grows with T (JAX's ``extra()`` printed E's
against A for that reason); ``index_add_`` adds each slot's few rows.

Timing as ``tools/_timing.py:Timer`` (median synced wall, CUDA-event
mean, bound: inputs once and the table once over 3.35 TB/s, or the f32
operations; rows under 10 ms also as one CUDA graph of 64 calls).

    python -m dynamicfusion_body_tpu_torch.tools.exp_asm
    python -m dynamicfusion_body_tpu_torch.tools.exp_asm --device cpu \\
        --res 32 --reps 1
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..pipeline.fusion import resolve_device
from ..solvers.nonrigid import (
    _coupling_keys, _lookup, jtwj_contributions, make_ell_dict)
from ._timing import Timer, bound, device_label, parse_args
from .profile_solver import solver_inputs

BLOCKS = (256, 512, 1024, 2048)


def row_layout(s):
    """The sorted-segment metadata of ``solver_inputs`` ``s``: ``order``
    (the contribution rows by slot, rows with no slot last), ``keep``
    (1 where the sorted row has a slot), and each slot's segment
    [seg_lo, seg_hi) in that order."""
    M, D = s.M, s.D
    keys = _coupling_keys(s.nbr_idx, s.corr_mask, s.pair_i, s.pair_j,
                          s.pair_mask, M)
    ell = make_ell_dict(s.nbr_idx, s.corr_mask, s.pair_i, s.pair_j,
                        s.pair_mask, M, D)
    slot = torch.where(keys < M * M, _lookup(ell.slot_key, keys), -1)
    key = torch.where(slot >= 0, slot, M * D)
    sk, order = torch.sort(key, stable=True)
    seg_hi = torch.searchsorted(sk, torch.arange(M * D, device=sk.device),
                                right=True)
    seg_lo = torch.cat([seg_hi.new_zeros(1), seg_hi[:-1]])
    return SimpleNamespace(order=order, keep=(sk < M * D).float(),
                           seg_lo=seg_lo, seg_hi=seg_hi)


def row_reduce(xT, lay):
    """(T, 64) contribution rows → (M·D, 64) by the sorted-segment form."""
    xs = xT[lay.order] * lay.keep[:, None]
    padded = torch.cat([xs.new_zeros(1, xs.shape[1]), torch.cumsum(xs, 0)])
    return padded[lay.seg_hi] - padded[lay.seg_lo]


def col_reduce(x, lay):
    """(64, T) channel-major contributions → (M·D, 64), the sorted-segment
    form along the columns (JAX's ``reduce_ell`` layout)."""
    xs = x[:, lay.order] * lay.keep[None, :]
    padded = torch.cat([xs.new_zeros(xs.shape[0], 1),
                        torch.cumsum(xs, 1)], 1)
    return (padded[:, lay.seg_hi] - padded[:, lay.seg_lo]).T


def col_reduce_blocked(x, lay, B: int):
    """:func:`col_reduce` with a blocked scan: block totals, their
    exclusive prefix, a scan within each block of ``B`` columns."""
    C, T = x.shape
    TB = -(-T // B) * B
    xs = x[:, lay.order] * lay.keep[None, :]
    blk = torch.nn.functional.pad(xs, (0, TB - T)).reshape(C, TB // B, B)
    tot = blk.sum(2)
    bpre = torch.cumsum(tot, 1) - tot
    csum = (torch.cumsum(blk, 2) + bpre[:, :, None]).reshape(C, TB)[:, :T]
    padded = torch.cat([csum.new_zeros(C, 1), csum], 1)
    return (padded[:, lay.seg_hi] - padded[:, lay.seg_lo]).T


def build_cm(s):
    """The contributions built channel-major, (64, T), in
    ``jtwj_contributions``' row order (JAX's ``gn_solve_core`` layout)."""
    k, V = s.k, s.V
    Jw = (s.J_d * s.w_d[:, None, None]).permute(1, 2, 0)      # (k, 8, V)
    JdT = s.J_d.permute(1, 2, 0)
    data = [(Jw[ka][:, None, :] * JdT[kb][None, :, :]).reshape(64, V)
            for ka in range(k) for kb in range(k)]

    def reg_outer(Jx, Jy):
        return sum((s.w_r[:, c] * Jx[:, c].T)[:, None, :]
                   * Jy[:, c].T[None, :, :] for c in range(3)).reshape(64, -1)

    return torch.cat(data + [reg_outer(s.J_ri, s.J_ri),
                             reg_outer(s.J_ri, s.J_rj),
                             reg_outer(s.J_rj, s.J_ri),
                             reg_outer(s.J_rj, s.J_rj)], 1)


def build_rows(s):
    """The contributions as (T, 64) rows: the port's
    ``jtwj_contributions``."""
    return jtwj_contributions(s.J_d, s.w_d, s.J_ri, s.J_rj, s.w_r)


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=8)
    dev = resolve_device(args.device)
    s = solver_inputs(args.res, dev)
    lay = row_layout(s)
    M, D, T = s.M, s.D, s.contrib.shape[0]
    rng = np.random.RandomState(0)
    x64 = torch.from_numpy(rng.rand(64, T).astype(np.float32)).to(dev)
    xT = x64.T.contiguous()
    t = Timer(dev, args.reps, args.trace)
    print(f"# exp_asm: M {M}, V {s.V}, k {s.k}, T {T}, D {D}; "
          f"{s.n_overflow} contributions past the degree cap; on "
          f"{device_label(dev)}; reps {args.reps}", flush=True)

    io = 256 * T + 8 * T + 256 * M * D        # rows, order, table
    nin = (s.J_d.numel() + s.w_d.numel() + s.J_ri.numel() * 2
           + s.w_r.numel()) * 4
    build = dict(**bound(nin + 256 * M * D, 3 * 64 * T))
    ref_x = s.reduce_ell(xT)
    ref_full = s.reduce_ell(build_rows(s))
    rows = {}

    def row(name, fn, ref, **b):
        r = t(name, fn, graph=True, **b)
        out = fn()
        r["max_diff"] = float(torch.max(torch.abs(out - ref)))
        r["scale"] = float(torch.max(torch.abs(ref)))
        print(f"{'':34s} max |Δ| vs A {r['max_diff']:.3e} (scale "
              f"{r['scale']:.3e})", flush=True)
        rows[name] = r

    row("A_index_add(T,64)", lambda: s.reduce_ell(xT), ref_x,
        **bound(io, 64 * T))
    row("A_full_build+index_add", lambda: s.reduce_ell(build_rows(s)),
        ref_full, **build)
    row("B_transpose+row_reduce", lambda: row_reduce(x64.T, lay), ref_x,
        **bound(io, 2 * 64 * T))
    row("B2_row_reduce_only(T,64)", lambda: row_reduce(xT, lay), ref_x,
        **bound(io, 2 * 64 * T))
    row("C_build_rows+row_reduce", lambda: row_reduce(build_rows(s), lay),
        ref_full, **build)
    row("CM_build_cm+col_reduce", lambda: col_reduce(build_cm(s), lay),
        ref_full, **build)
    row("CMB_build_cm+transpose+row_reduce",
        lambda: row_reduce(build_cm(s).T, lay), ref_full, **build)
    for B in BLOCKS:
        row(f"E_blocked_cumsum_B{B}",
            lambda B=B: col_reduce_blocked(x64, lay, B), ref_x,
            **bound(io, 2 * 64 * T))
    return rows


if __name__ == "__main__":
    main()
