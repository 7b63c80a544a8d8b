"""Primitive-cost microbenchmarks on the card — the port of
``tools/profile_prims.py``, written "so designs target measured costs,
not guesses": the primitives that marching cubes, the update and the
solver are built from, at the JAX tool's sizes (``--res 256``, the
default; a smaller ``--res`` scales every size by (res/256)³).

Rows, each the primitive as the port computes it:

* ``slice_{x,y,z,xyz}_shift``: the sum of a 255³ shifted slice of a 256³
  volume (the lattice's neighbour reads);
* ``case_build_8corners``: the MC case byte and crossing flags, K1
  (``ops/mc_cuda.py:mc_case_cross``) on the card — the port's only form
  of that build there — and ``case_build_8corners_torch``, the JAX row's
  eight shifted compares in PyTorch (the twin's formula);
* ``gather_*``: 16.7M indices into a 256-entry table and into a 67 MB
  array, 262k into 67 MB and into 128 KB, 1M into 67 MB (int64 indices,
  the port's index type). As in the JAX tool, the 16.7M indices into the
  67 MB array are drawn below 256, so that row reads 1 KB of it; each
  row's bound counts the distinct entries read;
* ``cumsum_16.7M_i32``, ``cumsum_50M_bool`` and beside it
  ``nonzero_50M_bool``: the port's compaction of a crossing mask
  (``ops/marching_cubes.py`` takes ``nonzero`` where JAX ranks by scan);
* ``sort_131k_i32``, ``argsort_131k_i32``;
* ``brick_transpose_reduce``: a bool count per 8³ brick through
  ``ops/bricks.py:vol_to_bricks``;
* ``padconcat_3x67MB``: three shifted slices padded and concatenated (the
  layout of the three crossing masks).

The JAX row ``onehot_lookup_16.7M_256`` (a table lookup as a bf16 one-hot
matmul) is a TPU workaround that the port replaced by a direct gather; it
has no counterpart and no row.

Each row reports the median synced wall and the CUDA-event mean
(``tools/_timing.py:Timer``), its bound (bytes: every input read once,
every output written once, over 3.35 TB/s) and share; rows under 10 ms
are also timed as one CUDA graph of 64 calls (the JAX tool's loop inside
one program), which says whether the host's launches pace them
(``tools/_timing.py``).

    python -m dynamicfusion_body_tpu_torch.tools.profile_prims
    python -m dynamicfusion_body_tpu_torch.tools.profile_prims \\
        --device cpu --res 32 --reps 1
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bricks import vol_to_bricks
from ..ops.mc_cuda import mc_case_cross
from ..pipeline.fusion import resolve_device
from ._timing import Timer, bound, device_label, parse_args


def case_build(vol, level: float = 0.5):
    """The JAX row's eight shifted compares: the case byte of each of the
    (R-1)³ cells, summed."""
    inside = vol < level
    c = vol.shape[0] - 1
    case = torch.zeros((c, c, c), dtype=torch.int32, device=vol.device)
    for b in range(8):
        dx, dy, dz = b & 1, (b >> 1) & 1, (b >> 2) & 1
        case |= inside[dx:dx + c, dy:dy + c, dz:dz + c].int() << b
    return case.sum()


def padconcat(vol):
    """Three shifted slices (×2), each zero-padded back to R³ and
    flattened, concatenated."""
    R = vol.shape[0]
    outs = []
    for a in range(3):
        sl = [slice(None)] * 3
        sl[a] = slice(0, R - 1)
        pad = [0, 0] * 3
        pad[2 * (2 - a) + 1] = 1      # F.pad lists the last axis first
        outs.append(torch.nn.functional.pad(vol[tuple(sl)] * 2.0,
                                            pad).reshape(-1))
    return torch.cat(outs)


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=8)
    dev = resolve_device(args.device)
    R = args.res
    n = R ** 3
    rng = np.random.RandomState(0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    vol = put(rng.rand(R, R, R).astype(np.float32))
    tbl256 = put(rng.randint(0, 6, 256).astype(np.int32))
    big = put(np.sort(rng.randint(0, 1 << 30, n)).astype(np.int32))
    q_small = put(rng.randint(0, n, n // 64).astype(np.int64))   # 262k
    q_all = put(rng.randint(0, 256, n).astype(np.int64))         # 16.7M
    small = put(np.sort(rng.randint(0, 1 << 30, n // 512)).astype(np.int32))
    q_mid = put(rng.randint(0, n, n // 16).astype(np.int64))     # 1M
    mask = put(rng.rand(3 * n) < 0.01)                            # 50M
    seg = put(rng.randint(0, 4096, n // 128).astype(np.int32))   # 131k
    q_all_i32 = q_all.int()
    q_all_big = q_all % n
    q_small_tbl = q_small % small.numel()

    t = Timer(dev, args.reps, args.trace)
    print(f"# profile_prims: {R}^3 on {device_label(dev)}; reps "
          f"{args.reps}", flush=True)
    s = (R - 1) * R * R * 4
    t("slice_x_shift(255^3 sum)", lambda: vol[1:].sum(), graph=True,
      **bound(s, s // 4))
    t("slice_y_shift", lambda: vol[:, 1:].sum(), graph=True,
      **bound(s, s // 4))
    t("slice_z_shift", lambda: vol[:, :, 1:].sum(), graph=True,
      **bound(s, s // 4))
    s3 = (R - 1) ** 3 * 4
    t("slice_xyz_shift", lambda: vol[1:, 1:, 1:].sum(), graph=True,
      **bound(s3, s3 // 4))

    t("case_build_8corners", lambda: mc_case_cross(vol, 0.5), graph=True,
      **bound(8 * n, 0))
    t("case_build_8corners_torch", lambda: case_build(vol), graph=True,
      **bound(4 * n, 0))

    def gather(name, table, q):
        # the indices, the output and the distinct table entries read (the
        # 16.7M-index rows, as in the JAX tool, index only entries < 256)
        nq, nd = q.numel(), torch.unique(q).numel()
        nbytes = (q.element_size() * nq + table.element_size() * (nq + nd))
        t(name, lambda: table[q], graph=True, **bound(nbytes, 0))

    gather("gather_16.7M_from_256tbl", tbl256, q_all)
    gather("gather_16.7M_from_67MB", big, q_all_big)
    gather("gather_262k_from_67MB", big, q_small)
    gather("gather_262k_from_128KB", small, q_small_tbl)
    gather("gather_1M_from_67MB", big, q_mid)

    t("cumsum_16.7M_i32", lambda: torch.cumsum(q_all_i32, 0,
                                               dtype=torch.int32),
      graph=True, **bound(8 * n, n))
    t("cumsum_50M_bool", lambda: torch.cumsum(mask, 0, dtype=torch.int32),
      graph=True, **bound(5 * mask.numel(), mask.numel()))
    n_true = int(mask.sum())
    t("nonzero_50M_bool", lambda: torch.nonzero(mask),
      **bound(mask.numel() + 8 * n_true, mask.numel()))

    t("sort_131k_i32", lambda: torch.sort(seg), graph=True,
      **bound(16 * seg.numel(), 0))
    t("argsort_131k_i32", lambda: torch.argsort(seg), graph=True,
      **bound(12 * seg.numel(), 0))

    nb = (R // 8) ** 3
    t("brick_transpose_reduce",
      lambda: vol_to_bricks(vol < 0.5, 8).sum(1), graph=True,
      **bound(4 * n + 8 * nb, n))
    t("padconcat_3x67MB", lambda: padconcat(vol), graph=True,
      **bound(4 * n + 12 * n, 3 * n))
    return t.rows


if __name__ == "__main__":
    main()
