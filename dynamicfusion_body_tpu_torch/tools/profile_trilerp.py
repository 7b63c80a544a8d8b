"""Split K4's trilerp time between its tap loads and its weights (K6).

Port of ``tools/profile_trilerp.py``: the JAX tool times K4 and nine
variants of an ablation kernel (``run``, the Pallas kernel at ``:142``)
that switch off the box DMA, the one-hot weights or bf16 matmul passes,
at group 8 or 16. Here K6 (``ops/trilerp_cuda.py:trilerp_ablation``) runs
each of its modes — ``loads`` (for ``dma_only``), ``weights`` (for
``onehot_only``), ``full`` (for ``full_*pass_*``) — at 128, 256 and 512
threads per block (for the group), beside K4 (``full_kernel``), its plain
twin and ``torch.nn.functional.grid_sample`` (the one PyTorch call that
computes the same trilerp). Like the TPU kernel, K6 stages each brick
row's box of ``live`` on chip (in shared memory, where the row's tap
extent fits ``ABLATION_BOX``) and reads the taps from there; ``loads``
stages the box and sums the taps, ``weights`` reads no ``live``. The bf16
pass count and the tent weights have no counterpart (f32, no matrix
unit). Each row prints its bound (bytes or operations; the live cells
tapped counted once) and, on the card, its share of it, and for the rows
that read ``live`` the sector floor: the bound's bytes with the tapped
cells counted as whole 32-byte sectors, the least the memory system can
move for them.

Inputs as the JAX tool's: ``np.random.RandomState(0)``, live
``rand(R,R,R)``, per-brick coordinates ``base + offs`` of shape
((R/8)³, 512): 16.8 M samples at 256³.

    python -m dynamicfusion_body_tpu_torch.tools.profile_trilerp
    python -m dynamicfusion_body_tpu_torch.tools.profile_trilerp \\
        --device cpu --res 32
"""

from __future__ import annotations

import torch

from ..ops.trilerp_cuda import (
    ABLATION_MODES, ABLATION_THREADS, trilerp_ablation, trilerp_ablation_ref,
    trilerp_bricks)
from ..pipeline.fusion import resolve_device
from ._scene import trilerp_inputs
from ._timing import (
    HBM_BPS, Timer, bound, device_label, live_sectors, live_taps,
    parse_args)

# f32 operations per sample: the index step (3 clamps of 2, 3 floors,
# 3 mins, 3 adds, 3 subtractions), the 7 additions of the loads' sum, the
# weights (3 subtractions, 16 multiplies, 7 additions), the 7 lerps of
# 4, and K4's in-volume test
OPS_INDEX, OPS_LOADS, OPS_WEIGHTS, OPS_LERP, OPS_VALID = 15, 7, 26, 28, 6
MODE_OPS = {"loads": OPS_INDEX + OPS_LOADS,
            "weights": OPS_INDEX + OPS_WEIGHTS,
            "full": OPS_INDEX + OPS_LERP}


def grid_sample_fn(live, wx, wy, wz):
    """``grid_sample`` over the same samples (align_corners, zero
    padding): equal to the trilerp inside the volume."""
    import torch.nn.functional as F

    rx, ry, rz = live.shape
    grid = torch.stack([2.0 * wz / (rz - 1) - 1.0, 2.0 * wy / (ry - 1) - 1.0,
                        2.0 * wx / (rx - 1) - 1.0], dim=-1)
    grid = grid.reshape(1, wx.shape[0], wx.shape[1], 1, 3)
    inp = live[None, None]
    return lambda: F.grid_sample(inp, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def mode_bounds(live, coords):
    """Each mode's bound on these inputs: coordinates read and one f32
    written per sample; the loads and the full trilerp also read each
    live cell they tap once. K4 writes ``valid`` (1 B) besides. The modes
    that read ``live`` also get ``floor_ms``: the same bytes with the
    tapped cells counted as whole 32-byte sectors, over the memory rate."""
    n = coords[0].numel()
    taps = 4 * live_taps(live.shape, coords)
    sectors = 32 * live_sectors(live.shape, coords)
    out = {m: bound(16 * n + (0 if m == "weights" else taps),
                    n * MODE_OPS[m]) for m in ABLATION_MODES}
    out["k4"] = bound(17 * n + taps, n * (MODE_OPS["full"] + OPS_VALID))
    for m, base in (("loads", 16 * n), ("full", 16 * n), ("k4", 17 * n)):
        out[m]["floor_ms"] = (base + sectors) / HBM_BPS * 1e3
    return out


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__, reps=20)
    dev = resolve_device(args.device)
    live, wx, wy, wz = trilerp_inputs(args.res, dev)
    coords = (wx, wy, wz)
    print(f"# profile_trilerp: {args.res}^3, {wx.numel()} samples on "
          f"{device_label(dev)}; reps {args.reps}", flush=True)
    bounds = mode_bounds(live, coords)
    t = Timer(dev, args.reps, args.trace)
    t("full_kernel", lambda: trilerp_bricks(live, *coords), **bounds["k4"])
    t("grid_sample", grid_sample_fn(live, *coords), **bounds["full"])
    t("twin", lambda: trilerp_ablation_ref(live, *coords, "full"),
      **bounds["full"])
    for mode in ABLATION_MODES:
        for threads in ABLATION_THREADS:
            t(f"{mode}_t{threads}",
              lambda m=mode, n=threads: trilerp_ablation(live, *coords, m, n),
              **bounds[mode])
    print(f"# launches: trilerp_ablation {trilerp_ablation.launches}, "
          f"trilerp_bricks {trilerp_bricks.launches}", flush=True)
    return t.rows


if __name__ == "__main__":
    main()
