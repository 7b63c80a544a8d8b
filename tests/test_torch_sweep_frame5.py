"""The port's sweep_frame5 (dynamicfusion_body_tpu_torch/tools/
sweep_frame5.py) on the CPU at 32³ with a 2-frame chain and one arm:
finite per-frame times, and its ratio and slack equal to gate 2's common
objective (``benchmarks/bench.py:track_energy``) recomputed on the same
warps from the rewind state the arms are gated from (the check of
test_torch_frame_tools.py)."""

import numpy as np
import torch

from dynamicfusion_body_tpu_torch.tools import sweep_frame5
from test_torch_frame_tools import ARGS, check_sweep

torch.set_num_threads(1)


def test_sweep_frame5_one_arm():
    out = sweep_frame5.main(ARGS + ["fresh_gn4"])
    check_sweep(out, "fresh_gn4")
    assert np.isfinite(out.rows["fresh_gn4"]["cost_pre"])
