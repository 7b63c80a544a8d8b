"""The frame tools of the port (dynamicfusion_body_tpu_torch/tools:
profile_frame5, sweep_solver5; sweep_frame5 in
test_torch_sweep_frame5.py, so that each file stays near a minute) on
the CPU at 32³ with a 2-frame chain and one arm each (the cheapest: a
32³ frame takes seconds here): finite per-frame times, and the sweep's
ratio equal to gate 2's common objective
(``benchmarks/bench.py:track_energy``) recomputed here on the same warps
from the state the arms start from."""

import math

import pytest
import torch

from dynamicfusion_body_tpu_torch.benchmarks import bench
from dynamicfusion_body_tpu_torch.tools import profile_frame5, sweep_solver5

torch.set_num_threads(1)

ARGS = ["--res", "32", "--device", "cpu", "--frames", "2"]


def test_profile_frame5_base_and_one_arm():
    rows = profile_frame5.main(ARGS + ["solve_iters=0"])
    assert list(rows) == ["base", "solve_iters=0"]
    for r in rows.values():
        assert math.isfinite(r["ms"]) and len(r["walls"]) == 2
        assert all(w > 0 for w in r["walls"])


def check_sweep(out, name):
    (key, row), = out.rows.items()
    assert key == name
    assert math.isfinite(row["ms"]) and len(row["walls"]) == 2
    _, _, wf0, lw0, mesh0 = out.state0
    ctx = bench.energy_context(wf0, mesh0, out.live, out.hyper)
    cost_f = float(bench.track_energy(ctx, *row["warp"])[1])
    cost_e = float(bench.track_energy(ctx, *row["exact_warp"])[1])
    assert cost_e > 0
    assert row["ratio"] == pytest.approx(cost_f / cost_e, rel=1e-6)
    cost_pre = float(bench.track_energy(ctx, wf0.node_dq, lw0)[1])
    assert row["slack"] == pytest.approx((cost_f - cost_e) / cost_pre,
                                         rel=1e-5, abs=1e-9)


def test_sweep_solver5_one_pair():
    check_sweep(sweep_solver5.main(ARGS + ["1,4"]), "1,4")
