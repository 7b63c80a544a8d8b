"""The port's profiling entry points (dynamicfusion_body_tpu_torch/tools)
at 32³ on the CPU, where the kernels' plain twins run: each tool returns
its named rows with finite host times, and ``device_trace`` writes a
trace holding the block's operations, and a row's trace counts as
whole only when nothing it launched is missing from it."""

import importlib.util
import json
import math
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu_torch.ops import cuda_lib
from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import (
    ABLATION_MODES, ABLATION_THREADS)
from dynamicfusion_body_tpu_torch.tools import (
    _scene, _timing, profile_corr5, profile_frame, profile_icp_pick,
    profile_mc, profile_solve, profile_trilerp, profile_upd)
from dynamicfusion_body_tpu_torch.utils.profiling import (
    BLOCK, DeviceTrace, device_trace)

# One intra-op thread (see tests/test_torch_solvers.py)
torch.set_num_threads(1)

SMALL = ["--res", "32", "--device", "cpu", "--reps", "1"]

ROWS = {
    profile_trilerp: ["full_kernel", "grid_sample", "twin"] + [
        f"{m}_t{n}" for m in ABLATION_MODES for n in ABLATION_THREADS],
    profile_upd: [
        "update_full_cached_cand", "build_warp_cache",
        "update_full_warp_cache", "k2_cached", "k3_kernel",
        "k3_no_coords", "trilerp_only_k4", "trilerp_only_t128",
        "trilerp_only_t256", "trilerp_only_t512", "merge_running_average",
        "config4_update", "config4_candidates", "config4_merge"],
    profile_solve: ["corr_exact", "corr_approx"] + [
        f"solve_gn{gn}_cg{cg}" for gn, cg in profile_solve.GRID],
    profile_frame: [
        "mc_live", "mc_canon_step2", "correspondence", "rigid_solve_12",
        "rigid_solve_4", "nonrigid_solve_8gn16cg", "nonrigid_solve_1gn16cg",
        "update_tsdf_full", "brick_candidates_2level", "trilerp_k4",
        "update_graph"],
    profile_mc: ["mc_full", "mc_case_cross", "mc_vertices", "mc_faces",
                 "mc_normals"],
    profile_corr5: ["knn_exact_kc16", "knn_approx_kc16"] + [
        f"knn_2lvl_c{c}_p{p}" for c, p in profile_corr5.POOLS],
}


@pytest.mark.parametrize("tool", list(ROWS), ids=lambda m: m.__name__)
def test_tool_rows(tool, capsys):
    rows = tool.main(SMALL)
    assert list(rows) == ROWS[tool]
    for name, row in rows.items():
        assert math.isfinite(row["wall_ms"]) and row["wall_ms"] > 0, name
        assert row["event_ms"] is None, name  # no device metric on the CPU
        if "bound_ms" in row:
            assert row["bound_ms"] > 0 and row["bound_by"] in (
                "bytes", "operations")
    out = capsys.readouterr().out
    assert "on cpu" in out and all(name in out for name in rows)


def test_profile_icp_pick_arguments():
    """The card's tool at 32³ on the CPU, where both sides are the plain
    composition: every case and the search row agree, count the
    composition's two host reads, and carry no device metric."""
    rows = profile_icp_pick.main(SMALL)
    cases = list(profile_icp_pick.edge_cases(torch.device("cpu")))
    assert [r["case"] for r in rows] == cases + ["search"]
    for r in rows:
        assert r["unequal"] == 0 and r["launches"] is None
        assert r["host_reads"] == r["host_reads_composition"] == 2
    assert rows[-1]["counted"] > 0 and "k9_ms" not in rows[-1]
    with pytest.raises(SystemExit):
        profile_icp_pick.main(SMALL[:2] + ["--reps", "0"])


def test_trilerp_bounds_count_this_run():
    """The bounds of profile_trilerp: per sample 16 bytes, plus each
    tapped live cell once for the modes that read live."""
    live, wx, wy, wz = profile_trilerp.trilerp_inputs(32, torch.device("cpu"))
    b = profile_trilerp.mode_bounds(live, (wx, wy, wz))
    n = wx.numel()
    assert b["weights"]["bound_ms"] == pytest.approx(16 * n / 3.35e12 * 1e3)
    assert b["loads"]["bound_ms"] == b["full"]["bound_ms"]
    assert b["full"]["bound_ms"] <= (16 * n + 4 * live.numel()) / 3.35e9
    assert b["k4"]["bound_ms"] > b["full"]["bound_ms"]


def test_device_trace_on_cpu(tmp_path):
    with device_trace(str(tmp_path / "t")) as tr:
        assert tr.path is None
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert os.path.getsize(tr.path) > 0
    assert tr.path.startswith(str(tmp_path))
    with open(tr.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any("mm" in str(k) for k in names), names


def _fake_trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = DeviceTrace()
    tr.path = str(path)
    return tr


def _ev(cat, name, corr, ts, dur=10.0):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                args={"correlation": corr})


@pytest.mark.parametrize("case", ["whole", "lost_kernel", "unmatched"])
def test_trace_summary_checks_the_trace(tmp_path, case):
    """A row's trace holds the block's device activity only (not the
    pre-roll's), and is whole only when every port kernel its wrappers
    launched is in it and every launch of the block has its kernel."""
    k4 = "trilerp_bricks_kernel(float const*, float const*)"
    k3 = "warp_trilerp_bricks_kernel(float const*)"
    fill = "vectorized_elementwise_kernel<4, FillFunctor>"
    events = [_ev("cuda_runtime", "cudaLaunchKernel", 1, 10.0),
              _ev("kernel", fill, 1, 20.0, 999.0),
              _ev("user_annotation", BLOCK, None, 100.0, 900.0),
              _ev("cuda_runtime", "cudaLaunchKernel", 2, 110.0),
              _ev("kernel", k4, 2, 120.0, 100.0),
              _ev("cuda_runtime", "cudaLaunchKernel", 3, 130.0),
              _ev("kernel", k3, 3, 220.0, 300.0),
              _ev("cuda_runtime", "cudaMemcpyAsync", 4, 140.0),
              _ev("gpu_memcpy", "Memcpy DtoH", 4, 520.0, 50.0),
              _ev("cpu_op", "aten::add", None, 150.0, 999.0)]
    launched = {"trilerp_bricks_kernel": 1, "warp_trilerp_bricks_kernel": 1,
                "mc_case_cross_kernel": 0}
    if case == "lost_kernel":
        launched["trilerp_bricks_kernel"] = 2
    if case == "unmatched":
        events.append(_ev("cuda_runtime", "cudaLaunchKernel", 5, 160.0))
    tr = _fake_trace(tmp_path, events)
    assert tr.device_kernels()[k4] == (0.1, 1)
    assert fill not in tr.device_kernels()  # the pre-roll's
    dev_ms, busy, top, lost = _timing.trace_summary(tr, 1.0, launched)
    assert dev_ms == pytest.approx(0.45)
    assert [k for _, _, k in top] == [k3, k4, "Memcpy DtoH"]
    if case == "whole":
        assert lost == {} and busy == pytest.approx(0.45)
    elif case == "lost_kernel":
        assert lost == {"trilerp_bricks_kernel": (2, 1)} and busy is None
    else:
        assert lost == {"unmatched": 1} and busy is None


def test_tool_trace_on_cpu(tmp_path, capsys):
    rows = profile_mc.main(SMALL + ["--trace", str(tmp_path)])
    for name, row in rows.items():
        assert os.path.isfile(tmp_path / name / "trace.json"), name
        assert row["busy"] is None  # no device kernels on the CPU
        assert row["trace_lost"] == {}  # and no port kernel launched
    assert "busy not measured" in capsys.readouterr().out


def test_tool_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_mc.main(["--res", "32", "--reps", "1"])


ROOT = Path(__file__).resolve().parent.parent


def _jax_side_script(name, path):
    """A script of the JAX side (numpy at import), loaded from its file."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bumpy_sdf_copy_matches_bench(rng):
    """tools/_scene.bumpy_sdf is bench.py's, value for value."""
    bench = _jax_side_script("bench", "bench.py")
    for _ in range(3):
        res = int(rng.randint(8, 33))
        args = (res, tuple(rng.rand(3) * res), float(rng.rand() * res / 2),
                float(rng.rand() * 3), float(rng.randint(1, 5)),
                float(rng.rand() * 2))
        np.testing.assert_array_equal(_scene.bumpy_sdf(*args),
                                      bench.bumpy_sdf(*args))


def test_make_bend_copy_matches_suite(rng):
    """tools/_scene.make_bend is benchmarks/suite.py's _make_bend, value
    for value, on points other than the ones it was frozen from."""
    suite = _jax_side_script("suite", "benchmarks/suite.py")
    ref = (rng.randn(500, 3) * [0.3, 0.8, 0.2]).astype(np.float32)
    pts = (rng.randn(2000, 3) * 0.5).astype(np.float32)
    mine, theirs = _scene.make_bend(ref), suite._make_bend(ref)
    for angle in (0.0, 0.08, 0.24, -1.0):
        np.testing.assert_array_equal(mine(pts, angle), theirs(pts, angle))


def test_port_kernel_names_are_cuda_symbols():
    """The kernel names the traced rows check against, one for each
    wrapper as its C entry's declaration names it, are the __global__
    functions of csrc/*.cu, one each: a renamed kernel cannot make every
    trace look incomplete, nor a new one go undeclared."""
    csrc = Path(_timing.__file__).resolve().parent.parent / "csrc"
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                      r"(?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(")
    names = {m.group(1) for src in csrc.glob("*.cu")
             for m in decl.finditer(src.read_text())}
    assert sorted(cuda_lib.wrappers().values()) == sorted(names)
