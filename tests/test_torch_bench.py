"""The port's frame bench (dynamicfusion_body_tpu_torch.benchmarks.bench)
against the repository's bench.py on the CPU: gate 2's common objective
(``track_energy``) against the same composition built from the JAX
package's functions (bench.py:270-308) at 32³, the gate function against
bench.py:309-345's expressions, the bench run end to end at 32³, and the
benchmark entry points raising without a card. (The voxel guard's
message is held in tests/test_torch_frame.py:test_large_volume_guard.)"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu.models import warp_field as JWF
from dynamicfusion_body_tpu.ops.marching_cubes import marching_cubes as j_mc
from dynamicfusion_body_tpu.pipeline.correspondence import (
    closest_point_correspondences as j_corr)
from dynamicfusion_body_tpu.pipeline.frame import _blend_weights as j_bw
from dynamicfusion_body_tpu.pipeline.frame import init_canonical as j_init
from dynamicfusion_body_tpu.solvers import nonrigid as JNR
from dynamicfusion_body_tpu_torch import convert
from dynamicfusion_body_tpu_torch.benchmarks import bench, suite
from dynamicfusion_body_tpu_torch.tools import diag_config7, diag_gate
from dynamicfusion_body_tpu_torch.tools._scene import LW_REF

# One intra-op thread (see tests/test_torch_frame.py)
torch.set_num_threads(1)

RES = 32
CPU = torch.device("cpu")
WF_FIELDS = ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
             "radius")
# relative tolerance of the common-objective costs: the same f32
# residuals summed over the canonical slots in another order (~1e-6
# relative), with the same correspondences (their count must be equal)
ENERGY_RTOL = 1e-4


def j_track_energy(wf0, mesh0, live_mesh, caps, live_caps, node_dq, lw_dq,
                   knn_k=3, tolerance=5.0):
    """bench.py:279-308 as the JAX bench composes it."""
    lmask = jnp.arange(live_caps[0]) < live_mesh["n_verts"]
    vmask0 = jnp.arange(caps[0]) < mesh0["n_verts"]
    nbr0 = JWF.neighbor_lookup(wf0, mesh0["verts"], knn_k)
    wfx = wf0.replace(node_dq=node_dq)
    bw = j_bw(wfx, mesh0["verts"], nbr0)
    wv, wn = JWF.warp_points(wfx, mesh0["verts"], nbr0,
                             normals=mesh0["normals"], m_lw=lw_dq)
    corr, cval, _ = j_corr(wv, wn, vmask0, live_mesh["verts"], lmask, knn_k,
                           tolerance, approx=False)
    data_args = (mesh0["verts"], mesh0["normals"], corr, cval, nbr0, bw)
    P = 8
    reg_args = (jnp.zeros(P, jnp.int32), jnp.zeros(P, jnp.int32),
                jnp.zeros((P, 3), jnp.float32), jnp.zeros(P, jnp.float32),
                jnp.zeros(P, bool))
    r_d, r_r = JNR._residuals(node_dq, data_args, reg_args, lw_dq)
    raw, rob = JNR._energies(r_d, r_r, lambda x: x)
    return float(raw), float(rob), int(jnp.sum(cval))


def test_track_energy_matches_jax():
    """The 32³ bench scene: JAX's init_canonical field carried across by
    convert.warp_field_from_jax, JAX's stride-2 canonical mesh by
    convert.mesh_from_jax; the initial warp and a seeded perturbation of
    it scored by both packages on the rewind frame lives[0]."""
    sc = bench.scene(RES, CPU)
    hyper = bench.settings(sc, use_kernels=False)
    caps = (hyper["vert_cap"], hyper["face_cap"])
    live_caps = (hyper["live_vert_cap"], hyper["live_face_cap"])
    canon = jnp.asarray(sc.canonical.numpy())
    wf_j, _ = j_init(canon, subsample_rate=1.5, node_cap=sc.wf.capacity,
                     mc_step=2, vert_cap=caps[0], face_cap=caps[1])
    mesh_j = j_mc(canon, level=0.0, vert_cap=caps[0], face_cap=caps[1],
                  step_size=2)
    live = sc.lives[0]
    live_j = j_mc(jnp.asarray(live.numpy()), level=0.0,
                  vert_cap=live_caps[0], face_cap=live_caps[1], step_size=1,
                  with_normals=False)
    wf_t = convert.warp_field_from_jax(
        {f: np.asarray(getattr(wf_j, f)) for f in WF_FIELDS}, device="cpu")
    mesh_t = convert.mesh_from_jax(
        {k: np.asarray(v) for k, v in mesh_j.items()}, device="cpu")
    ctx = bench.energy_context(wf_t, mesh_t, live, hyper)
    assert int(torch.sum(ctx.lmask)) == int(live_j["n_verts"])

    rng = np.random.RandomState(0)
    dq0 = np.asarray(wf_j.node_dq)
    active = np.asarray(wf_j.active)[:, None]
    dq1 = (dq0 + np.where(active, rng.normal(0, 0.02, dq0.shape), 0.0)
           ).astype(np.float32)
    lw = np.asarray(LW_REF, np.float32)
    for dq in (dq0, dq1):
        want = j_track_energy(wf_j, mesh_j, live_j, caps, live_caps,
                              jnp.asarray(dq), jnp.asarray(lw))
        raw, rob, nc = bench.track_energy(ctx, torch.from_numpy(dq),
                                          torch.from_numpy(lw))
        assert int(nc) == want[2] > 0
        np.testing.assert_allclose([float(raw), float(rob)], want[:2],
                                   rtol=ENERGY_RTOL)


def j_gates(dev99, cost_pre, cost_f, cost_e, pool_risk, corr_risk, n_verts,
            res):
    """bench.py:309-345's expressions, verbatim but for RES."""
    cost_ratio = cost_f / max(cost_e, 1e-30)
    cost_slack = cost_f - cost_e
    cost_ok = (cost_ratio < 1.10) or (
        (cost_slack <= 0.01 * cost_pre) and (cost_ratio < 2.0)
    )
    n_verts = max(n_verts, 1)
    risk_ok = (pool_risk <= 1e-4 * res**3) and (corr_risk <= 0.01 * n_verts)
    acc_ok = (dev99 < 0.5) and cost_ok and risk_ok
    return cost_ratio, cost_slack, dev99 < 0.5, cost_ok, risk_ok, acc_ok


# (dev99, cost_pre, cost_f, cost_e, pool_risk, corr_risk, n_verts, res)
GATE_CASES = [
    (0.1, 100.0, 1.0, 1.0, 0, 0, 1000, 256),        # all pass
    (0.5, 100.0, 1.0, 1.0, 0, 0, 1000, 256),        # gate 1 at its bound
    (0.4999, 100.0, 1.0, 1.0, 0, 0, 1000, 256),
    (0.1, 1.0, 1.1, 1.0, 0, 0, 1000, 256),          # ratio 1.10
    (0.1, 1.0, 1.0999, 1.0, 0, 0, 1000, 256),
    (0.1, 50.0, 2.0, 1.5, 0, 0, 1000, 256),         # slack exactly 1%
    (0.1, 49.9, 2.0, 1.5, 0, 0, 1000, 256),         # slack just above 1%
    (0.1, 100.0, 1.0, 0.5, 0, 0, 1000, 256),        # ratio 2, slack 0.5%
    (0.1, 100.0, 0.999, 0.5, 0, 0, 1000, 256),      # ratio just below 2
    (0.1, 100.0, 1.0, 0.0, 0, 0, 1000, 256),        # deep cost 0
    (0.1, 100.0, 1.0, 1.0, 1677, 0, 1000, 256),     # pool_risk 1e-4·R³
    (0.1, 100.0, 1.0, 1.0, 1678, 0, 1000, 256),
    (0.1, 100.0, 1.0, 1.0, 100, 0, 1000, 100),      # 1e-4·100³
    (0.1, 100.0, 1.0, 1.0, 101, 0, 1000, 100),
    (0.1, 100.0, 1.0, 1.0, 0, 10, 1000, 256),       # corr_risk 1%
    (0.1, 100.0, 1.0, 1.0, 0, 11, 1000, 256),
    (0.1, 100.0, 1.0, 1.0, 0, 0, 0, 256),           # no vertices
    (0.1, 100.0, 1.0, 1.0, 0, 1, 0, 256),
    (0.7, 100.0, 3.0, 1.0, 2000, 20, 1000, 256),    # all fail
]


@pytest.mark.parametrize("case", GATE_CASES)
def test_gates_match_bench_expressions(case):
    want = j_gates(*case)
    g = bench.gates(*case)
    assert (g["cost_ratio"], g["cost_slack"], g["gate1"], g["gate2"],
            g["gate3"], g["accuracy_ok"]) == want


def test_bench_cpu_json_line(capsys):
    """The bench end to end at 32³ on the CPU (the kernels' plain twins):
    one JSON last line with bench.py's keys and a boolean accuracy_ok."""
    report = bench.main(["--res", str(RES), "--device", "cpu"])
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert tuple(line) == bench.RESULT_KEYS
    assert line["metric"] == f"frame_ms_{RES}" and line["unit"] == "ms/frame"
    assert isinstance(line["accuracy_ok"], bool)
    assert line["accuracy_ok"] == report.gates["accuracy_ok"]
    assert line["corr_risk"] == line["corr_refresh"] == 0
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["accuracy_tsdf_dev_p999"] < bench.GATE_DEV_P999
    assert line["pool_risk"] == 0 and not report.mesh_overflow
    assert len(report.frame_walls) == 2 + 1 + bench.N_LIVES
    assert set(report.cost) == {"fast", "exact_same", "exact_deep"}
    assert "# accuracy: gate 1" in out.err
    assert "peak device memory" in out.err and "not measured" in out.err


@pytest.mark.parametrize("main", [
    bench.main, suite.main, diag_gate.main, diag_config7.main,
], ids=["bench", "suite", "diag_gate", "diag_config7"])
def test_entry_points_need_a_card(main, capsys):
    """Without a card and without --device cpu each entry point raises
    before it prints anything on standard output."""
    assert not torch.cuda.is_available()
    argv = ["--res", str(RES)] if main is not suite.main else ["--config", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert capsys.readouterr().out == ""
