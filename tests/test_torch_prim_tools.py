"""The port's primitive, solver, assembly and MC-stage microbenchmarks
(``dynamicfusion_body_tpu_torch/tools/profile_prims.py``,
``profile_prims2.py``, ``profile_solver.py``, ``exp_asm.py``,
``profile_mc2.py``), run end to end with ``--device cpu`` at a small
size (every row printed), and their computations held to the solver's
own and to the JAX package's on seeded inputs:

* ``profile_solver``'s parts against ``solvers/nonrigid.py:pcg_solve``
  (one PCG step rebuilt from ``precond`` and ``matvec_blockH``) and the
  matrix-free data matvec against the assembled one, within
  ``SOLVER_RTOL`` of the result's scale;
* the neighbour reduce and the assembly against JAX's sorted-cumsum
  reducers (``make_sorted_reducer``, ``make_block_ell``), whose prefix
  differences carry ~T·ulp of error: ``CUMSUM_RTOL``;
* ``exp_asm``'s rows against the port's assembly (its own max |Δ|
  column), within ``CUMSUM_RTOL`` of the table's scale (measured ≤ 9.6e-5
  at T = 8448);
* ``profile_mc2``'s whole-extraction stage against JAX's marching cubes
  (equal counts and faces, vertices within 1e-5), its face stage against
  the whole one;
* ``profile_prims``' case build against K1's twin, its pad-concat
  against the JAX row's formula in jnp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu.ops.marching_cubes import marching_cubes as j_mc
from dynamicfusion_body_tpu.solvers import nonrigid as JNR
from dynamicfusion_body_tpu_torch.ops.mc_cuda import mc_case_cross_ref
from dynamicfusion_body_tpu_torch.solvers.nonrigid import (
    jtwj_contributions, pcg_solve)
from dynamicfusion_body_tpu_torch.tools import (
    exp_asm, profile_mc2, profile_prims, profile_prims2, profile_solver)
from dynamicfusion_body_tpu_torch.tools._scene import bumpy, cap

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--reps", "1"]
SOLVER = ["--res", "32"]
SOLVER_RTOL = 1e-5
CUMSUM_RTOL = 5e-4

ROWS = {
    profile_prims: (["--res", "32"], [
        "slice_x_shift(255^3 sum)", "slice_y_shift", "slice_z_shift",
        "slice_xyz_shift", "case_build_8corners",
        "case_build_8corners_torch", "gather_16.7M_from_256tbl",
        "gather_16.7M_from_67MB", "gather_262k_from_67MB",
        "gather_262k_from_128KB", "gather_1M_from_67MB",
        "cumsum_16.7M_i32", "cumsum_50M_bool", "nonzero_50M_bool",
        "sort_131k_i32", "argsort_131k_i32", "brick_transpose_reduce",
        "padconcat_3x67MB"]),
    profile_prims2: (["--res", "32"], [
        "gather_128k_from_67MB", "gather_256k_from_67MB",
        "gather_1024k_from_67MB", "gather_4096k_from_67MB",
        "gather_16384k_from_67MB", "rowgather_2048x512_from_192MB",
        "rowgather_8192x512", "searchsorted_131k_x2048",
        "gather_2048x128_of_512", "index_add_94k_into_131k"]),
    profile_solver: (SOLVER, [
        "elementwise_(N,8)", "gather_rows_(M,8)->(N,8)", "red_nbr_(N,8)",
        "red_nbr_(N,64)", "precond_(M,8,8)", "matvec_data",
        "matvec_blockH_(M,24,8,8)", "assembly_red_(T,64)", "pcg_16"]),
    exp_asm: (SOLVER, [
        "A_index_add(T,64)", "A_full_build+index_add",
        "B_transpose+row_reduce", "B2_row_reduce_only(T,64)",
        "C_build_rows+row_reduce", "CM_build_cm+col_reduce",
        "CMB_build_cm+transpose+row_reduce", "E_blocked_cumsum_B256",
        "E_blocked_cumsum_B512", "E_blocked_cumsum_B1024",
        "E_blocked_cumsum_B2048"]),
    profile_mc2: (["--res", "32"], [
        "upto_case_cross", "upto_edges", "upto_verts", "upto_ntris",
        "upto_faces", "upto_normals"]),
}


@pytest.fixture(scope="module")
def small():
    return profile_solver.solver_inputs(32, torch.device("cpu"))


@pytest.mark.parametrize("tool", list(ROWS), ids=lambda m: m.__name__)
def test_tool_prints_every_row(tool, capsys):
    argv, names = ROWS[tool]
    rows = tool.main(SMALL + argv)
    out = capsys.readouterr().out
    assert list(rows) == names
    for name, row in rows.items():
        assert f"\n{name} " in out or out.startswith(f"{name} ")
        assert np.isfinite(row["wall_ms"]) and row["event_ms"] is None
        assert row["bound_by"] in ("bytes", "operations")
    if tool is exp_asm:
        for name, row in rows.items():
            assert row["max_diff"] <= CUMSUM_RTOL * row["scale"], name
        assert rows["A_index_add(T,64)"]["max_diff"] == 0.0


def test_solver_parts_rebuild_a_pcg_step(small):
    s = small
    assert s.n_overflow == 0
    z = profile_solver.precond(s.Dinv, s.rhs)
    Az = profile_solver.matvec_blockH(s.Bl, s.ell_nbr, z)
    alpha = torch.sum(s.rhs * z) / torch.sum(z * Az)
    want = pcg_solve(s.Bl, s.blk, s.ell_nbr, s.rhs, profile_solver.LAM, 1)
    scale = float(want.abs().max())
    np.testing.assert_allclose((alpha * z).numpy(), want.numpy(), rtol=0,
                               atol=SOLVER_RTOL * scale)
    # Dinv is the damped diagonal blocks' inverse
    eye = torch.eye(8).expand(s.M, 8, 8)
    damped = s.blk + profile_solver.LAM * torch.eye(8)
    np.testing.assert_allclose((s.Dinv @ damped).numpy(), eye.numpy(),
                               atol=1e-3)


def test_graph_stats_count_the_couplings(small):
    """``graph_stats`` against a set of the node pairs built in Python."""
    s = small
    pairs = set()
    for row in s.nbr_idx[s.corr_mask].tolist():
        pairs |= {(min(a, b), max(a, b)) for a in row for b in row if a != b}
    for a, b, m in zip(s.pair_i.tolist(), s.pair_j.tolist(),
                       s.pair_mask.tolist()):
        if m and a != b:
            pairs.add((min(a, b), max(a, b)))
    deg = np.bincount(np.array(sorted(pairs)).reshape(-1), minlength=s.M)
    gap = np.array([b - a for a, b in pairs], np.float64)
    g = profile_solver.graph_stats(s)
    assert g["pairs"] == len(pairs) > s.n_nodes
    assert g["deg_max"] == deg.max()
    np.testing.assert_allclose(g["deg_mean"], deg[deg > 0].mean())
    assert g["gap_max"] == gap.max()
    np.testing.assert_allclose([g["gap_p50"], g["gap_p95"]],
                               np.quantile(gap, [0.5, 0.95]))


def test_matvec_data_equals_assembled_data_term(small):
    s = small
    blocks = s.reduce_ell(jtwj_contributions(s.J_d, s.w_d, s.J_ri, s.J_rj,
                                             s.w_r * 0))
    Bl = blocks.reshape(s.M, s.D, 8, 8)
    p = torch.from_numpy(np.random.RandomState(2).randn(s.M, 8)
                         .astype(np.float32))
    want = profile_solver.matvec_blockH(Bl, s.ell_nbr, p, lam=0.0)
    got = profile_solver.matvec_data(s.J_d, s.w_d, s.nbr_idx, p)
    scale = float(want.abs().max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=SOLVER_RTOL * 10 * scale)


def test_reduce_and_assembly_match_jax(small):
    s = small
    flat = s.nbr_idx.reshape(-1)
    x = np.random.RandomState(3).rand(flat.numel(), 8).astype(np.float32)
    want = np.asarray(JNR.make_sorted_reducer(
        jnp.asarray(flat.numpy().astype(np.int32)), s.M)(jnp.asarray(x.T)))
    got = profile_solver.red_nbr(torch.from_numpy(x), flat, s.M).numpy()
    np.testing.assert_allclose(got.T, want, rtol=0,
                               atol=CUMSUM_RTOL * np.abs(want).max())

    i32 = [jnp.asarray(a.numpy().astype(np.int32))
           for a in (s.nbr_idx, s.pair_i, s.pair_j)]
    red, ell_nbr, self_ids, present, over = JNR.make_block_ell(
        i32[0], jnp.asarray(s.corr_mask.numpy()), i32[1], i32[2],
        jnp.asarray(s.pair_mask.numpy()), s.M, s.D)
    assert int(over) == s.n_overflow == 0
    np.testing.assert_array_equal(np.asarray(ell_nbr), s.ell_nbr.numpy())
    contrib = s.contrib.numpy()
    want = np.asarray(red(jnp.asarray(contrib.T))).T
    got = s.reduce_ell(s.contrib).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=CUMSUM_RTOL * np.abs(want).max())


def test_exp_asm_layouts_equal_assembly(small):
    """Each layout's reduce on the same rows against ``index_add_``."""
    s = small
    lay = exp_asm.row_layout(s)
    ref = s.reduce_ell(s.contrib)
    tol = CUMSUM_RTOL * float(ref.abs().max())
    cm = exp_asm.build_cm(s)
    np.testing.assert_array_equal(cm.T.numpy(), s.contrib.numpy())
    for got in (exp_asm.row_reduce(s.contrib, lay),
                exp_asm.col_reduce(cm, lay),
                exp_asm.col_reduce_blocked(cm, lay, 256)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=tol)


def test_mc2_stages_match_jax():
    res = 32
    vol = bumpy(res, (128, 128, 128), 0.0)
    vc, fc = cap(1 << 17, res), cap(1 << 18, res, 4096)
    want = j_mc(jnp.asarray(vol), vert_cap=vc, face_cap=fc)
    tvol = torch.from_numpy(vol)
    got = profile_mc2.upto("normals", tvol, vc, fc)
    for key in ("faces", "n_verts", "n_faces"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["verts"].numpy(), np.asarray(want["verts"]),
                               atol=1e-5)
    verts, (faces, n_faces) = profile_mc2.upto("faces", tvol, vc, fc)
    np.testing.assert_array_equal(faces.numpy(), got["faces"].numpy())
    nv = int(want["n_verts"])      # the vertex stage pads past the count
    np.testing.assert_array_equal(verts[:nv].numpy(),
                                  got["verts"][:nv].numpy())
    edges = profile_mc2.upto("edges", tvol, vc, fc)
    assert edges.numel() == int(want["n_verts"])
    cells, counts = profile_mc2.upto("ntris", tvol, vc, fc)[1]
    assert int(counts.sum()) == n_faces == int(want["n_faces"])


def test_prims_case_build_and_padconcat():
    rng = np.random.RandomState(4)
    vol = rng.rand(16, 16, 16).astype(np.float32)
    t = torch.from_numpy(vol)
    words = mc_case_cross_ref(t, 0.5)
    assert int(profile_prims.case_build(t)) == int(
        (words[:15, :15, :15] & 255).sum())
    outs = []
    for a in range(3):
        sl = [slice(None)] * 3
        sl[a] = slice(0, 15)
        pad = [(0, 0)] * 3
        pad[a] = (0, 1)
        outs.append(jnp.pad(jnp.asarray(vol)[tuple(sl)] * 2.0,
                            pad).reshape(-1))
    np.testing.assert_array_equal(profile_prims.padconcat(t).numpy(),
                                  np.asarray(jnp.concatenate(outs)))
