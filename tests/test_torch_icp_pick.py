"""K9 (``ops/icp_pick_cuda.py``: the rigid ICP's warp and point-to-plane
pick) on the CPU, where its wrapper takes the plain composition
(``pipeline/correspondence.py:rigid_correspondences_twin``). Over
``tools/profile_icp_pick.py``'s cases the entry's outputs are held to an
independent float64 evaluation of what the composition computes (the
sandwich, the k nearest live vertices, the first least plane cost, the
1.0 fallback, the tolerance); each case reaches the edge its name says;
the arguments the kernels cannot take are refused on every device; the
wrappers are the port's. The kernels' bits against the composition on
the card are held by ``chip_smoke.py`` (phase 10) and by
``python -m dynamicfusion_body_tpu_torch.tools.profile_icp_pick --res
512``."""

import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu_torch.ops import cuda_lib
from dynamicfusion_body_tpu_torch.ops import icp_pick_cuda as K9
from dynamicfusion_body_tpu_torch.ops.dualquat import (
    dq_transform_normal, dq_transform_point)
from dynamicfusion_body_tpu_torch.pipeline.correspondence import (
    closest_point_correspondences_lattice)
from dynamicfusion_body_tpu_torch.tools.profile_icp_pick import (
    edge_cases, unequal)

torch.set_num_threads(1)

CASES = edge_cases(torch.device("cpu"))


def composition(dq, verts, normals, n, live, n_live, k, tol, extent):
    return closest_point_correspondences_lattice(
        dq_transform_point(dq, verts), dq_transform_normal(dq, normals), n,
        live, n_live, k, tol, extent)


def _qmul(a, b):
    """Hamilton products of (..., 4) float64 arrays."""
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], -1)


def _sandwich(r, d, p):
    """(r + εd)·(1 + εp)·conj(r + εd), the full conjugate, in float64:
    the moved points (V,3)."""
    one = np.broadcast_to(np.array([1.0, 0, 0, 0]), (p.shape[0], 4))
    vd = np.concatenate([np.zeros((p.shape[0], 1)), p], 1)
    ar, ad = _qmul(r, one), _qmul(r, vd) + _qmul(d, one)
    cr, cd = r * [1.0, -1, -1, -1], d * [-1.0, 1, 1, 1]
    return (_qmul(ar, cd) + _qmul(ad, cr))[:, 1:]


@pytest.mark.parametrize("name", list(CASES))
def test_entry_returns_the_composition(name):
    """The entry's (corr, valid, best_cost) against the composition's
    semantics in float64: every corr a live vertex; rows past the count,
    or with no live vertex, live vertex 0, cost 1 and invalid; a counted
    row's cost its corr's plane cost and the least of its k nearest where
    below 1, else 1 with the nearest; valid where the cost is within the
    tolerance."""
    args = CASES[name]
    corr, valid, cost = K9.rigid_correspondences_lattice(*args)
    dq, verts, normals, n, live, n_live, k, tol, _ = args
    V, P = verts.shape[0], live.shape[0]
    assert [tuple(t.shape) for t in (corr, valid, cost)] == [
        (V, 3), (V,), (V,)]
    assert [t.dtype for t in (corr, valid, cost)] == [
        torch.float32, torch.bool, torch.float32]
    n, m = min(int(n), V), min(int(n_live), P)
    dq = np.asarray(torch.as_tensor(dq), np.float64)
    wv = _sandwich(dq[:4], dq[4:], verts[:n].double().numpy())
    wn = _sandwich(dq[:4], np.zeros(4), normals[:n].double().numpy())
    pts = live[:max(m, 1)].double().numpy()
    c64, cost = corr.double().numpy(), cost.double().numpy()
    assert (c64[:, None, :] == pts[None]).all(-1).any(-1).all()
    no_cand = np.arange(V) >= (n if m else 0)  # live vertex 0, cost 1
    assert (c64[no_cand] == pts[0]).all() and (cost[no_cand] == 1.0).all()
    assert not valid[torch.from_numpy(no_cand)].any()
    assert (valid.numpy() == (~no_cand & (cost <= tol))).all()
    for i in np.flatnonzero(~no_cand):
        dist = np.linalg.norm(pts - wv[i], axis=1)
        near = np.argsort(dist, kind="stable")[:k]
        plane = np.abs((pts[near] - wv[i]) @ wn[i])
        least = np.min(plane) if not np.isnan(plane).any() else np.nan
        if cost[i] < 1.0:
            own = abs((c64[i] - wv[i]) @ wn[i])
            assert abs(cost[i] - own) < 1e-4 and own < least + 1e-4, i
        else:
            assert cost[i] == 1.0 and not least < 1.0 - 1e-4, i
            assert abs(np.linalg.norm(c64[i] - wv[i]) - dist[near[0]]) \
                < 1e-4, i


def _first(live, args):
    """Each row's candidate 0: K7's nearest (the live vertex 0 where it
    found none)."""
    dq, verts, _, n, _, n_live, k, _, extent = args
    from dynamicfusion_body_tpu_torch.ops.knn_grid_cuda import knn_grid

    _, idx = knn_grid(dq_transform_point(dq, verts), live, k, n, n_live,
                      extent)
    return live[idx[:, 0]]


def test_cases_reach_their_edges():
    out = {name: composition(*args) for name, args in CASES.items()}
    rows = torch.arange(96)
    n = int(CASES["rows_some"][3])
    for name in ("rows_0", "live_0"):
        corr, valid, cost = out[name]
        assert not valid.any() and (cost == 1.0).all(), name
        assert (corr == CASES[name][4][0]).all(), name
    corr, valid, cost = out["rows_some"]
    assert valid[:n].all() and not valid[n:].any()  # tolerance 1
    assert (cost[:n] < 1.0).any() and (cost[:n] == 1.0).any()
    assert out["rows_all"][1][n:].any()
    # ties: four candidates of one cost, the first taken
    corr, valid, cost = out["tie"]
    assert valid.all() and (cost == 0.25).all()
    assert (corr == _first(CASES["tie"][4], CASES["tie"])).all()
    # no candidate under a cost of 1: candidate 0 and cost 1
    for name, any_valid in (("fallback", True), ("fallback_tol_half", False)):
        corr, valid, cost = out[name]
        assert (cost == 1.0).all(), name
        assert (corr == _first(CASES[name][4], CASES[name])).all(), name
        assert bool(valid[:n].all()) is any_valid and not valid[n:].any()
    # NaN normals: a NaN cost, so candidate 0 and cost 1
    corr, valid, cost = out["nan_normals"]
    nan_rows = (rows % 5 == 0) & (rows < n)
    assert (cost[nan_rows] == 1.0).all()
    args = CASES["nan_normals"]
    assert (corr[nan_rows] == _first(args[4], args)[nan_rows]).all()
    # non-finite canonical rows past the count: invalid, as any row there
    corr, valid, cost = out["nonfinite_past_n"]
    assert not torch.isfinite(CASES["nonfinite_past_n"][1][n:]).any()
    assert not valid[n:].any() and (cost[n:] == 1.0).all()
    assert unequal(out["nonfinite_past_n"][:2],
                   out["rows_some"][:2]) == 0
    # k = 1 keeps the nearest, k = 8 looks further
    assert (out["k1"][0] == _first(CASES["k1"][4], CASES["k1"])).all()
    assert (out["k8"][2] <= out["rows_some"][2]).all()


def _bad(case):
    dq, verts, normals, n, live, n_live, k, tol, extent = CASES["rows_some"]
    if case == "dtype":
        verts = verts.double()
    elif case == "verts4":
        verts = torch.zeros(verts.shape[0], 4)
    elif case == "normals":
        normals = normals[:-1]
    elif case == "dq7":
        dq = dq[:7]
    elif case == "live2":
        live = live[:, :2]
    elif case in ("k0", "k9"):
        k = int(case[1])
    elif case == "device":
        live = live.to("meta")
    elif case == "rows3":  # 3·V past the kernels' int index, V·k not
        dq, live, k = dq.to("meta"), live.to("meta"), 1
        verts = normals = torch.empty(716_000_000, 3, device="meta")
    return dq, verts, normals, n, live, n_live, k, tol, extent


@pytest.mark.parametrize("case", ["dtype", "verts4", "normals", "dq7",
                                  "live2", "k0", "k9", "device", "rows3"])
def test_refuses_what_the_kernels_take_not(case):
    with pytest.raises(ValueError, match="rigid_correspondences"):
        K9.rigid_correspondences_lattice(*_bad(case))


def test_kernels_are_the_ports_wrappers():
    kernels = cuda_lib.wrappers()
    assert kernels[K9.warp] == "icp_warp_kernel"
    assert kernels[K9.rigid_correspondences_lattice] == "icp_pick_kernel"
    dq, verts, _, n = CASES["rows_some"][:4]
    with pytest.raises(ValueError, match="unsupported device cpu"):
        K9.warp(dq, verts, n)  # no plain twin: the card's alone
