"""The port's ICP ingest (``FusionDM.compute_live_tsdf(useICP=True)``, its
correspondences through K7's twin) against the benchmark's plain
reference (``h100bench/reference/icp.py``), and the cell that measures it
(``ingest_512_icp``), on the CPU at small sizes: seeded captures of the
benchmark's body scene with three views, the later two handed over with
the traffic's calibration error.

* Poses: the reference finds them in float64, the port in float32; they
  agree to a few hundredths of a voxel at the volume's corners (the
  accept/reject of a Gauss-Newton step can flip on float32 noise, tests/
  test_torch_fusion_dm.py), held to 0.05.
* The volume: the reference chain run with the port's own poses gives
  the port's volume bit for bit.
* The cell: a sound run reads correct; the bfloat16 control, altered
  poses, an altered volume and a lost view do not; set-up refuses a
  program that keeps no per-view poses.
* Spans: ``icp`` under ``compute_live_tsdf``, and in it per later view
  ``correspondences`` (with the live ``marching_cubes`` and ``knn``),
  ``rigid`` and ``update``; the cell's three new readers return numbers.
"""

import copy
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu_torch.pipeline.fusion import FusionDM
from dynamicfusion_body_tpu_torch.utils import profiling as P
from h100bench import manifest
from h100bench.drivers import fusion_dm_icp as drv_icp
from h100bench.reference import icp as ref_icp
from h100bench.run import run_cell
from h100bench.tests._small import small_cell

CPU = torch.device("cpu")
SEED = 2 ** 32 + 1234
CELL = "ingest_512_icp"
POSE_TOL = 0.05      # voxels at the volume's corners
READERS = ("k7_roofline", "icp_corr_ms_per_capture",
           "icp_rigid_ms_per_capture")


def three_views(res=32, caps=None):
    """The cell at res³ with 3 of its 8 ring views (every third)."""
    cell = small_cell(CELL, res)
    cfg = copy.deepcopy(cell.config)
    cfg["cameras"]["views"] = 3
    if caps:
        cfg["caps"] = {"vert_cap": caps, "face_cap": 2 * caps}
    cell.config = cfg
    return cell


@pytest.fixture(scope="module")
def run32():
    """One traced capture of the 32³ cell: (driver, span counts, span
    totals)."""
    torch.set_num_threads(2)
    cell = three_views()
    drv = drv_icp.Driver(cell.config, cell.traffic, SEED, CPU)
    P.RECORDER.reset()
    with P.tracing():
        drv.request(0)
    spans = (dict(P.RECORDER.counts), dict(P.RECORDER.totals))
    P.RECORDER.reset()
    drv.sample()
    return drv, spans


@pytest.mark.parametrize("res", [32, 64])
def test_port_matches_reference(res):
    torch.set_num_threads(2)
    cell = three_views(res, caps=1 << 15)
    drv = drv_icp.Driver(cell.config, cell.traffic, SEED + res, CPU)
    depths, lws = drv.pool[1]
    fus = drv.fus
    v, w = fus.compute_live_tsdf(depths, lws, UseAutoAlignment=True,
                                 useICP=True, as_numpy=False)
    assert len(fus.icp_poses) == 2 and fus.icp_poses[-1] is fus._lw
    assert int(fus._corr_valid.sum()) > 100
    maps, projs, kr, _ = drv._inputs(1, fus._IND.astype(np.float64))
    args = (maps, projs, kr, res, drv.tdist)
    truth = ref_icp.poses(*args)
    gap = ref_icp.pose_gap(fus.icp_poses, truth, res)
    assert gap < POSE_TOL, gap
    # the calibration error is what the poses undo: well above the gap
    ident = [torch.tensor(ref_icp.IDENTITY, dtype=torch.float64)] * 2
    assert ref_icp.pose_gap(truth, ident, res) > 10 * POSE_TOL
    rv, rw = ref_icp.chain(*args, fus.icp_poses)
    assert torch.equal(v, rv) and torch.equal(w, rw)
    assert (w > 1).any()     # the later views did fold in


def test_checks_sound_and_control(run32):
    drv, _ = run32
    idx = max(drv.kept)
    lim = drv.cfg["limits"]
    sound = drv.check(idx)
    assert set(sound) == {"calib_gap", "pose_gap", "tsdf_gap", "weight_gap"}
    assert sound["tsdf_gap"] == 0 and sound["weight_gap"] == 0
    assert all(sound[k] <= lim[k] for k in sound), sound
    ctl = drv.check(idx, control=True)
    assert any(ctl[k] > lim[k] for k in ctl), ctl


@pytest.mark.parametrize("fault", ["pose", "volume", "lost_view"])
def test_faults_are_caught(run32, fault):
    drv, _ = run32
    idx = max(drv.kept)
    pi, v, w, ind, poses, over = drv.kept[idx]
    if fault == "pose":
        poses = [p.clone() for p in poses]
        poses[0][5] += 0.25          # a quarter voxel along x
    if fault == "volume":
        v = v.clone()
        v.view(-1)[v.numel() // 2] += 0.5 * drv.tdist
    if fault == "lost_view":
        poses = poses[:-1]
    saved = drv.kept[idx]
    drv.kept[idx] = (pi, v, w, ind, poses, over)
    try:
        nums = drv.check(idx)
    finally:
        drv.kept[idx] = saved
    lim = drv.cfg["limits"]
    assert any(nums[k] > lim[k] for k in nums), nums


def test_spans_and_readers(run32, monkeypatch):
    drv, (counts, totals) = run32
    root = "compute_live_tsdf/icp"
    for path, n in ((root, 1), (f"{root}/correspondences", 6),
                    (f"{root}/correspondences/marching_cubes", 6),
                    (f"{root}/correspondences/knn", 6), (f"{root}/rigid", 6),
                    (f"{root}/update", 2), (f"{root}/marching_cubes", 1),
                    (f"{root}/fuse", 3)):
        assert counts.get(path) == n, (path, counts.get(path))
    monkeypatch.setattr(P.RECORDER, "counts", counts)
    monkeypatch.setattr(P.RECORDER, "totals", totals)
    bounds = drv.kernel_bounds(0)
    assert [len(bounds[k]) for k in ("k5", "k1", "k7")] == [3, 7, 6]
    ctx = SimpleNamespace(
        unit="capture", traced=1, bounds=bounds,
        trace={"kernels": {"knn_grid_query_kernel<4>":
                           [2 * b * 1e-3 for b in bounds["k7"]]},
               "window_s": 1.0, "busy_s": 0.5, "launches": 10})
    got = {m: manifest.reader(m)(ctx) for m in READERS}
    assert got["k7_roofline"] == pytest.approx(50.0)
    assert got["icp_corr_ms_per_capture"] > 0
    assert got["icp_rigid_ms_per_capture"] > 0
    # the capture's calibration and upload, outside the branch
    for m in ("calib_ms_per_capture", "upload_ms_per_capture"):
        assert manifest.reader(m)(ctx) > 0, m
    # the canonical and live marching cubes lie under icp, not at the root
    assert manifest.reader("mc_ms_per_capture")(ctx) is None
    cell = manifest.cell(CELL)
    assert {m["name"] for m in cell.per_layer} >= set(READERS) | {
        "launches_per_capture", "device_idle_pct.ingest",
        "host_reads_per_capture", "k5_roofline", "k1_roofline.ingest",
        "calib_ms_per_capture", "upload_ms_per_capture"}


def test_sound_run_and_control():
    torch.set_num_threads(2)
    cell = three_views()
    out = json.loads(json.dumps(run_cell(cell, SEED, 1.0, False, CPU)))
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "captures_per_s",
                                   "capture_p95_ms"}
    assert set(out["checks"]) == {"calib_gap", "pose_gap", "tsdf_gap",
                                  "weight_gap"}
    assert run_cell(cell, SEED, 1.0, False, CPU, control=True)[
        "correct"] is False


def test_refuses_a_program_without_poses(monkeypatch):
    """A FusionDM that keeps no per-view poses (the port before it did)
    is refused in set-up, before any capture."""
    real = FusionDM.__init__

    def old(self, *a, **kw):
        real(self, *a, **kw)
        del self.icp_poses

    monkeypatch.setattr(FusionDM, "__init__", old)
    cell = three_views()
    with pytest.raises(RuntimeError, match="per-view ICP poses"):
        drv_icp.Driver(cell.config, cell.traffic, SEED, CPU)


def test_icp_settings_come_from_the_program(monkeypatch):
    """The driver takes k, rounds, GN steps and tolerance from the
    program (``FusionDM.icp_settings``), so the reference and the bounds
    follow what the program runs."""
    monkeypatch.setattr(FusionDM, "ICP_ROUNDS", 2)
    cell = three_views()
    drv = drv_icp.Driver(cell.config, cell.traffic, SEED, CPU)
    assert drv.icp == {"k": 4, "rounds": 2, "iters": FusionDM.ICP_ITERS,
                       "tolerance": FusionDM.ICP_TOLERANCE}
    bounds = drv.kernel_bounds(0)
    assert [len(bounds[k]) for k in ("k5", "k1", "k7")] == [3, 5, 4]


def test_reference_update_in_bfloat16_on_a_512_wide_lattice():
    """The control's rigid update indexes a 512-wide lattice, whose top
    index bfloat16 cannot hold (511 rounds to 512)."""
    g = torch.Generator().manual_seed(3)
    vals = torch.rand(4, 4, 512, generator=g) * 0.04 - 0.02
    x = torch.tensor(ref_icp.IDENTITY, dtype=torch.float64)
    args = (torch.full_like(vals, 0.02), torch.zeros_like(vals), vals, x,
            0.02)
    v, w = ref_icp.update_rigid(*args, dtype=torch.bfloat16)
    v32, w32 = ref_icp.update_rigid(*args)
    assert torch.isfinite(v).all()
    # most voxels update in both; bfloat16 moves some across −tdist
    assert (w == 1).float().mean() > 0.5 and (w != w32).float().mean() < 0.1
