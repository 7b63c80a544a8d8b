"""A run on the CPU at a small size: the result line's schema, the
control coming out not correct, and each fault a cell can have, planted
under the timed path, turning ``correct`` false. The card is skipped
(``run_cell`` is driven directly); the program's kernels run as their
plain twins."""

import json

import pytest
import torch

import dynamicfusion_body_tpu_torch.pipeline.fusion as port_fusion
from h100bench import trace
from h100bench.drivers import fusion_frame as drv_frame
from h100bench.run import run_cell
from h100bench.tests._small import small_cell

CPU = torch.device("cpu")
SEED = 2 ** 32 + 99
TRACK, MESH, TSDF = "track_256_motion", "ingest_512_mesh", "ingest_512_tsdf"


def _run(name, seconds=1.0, control=False):
    torch.set_num_threads(2)
    return run_cell(small_cell(name), SEED, seconds, False, CPU,
                    control=control)


@pytest.mark.parametrize("name", [TRACK, MESH, TSDF])
def test_sound_run_schema(name):
    out = _run(name)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {"setup_s", "frame_ms"} if name == TRACK else {
        "setup_s", "captures_per_s", "capture_p95_ms"}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("name", [TRACK, MESH, TSDF])
def test_control_is_not_correct(name):
    assert _run(name, control=True)["correct"] is False


def _frame_fault(kind):
    real = drv_frame.fusion_frame

    def fault(values, weights, live, wf, lw, **kw):
        v, w, wf2, lw2, stats, mesh = real(values, weights, live, wf, lw,
                                           **kw)
        if kind == "unchanged":
            return values, weights, wf, lw, stats, kw["canon_mesh"] or mesh
        if kind == "half":
            h = v.shape[0] // 2
            v = torch.cat([v[:h], values[h:]])
            w = torch.cat([w[:h], weights[h:]])
        if kind == "altered":
            mesh = dict(mesh, verts=mesh["verts"].clone())
            mesh["verts"][0, 0] += 0.25
        return v, w, wf2, lw2, stats, mesh

    return fault


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_tracking_faults_are_caught(monkeypatch, kind):
    monkeypatch.setattr(drv_frame, "fusion_frame", _frame_fault(kind))
    assert _run(TRACK)["correct"] is False


def _capture_fault(kind):
    real = port_fusion.FusionDM.compute_live_tsdf

    def fault(self, depths, lws, **kw):
        if kind == "half":
            return real(self, depths[: len(depths) // 2],
                        lws[: len(lws) // 2], **kw)
        v, w = real(self, depths, lws, **kw)
        if kind == "unchanged":
            v, w = torch.full_like(v, self._tdist), torch.zeros_like(w)
            self.volume = self.volume.replace(values=v, weights=w)
        if kind == "altered":
            v = v.clone()
            v.view(-1)[v.numel() // 2] += 0.5
            self.volume = self.volume.replace(values=v)
        return v, w

    return fault


@pytest.mark.parametrize("name", [MESH, TSDF])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_ingest_faults_are_caught(monkeypatch, name, kind):
    monkeypatch.setattr(port_fusion.FusionDM, "compute_live_tsdf",
                        _capture_fault(kind))
    assert _run(name)["correct"] is False


def test_trace_summary_by_hand(tmp_path):
    """Busy time is the union of the window's device intervals; launches
    and idle gaps come from the window's host calls."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 100, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 100,
         "dur": 40},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 105, "dur": 2, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110, "dur": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 150,
         "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 120, "dur": 20,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 130, "dur": 20,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k_other", "ts": 10, "dur": 5,
         "args": {"correlation": 99}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(str(path))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["launches"] == 2 and s["lost_launches"] == 0
    assert s["kernels"] == {"k_a": [pytest.approx(20e-6)],
                            "k_b": [pytest.approx(20e-6)]}
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(20e-6)
    assert gaps["aten::nonzero"] == pytest.approx(50e-6)
