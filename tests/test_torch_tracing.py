"""The program's spans (``utils/profiling.py``: ``span``, ``host_read``,
``RECORDER``, ``DeviceTrace.by_span``) on the CPU: off they record nothing
and enter no profiler range; on, they nest with their parents, self times
and request ids and sit in the profiler's trace; ``by_span`` puts device
time and idle gaps down to them; the benchmark's span readers count the
ingest cells' host reads exactly; a tracking frame opens every frame
span."""

import importlib
import json
import math
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynamicfusion_body_tpu_torch.utils import profiling as P
from h100bench import manifest
from h100bench.tests._small import small_cell

CPU = torch.device("cpu")
SEED = 2 ** 32 + 7
# host reads of one capture in the program's calls: compute_live_tsdf 29
# (8 map uploads, 8 extrinsic uploads, 8 reads of the grid matrix, 5 small
# uploads), marching_cubes 11 (two nonzero, a face count, two
# repeat_interleave reading twice each, three count uploads, the overflow
# check); the card's sync debug mode warns as often (PERF.md)
HOST_READS = {"ingest_512_tsdf": 29, "ingest_512_mesh": 40}
READERS = ("host_reads_per_capture", "calib_ms_per_capture",
           "upload_ms_per_capture", "mc_ms_per_capture")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    torch.set_num_threads(2)
    P.RECORDER.reset()
    yield
    P.RECORDER.reset()


class _Counted:
    entered = 0

    def __init__(self, name, args=None):
        pass

    def __enter__(self):
        _Counted.entered += 1

    def __exit__(self, *exc):
        return False


def _nested():
    with P.span("outer"):
        time.sleep(0.002)
        with P.span("inner"):
            time.sleep(0.003)
            with P.host_read(2):
                pass
        with P.span("outer"):  # continues the open span of its name
            pass
    with P.span("second"):
        with P.span("inner"):
            pass


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)

    def no_sync(*a, **k):
        raise AssertionError("a span synchronized the card")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    _Counted.entered = 0
    assert not torch.autograd._profiler_enabled()
    _nested()
    assert P.span("x") is P.span("y")  # one shared object: nothing made
    assert _Counted.entered == 0
    assert P.RECORDER.records == [] and not P.RECORDER.counts
    with P.tracing():
        _nested()
    assert _Counted.entered == 5
    assert len(P.RECORDER.records) == 5


def test_on_nests_parents_self_time_and_requests(tmp_path):
    with P.device_trace(str(tmp_path), cuda=False) as tr:
        _nested()
    rec = P.RECORDER
    names = [(r[0], r[1], r[2], r[3]) for r in rec.records]
    assert names == [("outer", "outer", -1, 1),
                     ("inner", "outer/inner", 0, 1),
                     ("host_read", "outer/inner/host_read", 1, 1),
                     ("second", "second", -1, 2),
                     ("inner", "second/inner", 3, 2)]
    for name, path, parent, req, t0, t1 in rec.records:
        assert t1 >= t0
        if parent >= 0:
            up = rec.records[parent]
            assert up[4] <= t0 and t1 <= up[5]
    assert rec.counts["outer/inner/host_read"] == 2
    s = rec.span_summary()
    assert s["outer"]["count"] == 1 and s["outer/inner"]["count"] == 1
    inner = s["outer/inner"]["total_s"]
    assert inner >= 0.003
    assert s["outer"]["total_s"] >= inner + 0.002
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["total_s"] - inner, abs=2e-6)
    # the spans sit in the exported trace as ranges nested in the block
    with open(tr.path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    block = next(e for e in ev if e["name"] == P.BLOCK)
    spans = [e for e in ev if e["name"] != P.BLOCK]
    assert sorted(e["name"] for e in spans) == [
        "host_read", "inner", "inner", "outer", "second"]
    for e in spans:
        assert block["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= block["ts"] + block["dur"]
    outer = next(e for e in spans if e["name"] == "outer")
    hr = next(e for e in spans if e["name"] == "host_read")
    assert outer["ts"] <= hr["ts"] <= outer["ts"] + outer["dur"]


def _ev(cat, name, ts, dur, corr=None, tid=1):
    args = {} if corr is None else {"correlation": corr}
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                args=args)


def test_by_span_on_a_hand_made_trace(tmp_path):
    ua = "user_annotation"
    events = [
        _ev(ua, P.BLOCK, 0, 100), _ev(ua, "a", 10, 60),
        _ev(ua, "b", 20, 25), _ev(ua, "other_thread", 0, 100, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 25, 2, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 2, 2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 80, 2, 3),
        _ev("kernel", "k1", 30, 10, 1), _ev("kernel", "k2", 62, 5, 2),
        _ev("gpu_memcpy", "Memcpy HtoD", 85, 5, 3),
        _ev("kernel", "outside_the_block", 200, 5, 9)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = P.DeviceTrace()
    tr.path = str(path)
    got = tr.by_span()
    assert set(got) == {"a", "a/b", P.NO_SPAN}
    want = {"a": (1, 0.060, 0.015, 0.018), "a/b": (1, 0.025, 0.010, 0.022),
            P.NO_SPAN: (0, 0.0, 0.005, 0.040)}
    for k, (n, host, dev, idle) in want.items():
        assert got[k]["count"] == n
        assert got[k]["host_ms"] == pytest.approx(host)
        assert got[k]["device_ms"] == pytest.approx(dev)
        assert got[k]["idle_ms"] == pytest.approx(idle)


def _driver(name):
    cell = small_cell(name)
    mod = importlib.import_module(
        f"h100bench.drivers.{cell.config['entry']}")
    drv = mod.Driver(cell.config, cell.traffic, SEED, CPU)
    drv.warm_up()
    return drv, mod.UNIT


def _read(name, ctx):
    return {m: manifest.reader(m)(ctx) for m in READERS}


@pytest.mark.parametrize("name", sorted(HOST_READS))
def test_ingest_readers_count_host_reads(name):
    drv, unit = _driver(name)
    P.RECORDER.reset()
    n = 2
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n):
            drv.request(i)
    traced = SimpleNamespace(unit=unit, trace={"window_s": 1.0}, traced=n)
    got = _read(name, traced)
    assert got["host_reads_per_capture"] == HOST_READS[name]
    for m in READERS:
        if m == "mc_ms_per_capture" and name == "ingest_512_tsdf":
            assert got[m] is None
        else:
            assert math.isfinite(got[m]) and got[m] > 0, (m, got[m])
    untraced = SimpleNamespace(unit=unit, trace=None, traced=0)
    assert all(v is None for v in _read(name, untraced).values())
    P.RECORDER.reset()
    drv.request(n)  # no profiler: nothing recorded, nothing read
    assert all(v is None for v in _read(name, traced).values())


def test_frame_opens_every_frame_span():
    drv, unit = _driver("track_256_motion")
    P.RECORDER.reset()
    with P.tracing():
        drv.request(0)
    paths = set(P.RECORDER.counts)
    for p in ("fusion_frame", "fusion_frame/marching_cubes/case_cross",
              "fusion_frame/correspondences", "fusion_frame/rigid",
              "fusion_frame/solve/gn_step/jacobians",
              "fusion_frame/solve/gn_step/assemble",
              "fusion_frame/solve/gn_step/pcg",
              "fusion_frame/solve/gn_step/lm_try/host_read",
              "fusion_frame/solve/gn_step/host_read",
              "fusion_frame/tsdf_update", "fusion_frame/graph_update",
              "fusion_frame/graph_update/marching_cubes",
              "fusion_frame/graph_update/host_read",
              "fusion_frame/host_read"):
        assert p in paths, (p, sorted(paths))
    assert {r[3] for r in P.RECORDER.records} == {1}  # one request
    # a frame is no capture: the ingest readers read nothing
    ctx = SimpleNamespace(unit=unit, trace={"window_s": 1.0}, traced=1)
    assert all(v is None for v in _read("track", ctx).values())
