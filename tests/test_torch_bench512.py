"""The port's 512³ bench (dynamicfusion_body_tpu_torch.benchmarks.bench512)
at ``--res 64`` on the CPU: its ``Fusion`` with the bench's settings and
volumes against the JAX package's ``Fusion`` with the same, two frames
each (setupCorrespondences → solve → updateTSDF → update_graph), and the
script's last line.

Tolerances, per frame: node counts equal; the per-round costs the
drivers print (verbose) within rtol 2e-2 (measured at most 5e-3: the
second frame's rigid presolve starts from poses that differ by ~3e-3);
the fused canonical volumes within p99.9 |Δ| < 0.1 (measured 9e-5 after
the first frame, 0.022 after the second; the frame bench's gate is 0.5).
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu import Fusion as JFusion
from dynamicfusion_body_tpu_torch import Fusion as TFusion
from dynamicfusion_body_tpu_torch.benchmarks import bench512

# One intra-op thread (see tests/test_torch_marching_cubes.py)
torch.set_num_threads(1)

RES = 64
COST_RTOL = 2e-2
VOL_P999 = 0.1


def _costs(text):
    """(costs before, costs after) of every round a verbose driver
    printed."""
    return ([float(x) for x in
             re.findall(r"Cost before optimization: (\S+)", text)],
            [float(x) for x in
             re.findall(r"Optimized cost at \d+ iteration: (\S+)", text)])


def _drive(cls, host, tdist, **kw):
    buf = io.StringIO()
    frames = []
    with contextlib.redirect_stdout(buf):
        fus = cls(host[0], tdist, verbose=True, **bench512.DRIVER,
                  **bench512.caps(RES), **kw)
        n0 = int(fus._warp.num_active)
        for vol in host[1:3]:
            fus.setupCorrespondences(vol, **bench512.FRAME)
            fus.solve(**bench512.SOLVE)
            fus.updateTSDF()
            fus.update_graph()
            frames.append((int(fus._warp.num_active),
                           np.array(fus.volume.values)))
    return n0, frames, _costs(buf.getvalue())


@pytest.fixture(scope="module")
def drivers():
    host = bench512.volumes(RES)
    tdist = float(host[0].max())
    return (_drive(JFusion, host, tdist),
            _drive(TFusion, host, tdist, device="cpu"))


def test_bench512_nodes(drivers):
    (jn0, jframes, _), (tn0, tframes, _) = drivers
    assert tn0 == jn0 > 0
    assert [f[0] for f in tframes] == [f[0] for f in jframes]


def test_bench512_solve_costs(drivers):
    (_, _, (jb, ja)), (_, _, (tb, ta)) = drivers
    assert len(tb) == len(jb) >= 2 and len(ta) == len(ja) == len(tb)
    np.testing.assert_allclose(tb, jb, rtol=COST_RTOL)
    np.testing.assert_allclose(ta, ja, rtol=COST_RTOL)
    assert ta[0] < tb[0]


@pytest.mark.parametrize("frame", [0, 1])
def test_bench512_fused_volume(drivers, frame):
    (_, jframes, _), (_, tframes, _) = drivers
    dv = np.abs(tframes[frame][1] - jframes[frame][1])
    assert np.isfinite(tframes[frame][1]).all()
    assert np.percentile(dv, 99.9) < VOL_P999


def test_bench512_last_line(capsys):
    report = bench512.main(["--res", str(RES), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["metric"] == "frame_ms_512" and last["unit"] == "ms/frame"
    assert last["value"] > 0 and last == report.result
    assert len(report.walls) == 3 and report.launches == (0, 0)
    assert set(report.frames[0]) == {"correspondences", "solve", "update",
                                     "graph"}
