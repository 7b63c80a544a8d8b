"""The port's warp-field checkpoints and ``.dist`` volumes against the JAX
package's (io/warpfield_io.py, io/sdf_io.py), and its ``sequence`` and
``dummy`` CLI commands on the CPU."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.io import sdf_io as JS
from dynamicfusion_body_tpu.io import warpfield_io as JIO
from dynamicfusion_body_tpu.models import warp_field as JW
from dynamicfusion_body_tpu_torch import cli, convert
from dynamicfusion_body_tpu_torch.io import sdf_io as TS
from dynamicfusion_body_tpu_torch.io import warpfield_io as TIO
from dynamicfusion_body_tpu_torch.models.warp_field import WarpField
from fixtures import ellipsoid_levelset

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)

WF_FIELDS = ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
             "radius")


def jax_field(rng, capacity=64):
    verts = (rng.rand(200, 3) * 20).astype(np.float32)
    wf = JW.construct_graph(jnp.asarray(verts), jnp.float32(4.0), capacity)
    dqs = (rng.randn(capacity, 8) * 0.1).astype(np.float32)
    dqs[:, 0] += 1.0
    return wf.replace(node_dq=jnp.asarray(dqs))


def test_warp_field_pickles_are_byte_identical(rng, tmp_path):
    wf = jax_field(rng)
    n = int(wf.num_active)
    assert 3 < n < wf.capacity
    twf = convert.warp_field_from_jax(
        {f: np.asarray(getattr(wf, f)) for f in WF_FIELDS}, device="cpu")
    jpath = JIO.save_warp_field(wf, str(tmp_path), "jax", 7)
    tpath = TIO.save_warp_field(twf, str(tmp_path), "port", 7)
    assert os.path.basename(tpath) == "port__7.p"
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    # cross-loaded both ways: the reference's list of 4-tuples
    for got, want in zip(TIO.load_warp_field_nodes(jpath),
                         JIO.load_warp_field_nodes(tpath)):
        np.testing.assert_array_equal(got, want)
    pos, dq, w, vidx = TIO.load_warp_field_nodes(jpath)
    np.testing.assert_array_equal(pos, np.asarray(wf.node_pos)[:n])
    np.testing.assert_array_equal(dq, np.asarray(wf.node_dq)[:n])
    np.testing.assert_array_equal(vidx, np.asarray(wf.node_vert_idx)[:n])


def test_restore_warp_field_matches_jax(rng, tmp_path):
    wf = jax_field(rng)
    path = JIO.save_warp_field(wf, str(tmp_path), "wf", 1)
    want = JIO.restore_warp_field(JW.WarpField, path, 80)
    got = TIO.restore_warp_field(WarpField, path, 80, device="cpu")
    for f in WF_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.node_vert_idx.dtype == torch.int64
    with pytest.raises(ValueError, match="capacity"):
        TIO.restore_warp_field(WarpField, path, 3, device="cpu")


@pytest.mark.parametrize("closest", [False, True])
def test_dist_volumes_round_trip_against_jax(rng, tmp_path, closest):
    vol = rng.randn(9, 7, 5).astype(np.float32)
    b_min, b_max = np.array([-1.0, -2.0, -3.0]), np.array([1.0, 2.5, 3.5])
    tpath, jpath = tmp_path / "port.dist", tmp_path / "jax.dist"
    TS.save_sdf(tpath, vol, b_min, b_max)
    JS.save_sdf(jpath, vol, b_min, b_max)
    cp = rng.randn(9, 7, 5, 3).astype(np.float32)
    if closest:  # the closest-point tail the reference's files carry
        for p in (tpath, jpath):
            with open(p, "ab") as f:
                np.swapaxes(cp, 0, 2).tofile(f)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    for path in (tpath, jpath):
        got = TS.load_sdf(path, read_closest_points=closest)
        want = JS.load_sdf(path, read_closest_points=closest)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[2], vol)
        np.testing.assert_array_equal(got[0], b_min)
        if closest:
            np.testing.assert_array_equal(got[3], cp)


def test_cli_dummy_writes_mesh(tmp_path):
    assert cli.main(["dummy", "--device", "cpu", "--out-dir",
                     str(tmp_path)]) == 0
    txt = open(tmp_path / "mesh.obj").read()
    assert txt.count("\nf ") > 10
    assert "test__1.p" in os.listdir(tmp_path)


def write_dist_frames(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for i, off in enumerate(((0.0, 0.0, 0.0), (0.6, 0.4, 0.0))):
        vol = ellipsoid_levelset(6, 10, 16, offset=off)[:-1]
        TS.save_sdf(data / f"frame{i}_64.dist", np.pad(vol, ((0, 1),) * 3,
                                                        mode="edge"),
                    [0, 0, 0], [1, 1, 1])
    out = tmp_path / "out"
    out.mkdir()
    return ["sequence", "--data", str(data), "--device", "cpu", "--out-dir",
            str(out), "--subsample-rate", "2", "--mc-step", "1",
            "--vert-cap", "4096", "--face-cap", "8192", "--node-cap", "128"]


def test_cli_sequence_runs_dist_files(tmp_path):
    argv = write_dist_frames(tmp_path)
    out = tmp_path / "out"
    assert cli.main(argv) == 0
    prof = json.load(open(out / "profile.json"))
    assert set(prof) == {"setupCorrespondences", "solve", "updateTSDF",
                         "update_graph"}
    assert all(p["count"] == 1 for p in prof.values())
    assert open(out / "mesh.obj").read().count("\nf ") > 10
    assert (out / "original.obj").exists()


def test_cli_sequence_failed_frame_exits_nonzero(tmp_path, monkeypatch):
    """A frame that raises stops the loop and still writes the mesh, as the
    reference harness does, but the exit code reports the failure."""
    from dynamicfusion_body_tpu_torch.pipeline.fusion import Fusion

    def fail(self, *args, **kwargs):
        raise ValueError("frame failed")

    monkeypatch.setattr(Fusion, "setupCorrespondences", fail)
    argv = write_dist_frames(tmp_path)
    out = tmp_path / "out"
    assert cli.main(argv) == 1
    assert open(out / "mesh.obj").read().count("\nf ") > 10
    assert set(json.load(open(out / "profile.json"))) == {
        "setupCorrespondences"}


def test_cli_sequence_writes_spans(tmp_path):
    """``sequence`` traces its frames: spans.json holds the solver's
    spans under ``solve`` and the host reads, by path."""
    argv = write_dist_frames(tmp_path)
    out = tmp_path / "out"
    assert cli.main(argv) == 0
    spans = json.load(open(out / "spans.json"))
    assert spans["solve/gn_step/pcg"]["count"] >= 1
    assert any(p.endswith("host_read") for p in spans)
    for s in spans.values():
        assert set(s) == {"total_s", "count", "mean_s", "self_s"}
        assert 0 <= s["self_s"] <= s["total_s"] + 1e-6
