"""The port's CNN-path entry points on the CPU, at small sizes:
``benchmarks/bench_cnn.py`` (its JSON line), ``tools/train_dhbc.py``
(weights in the JAX package's npz format, which JAX loads) and
``tools/ablate_dhbc.py`` on them, ``cli sequence --cnn --method cnn`` on
a directory of ``.dist`` volumes; and train_dhbc's dataset and
deformation code against the JAX script's (``tools/train_dhbc.py``)."""

import importlib.util
import json
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamicfusion_body_tpu.models.dhbc import init_dhbc as j_init_dhbc
from dynamicfusion_body_tpu.models.dhbc import (
    load_npz_params as j_load_npz_params)
from dynamicfusion_body_tpu_torch import cli
from dynamicfusion_body_tpu_torch.benchmarks import bench_cnn
from dynamicfusion_body_tpu_torch.io import sdf_io as TS
from dynamicfusion_body_tpu_torch.models.dhbc import npz_normalize_input
from dynamicfusion_body_tpu_torch.pipeline.cnn_correspondence import (
    view_mvps)
from dynamicfusion_body_tpu_torch.tools import ablate_dhbc, train_dhbc
from fixtures import ellipsoid_levelset

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def jax_train_dhbc():
    """The JAX script ``tools/train_dhbc.py`` as a module (it imports JAX
    inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_dhbc", ROOT / "tools" / "train_dhbc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_cnn_prints_its_line(capsys):
    line, report = bench_cnn.main(["--res", "32", "--size", "32", "--views",
                                   "4", "--device", "cpu"])
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == line
    assert tuple(line) == bench_cnn.RESULT_KEYS
    assert line["metric"] == "cnn_setup_corr_32"
    assert all(np.isfinite(v) and v >= 0 for k, v in line.items()
               if k not in ("metric", "unit"))
    assert line["coverage_s4"] > 0.9
    assert 0 < report["n_matched"] <= report["n_canon"]
    assert set(report["rows"]) == {
        "descriptors B=1 S=8", "descriptors B=8 S=8", "descriptors B=8 S=4",
        "descriptors B=8 S=2", "renders", "network", "scatter", "match"}
    assert "descriptors B=8 S=4" in out.err and "scatter" in out.err


def small_mesh():
    """A bumpy sphere's MC mesh at 32³ (numpy verts, int32 faces)."""
    from dynamicfusion_body_tpu_torch.ops.marching_cubes import (
        marching_cubes)

    g = np.arange(32, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt((x - 15.5) ** 2 + (y - 15.5) ** 2 + (z - 15.5) ** 2)
    sdf = (r - 9.0 - 2.0 * np.sin(x / 3.0)).astype(np.float32)
    m = marching_cubes(torch.from_numpy(sdf), vert_cap=1 << 12,
                       face_cap=1 << 13)
    nv, nf = int(m["n_verts"]), int(m["n_faces"])
    return (m["verts"][:nv].numpy(),
            m["faces"][:nf].numpy().astype(np.int32))


def test_train_and_ablate_dhbc(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "w.npz")
    rep = train_dhbc.main(["--steps", "3", "--size", "32", "--device",
                           "cpu", "--out", out])
    text = capsys.readouterr().out
    assert "# body mesh: meshes/original.obj" in text
    assert "step     0 loss" in text and "step     2 loss" in text
    assert f"# saved {out}" in text
    assert len(rep["losses"]) == 3 and rep["best_loss"] == min(rep["losses"])
    assert np.load(out.replace(".npz", "_head.npy")).shape == (16, 16)
    assert npz_normalize_input(out) is True
    # the weights load in the JAX package, unchanged
    _, jp = j_init_dhbc(0, 32, 32)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jp)
    got = flax.traverse_util.flatten_dict(j_load_npz_params(zeros, out),
                                          sep="/")
    data = np.load(out)
    assert len(got) == 30
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), data[k])

    # the ablation on a small mesh: four 16-D searches over the body's
    # 23k vertices and 96 renders of its 46k faces take a minute here
    verts, faces = small_mesh()
    monkeypatch.setattr(ablate_dhbc, "body_mesh",
                        lambda dev: (verts, faces))
    res = ablate_dhbc.main(["--weights", out, "--bends", "0.7", "--size",
                            "32", "--cpu"])
    text = capsys.readouterr().out
    assert "# ablation at bend=0.7 rad" in text
    assert set(res[0.7]) == {"clpts", "clpts_yawinv", "cnn_random",
                             "cnn_trained"}
    assert all(np.isfinite(e) and n > 0 for e, n in res[0.7].values())


def test_dataset_and_deformations_match_jax_script():
    """Labels, renders and deformations of the port's train_dhbc against
    the JAX script's, on a small mesh."""
    jt = jax_train_dhbc()
    rng = np.random.RandomState(2)
    v = (rng.randn(300, 3) * [1.0, 2.0, 0.5]).astype(np.float32)
    np.testing.assert_array_equal(train_dhbc.bend_mesh(v, 1.1),
                                  jt.bend_mesh(v, 1.1))
    np.testing.assert_array_equal(train_dhbc.yaw_mesh(v, 0.4),
                                  jt.yaw_mesh(v, 0.4))
    np.testing.assert_array_equal(
        train_dhbc.random_deform(v, np.random.default_rng(7)),
        jt.random_deform(v, np.random.default_rng(7)))

    verts, faces = small_mesh()
    labels = train_dhbc.region_labels(verts, 16)
    np.testing.assert_array_equal(labels, jt.region_labels(verts, 16))
    mvps = view_mvps(3)
    vc = (verts / 20.0).astype(np.float32)
    got = train_dhbc.make_dataset(verts, faces, labels, mvps, 32, vcoords=vc)
    want = jt.make_dataset(verts, faces, labels, mvps, 32, vcoords=vc)
    for (d, lab, co), (jd, jlab, jco) in zip(got, want):
        # the rasterizers' window depths may differ by ulps and flip a
        # depth8 floor (tests/test_torch_render.py)
        assert np.mean(d.numpy() == np.asarray(jd)) >= 0.99
        assert np.mean(lab.numpy() == np.asarray(jlab)) >= 0.99
        assert (np.asarray(jlab) > 0).mean() > 0.05
        same = np.all(co.numpy() == np.asarray(jco), axis=-1)
        assert same.mean() >= 0.99


def test_cli_sequence_cnn(tmp_path):
    """``sequence --cnn --method cnn`` on two .dist frames (the CNN at 32²
    with random weights)."""
    data = tmp_path / "data"
    data.mkdir()
    for i, off in enumerate(((0.0, 0.0, 0.0), (0.6, 0.4, 0.0))):
        vol = ellipsoid_levelset(6, 10, 16, offset=off)[:-1]
        TS.save_sdf(data / f"frame{i}_64.dist",
                    np.pad(vol, ((0, 1),) * 3, mode="edge"),
                    [0, 0, 0], [1, 1, 1])
    out = tmp_path / "out"
    out.mkdir()
    argv = ["sequence", "--data", str(data), "--device", "cpu", "--out-dir",
            str(out), "--subsample-rate", "2", "--mc-step", "1",
            "--vert-cap", "4096", "--face-cap", "8192", "--node-cap", "128",
            "--cnn", "--method", "cnn", "--cnn-image-size", "32"]
    assert cli.main(argv) == 0
    prof = json.load(open(out / "profile.json"))
    assert all(p["count"] == 1 for p in prof.values())
    assert open(out / "mesh.obj").read().count("\nf ") > 10
