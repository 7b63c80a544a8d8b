"""The port's native I/O library (dynamicfusion_body_tpu_torch/native:
its own copy of dfio.cc, built by g++ at first use) and its visualization
helpers, on the CPU:

* the four cases of tests/test_native_io.py on the port;
* the port's native OBJ writer byte-equal to the JAX package's native
  writer and to the port's Python path (plain, with normals, and with the
  FusionDM grid→world map), and its readers equal to the Python paths;
* the native path is the default and a broken source raises (no silent
  fallback to Python);
* ``visualize_tsdf`` writing a PNG under matplotlib's Agg backend.
"""

import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu import native as jnative
from dynamicfusion_body_tpu_torch import native
from dynamicfusion_body_tpu_torch.io.mesh_io import load_obj, save_obj
from dynamicfusion_body_tpu_torch.io.sdf_io import load_sdf, save_sdf

torch.set_num_threads(1)


def mesh(rng, n=100, m=50):
    verts = rng.rand(n, 3).astype(np.float32)
    faces = rng.randint(0, n, (m, 3)).astype(np.int32)
    normals = rng.randn(n, 3).astype(np.float32)
    return verts, faces, normals


def ind_matrix():
    ind = np.eye(4)
    ind[0, 0] = ind[1, 1] = ind[2, 2] = 0.5
    ind[:3, 3] = [1.0, -2.0, 3.0]
    return ind


# tests/test_native_io.py on the port


def test_native_obj_roundtrip(tmp_path, rng):
    verts, faces, normals = mesh(rng)
    p = str(tmp_path / "m.obj")
    native.write_obj(p, verts, faces, normals=normals)
    v2, f2 = native.read_obj(p)
    np.testing.assert_allclose(v2, verts, atol=1e-5)
    np.testing.assert_array_equal(f2, faces)


def test_native_obj_ind_transform(tmp_path, rng):
    verts, faces, normals = mesh(rng, 20, 10)
    p = str(tmp_path / "m.obj")
    native.write_obj(p, verts, faces, normals=normals, ind=ind_matrix())
    assert "//" in open(p).read()  # FusionDM face style
    v2, f2 = native.read_obj(p)
    np.testing.assert_allclose(v2, verts * 0.5 + [1, -2, 3], atol=1e-5)
    np.testing.assert_array_equal(f2, faces)


def test_native_matches_python_obj(tmp_path, rng):
    verts, faces, _ = mesh(rng, 30, 15)
    p = str(tmp_path / "m.obj")
    save_obj(p, verts, faces)  # the native writer
    v2, f2 = load_obj(p, native=False)
    np.testing.assert_allclose(v2, verts, atol=1e-5)
    np.testing.assert_array_equal(f2, faces)


def test_native_dist_loader(tmp_path, rng):
    vol = rng.randn(9, 9, 9).astype(np.float32)
    p = str(tmp_path / "v.dist")
    save_sdf(p, vol, [-1, -1, -1], [1, 1, 1])
    b_min, b_max, v2 = native.read_dist(p)
    np.testing.assert_allclose(b_min, [-1, -1, -1])
    np.testing.assert_allclose(b_max, [1, 1, 1])
    np.testing.assert_allclose(v2, vol, atol=0)
    # the io front-end takes the native path by default
    _, _, v3, _ = load_sdf(p)
    np.testing.assert_allclose(v3, vol, atol=0)


# byte-equality with the JAX package's native writer and the Python path


@pytest.mark.parametrize("style", ["plain", "normals", "ind"])
def test_obj_bytes_equal_jax_native_and_python(tmp_path, rng, style):
    verts, faces, normals = mesh(rng, 200, 300)
    kw = {"plain": {}, "normals": dict(normals=normals),
          "ind": dict(normals=normals, ind=ind_matrix())}[style]
    paths = {k: str(tmp_path / f"{k}.obj") for k in ("port", "py", "jax")}
    save_obj(paths["port"], verts, faces, **kw)
    save_obj(paths["py"], verts, faces, native=False, **kw)
    assert jnative.write_obj(paths["jax"], verts, faces, **kw)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert len(data["port"]) > 1000
    assert data["port"] == data["py"] == data["jax"]
    # and the native reader equals the Python parser on it
    for a, b in zip(load_obj(paths["port"]),
                    load_obj(paths["port"], native=False)):
        np.testing.assert_array_equal(a, b)


def test_dist_native_equals_python_and_jax(tmp_path, rng):
    vol = rng.randn(7, 12, 17).astype(np.float32)
    p = str(tmp_path / "v.dist")
    save_sdf(p, vol, [-1.5, -2, -3], [1, 2, 3.25])
    nat = load_sdf(p)
    py = load_sdf(p, native=False)
    jx = jnative.read_dist(p)
    for a, b, c in zip(nat[:3], py[:3], jx):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.dtype == b.dtype == c.dtype
    assert nat[3] is None


def test_reference_mesh_reads_alike(rng):
    """meshes/original.obj, the configs' body mesh, through both paths."""
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "meshes" / "original.obj"
    v, f = load_obj(path)
    v2, f2 = load_obj(path, native=False)
    assert len(v) > 10000
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(f, f2)


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        load_sdf(str(tmp_path / "none.dist"))
    with pytest.raises(OSError):
        load_obj(str(tmp_path / "none.obj"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ rejects raises; nothing falls back to Python."""
    bad = tmp_path / "dfio.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def test_visualize_tsdf_writes_png(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from dynamicfusion_body_tpu_torch.utils.visualize import visualize_tsdf

    g = np.arange(24, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    tsdf = np.sqrt((x - 12) ** 2 + (y - 11) ** 2 + (z - 12) ** 2) - 7.0
    p = str(tmp_path / "tsdf.png")
    assert visualize_tsdf(torch.from_numpy(tsdf), save_path=p,
                          vert_cap=8192, face_cap=16384) == p
    png = open(p, "rb").read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 10000
