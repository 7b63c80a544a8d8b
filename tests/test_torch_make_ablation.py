"""The port's ablation grid (``dynamicfusion_body_tpu_torch/tools/
make_ablation.py``) against the JAX tool (``tools/make_ablation.py``),
both ``run_variant``s on the tool's sequence at 32³ over 2 frames, on the
CPU (the kernels' twins stand in for K1 and K2).

Both tools build ``Fusion`` with its default caps (65,536 vertices),
which takes minutes a construction on the CPU at any size: each runs
with the caps cut to the 32³ surface and the solve at half depth (gn
4 / cg 16), through a ``Fusion`` subclass patched in for the call (the
tools' code is otherwise run as it stands). JAX's grid and two of the
port's arms run in spawned processes beside the port's other two, which
keeps the file's wall near the longest of them.

* ``original``: the same vertex and face counts and faces, positions
  within 1e-5 (MC of the same volume is bit-identical by contract);
* the two closest-point arms: the meshes within a stated distance of
  JAX's. The two drivers take the same steps in f32 with sums in other
  orders (tests/test_torch_fusion_driver.py), so the fused meshes are
  held by their symmetric nearest-vertex distance;
* the CNN arm, the port alone (JAX's arm would not fit beside the
  others: the file already takes over a minute, most of it the port's
  CPU solve, ``jacfwd`` under ``vmap``, and JAX compiling its frame):
  random weights from a seed, saved as an npz, at 32² (the smallest
  image that the DHBC's skip connections accept; the tool's is 64²);
  finite, with the canonical surface's counts within 5%.
"""

import importlib.util
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import dynamicfusion_body_tpu.pipeline.fusion as jfusion
from dynamicfusion_body_tpu_torch.io.mesh_io import load_obj
from dynamicfusion_body_tpu_torch.models import dhbc as td
from dynamicfusion_body_tpu_torch.pipeline import fusion as tfusion
from dynamicfusion_body_tpu_torch.tools import make_ablation as tab

ROOT = Path(__file__).resolve().parent.parent
RES, FRAMES = 32, 2
CAPS = dict(vert_cap=4096, face_cap=8192, node_cap=256)
SOLVE = dict(gn_iters=4, cg_iters=16)
CNN_SIZE = 32
# the fused arms' symmetric nearest-vertex distance to JAX's (voxels;
# measured 3.1e-5 / 1.1e-4 and 5.0e-3 / 1.5e-2 for mean / p95)
FUSED_MEAN, FUSED_P95 = 0.02, 0.05

# One intra-op thread (see tests/test_torch_warp_trilerp.py)
torch.set_num_threads(1)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_ablation", ROOT / "tools" / "make_ablation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _CutFusion(jfusion.Fusion):
    """The JAX ``Fusion`` with the test's caps and solve depth."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **{**kw, **CAPS})

    def solve(self, *args, **kw):
        return super().solve(*args, **{**kw, **SOLVE})


class _CutPortFusion(tfusion.Fusion):
    """The port's ``Fusion`` with the test's caps, solve depth and CNN
    image size."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **{**kw, **CAPS, "cnn_image_size": CNN_SIZE})

    def solve(self, *args, **kw):
        return super().solve(*args, **{**kw, **SOLVE})


def _jax_grid(out: str):
    """JAX's three closest-point arms (original and the fused two) into
    ``out``; run in a spawned process, where the patch stays."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jfusion.Fusion = _CutFusion
    tool = _jax_tool()
    vols = tab.sequence(RES, FRAMES)
    for name, reg, prune, method in tab.ARMS[:3]:
        tool.run_variant(vols, name, out, reg, prune, method,
                         float(vols[0].max()))


def _port_arm(out: str, arm: int, weights=None) -> dict:
    """The port's arm ``tab.ARMS[arm]`` into ``out`` (the CNN arm on the
    npz ``weights``)."""
    vols = tab.sequence(RES, FRAMES)
    name, reg, prune, method = tab.ARMS[arm]
    return tab.run_variant(vols, name, out, reg, prune, method,
                           float(vols[0].max()), cnn_weights=weights,
                           device="cpu")


def _spawned_port_arm(out: str, arm: int, weights=None) -> dict:
    """``_port_arm`` in a spawned process, where the patch stays."""
    tab.Fusion = _CutPortFusion
    return _port_arm(out, arm, weights)


@pytest.fixture(scope="module")
def vols():
    return tab.sequence(RES, FRAMES)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """JAX's three closest-point arms and the port's four (the CNN arm on
    random weights from a seed), JAX's grid and the port's unpruned and
    CNN arms each in a spawned process beside the port's other two:
    (JAX's directory, the port's directory, the port's reports)."""
    jout = tmp_path_factory.mktemp("jax")
    out = tmp_path_factory.mktemp("port")
    _, params = td.init_dhbc(5, device="cpu")
    npz = str(out / "dhbc.npz")
    td.save_npz_params(params, npz)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(3, mp_context=ctx) as pool:
        jax_done = pool.submit(_jax_grid, str(jout))
        spawned = {i: pool.submit(_spawned_port_arm, str(out), i, w)
                   for i, w in ((1, None), (3, npz))}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tab, "Fusion", _CutPortFusion)
            rep = {i: _port_arm(str(out), i) for i in (0, 2)}
        rep.update({i: f.result() for i, f in spawned.items()})
        jax_done.result()
    return jout, out, {tab.ARMS[i][0]: rep[i] for i in sorted(rep)}


def test_sequence_is_the_jax_tools(vols):
    """The JAX tool's volumes (bench.bumpy_sdf, its centres and phases)."""
    import sys
    sys.path.insert(0, str(ROOT))
    from bench import bumpy_sdf

    r = RES
    assert len(vols) == FRAMES + 1
    for i, v in enumerate(vols):
        want = bumpy_sdf(r, (r / 2 + i, r / 2 + 0.7 * i, r / 2), 0.27 * r,
                         r / 64, 3.0, 0.1 * i)
        np.testing.assert_array_equal(v, want)


def test_original_equals_jax(grids):
    jax_grid, out, rep = grids
    gv, gf = load_obj(str(out / "original.obj"))
    jv, jf = load_obj(str(jax_grid / "original.obj"))
    assert len(gv) == len(jv) > 1000 and len(gf) == len(jf)
    np.testing.assert_array_equal(gf, jf)
    np.testing.assert_allclose(gv, jv, rtol=0, atol=1e-5)
    assert rep["original"]["n_verts"] == len(jv)
    c = tab.mesh_distance(out / "original.obj", jax_grid / "original.obj",
                          "cpu")
    assert c["max_pos"] <= 1e-5 and c["faces_equal"]


@pytest.mark.parametrize("name", [a[0] for a in tab.ARMS[1:3]])
def test_fused_arms_near_jax(grids, name):
    jax_grid, out, rep = grids
    c = tab.mesh_distance(out / f"{name}.obj", jax_grid / f"{name}.obj",
                          "cpu")
    print(name, c)
    assert abs(c["n_verts"][0] - c["n_verts"][1]) <= 0.01 * c["n_verts"][1]
    assert c["mean"] < FUSED_MEAN and c["p95"] < FUSED_P95
    # the fused surface moved off the canonical one
    d0 = tab.mesh_distance(out / f"{name}.obj", out / "original.obj", "cpu")
    assert d0["mean"] > 2 * c["mean"]


def test_cnn_arm_port(grids):
    _, out, rep = grids
    name = tab.ARMS[3][0]
    orig, arm = rep["original"], rep[name]
    v, f = load_obj(arm["path"])
    assert np.all(np.isfinite(v)) and len(f) > 0
    c = tab.mesh_distance(arm["path"], orig["path"], "cpu")
    print(name, c)
    assert abs(arm["n_verts"] - orig["n_verts"]) <= 0.05 * orig["n_verts"]
    assert c["mean"] < 1.0
