"""Parity of the port's marching cubes and its K1 twin with the JAX
package (dynamicfusion_body_tpu.ops.marching_cubes / mc_pallas)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.ops.marching_cubes import marching_cubes as j_mc
from dynamicfusion_body_tpu.ops.mc_pallas import mc_case_cross as j_k1
from dynamicfusion_body_tpu_torch.ops import marching_cubes as mc_mod
from dynamicfusion_body_tpu_torch.ops.marching_cubes import (
    index_widths, marching_cubes)
from dynamicfusion_body_tpu_torch.ops.mc_cuda import (
    MAX_OFFSET, check_args, mc_case_cross, mc_case_cross_ref)

# One intra-op thread: with torch 2.13's CPU build on x86-64 (AVX-512),
# worker threads intermittently returned f32 sqrt results ~3e-4 off for
# part of a tensor (2 processes in 24; none in 24 single-threaded), far
# above the tolerances below.
torch.set_num_threads(1)


def sphere_sdf(res, center, radius):
    g = np.arange(res)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2
                    + (z - center[2]) ** 2) - radius).astype(np.float32)


def rough_volume(rng, X=16, Y=16, Z=128):
    g = np.stack(np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                             indexing="ij"), -1).astype(np.float32)
    c = np.array([7.5, 7.5, 63.5], np.float32)
    vol = np.linalg.norm((g - c) / np.array([1, 1, 4]), axis=-1) - 6.0
    return (vol + 0.3 * rng.randn(X, Y, Z)).astype(np.float32)


@pytest.mark.parametrize("shape", [(16, 16, 128), (8, 24, 256)])
def test_k1_twin_bit_equal_to_pallas_interpret(rng, shape):
    vol = rng.randn(*shape).astype(np.float32)
    want = np.asarray(j_k1(jnp.asarray(vol), 0.0, interpret=True))
    got = mc_case_cross_ref(torch.from_numpy(vol), 0.0).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the twin for a CPU tensor (and counts no launch)
    n0 = mc_case_cross.launches
    np.testing.assert_array_equal(
        mc_case_cross(torch.from_numpy(vol), 0.0).numpy(), want)
    assert mc_case_cross.launches == n0


CASES = {
    "sphere": (lambda rng: sphere_sdf(24, (12, 12, 12), 7.0),
               dict(vert_cap=4096, face_cap=8192)),
    "rough": (rough_volume, dict(vert_cap=1 << 13, face_cap=1 << 14)),
    "no_normals": (rough_volume, dict(vert_cap=1 << 13, face_cap=1 << 14,
                                      with_normals=False)),
    "step2_odd": (lambda rng: sphere_sdf(33, (16, 16, 16), 10.0),
                  dict(vert_cap=4096, face_cap=8192, step_size=2)),
    # tests/test_marching_cubes.py:104 — capacity saturation reported
    "saturated": (lambda rng: sphere_sdf(24, (12, 12, 12), 7.0),
                  dict(vert_cap=64, face_cap=64)),
    "empty": (lambda rng: np.full((8, 8, 8), 1.0, np.float32),
              dict(vert_cap=64, face_cap=64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("use_kernels", [False, True])
def test_marching_cubes_matches_jax(rng, case, use_kernels):
    make, kw = CASES[case]
    vol = make(rng)
    want = j_mc(jnp.asarray(vol), **kw)
    got = marching_cubes(torch.from_numpy(vol), use_kernels=use_kernels, **kw)
    # topology and counts: exact (same edge/cell numbering and dtype)
    for key in ("faces", "n_verts", "n_faces", "overflow"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype, key
    # the lattice-edge identity keeps the port's int64
    for key in ("edge_axis", "edge_x"):
        assert got[key].dtype == torch.int64, key
    # coordinates/normals: f32 rounding across frameworks
    for key in ("verts", "normals", "values"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)
    if case == "saturated":
        assert int(got["n_verts"]) == 64 and bool(got["overflow"])


I32, I64 = torch.int32, torch.int64


@pytest.mark.parametrize("shape,caps,widths", [
    ((512,) * 3, (1 << 24, 1 << 25), (I32, I32)),  # the 512³ ingest
    ((256,) * 3, (1 << 16, 1 << 17), (I32, I32)),
    ((1024, 1024, 682), (1 << 24, 1 << 25), (I32, I32)),  # 3·XYZ < 2^31
    ((1024, 1024, 683), (1 << 24, 1 << 25), (I64, I32)),
    ((2048,) * 3, (1 << 24, 1 << 25), (I64, I32)),
    ((64,) * 3, (1 << 12, 1 << 31), (I32, I64)),
])
def test_index_widths(shape, caps, widths):
    """The faces stage's widths from the shape and caps alone: no volume
    is allocated."""
    assert index_widths(shape, *caps) == widths


@pytest.mark.parametrize("widths", [(I64, I32), (I32, I64), (I64, I64)])
def test_faces_stage_at_each_width(rng, monkeypatch, widths):
    """The faces stage forced to each width the small lattices do not
    take (they take int32 throughout): the same faces and counts as
    JAX's, in the faces' width."""
    monkeypatch.setattr(mc_mod, "index_widths", lambda *a: widths)
    vol = rough_volume(rng)
    kw = dict(vert_cap=1 << 13, face_cap=1 << 14)
    want = j_mc(jnp.asarray(vol), **kw)
    got = marching_cubes(torch.from_numpy(vol), **kw)
    for key in ("faces", "n_verts", "n_faces"):
        assert got[key].dtype == widths[1], key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def test_k1_on_a_stride2_view_matches_pallas(rng):
    """The canonical MC's call: K1 (its twin on the CPU) on the stride-2
    view as it lies, against the Pallas kernel on the subsampled copy."""
    vol = rng.randn(32, 16, 256).astype(np.float32)
    view = torch.from_numpy(vol)[::2, ::2, ::2]
    assert not view.is_contiguous()
    want = np.asarray(j_k1(jnp.asarray(np.ascontiguousarray(
        vol[::2, ::2, ::2])), 0.0, interpret=True))
    np.testing.assert_array_equal(mc_case_cross(view, 0.0).numpy(), want)


@pytest.mark.parametrize("case", ["stride2", "offset", "cells"])
def test_mc_case_cross_index_limit(case):
    """The kernel's 32-bit offsets: a view is taken where its largest
    element offset, one past it (the stride-2 loads read it) and its cell
    count fit; meta tensors, so nothing is allocated."""
    if case == "stride2":  # the 256³ canonical's stride-2 view
        view = torch.empty((256,) * 3, device="meta")[::2, ::2, ::2]
        assert check_args(view) == 254 * (65536 + 256 + 1)
        return
    if case == "offset":  # few cells, one far apart
        vol = torch.empty_strided((2, 2, 2), (MAX_OFFSET, 1, 1),
                                  device="meta")
    else:  # 2^31 cells
        vol = torch.empty((2, 1024, 1 << 20), device="meta")
    with pytest.raises(ValueError, match="32 bits"):
        check_args(vol)
