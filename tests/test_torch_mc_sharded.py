"""The port's sharded marching cubes (dynamicfusion_body_tpu_torch.parallel.
mc_sharded) against the JAX package's, held as tests/test_mc_sharded.py
holds JAX: on 4 gloo ranks against ``marching_cubes_sharded`` on
``make_mesh(4)``, every per-rank block (vertices, faces, validity,
ownership, counts) equal, and against the one-device extraction the
vertex and face sets equal, the owned vertices each surface vertex once,
normals within 1e-5; then the slab arguments of ``marching_cubes`` in
process and the replicated (live) volume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dynamicfusion_body_tpu.ops.marching_cubes import marching_cubes as j_mc
from dynamicfusion_body_tpu.parallel.mc_sharded import (
    marching_cubes_sharded as j_mc_sharded, mc_local_slab as j_local)
from dynamicfusion_body_tpu.parallel.mesh import (
    VOXEL_AXIS, make_mesh, volume_sharding)
from dynamicfusion_body_tpu_torch import convert
from dynamicfusion_body_tpu_torch.ops.marching_cubes import marching_cubes
from dynamicfusion_body_tpu_torch.parallel import launch, ranks
from dynamicfusion_body_tpu_torch.parallel.mc_sharded import global_faces

# One intra-op thread here and in every rank (see
# tests/test_torch_marching_cubes.py)
torch.set_num_threads(1)

N_RANKS = 4
CAPS = (1 << 12, 1 << 13)  # per rank


def _bumpy(res=64, radius=18.0):
    """tests/test_mc_sharded.py:24-30."""
    g = np.arange(res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = res / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) + 1e-6
    th = np.arccos(np.clip((z - c) / r, -1, 1))
    return (r - radius - 2.0 * np.sin(3 * th)).astype(np.float32)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(N_RANKS)


@pytest.mark.parametrize("step", [1, 2])
def test_sharded_mc_matches_jax(mesh4, step):
    vol = _bumpy()
    want = j_mc_sharded(mesh4, vert_cap=CAPS[0], face_cap=CAPS[1],
                        step_size=step)(
        jax.device_put(jnp.asarray(vol), volume_sharding(mesh4)))
    sh = launch.run(ranks.marching_cubes, N_RANKS,
                    (vol, CAPS[0], CAPS[1], step), backend="gloo")
    assert not bool(sh["overflow"])
    for key in ("verts", "faces", "vert_valid", "face_valid", "vert_owned",
                "n_verts", "n_faces", "n_owned"):
        np.testing.assert_array_equal(sh[key], np.asarray(want[key]),
                                      err_msg=key)
    assert sh["faces"].dtype == np.asarray(want["faces"]).dtype == np.int32
    np.testing.assert_allclose(sh["normals"], np.asarray(want["normals"]),
                               atol=1e-5)

    # the JAX test's contract, against the port's one-device extraction
    ref = marching_cubes(torch.from_numpy(vol), vert_cap=1 << 14,
                         face_cap=1 << 15, step_size=step)
    nvr, nfr = int(ref["n_verts"]), int(ref["n_faces"])
    rv = ref["verts"][:nvr].numpy()
    vvalid = sh["vert_valid"]
    sv = sh["verts"][vvalid]
    rset = set(map(tuple, rv))
    assert rset == set(map(tuple, sv))
    assert int(sh["n_verts"]) >= nvr
    assert int(sh["n_faces"]) == nfr
    so = sh["verts"][sh["vert_owned"]]
    assert int(sh["n_owned"]) == nvr == len(so)
    assert set(map(tuple, so)) == rset
    tri_r = rv[ref["faces"][:nfr].numpy().reshape(-1)].reshape(-1, 9)
    fs = sh["faces"][sh["face_valid"]]
    tri_s = sh["verts"][fs.reshape(-1)].reshape(-1, 9)
    assert set(map(tuple, tri_r)) == set(map(tuple, tri_s))
    pos2n = {tuple(p): n for p, n in zip(rv, ref["normals"][:nvr].numpy())}
    errs = np.array([np.abs(pos2n[tuple(p)] - n).max()
                     for p, n in zip(sv, sh["normals"][vvalid])])
    assert errs.max() < 1e-5


@pytest.mark.parametrize("case", ["two_ranks", "promoted"])
def test_sharded_global_faces_width(case):
    """The global faces stay int32 while world·vert_cap < 2^31: on 2 gloo
    ranks equal to JAX's on ``make_mesh(2)``; past that, int64 and
    exact (on a few faces, nothing allocated at the caps)."""
    if case == "promoted":
        local = torch.tensor([[0, 1, 2], [3, 4, 5], [7, 7, 7]],
                             dtype=torch.int32)
        for world, vcap, dt in ((2, 1 << 29, torch.int32),
                                (4, 1 << 29, torch.int64),
                                (2, 1 << 30, torch.int64)):
            g, valid = global_faces(local, torch.tensor(2, dtype=torch.int32),
                                    world - 1, world, vcap)
            assert g.dtype == dt
            assert valid.tolist() == [True, True, False]
            want = local.long() + (world - 1) * vcap
            assert g[:2].tolist() == want[:2].tolist()
            assert g[2].tolist() == [0, 0, 0]
        return
    vol = _bumpy(32, 9.0)
    mesh2 = make_mesh(2)
    want = j_mc_sharded(mesh2, vert_cap=CAPS[0], face_cap=CAPS[1])(
        jax.device_put(jnp.asarray(vol), volume_sharding(mesh2)))
    sh = launch.run(ranks.marching_cubes, 2, (vol, CAPS[0], CAPS[1], 1),
                    backend="gloo")
    for key in ("faces", "face_valid", "n_verts", "n_faces"):
        np.testing.assert_array_equal(sh[key], np.asarray(want[key]),
                                      err_msg=key)
    assert sh["faces"].dtype == np.asarray(want["faces"]).dtype == np.int32
    assert sh["n_faces"].dtype == np.int32
    assert int(sh["n_faces"]) > 100


def test_sharded_mc_replicated_volume(mesh4):
    """The live-volume mode: the volume whole on every rank, each rank
    extracting its slab without an exchange."""
    vol = _bumpy()

    def local(v):
        m = j_local(v, VOXEL_AXIS, N_RANKS, vert_cap=CAPS[0],
                    face_cap=CAPS[1], with_normals=False,
                    replicated_vol=True)
        return m["verts"], jnp.arange(CAPS[0]) < m["n_verts"]

    jv, jvalid = jax.jit(shard_map(
        local, mesh=mesh4, in_specs=(P(),),
        out_specs=(P(VOXEL_AXIS), P(VOXEL_AXIS))))(jnp.asarray(vol))
    got = launch.run(ranks.mc_replicated, N_RANKS, (vol, *CAPS),
                     backend="gloo")
    np.testing.assert_array_equal(got["verts"], np.asarray(jv))
    np.testing.assert_array_equal(got["valid"], np.asarray(jvalid))
    ref = marching_cubes(torch.from_numpy(vol), vert_cap=1 << 14,
                         face_cap=1 << 15, with_normals=False)
    rv = ref["verts"][:int(ref["n_verts"])].numpy()
    assert set(map(tuple, rv)) == set(map(tuple, got["verts"][got["valid"]]))


@pytest.mark.parametrize("last", [False, True])
def test_slab_arguments_match_jax(last):
    """``cell_x_lo``/``cell_x_hi``/``x_index_offset`` and the edge
    identity outputs, on a slab with its halo planes, against the JAX
    op with the same arguments."""
    # the last slab of a 48-plane volume cuts the sphere's equator
    vol = _bumpy()[:48] if last else _bumpy()
    S, x0 = 16, 32 if last else 16
    ve = vol[x0 - 1:x0 + S + (0 if last else 2)]
    if last:  # the extrapolated right halo of the last slab
        ve = np.concatenate([ve, (2.0 * ve[-1] - ve[-2])[None],
                             (3.0 * ve[-1] - 2.0 * ve[-2])[None]])
    kw = dict(vert_cap=CAPS[0], face_cap=CAPS[1], cell_x_lo=1,
              cell_x_hi=S if last else S + 1, x_index_offset=x0 - 1)
    want = j_mc(jnp.asarray(ve), 0.0, **kw)
    got = marching_cubes(torch.from_numpy(ve), 0.0, **kw)
    for key in ("verts", "faces", "n_verts", "n_faces", "overflow",
                "edge_axis", "edge_x"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["normals"].numpy(),
                               np.asarray(want["normals"]), atol=1e-5)
    assert int(got["n_verts"]) > 100


def test_mesh_from_jax_carries_edge_identity():
    """convert.mesh_from_jax keeps the lattice-edge identity the port's
    marching cubes now produces."""
    vol = _bumpy(32, 9.0)
    want = j_mc(jnp.asarray(vol), 0.0, vert_cap=4096, face_cap=8192)
    got = convert.mesh_from_jax({k: np.asarray(v) for k, v in want.items()},
                                device="cpu")
    port = marching_cubes(torch.from_numpy(vol), 0.0, vert_cap=4096,
                          face_cap=8192)
    assert set(port) <= set(got)
    for key in ("edge_axis", "edge_x"):
        assert got[key].dtype == torch.int64
        assert torch.equal(got[key], port[key])
