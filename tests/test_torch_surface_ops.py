"""The port's numeric and I/O public surface against the JAX package's, on
the same seeded inputs: the robust losses, ``bilinear``, ``warp_point``,
``dq_normal_c``, the transform toolkit and the full-state checkpoint
(written by either package, read by the other)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.io import checkpoint as JCK
from dynamicfusion_body_tpu.models import warp_field as JW
from dynamicfusion_body_tpu.models.tsdf_volume import TsdfVolume as JVol
from dynamicfusion_body_tpu.ops import compwise as JCW
from dynamicfusion_body_tpu.ops import losses as JL
from dynamicfusion_body_tpu.ops import transforms as JT
from dynamicfusion_body_tpu.ops.dualquat import warp_point as j_warp_point
from dynamicfusion_body_tpu.ops.interp import bilinear as j_bilinear
from dynamicfusion_body_tpu_torch.io import checkpoint as TCK
from dynamicfusion_body_tpu_torch.models import warp_field as TW
from dynamicfusion_body_tpu_torch.models.tsdf_volume import TsdfVolume
from dynamicfusion_body_tpu_torch.ops import compwise as TCW
from dynamicfusion_body_tpu_torch.ops import losses as TL
from dynamicfusion_body_tpu_torch.ops import transforms as TT
from dynamicfusion_body_tpu_torch.ops.dualquat import warp_point
from dynamicfusion_body_tpu_torch.ops.interp import bilinear

# One intra-op thread (see tests/test_torch_frame.py)
torch.set_num_threads(1)

RTOL = 1e-6   # the f32 functions against JAX
ATOL = 1e-6


def T(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", ["huber_loss", "tukey_biweight_loss",
                                  "tukey_irls_weight", "huber_irls_weight"])
def test_losses_match_jax(rng, name):
    x = (rng.randn(1000) * 3).astype(np.float32)
    c = np.float32(1.3)
    args = (x, c) if name != "huber_irls_weight" else (x, 1.3)
    want = getattr(JL, name)(jnp.asarray(args[0]), args[1])
    close(getattr(TL, name)(T(args[0]), args[1]), want)


def test_bilinear_matches_jax(rng):
    img = rng.rand(40, 50).astype(np.float32)
    px = (rng.rand(500) * 52 - 1).astype(np.float32)  # some off the image
    py = (rng.rand(500) * 42 - 1).astype(np.float32)
    close(bilinear(T(img), T(px), T(py)),
          j_bilinear(jnp.asarray(img), jnp.asarray(px), jnp.asarray(py)))


@pytest.mark.parametrize("extras", ["point", "normal_pose_mask"])
def test_warp_point_matches_jax(rng, extras):
    n, K = 200, 4
    pos = (rng.rand(n, 3) * 10).astype(np.float32)
    npos = (pos[:, None] + rng.randn(n, K, 3)).astype(np.float32)
    dq = rng.randn(n, K, 8).astype(np.float32) * 0.1
    dq[..., 0] += 1.0
    nw = (rng.rand(n, K) + 0.5).astype(np.float32)
    kw = {}
    if extras != "point":
        lw = np.array([0.99, 0.05, -0.02, 0.1, 0.0, 0.3, -0.2, 0.1],
                      np.float32)
        kw = dict(normal=rng.randn(n, 3).astype(np.float32), m_lw=lw,
                  mask=rng.rand(n, K) > 0.3)
    want = j_warp_point(*map(jnp.asarray, (pos, npos, dq, nw)),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = warp_point(*map(T, (pos, npos, dq, nw)),
                     **{k: T(v) for k, v in kw.items()})
    for g, w in zip(*((got, want) if kw else ((got,), (want,)))):
        close(g, w)


def test_dq_normal_c_matches_jax(rng):
    dq = rng.randn(8, 300).astype(np.float32)
    nrm = rng.randn(3, 300).astype(np.float32)
    want = JCW.dq_normal_c(tuple(map(jnp.asarray, dq)),
                           tuple(map(jnp.asarray, nrm)))
    got = TCW.dq_normal_c(tuple(map(T, dq)), tuple(map(T, nrm)))
    for g, w in zip(got, want):
        close(g, w)


# --- transforms: tests/test_transforms_ckpt.py's cases, and against JAX --

def test_transforms_constructors_match_jax():
    for name, args in (
            ("identity_matrix", ()),
            ("translation_matrix", ([1.0, -2.0, 3.5],)),
            ("rotation_matrix", (0.7, [0, 1, 0], [1.0, 2.0, 3.0])),
            ("scale_matrix", (2.5,)),
            ("scale_matrix", (0.5, [1.0, 2.0, 3.0])),
            ("euler_matrix", (0.3, -0.5, 1.1)),
            ("quaternion_about_axis", (0.9, [1.0, 2.0, -1.0]))):
        np.testing.assert_array_equal(getattr(TT, name)(*args),
                                      getattr(JT, name)(*args), name)
    M = TT.euler_matrix(0.3, -0.5, 1.1)
    np.testing.assert_allclose(TT.euler_from_matrix(M), (0.3, -0.5, 1.1),
                               atol=1e-10)
    assert TT.euler_from_matrix(M) == JT.euler_from_matrix(M)
    gimbal = TT.euler_matrix(0.2, np.pi / 2, 0.0)
    assert TT.euler_from_matrix(gimbal) == JT.euler_from_matrix(gimbal)
    with pytest.raises(NotImplementedError):
        TT.euler_matrix(0.1, 0.2, 0.3, axes="rzyx")


def test_quaternions_match_jax():
    rng_t, rng_j = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(5):
        q = TT.random_quaternion(rng_t)
        np.testing.assert_array_equal(q, JT.random_quaternion(rng_j))
        M = TT.quaternion_matrix(q)
        close(M, JT.quaternion_matrix(q))
        q2 = TT.quaternion_from_matrix(M)
        close(q2, JT.quaternion_from_matrix(M), rtol=1e-5, atol=1e-6)
        # sign convention w >= 0
        np.testing.assert_allclose(q2, q if q[0] >= 0 else -q, atol=1e-5)
        assert TT.is_same_transform(M, TT.quaternion_matrix(q2), atol=1e-5)
        assert TT.is_same_transform(M, M * 2.0)
        assert (TT.is_same_transform(M, TT.identity_matrix())
                == JT.is_same_transform(M, JT.identity_matrix()))
    close(TT.random_rotation_matrix(np.random.RandomState(3)),
          JT.random_rotation_matrix(np.random.RandomState(3)))
    M = TT.random_rotation_matrix(torch.Generator().manual_seed(7))
    R = M[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(R) - 1) < 1e-5
    assert M.shape == (4, 4) and M[3, 3] == 1.0
    np.testing.assert_array_equal(
        M, TT.random_rotation_matrix(torch.Generator().manual_seed(7)))


def test_arcball_matches_jax():
    balls = TT.Arcball(), JT.Arcball()
    for b in balls:
        b.place([100, 100], 100)
        b.down([100, 100])
        b.drag([150, 100])
        b.down([150, 100])
        b.drag([160, 300])  # off the ball
    close(balls[0].matrix(), balls[1].matrix())
    R = balls[0].matrix()[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert not np.allclose(R, np.eye(3))


# --- checkpoint: each package reads the other's file ---------------------

def _state(rng):
    values = rng.randn(8, 8, 8).astype(np.float32)
    weights = rng.rand(8, 8, 8).astype(np.float32)
    ind = np.eye(4, dtype=np.float32) * 0.5
    ind[3, 3] = 1.0
    verts = (rng.rand(20, 3) * 7).astype(np.float32)
    lw = rng.randn(8).astype(np.float32)
    return values, weights, ind, verts, lw


def _check_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert za.files == zb.files
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], k)


def test_checkpoint_jax_writes_port_reads(tmp_path, rng):
    values, weights, ind, verts, lw = _state(rng)
    vol = JVol(values=jnp.asarray(values), weights=jnp.asarray(weights),
               ind=jnp.asarray(ind))
    wf = JW.construct_graph(jnp.asarray(verts), jnp.float32(1.0), 16)
    p = tmp_path / "jax.npz"
    JCK.save_checkpoint(str(p), vol, wf, jnp.asarray(lw), itercounter=7,
                        extra={"foo": [1, 2, 3]})
    vol2, wf2, lw2, it, extra = TCK.load_checkpoint(str(p), device="cpu")
    np.testing.assert_array_equal(vol2.values.numpy(), values)
    np.testing.assert_array_equal(vol2.weights.numpy(), weights)
    np.testing.assert_array_equal(vol2.ind.numpy(), ind)
    for f in ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
              "radius"):
        np.testing.assert_array_equal(getattr(wf2, f).numpy(),
                                      np.asarray(getattr(wf, f)), f)
    np.testing.assert_array_equal(lw2.numpy(), lw)
    assert it == 7
    np.testing.assert_array_equal(extra["foo"], [1, 2, 3])
    # the resumed state is usable: warp a point
    q = torch.tensor([[1.0, 1.0, 1.0]])
    idx = TW.neighbor_lookup(wf2, q, 3)
    assert torch.isfinite(TW.warp_points(wf2, q, idx)).all()
    # and the port writes that state back as the same file's arrays
    p2 = tmp_path / "port.npz"
    TCK.save_checkpoint(str(p2), vol2, wf2, lw2, itercounter=it, extra=extra)
    _check_npz(p, p2)


def test_checkpoint_port_writes_jax_reads(tmp_path, rng):
    values, weights, ind, verts, lw = _state(rng)
    vol = TsdfVolume(values=T(values), weights=T(weights), ind=T(ind))
    wf = TW.construct_graph(T(verts), 1.0, 16)
    p = tmp_path / "port.npz"
    TCK.save_checkpoint(str(p), vol, wf, T(lw), itercounter=3,
                        extra={"bar": np.arange(4.0)})
    vol2, wf2, lw2, it, extra = JCK.load_checkpoint(str(p))
    np.testing.assert_array_equal(np.asarray(vol2.values), values)
    np.testing.assert_array_equal(np.asarray(vol2.ind), ind)
    for f in ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
              "radius"):
        got = np.asarray(getattr(wf2, f))
        want = getattr(wf, f).numpy()
        np.testing.assert_array_equal(got, want, f)
    assert np.asarray(wf2.node_vert_idx).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(lw2), lw)
    assert it == 3
    np.testing.assert_array_equal(extra["bar"], np.arange(4.0))
    p2 = tmp_path / "jax.npz"
    JCK.save_checkpoint(str(p2), vol2, wf2, lw2, itercounter=it, extra=extra)
    _check_npz(p, p2)
    with np.load(p) as z:
        bad = dict(z)
    bad["format_version"] = np.int64(2)
    np.savez_compressed(tmp_path / "v2.npz", **bad)
    with pytest.raises(ValueError, match="version 2"):
        TCK.load_checkpoint(str(tmp_path / "v2.npz"), device="cpu")
