"""The port's sharded frame (dynamicfusion_body_tpu_torch.parallel.
frame_sharded) on 2 gloo ranks against the JAX package's on
``make_mesh(2)`` and against the port's one-device ``fusion_frame``, on
tests/test_frame_sharded.py's 64³ scene and settings, by that test's
criteria (the paths agree geometrically, not bitwise: vertex order is per
slab): sampling radius rtol 1e-6, equal n_corr, no overflow, per-round
costs before rtol 0.05 and after rtol 0.10, a real descent, fused values
p99.9 |Δ| < 0.25, node counts within 16. Two frames chain through the
sharded frame's outputs (tests/test_frame_sharded.py:100-132, here with
the first test's settings so that both frames share JAX's compiled
program). The per-rank caps are twice the JAX test's 8-device ones: each
of 2 slabs holds a quarter of the surface more than the largest of 8.

The second frame is held by the same criteria but the pre-solve cost:
that cost is taken after the rigid presolve, whose accept/reject steps
on the gauge-underdetermined 8-dof pose flip on f32 noise between the
packages (tests/test_torch_frame.py:27-34). Measured on this scene: the
second frame's pre-solve cost 32.60 (port) against 36.78 (JAX), 11%,
while its cost after the solve agrees to 0.8% and n_corr and the node
count are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu.parallel.frame_sharded import (
    make_fusion_frame_sharded, make_init_canonical_sharded)
from dynamicfusion_body_tpu.parallel.mesh import make_mesh, volume_sharding
from dynamicfusion_body_tpu_torch.parallel import launch, ranks
from dynamicfusion_body_tpu_torch.pipeline.frame import (
    fusion_frame, init_canonical)
from dynamicfusion_body_tpu_torch.tools._scene import bumpy_sdf

# One intra-op thread here and in every rank (see
# tests/test_torch_marching_cubes.py)
torch.set_num_threads(1)

R, N_RANKS = 64, 2
LW = np.array([1, 0, 0, 0, 0, 0.1, 0, 0], np.float32)
INIT = dict(subsample_rate=1.5, node_cap=512, mc_step=2)
RANK_CAPS = dict(vert_cap=1 << 11, face_cap=1 << 12)
LIVE_CAPS = dict(live_vert_cap=1 << 12, live_face_cap=1 << 13)


def hyper(tdist):
    """tests/test_frame_sharded.py:49-53."""
    return dict(regularization_weight=0.5, knn_k=3, tdist=tdist, mc_step=2,
                solve_iters=3, gn_iters=4, cg_iters=8, tolerance=5.0,
                n_candidates=8)


def scene():
    canonical = bumpy_sdf(R, (32, 32, 32), 18.0, 2.0, 3.0, 0.0)
    lives = [bumpy_sdf(R, (32 + i, 32, 32), 18.0, 2.0, 3.0, 0.05 * i)
             for i in (1, 2)]
    return canonical, lives, float(canonical.max())


@pytest.fixture(scope="module")
def runs():
    canonical, lives, tdist = scene()
    h = hyper(tdist)
    port = launch.run(ranks.fusion_frames, N_RANKS,
                      (canonical, lives, LW, dict(INIT, **RANK_CAPS),
                       dict(h, **RANK_CAPS, **LIVE_CAPS)), backend="gloo")

    mesh = make_mesh(N_RANKS)
    vs = jax.device_put(jnp.asarray(canonical), volume_sharding(mesh))
    ws = jax.device_put(jnp.zeros((R,) * 3, jnp.float32),
                        volume_sharding(mesh))
    wf, rad = make_init_canonical_sharded(mesh, **INIT, **RANK_CAPS)(vs)
    frame = make_fusion_frame_sharded(mesh, **RANK_CAPS, **LIVE_CAPS, **h)
    state, jax_frames = (vs, ws, wf, jnp.asarray(LW)), []
    for live in lives:
        v, w, wf2, lw2, st, _ = frame(*state[:2], jnp.asarray(live),
                                      *state[2:])
        jax_frames.append((np.asarray(v), st))
        state = (v, w, wf2, lw2)

    values = torch.from_numpy(canonical)
    wf_c, rad_c = init_canonical(values, **INIT, vert_cap=1 << 12,
                                 face_cap=1 << 13)
    v_c, _, _, _, st_c, _ = fusion_frame(
        values, torch.zeros_like(values), torch.from_numpy(lives[0]), wf_c,
        torch.from_numpy(LW), vert_cap=1 << 12, face_cap=1 << 13,
        live_vert_cap=1 << 13, live_face_cap=1 << 14, **h)
    return dict(port=port, jax_radius=float(rad), jax_frames=jax_frames,
                single=(float(rad_c), v_c.numpy(), st_c))


def _to_np(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def assert_frames_agree(radius, values, st, radius_ref, values_ref, st_ref,
                        presolve_cost=True):
    """tests/test_frame_sharded.py:75-97's criteria (the pre-solve cost's
    only with ``presolve_cost``, module docstring)."""
    st, st_ref = _to_np(st), _to_np(st_ref)
    np.testing.assert_allclose(radius, radius_ref, rtol=1e-6)
    assert int(st["n_corr"]) == int(st_ref["n_corr"])
    assert not bool(st["overflow"])
    if presolve_cost:
        np.testing.assert_allclose(st["cost_before"], st_ref["cost_before"],
                                   rtol=0.05)
    np.testing.assert_allclose(st["cost_after"], st_ref["cost_after"],
                               rtol=0.10)
    assert st["cost_after"][0] < 0.5 * st["cost_before"][0]  # descends
    dv = np.abs(values - values_ref)
    assert np.percentile(dv, 99.9) < 0.25
    assert int(st["n_nodes"]) > 0
    assert abs(int(st["n_nodes"]) - int(st_ref["n_nodes"])) <= 16


def test_sharded_frame_matches_fusion_frame(runs):
    f = runs["port"]["frames"][0]
    rad_c, v_c, st_c = runs["single"]
    assert_frames_agree(float(runs["port"]["radius"]), f["values"],
                        f["stats"], rad_c, v_c, st_c)


def test_sharded_frame_matches_jax_sharded(runs):
    f = runs["port"]["frames"][0]
    v_j, st_j = runs["jax_frames"][0]
    assert_frames_agree(float(runs["port"]["radius"]), f["values"],
                        f["stats"], runs["jax_radius"], v_j, st_j)


def test_sharded_frame_chains(runs):
    """The second frame starts from the first's outputs (TSDF, field, pose
    and node pool round-trip) and still agrees with JAX's second frame
    (but the pre-solve cost, module docstring)."""
    frames = runs["port"]["frames"]
    for f in frames:
        assert not bool(f["stats"].overflow)
        assert int(f["stats"].n_corr) > 1000
    v_j, st_j = runs["jax_frames"][1]
    assert_frames_agree(float(runs["port"]["radius"]), frames[1]["values"],
                        frames[1]["stats"], runs["jax_radius"], v_j, st_j,
                        presolve_cost=False)
