"""The port's sharded 512³ bench
(dynamicfusion_body_tpu_torch/benchmarks/bench512_sharded.py) on the CPU,
at 32³:

* the equivalence on 2 gloo ranks (``parallel/launch.py``): the sharded
  update equal to the dense one, deviations exactly 0, and the JAX
  script's JSON keys;
* the script's scene and dense arm against the JAX script's
  (``benchmarks/bench512_sharded.py:39-77``: the same seeded vertices,
  ``construct_graph`` and ``W.update_tsdf_nonrigid``), with
  test_torch_tsdf_update.py's tolerance (atol 3e-3 off the subnormal
  shell);
* ``--full-frame`` on 2 ranks with the iterations cut: the JSON keys,
  ``ok`` true, the per-rank caps scaled by 8/world and the node pool;
* ``make_mesh`` refusing NCCL without a card, and more NCCL ranks than
  cards.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamicfusion_body_tpu.models import warp_field as JW
from dynamicfusion_body_tpu_torch.benchmarks import bench512_sharded as B
from dynamicfusion_body_tpu_torch.models.warp_field import (
    brick_candidates_2level, build_warp_cache)
from dynamicfusion_body_tpu_torch.ops.bricks import vol_from_bricks
from dynamicfusion_body_tpu_torch.parallel import mesh as tmesh
from dynamicfusion_body_tpu_torch.parallel import ranks
from dynamicfusion_body_tpu_torch.tools._scene import (
    sharded_field, sharded_pose, sharded_volumes)
from test_torch_warp_trilerp import ieee_mask

# One intra-op thread here and in every rank (see
# tests/test_torch_marching_cubes.py)
torch.set_num_threads(1)

RES = 32
EQ_KEYS = ("res", "n_devices", "max_dev_values", "max_dev_weights",
           "esc_dropped", "pool_risk", "t_dense_s", "t_sharded_s", "metric",
           "ok")
FRAME_KEYS = ("res", "n_devices", "n_corr", "n_nodes", "cost_before_r0",
              "cost_after_r0", "descended", "pool_risk", "corr_risk",
              "overflow", "t_setup_s", "t_frame_s", "metric", "ok")


def test_equivalence_on_two_gloo_ranks(capsys):
    out = B.main(["--res", str(RES), "--world", "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    parsed = json.loads(line)
    assert tuple(parsed) == EQ_KEYS
    assert parsed["metric"] == f"sharded_equivalence_{RES}"
    assert parsed["n_devices"] == 2 and parsed["ok"] is True
    assert out["max_dev_values"] == 0.0 and out["max_dev_weights"] == 0.0
    assert out["esc_dropped"] == 0


def test_dense_arm_matches_jax():
    """The scene built from (res, seed) and the dense update against the
    JAX script's own calls on the same numpy draws."""
    canonical, live = sharded_volumes(RES)
    verts, dqs, w0 = sharded_field(RES, canonical, 0)
    # bench512_sharded.py:63-77 in JAX
    jwf = JW.construct_graph(jnp.asarray(verts), jnp.float32(0.05 * RES),
                             len(verts))
    jwf = jwf.replace(node_dq=jnp.asarray(dqs))
    tdist = float(canonical.max())
    want_v, want_w, _, want_risk = JW.update_tsdf_nonrigid(
        jnp.asarray(canonical), jnp.asarray(w0), jnp.asarray(live), jwf,
        jnp.asarray(sharded_pose(RES)), k=3, tdist=tdist, brick=8,
        n_candidates=16)

    sc = ranks.bench512_scene(torch.device("cpu"), RES, 0)
    np.testing.assert_array_equal(sc.canonical, canonical)
    np.testing.assert_array_equal(sc.w0, w0)
    np.testing.assert_array_equal(sc.wf.node_pos.numpy(),
                                  np.asarray(jwf.node_pos))
    np.testing.assert_array_equal(sc.wf.active.numpy(),
                                  np.asarray(jwf.active))
    got_v, got_w = ranks.bench512_dense(torch.from_numpy(canonical),
                                        torch.from_numpy(w0), sc)
    cand, risk = brick_candidates_2level(sc.wf, (RES,) * 3, 8, 16,
                                         with_risk=True, risk_k=3)
    assert int(risk) == int(want_risk)
    selw = build_warp_cache(sc.wf, (RES,) * 3, cand, 3, 8)[1]
    m = vol_from_bricks(torch.from_numpy(ieee_mask(selw.numpy())),
                        (RES,) * 3, 8).numpy()
    assert m.mean() > 0.5
    assert int(np.sum(got_w.numpy() != w0)) > 100  # voxels updated
    np.testing.assert_allclose(got_v.numpy()[m], np.asarray(want_v)[m],
                               atol=3e-3)
    np.testing.assert_allclose(got_w.numpy()[m], np.asarray(want_w)[m],
                               atol=3e-3)


def test_full_frame_on_two_gloo_ranks():
    out = B.run_full_frame(RES, 2, "gloo", frame_kw=dict(
        solve_iters=1, gn_iters=2, cg_iters=4))
    line = B.result(out, full=True)
    assert tuple(line) == FRAME_KEYS
    assert line["metric"] == f"sharded_full_frame_{RES}"
    assert line["ok"] is True, line
    assert line["n_corr"] > 0 and line["n_nodes"] > 0
    assert out["caps"] == B.frame_caps(RES, 2)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_frame_caps_scale_with_world(world):
    caps = B.frame_caps(512, world)
    assert caps == {k: v * 8 // world for k, v in B.JAX_CAPS.items()}
    assert sum(caps.values()) * world == 8 * sum(B.JAX_CAPS.values())
    small = B.frame_caps(RES, world)
    assert small["vert_cap"] >= 2048 and small["face_cap"] >= 4096


def test_node_pool_holds_the_surface():
    """The scene wants 4,255 nodes at 256³ and 17,187 at 512³ (measured
    on the card): the pool holds them, and is the JAX script's below."""
    assert B.node_cap(512) == 32768 and B.node_cap(256) == 8192
    assert B.node_cap(RES) == B.node_cap(128) == B.JAX_NODE_CAP


def test_make_mesh_refuses_nccl_without_a_card(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.make_mesh(1, str(tmp_path / "store"), "nccl", 0)
    # more NCCL ranks than cards: refused before the group is joined
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 cards"):
        tmesh.make_mesh(2, str(tmp_path / "store2"), "nccl", 0)
