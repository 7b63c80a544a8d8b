"""K8's wrapper (``ops/rigid_update_cuda.py:rigid_update``) on the CPU,
where it takes its plain twin: the rigid TSDF update's formula as
``models/tsdf_volume.py:update_tsdf_rigid`` computed it before the
kernel, bit for bit, on poses that keep every sample in the live volume
and that send some out, with live values at exactly ∓tdist and weights
at ``wmax``; x-slabs with their offsets composing the whole volume; and
the arguments the kernel refuses.

The kernel itself runs on the card only: ``python -m
dynamicfusion_body_tpu_torch.tools.profile_rigid_update --res 512``
holds it to this twin there, voxel for voxel (also ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from dynamicfusion_body_tpu_torch.models import tsdf_volume as TT
from dynamicfusion_body_tpu_torch.ops import rigid_update_cuda as K8
from dynamicfusion_body_tpu_torch.ops.dualquat import (dq_transform_point,
                                                       quat_multiply)
from dynamicfusion_body_tpu_torch.ops.interp import trilinear
from dynamicfusion_body_tpu_torch.tools import profile_rigid_update

torch.set_num_threads(1)

TDIST, WMAX = 0.5, 4.0
SHAPE = (14, 12, 16)
# (degrees about an axis, translation in voxels): rigid DQs
POSES = {
    "identity": (0.0, (0, 0, 1), (0, 0, 0)),
    # a small rotation and a sub-voxel translation (some samples near the
    # faces leave the live volume)
    "moved": (3.0, (1, -1.5, 0.5), (0.2, 0.4, -0.3)),
    # a larger rotation and a few voxels: about half leaves it
    "out": (12.0, (1, 2, -1), (3.0, -2.0, 1.5)),
}


def formula(values, weights, live, lw_dq, tdist, wmax, x_offset=0):
    """``update_tsdf_rigid`` as the port computed it before K8."""
    xs, ys, zs = TT._grid_axes(values.shape, values.device, x_offset)
    pos = torch.stack(torch.broadcast_tensors(xs, ys, zs), dim=-1)
    warped = dq_transform_point(lw_dq, pos.reshape(-1, 3))
    tsdf_l, valid = trilinear(live, warped)
    tsdf_l = tsdf_l.reshape(values.shape)
    valid = valid.reshape(values.shape)
    upd = valid & (tsdf_l > -tdist)
    new_w = weights + 1.0
    new_vals = (values * weights + torch.clamp_max(tsdf_l, tdist) * 1.0) / new_w
    return (torch.where(upd, new_vals, values),
            torch.where(upd, torch.clamp_max(new_w, wmax), weights))


def scene(seed=0, shape=SHAPE):
    """(values, weights, live): live with entries at exactly -tdist and
    tdist, weights from 0 to wmax."""
    rng = np.random.RandomState(seed)
    live = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    edge = rng.rand(*shape)
    live[edge < 0.1] = -TDIST
    live[edge > 0.9] = TDIST
    values = rng.uniform(-TDIST, TDIST, shape).astype(np.float32)
    weights = rng.randint(0, int(WMAX) + 1, shape).astype(np.float32)
    return (torch.from_numpy(values), torch.from_numpy(weights),
            torch.from_numpy(live))


def pose(name):
    deg, axis, t = POSES[name]
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    half = np.radians(deg) / 2
    qr = torch.tensor([np.cos(half), *(np.sin(half) * axis)],
                      dtype=torch.float32)
    qd = 0.5 * quat_multiply(torch.tensor([0.0, *t]), qr)
    return torch.cat([qr, qd])


@pytest.mark.parametrize("name", sorted(POSES))
def test_twin_is_the_formula(name):
    values, weights, live = scene()
    dq = pose(name)
    got_v, got_w = K8.rigid_update(values, weights, live, dq, TDIST, WMAX)
    want_v, want_w = formula(values, weights, live, dq, TDIST, WMAX)
    assert torch.equal(got_v, want_v) and torch.equal(got_w, want_w)
    assert torch.equal(got_v, TT.update_tsdf_rigid(values, weights, live, dq,
                                                   TDIST, WMAX)[0])
    pos = torch.stack(torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32) for n in SHAPE],
        indexing="ij"), dim=-1).reshape(-1, 3)
    _, valid = trilinear(live, dq_transform_point(dq, pos))
    valid = valid.reshape(SHAPE)
    assert bool(valid.any())
    outside = float((~valid).float().mean())
    assert (outside == 0) == (name == "identity")
    assert (outside > 0.4) == (name == "out"), outside
    # the weight clamp binds: voxels at wmax that the update reaches
    assert bool(((weights == WMAX) & (got_w == WMAX) & valid).any())
    if name == "identity":  # samples on the lattice: live itself
        at_minus = live == -TDIST
        assert bool(at_minus.any())
        assert torch.equal(got_v[at_minus], values[at_minus])
        assert torch.equal(got_w[at_minus], weights[at_minus])
        at_plus = (live == TDIST) & (weights == 0)
        assert bool(at_plus.any())
        assert torch.equal(got_v[at_plus], live[at_plus])


@pytest.mark.parametrize("split", [1, 5, 13])
def test_x_slabs_compose_the_volume(split):
    values, weights, live = scene(seed=1)
    dq = pose("moved")
    whole = K8.rigid_update(values, weights, live, dq, TDIST, WMAX)
    parts = [K8.rigid_update(values[a:b], weights[a:b], live, dq, TDIST,
                             WMAX, x_offset=a)
             for a, b in ((0, split), (split, SHAPE[0]))]
    for i in range(2):
        assert torch.equal(torch.cat([p[i] for p in parts]), whole[i])


def _bad(case):
    values, weights, live = scene()
    dq = pose("moved")
    if case == "dtype":
        values = values.double()
    elif case == "shape":
        weights = weights[:, :, :-1].contiguous()
    elif case == "live":
        live = live[0]
    elif case == "contiguous":
        values = values.transpose(0, 2).contiguous().transpose(0, 2)
        weights = weights.transpose(0, 2).contiguous().transpose(0, 2)
    elif case == "dq7":
        dq = dq[:7]
    elif case == "dq2d":
        dq = dq[None]
    elif case == "device":
        values, weights, live, dq = (t.to("meta")
                                     for t in (values, weights, live, dq))
    return values, weights, live, dq


@pytest.mark.parametrize("case", ["dtype", "shape", "live", "contiguous",
                                  "dq7", "dq2d", "device"])
def test_refuses_what_the_kernel_takes_not(case):
    args = _bad(case)
    with pytest.raises(ValueError, match="rigid_update"):
        K8.rigid_update(*args, TDIST, WMAX)


def test_profile_tool_on_the_cpu():
    rows = profile_rigid_update.main(["--device", "cpu", "--res", "32",
                                      "--reps", "1"])
    assert [r["pose"] for r in rows] == ["identity", "icp"]
    for r in rows:
        assert r["unequal_values"] == 0 and r["unequal_weights"] == 0
        assert 0 < r["updated"] < 1 and r["launches"] == 0
