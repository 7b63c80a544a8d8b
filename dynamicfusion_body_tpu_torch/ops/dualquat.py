"""Batched quaternion / dual-quaternion algebra on torch tensors.

Counterpart of ``dynamicfusion_body_tpu/ops/dualquat.py``; the same
conventions (reference core/util.py:63-304):

* quaternion layout ``(w, x, y, z)``;
* dual quaternion layout ``(w, x, y, z, we, xe, ye, ze)``;
* the "full" DQ conjugate negates components 1..4;
* the point transform is the literal sandwich ``dq * v * conj(dq)`` with
  ``v = (1,0,0,0, 0,px,py,pz)`` and no normalization;
* blending normalizes by the 8-vector norm with an identity fallback.

Every function takes arbitrary leading batch dims with the (4,)/(8,)
component on the trailing axis, and works under ``torch.func`` transforms.
"""

from __future__ import annotations

import torch

IDENTITY_DQ = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

# Smallest normal float32. Far from every node the blend weights are tiny
# (exp(-d²/4w²) < 1e-24 beyond d = 15w), and a blend whose squared 8-norm is
# below this has underflowed: its squares are subnormal, the computed norm
# can be off by orders of magnitude, and the "normalized" DQ then scales
# what it transforms (canonical vertices moved by up to 186 voxels at the
# 256³ bench). The TPU and XLA flush subnormals, so the JAX package takes
# the identity fallback there; comparing with NORM2_MIN makes the same
# decision under IEEE arithmetic.
NORM2_MIN = float(torch.finfo(torch.float32).tiny)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (reference core/util.py:255-269)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def dq_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(ar + ε ad)(br + ε bd) — reference core/util.py:275-282."""
    ar, ad = a[..., :4], a[..., 4:]
    br, bd = b[..., :4], b[..., 4:]
    rr = quat_multiply(ar, br)
    rd = quat_multiply(ar, bd) + quat_multiply(ad, br)
    return torch.cat([rr, rd], dim=-1)


def dq_full_conjugate(dq: torch.Tensor) -> torch.Tensor:
    """Negate components 1..4 (reference core/util.py:299-304)."""
    sign = dq.new_tensor([1.0, -1, -1, -1, -1, 1, 1, 1])
    return dq * sign


def dq_transform_point(dq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(dq · v · conj(dq))[5:8] with v = 1 + ε(p); no normalization
    (reference core/util.py:68-72). Leading dims broadcast."""
    zeros = torch.zeros_like(p[..., :1])
    ones = torch.ones_like(p[..., :1])
    vq = torch.cat([ones, zeros, zeros, zeros, zeros, p], dim=-1)
    shape = torch.broadcast_shapes(dq.shape[:-1], vq.shape[:-1]) + (8,)
    dq = dq.expand(shape)
    vq = vq.expand(shape)
    out = dq_multiply(dq_multiply(dq, vq), dq_full_conjugate(dq))
    return out[..., 5:8]


def dq_transform_normal(dq: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Rotate by the real part only (reference core/util.py:74-76)."""
    rq = torch.cat([dq[..., :4], torch.zeros_like(dq[..., :4])], dim=-1)
    return dq_transform_point(rq, n)


def dq_normalize8(dq: torch.Tensor) -> torch.Tensor:
    """Normalize by the full 8-vector norm; identity DQ where the norm is
    zero or has underflowed (:data:`NORM2_MIN`; reference
    core/fusion.py:544-551)."""
    norm = torch.linalg.vector_norm(dq, dim=-1, keepdim=True)
    ok = norm * norm >= NORM2_MIN
    out = dq / torch.where(ok, norm, torch.ones_like(norm))
    ident = dq.new_tensor(IDENTITY_DQ).expand(dq.shape)
    return torch.where(ok, out, ident)


def dqb_weights(pos, node_pos, node_w):
    """Gaussian blend weights exp(-(‖pos-v_k‖ / (2 w_k))²) —
    reference core/fusion.py:536-538. pos (...,3); node_pos (...,K,3);
    node_w (...,K)."""
    d = torch.linalg.vector_norm(pos[..., None, :] - node_pos, dim=-1)
    return torch.exp(-((d / (2.0 * node_w)) ** 2))


def dq_blend(pos, node_pos, node_dq, node_w, mask=None):
    """Gaussian DQ blend over K nodes per point, 8-norm normalized with
    identity fallback (reference core/fusion.py:527-551). ``mask``
    (...,K) zeroes the weight of masked pool slots."""
    w = dqb_weights(pos, node_pos, node_w)
    if mask is not None:
        w = torch.where(mask, w, torch.zeros_like(w))
    blended = torch.sum(w[..., None] * node_dq, dim=-2)
    return dq_normalize8(blended)
