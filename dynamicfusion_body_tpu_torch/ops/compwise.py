"""Componentwise quaternion/DQ algebra on tuples of same-shape tensors.

Counterpart of ``dynamicfusion_body_tpu/ops/compwise.py``. The JAX package
keeps the hot voxel path in structure-of-arrays form to dodge the TPU's
(8,128) tile padding; the port keeps the form because the K2 kernel
(``csrc/warp_trilerp_cached.cu``) evaluates exactly these expressions,
term by term and in the same order, so its plain twin
(``ops/trilerp_cuda.py``) and the kernel round alike.
"""

from __future__ import annotations

import torch

from .dualquat import NORM2_MIN


def quat_mul_c(a, b):
    """Hamilton product on 4-tuples."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def dq_mul_c(a, b):
    """Dual-quaternion product on 8-tuples."""
    rr = quat_mul_c(a[:4], b[:4])
    rd1 = quat_mul_c(a[:4], b[4:])
    rd2 = quat_mul_c(a[4:], b[:4])
    return rr + tuple(x + y for x, y in zip(rd1, rd2))


def dq_conj_full_c(q):
    """Negate components 1..4 (reference core/util.py:299-304)."""
    return (q[0], -q[1], -q[2], -q[3], -q[4], q[5], q[6], q[7])


def dq_point_c(dq, p):
    """Sandwich transform (dq·v·conj(dq))[5:8]; no normalization.
    ``dq`` may hold tensors or Python floats, ``p`` holds tensors."""
    one = torch.ones_like(p[0])
    zero = torch.zeros_like(p[0])
    v = (one, zero, zero, zero, zero, p[0], p[1], p[2])
    out = dq_mul_c(dq_mul_c(dq, v), dq_conj_full_c(dq))
    return out[5:8]


def dq_normalize8_c(dq):
    """8-vector-norm normalization with identity fallback where the norm is
    zero or has underflowed (``dualquat.NORM2_MIN``; reference
    core/fusion.py:544-551)."""
    n2 = sum(c * c for c in dq)
    n = torch.sqrt(n2)
    ok = n2 >= NORM2_MIN
    zero = torch.zeros_like(n)
    inv = torch.where(ok, 1.0 / torch.where(ok, n, torch.ones_like(n)), zero)
    out = tuple(c * inv for c in dq)
    ident_w = torch.where(ok, out[0], torch.ones_like(n))
    return (ident_w,) + tuple(torch.where(ok, c, zero) for c in out[1:])
