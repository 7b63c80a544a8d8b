"""Dual-quaternion algebra of the reference DynamicFusion (plain PyTorch).

Layout (w, x, y, z, we, xe, ye, ze); a point p is moved by the literal
sandwich dq · (1 + ε p) · conj(dq), with the full conjugate that negates
components 1..4, and no normalization; a blend is normalized by its
8-vector norm, and a blend whose squared norm is below the smallest
normal float32 (it has underflowed) is the identity. Components are kept
as tuples of tensors, so that any batch shape and dtype work.
"""

from __future__ import annotations

import torch

NORM2_MIN = float(torch.finfo(torch.float32).tiny)


def qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def dqmul(a, b):
    rr = qmul(a[:4], b[:4])
    rd = [x + y for x, y in zip(qmul(a[:4], b[4:]), qmul(a[4:], b[:4]))]
    return rr + tuple(rd)


def transform_point(dq, p):
    """dq (8 tensors), p (3 tensors) → the moved point (3 tensors)."""
    one = torch.ones_like(p[0])
    zero = torch.zeros_like(p[0])
    v = (one, zero, zero, zero, zero, p[0], p[1], p[2])
    conj = (dq[0], -dq[1], -dq[2], -dq[3], -dq[4], dq[5], dq[6], dq[7])
    out = dqmul(dqmul(dq, v), conj)
    return out[5], out[6], out[7]


def normalize(dq):
    """8-norm normalization with the identity for an underflowed blend."""
    n2 = sum(c.float() * c.float() for c in dq)
    norm = torch.sqrt(n2)
    ok = n2 >= NORM2_MIN
    dt = dq[0].dtype
    inv = torch.where(ok, norm, torch.ones_like(norm)).to(dt)
    ident = (1.0,) + (0.0,) * 7
    return tuple(torch.where(ok, c / inv, torch.full_like(c, e))
                 for c, e in zip(dq, ident))


def split(t):
    """(..., n) tensor → tuple of n tensors."""
    return tuple(t[..., i] for i in range(t.shape[-1]))
