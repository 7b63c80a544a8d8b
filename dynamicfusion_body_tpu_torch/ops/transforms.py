"""Host-side 4x4 / quaternion / Euler transform toolkit (NumPy) —
counterpart of ``dynamicfusion_body_tpu/ops/transforms.py``: homogeneous
rotation constructors, Euler conversions, quaternion utilities, random
rotations and an Arcball for interactive viewers. They build camera poses
and test fixtures; on-device math lives in ``ops/se3.py`` and
``ops/dualquat.py``. A copy, not an import (the JAX package's ``__init__``
imports jax); the quaternion ↔ matrix pair goes through this package's
``ops/se3.py`` in float32, as the JAX module goes through its own. The
random generators take an explicit numpy generator or
``torch.Generator`` in place of numpy's global state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .se3 import quat_from_matrix, quat_to_matrix


def identity_matrix():
    return np.eye(4)


def translation_matrix(direction):
    m = np.eye(4)
    m[:3, 3] = direction[:3]
    return m


def rotation_matrix(angle, direction, point=None):
    """Homogeneous rotation about an axis ``direction`` through ``point``."""
    d = np.asarray(direction, dtype=np.float64)[:3]
    d = d / np.linalg.norm(d)
    c, s = math.cos(angle), math.sin(angle)
    K = np.array([[0, -d[2], d[1]], [d[2], 0, -d[0]], [-d[1], d[0], 0]])
    R = c * np.eye(3) + s * K + (1 - c) * np.outer(d, d)
    m = np.eye(4)
    m[:3, :3] = R
    if point is not None:
        p = np.asarray(point, dtype=np.float64)[:3]
        m[:3, 3] = p - R @ p
    return m


def scale_matrix(factor, origin=None):
    m = np.eye(4) * factor
    m[3, 3] = 1.0
    if origin is not None:
        o = np.asarray(origin, dtype=np.float64)[:3]
        m[:3, 3] = o * (1.0 - factor)
    return m


def euler_matrix(ai, aj, ak, axes="sxyz"):
    """Euler angles → homogeneous rotation (static xyz order)."""
    if axes != "sxyz":
        raise NotImplementedError("only the common 'sxyz' sequence is provided")
    rx = rotation_matrix(ai, [1, 0, 0])
    ry = rotation_matrix(aj, [0, 1, 0])
    rz = rotation_matrix(ak, [0, 0, 1])
    return rz @ ry @ rx


def euler_from_matrix(m, axes="sxyz"):
    if axes != "sxyz":
        raise NotImplementedError("only the common 'sxyz' sequence is provided")
    R = np.asarray(m)[:3, :3]
    sy = math.hypot(R[0, 0], R[1, 0])
    if sy > 1e-8:
        ai = math.atan2(R[2, 1], R[2, 2])
        aj = math.atan2(-R[2, 0], sy)
        ak = math.atan2(R[1, 0], R[0, 0])
    else:
        ai = math.atan2(-R[1, 2], R[1, 1])
        aj = math.atan2(-R[2, 0], sy)
        ak = 0.0
    return ai, aj, ak


def quaternion_about_axis(angle, axis):
    a = np.asarray(axis, dtype=np.float64)[:3]
    a = a / np.linalg.norm(a)
    return np.concatenate([[math.cos(angle / 2.0)], a * math.sin(angle / 2.0)])


def quaternion_matrix(q):
    """Quaternion (w,x,y,z) → 4x4 rotation, in float32."""
    return quat_to_matrix(torch.as_tensor(np.asarray(q), dtype=torch.float32)
                          ).numpy()


def quaternion_from_matrix(m):
    """Rotation matrix → quaternion (w,x,y,z), w >= 0, in float32."""
    return quat_from_matrix(torch.as_tensor(np.asarray(m),
                                            dtype=torch.float32)).numpy()


def _uniform3(rng) -> np.ndarray:
    if isinstance(rng, torch.Generator):
        return torch.rand(3, generator=rng, dtype=torch.float64).numpy()
    return rng.uniform(size=3)


def random_quaternion(rng):
    """Uniform random unit quaternion (Shoemake's method) from ``rng``: a
    numpy ``Generator``/``RandomState`` or a ``torch.Generator``."""
    u1, u2, u3 = _uniform3(rng)
    return np.array(
        [
            math.sqrt(u1) * math.cos(2 * math.pi * u3),
            math.sqrt(1 - u1) * math.sin(2 * math.pi * u2),
            math.sqrt(1 - u1) * math.cos(2 * math.pi * u2),
            math.sqrt(u1) * math.sin(2 * math.pi * u3),
        ]
    )


def random_rotation_matrix(rng):
    """Uniform random homogeneous rotation (the one symbol the reference
    pipeline used, test.py:205)."""
    return quaternion_matrix(random_quaternion(rng))


def is_same_transform(a, b, atol=1e-6):
    a = np.asarray(a) / np.asarray(a)[3, 3]
    b = np.asarray(b) / np.asarray(b)[3, 3]
    return np.allclose(a, b, atol=atol)


class Arcball:
    """Virtual trackball for interactive viewers (reference
    core/transformation.py Arcball equivalent, minimal)."""

    def __init__(self, initial=None):
        self._qdown = (np.array([1.0, 0, 0, 0]) if initial is None
                       else np.asarray(initial))
        self._qnow = self._qdown.copy()
        self._v0 = None
        self.center = np.array([0.0, 0.0])
        self.radius = 1.0

    def place(self, center, radius):
        self.center = np.asarray(center, dtype=np.float64)
        self.radius = float(radius)

    def _to_sphere(self, pt):
        v = (np.asarray(pt, dtype=np.float64) - self.center) / self.radius
        n = v @ v
        if n > 1.0:
            v = v / math.sqrt(n)
            return np.array([v[0], v[1], 0.0])
        return np.array([v[0], v[1], math.sqrt(1.0 - n)])

    def down(self, pt):
        self._v0 = self._to_sphere(pt)
        self._qdown = self._qnow.copy()

    def drag(self, pt):
        v1 = self._to_sphere(pt)
        cross = np.cross(self._v0, v1)
        q = np.concatenate([[self._v0 @ v1], cross])
        # qnow = q * qdown (Hamilton)
        w0, x0, y0, z0 = self._qdown
        w1, x1, y1, z1 = q
        self._qnow = np.array(
            [
                w1 * w0 - x1 * x0 - y1 * y0 - z1 * z0,
                w1 * x0 + x1 * w0 + y1 * z0 - z1 * y0,
                w1 * y0 - x1 * z0 + y1 * w0 + z1 * x0,
                w1 * z0 + x1 * y0 - y1 * x0 + z1 * w0,
            ]
        )
        n = np.linalg.norm(self._qnow)
        if n > 0:
            self._qnow = self._qnow / n

    def matrix(self):
        return quaternion_matrix(self._qnow)
