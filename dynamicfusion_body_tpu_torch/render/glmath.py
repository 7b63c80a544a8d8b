"""mat4 helpers (perspective/ortho/lookat/rotate/translate/transform) — a
copy of ``dynamicfusion_body_tpu/render/glmath.py`` (numpy only), so the
port imports nothing of the JAX package.

NumPy port of the reference's GL math module (core/gl/glm.py:1-126) with
identical conventions (column-vector, right-handed, OpenGL clip space) so
the CNN render path reproduces the same MVPs.
"""

from __future__ import annotations

import numpy as np


def radians(deg):
    return np.deg2rad(deg)


def vec3(x, y, z):
    return np.array([x, y, z], dtype=np.float32)


def identity():
    return np.eye(4, dtype=np.float32)


def normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def translate(m, v):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = v
    return m @ t


def rotate(m, angle, axis):
    a = normalize(np.asarray(axis, dtype=np.float64))
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = a
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s, 0],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c), 0],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )
    return m @ r


def perspective(fovy, aspect, znear, zfar):
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = 2.0 * zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    return m


def ortho(left, right, bottom, top, znear, zfar):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -2.0 / (zfar - znear)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(zfar + znear) / (zfar - znear)
    return m


def lookat(eye, center, up):
    f = normalize(np.asarray(center, np.float64) - np.asarray(eye, np.float64))
    s = normalize(np.cross(f, normalize(np.asarray(up, np.float64))))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -(m[:3, :3] @ np.asarray(eye, np.float64))
    return m


def transform(points4, m):
    """Apply mat4 to (N,4) homogeneous points."""
    return points4 @ m.T
