"""Binary ``.dist`` SDF volumes — counterpart of
``dynamicfusion_body_tpu/io/sdf_io.py`` (numpy-only there too; copied,
because importing that package imports jax). :func:`load_sdf` reads
through the native C++ reader (``native/dfio.cc``, built at first use);
``native=False`` takes the Python path, which the tests hold it to. A
failed native build raises: nothing falls back.

File format (documented in the reference, core/sdf.py:10-21): three int32
resolutions (x and y stored negated), float64 bbox min/max, float32
(res+1)³ distance data in z-major order (swapped to x-major on load), and
an optional closest-point field. Byte-compatible with the reference's
``load_sdf`` (core/sdf.py:24-69).
"""

from __future__ import annotations

import numpy as np


def load_sdf(file_path, read_closest_points=False, verbose=False,
             native=True):
    """Returns (b_min (3,), b_max (3,), volume (rx+1,ry+1,rz+1) f32,
    closest_points (rx+1,ry+1,rz+1,3) f32 or None), numpy arrays. The
    closest-point field is parsed by the Python path only, as in the JAX
    package."""
    if native and not read_closest_points:
        from ..native import read_dist

        b_min, b_max, volume = read_dist(file_path)
        if verbose:
            print("loaded volume from %s" % file_path)
        return b_min, b_max, volume, None
    with open(file_path, "rb") as fp:
        res_x = -int(np.fromfile(fp, dtype=np.int32, count=1)[0])
        res_y = -int(np.fromfile(fp, dtype=np.int32, count=1)[0])
        res_z = int(np.fromfile(fp, dtype=np.int32, count=1)[0])
        if verbose:
            print("resolution: %d %d %d" % (res_x, res_y, res_z))
        b_min = np.fromfile(fp, dtype=np.float64, count=3)
        b_max = np.fromfile(fp, dtype=np.float64, count=3)
        n = (1 + res_x) * (1 + res_y) * (1 + res_z)
        volume = np.fromfile(fp, dtype=np.float32, count=n)
        volume = volume.reshape((1 + res_z, 1 + res_y, 1 + res_x))
        volume = np.swapaxes(volume, 0, 2)
        closest = None
        if read_closest_points:
            closest = np.fromfile(fp, dtype=np.float32, count=n * 3)
            closest = closest.reshape((1 + res_z, 1 + res_y, 1 + res_x, 3))
            closest = np.swapaxes(closest, 0, 2)
    return b_min, b_max, volume, closest


def save_sdf(file_path, volume, b_min, b_max):
    """Inverse of :func:`load_sdf` without the closest-point field."""
    volume = np.asarray(volume, dtype=np.float32)
    rx, ry, rz = (s - 1 for s in volume.shape)
    with open(file_path, "wb") as fp:
        np.array([-rx, -ry, rz], dtype=np.int32).tofile(fp)
        np.asarray(b_min, dtype=np.float64).tofile(fp)
        np.asarray(b_max, dtype=np.float64).tofile(fp)
        np.swapaxes(volume, 0, 2).astype(np.float32).tofile(fp)
