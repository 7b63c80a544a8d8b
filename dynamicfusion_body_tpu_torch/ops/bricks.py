"""Volume ↔ brick-row layout — counterpart of
``dynamicfusion_body_tpu/ops/bricks.py``.

A (rx, ry, rz) volume tiles into brick³ cubes in x-major order (z
fastest); each brick's voxels flatten x-major into one (V = brick³) row.
The K2 kernel runs one CTA per row.
"""

from __future__ import annotations


def vol_to_bricks(vol, brick: int):
    rx, ry, rz = vol.shape
    nbx, nby, nbz = rx // brick, ry // brick, rz // brick
    t = vol.reshape(nbx, brick, nby, brick, nbz, brick)
    return t.permute(0, 2, 4, 1, 3, 5).reshape(nbx * nby * nbz, brick ** 3)


def vol_from_bricks(b2, shape, brick: int):
    rx, ry, rz = shape
    nbx, nby, nbz = rx // brick, ry // brick, rz // brick
    t = b2.reshape(nbx, nby, nbz, brick, brick, brick)
    return t.permute(0, 3, 1, 4, 2, 5).reshape(rx, ry, rz)
