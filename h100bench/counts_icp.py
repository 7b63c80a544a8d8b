"""The yardstick of K7's roofline share (the exact lattice k-NN of the ICP
ingest, ``knn_grid_query_kernel``): the bytes a search needs, over the
card's memory rate (``counts.py``'s peaks).

Each valid query and point is read once (three float32 each) and each
query's k slots written once (a float32 distance and an int64 index).
The search's own traffic (the octree's offsets, the points it revisits)
is not counted: that is the kernel's cost, not the work's.
"""

from __future__ import annotations

from .counts import bound_ms


def k7_bound_ms(n_queries: int, n_points: int, k: int) -> float:
    nbytes = 12 * n_queries + 12 * n_points + 12 * k * n_queries
    return bound_ms(nbytes, 0)


def crossing_edges(vol, level: float = 0.0) -> int:
    """The vertices marching cubes makes of ``vol`` at stride 1: the
    lattice edges whose two ends lie on different sides of ``level``."""
    ins = vol < level
    return int((ins[1:] != ins[:-1]).sum() + (ins[:, 1:] != ins[:, :-1]).sum()
               + (ins[:, :, 1:] != ins[:, :, :-1]).sum())
