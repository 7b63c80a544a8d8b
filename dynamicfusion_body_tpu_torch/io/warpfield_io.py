"""Warp-field checkpoints in the reference's format — counterpart of
``dynamicfusion_body_tpu/io/warpfield_io.py`` (numpy and pickle only in
the JAX package too; copied, because importing that package imports jax).

The reference pickles ``self._nodes`` — a list of 4-tuples
(anchor_vertex_idx, position (3,) ndarray, dq (8,) ndarray, weight) —
after every graph update (core/fusion.py:571-573). The fixed-capacity
WarpField pool is written to that structure (active nodes only), byte for
byte as the JAX package writes it for the same field, and either format
loads back.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def save_warp_field(wf, path, filename, itercounter):
    """Write ``<path>/<filename>__<itercounter>.p``; returns its path."""
    n = int(wf.num_active)
    pos = wf.node_pos.detach().cpu().numpy()
    dq = wf.node_dq.detach().cpu().numpy()
    w = wf.node_w.detach().cpu().numpy()
    vidx = wf.node_vert_idx.detach().cpu().numpy()
    nodes = [(int(vidx[i]), pos[i].copy(), dq[i].copy(), float(w[i]))
             for i in range(n)]
    fpath = os.path.join(path, filename + "__" + str(itercounter) + ".p")
    with open(fpath, "wb") as f:
        pickle.dump(nodes, f)
    return fpath


def load_warp_field_nodes(path):
    """Returns numpy (positions (N,3) f32, dqs (N,8) f32, weights (N,) f32,
    vert_idx (N,) int32)."""
    with open(path, "rb") as f:
        nodes = pickle.load(f)
    vidx = np.array([n[0] for n in nodes], dtype=np.int32)
    pos = np.array([n[1] for n in nodes], dtype=np.float32)
    dq = np.array([n[2] for n in nodes], dtype=np.float32)
    w = np.array([n[3] for n in nodes], dtype=np.float32)
    return pos, dq, w, vidx


def restore_warp_field(wf_cls, path, capacity, device="cuda"):
    """Rebuild a WarpField pool of ``capacity`` slots from a checkpoint on
    ``device`` (the resume path the reference never had, SURVEY §5.4):
    free slots hold zeros and the identity DQ; the sampling radius is half
    the first node's support."""
    pos, dq, w, vidx = load_warp_field_nodes(path)
    n = len(pos)
    if n > capacity:
        raise ValueError(f"checkpoint has {n} nodes > capacity {capacity}")
    pad = capacity - n
    dq = np.pad(dq.reshape(n, 8), ((0, pad), (0, 0)))
    dq[n:, 0] = 1.0

    def t(a, dtype):
        return torch.as_tensor(a, device=device).to(dtype)

    return wf_cls(
        node_pos=t(np.pad(pos.reshape(n, 3), ((0, pad), (0, 0))),
                   torch.float32),
        node_dq=t(dq, torch.float32),
        node_w=t(np.pad(w, (0, pad)), torch.float32),
        node_vert_idx=t(np.pad(vidx, (0, pad)), torch.int64),
        active=torch.arange(capacity, device=device) < n,
        radius=t(np.float32(w[0] / 2.0 if n else 1.0), torch.float32),
    )
