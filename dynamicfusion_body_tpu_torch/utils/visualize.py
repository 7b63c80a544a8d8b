"""Mesh / TSDF visualization — the port of
``dynamicfusion_body_tpu/utils/visualize.py`` (reference ``visualize``,
test.py:24-38).

Renders the level-0 isosurface of a TSDF (or an explicit mesh) as a
matplotlib Poly3DCollection. Both functions take torch tensors (on any
device) or numpy arrays. matplotlib is imported lazily, inside the
functions, so that headless pipelines never pay for it; pass
``save_path`` to write a PNG without a display. The machine with the
card has no matplotlib, so nothing there calls these (the chip smoke
does not); the CPU tests render with the Agg backend.
"""

from __future__ import annotations

import numpy as np
import torch


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def visualize_mesh(verts, faces, save_path=None, show=False, title=None):
    """Draw ``verts`` (V, 3) / ``faces`` (F, 3); returns ``save_path``."""
    import matplotlib

    if save_path and not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    verts = _numpy(verts)
    faces = _numpy(faces)
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="3d")
    if len(verts) and len(faces):
        mesh = Poly3DCollection(verts[faces])
        mesh.set_edgecolor("k")
        ax.add_collection3d(mesh)
        lo = verts.min(axis=0)
        hi = verts.max(axis=0)
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
    else:
        ax.set_title((title or "") + " (empty isosurface)")
    if title:
        ax.set_title(title)
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path, dpi=120)
        plt.close(fig)
    if show:
        plt.show()
    return save_path


def visualize_tsdf(tsdf, level=0.0, step_size=1, save_path=None, show=False,
                   vert_cap=1 << 16, face_cap=1 << 17):
    """Marching-cubes the volume (the port's ``ops/marching_cubes.py``, on
    the tensor's device) then render it with :func:`visualize_mesh`."""
    from ..ops.marching_cubes import marching_cubes

    vol = tsdf if isinstance(tsdf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(tsdf, dtype=np.float32))
    out = marching_cubes(vol, level=level, vert_cap=vert_cap,
                         face_cap=face_cap, step_size=step_size,
                         use_kernels=vol.is_cuda)
    nv, nf = int(out["n_verts"]), int(out["n_faces"])
    return visualize_mesh(out["verts"][:nv], out["faces"][:nf],
                          save_path=save_path, show=show)
