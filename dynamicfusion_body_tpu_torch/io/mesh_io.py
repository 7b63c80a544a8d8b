"""OBJ mesh read/write — a copy of ``dynamicfusion_body_tpu/io/mesh_io.py``.
:func:`load_obj` and :func:`save_obj` go through the native C++ parser
and writer (``native/dfio.cc``, built at first use); ``native=False``
takes the Python path, which writes the same bytes and which the tests
hold the native one to. A failed native build raises: nothing falls back.

Reference writers: core/fusion.py:577-586 (plain ``v``/``vn``/``f``) and
core/fusion_dm.py:339-354 (vertices/normals mapped grid→world through the
``_IND`` rotation+translation, faces as ``v//vn`` with 1-based indices).
Reader: core/meshutil.py:12-39.
"""

from __future__ import annotations

import numpy as np


def load_obj(path, native=True):
    """Returns (vertices (V,3) f32, faces (F,3) i32 zero-based)."""
    if native:
        from ..native import read_obj

        return read_obj(path)
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) for p in parts[1:4]])
    v = np.asarray(verts, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int32)
    if f.size and f.min() == 1:
        f = f - 1
    return v, f


def save_obj(path, verts, faces, normals=None, ind=None, native=True):
    """Write an OBJ. With ``ind`` (4,4), vertices/normals are mapped
    grid→world via its rotation+translation first and faces are written as
    ``v//vn`` (core/fusion_dm.py:339-354)."""
    if native:
        from ..native import write_obj

        write_obj(path, verts, faces, normals=normals, ind=ind)
        return
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float64)
    if ind is not None:
        rot = np.asarray(ind)[:3, :3]
        trans = np.asarray(ind)[:3, 3]
        verts = verts @ rot.T + trans
        if normals is not None:
            normals = normals @ rot.T
    with open(path, "w") as f:
        for v in verts:
            f.write("v %f %f %f\n" % (v[0], v[1], v[2]))
        if normals is not None:
            for n in normals:
                f.write("vn %f %f %f\n" % (n[0], n[1], n[2]))
        if ind is not None and normals is not None:
            # FusionDM style: f v//vn (core/fusion_dm.py:352-353)
            for t in faces:
                f.write(
                    "f %d//%d %d//%d %d//%d\n"
                    % (t[0] + 1, t[0] + 1, t[1] + 1, t[1] + 1, t[2] + 1, t[2] + 1)
                )
        else:
            # Fusion style: plain faces (core/fusion.py:584-585)
            for t in faces:
                f.write("f %d %d %d\n" % (t[0] + 1, t[1] + 1, t[2] + 1))


def regularize_mesh(vertices, flipyz=False):
    """Center and scale to a 1.8-unit height (reference
    core/meshutil.py:62-69)."""
    vertices = np.array(vertices, dtype=np.float32)
    if flipyz:
        vertices[:, [1, 2]] = vertices[:, [2, 1]]
    scale = 1.8 / (np.max(vertices[:, 1]) - np.min(vertices[:, 1]))
    return (vertices - np.mean(vertices, 0)) * scale
