"""Learned (CNN) correspondences — counterpart of
``dynamicfusion_body_tpu/pipeline/cnn_correspondence.py``.

The reference's TF1 + OpenGL flow (core/sdf.py:75-150 +
core/fusion.py:277-296): render the mesh from 24 yaw angles (15° steps),
convert the z-buffer to the 8-bit linearized depth the network expects,
run DHBC to get per-pixel 16-D descriptors, average them onto vertices
through the ID render, then match canonical → live vertices by nearest
descriptor.

Per mesh (:func:`_descriptors`): the renders run one view at a time
(each keeps F·S² fragments live), the network takes ``view_batch`` views
as one forward, and one flat ``index_add_`` over all views sums the
features and the counts per vertex. The renderer emits vertex IDs
directly; the 24-bit colour codec stays in ``utils/colorcodec.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.dhbc import (init_dhbc, load_npz_params, npz_feature_norm,
                           npz_normalize_input)
from ..render import glmath
from ..render.raster import render_id
from .correspondence import feature_correspondences
from .fusion import resolve_device


def view_mvps(n_views: int = 24, znear: float = 1.0, zfar: float = 3.5,
              swi: float = 35.0, max_swi: float = 70.0, dis: float = 200.0):
    """The reference's 24 view matrices (core/sdf.py:124-131), (V,4,4)
    float32 numpy."""
    proj = glmath.perspective(glmath.radians(70), 1.0, znear, zfar)
    mvps = []
    for rot in range(0, 360, 360 // n_views):
        mod = glmath.identity()
        mod = glmath.rotate(mod, glmath.radians(swi - max_swi / 2),
                            glmath.vec3(0, 1, 0))
        mod = glmath.translate(mod, glmath.vec3(0, 0, -dis / 100.0))
        mod = glmath.rotate(mod, glmath.radians(rot), glmath.vec3(0, 1, 0))
        mvps.append(proj @ mod)
    return np.stack(mvps).astype(np.float32)


def regularize_verts(verts, vert_mask, flipyz: bool = False):
    """Center and scale to a 1.8-unit height over the VALID vertices
    (masked version of core/meshutil.py:62-69); masked slots are 0."""
    if flipyz:
        verts = verts[:, [0, 2, 1]]
    m = vert_mask[:, None]
    y = verts[:, 1]
    ymax = torch.amax(torch.where(vert_mask, y, -torch.inf))
    ymin = torch.amin(torch.where(vert_mask, y, torch.inf))
    n = torch.clamp_min(torch.sum(vert_mask), 1)
    mean = torch.sum(torch.where(m, verts, 0.0), dim=0) / n
    scale = 1.8 / torch.clamp_min(ymax - ymin, 1e-6)
    return torch.where(m, (verts - mean) * scale, 0.0)


def render_views(reg, faces, face_mask, mvps, znear, zfar, h: int, w: int,
                 S: int):
    """One ID render per view, serially → (ids (V,h,w) int32, 1-based;
    depth8 (V,h,w) f32: ``floor(clip((zfar − b/(zwin − a))/(zfar −
    znear)·255, 0, 255))``, the reference's linearized z-buffer)."""
    b = zfar * znear / (znear - zfar)
    a = -b / znear
    ids_all, depth_all = [], []
    for mvp in mvps:
        ids, zwin = render_id(reg, faces, face_mask, mvp, h, w, S=S)
        depth_all.append(torch.floor(torch.clamp(
            (zfar - b / (zwin - a)) / (zfar - znear) * 255.0, 0, 255)))
        ids_all.append(ids)
    return torch.stack(ids_all), torch.stack(depth_all)


def network(model, params, depth8, view_batch: int):
    """DHBC over ``view_batch`` views per forward (singles when the view
    count is not a multiple of it, as in the JAX package) → (V,h,w,16)."""
    n_views, h, w = depth8.shape
    vb = max(1, min(view_batch, n_views))
    if n_views % vb:
        vb = 1
    with torch.no_grad():
        feats = [torch.func.functional_call(model, params, (x[:, None],))
                 for x in depth8.split(vb)]
    return torch.cat(feats).permute(0, 2, 3, 1)


# rows past the vertices that take the background pixels, spread so that
# the card's atomic adds do not all contend for one row
DROP_ROWS = 1024


def scatter(ids, feats, n_verts: int):
    """Per-vertex feature means and pixel counts over all views: one flat
    ``index_add_`` of features and counts; pixels without a vertex go to
    ``DROP_ROWS`` dropped rows → (feats (N,16), cnt (N,))."""
    mask = (ids > 0).reshape(-1)
    drop = torch.arange(mask.numel(), device=ids.device) % DROP_ROWS
    seg = torch.where(mask, ids.reshape(-1).long() - 1, n_verts + drop)
    nf = feats.shape[-1]
    rows = n_verts + DROP_ROWS
    fsum = feats.new_zeros((rows, nf)).index_add_(
        0, seg, feats.reshape(-1, nf))[:n_verts]
    cnt = feats.new_zeros(rows).index_add_(
        0, seg, mask.to(feats.dtype))[:n_verts]
    return fsum / torch.clamp_min(cnt, 1.0)[:, None], cnt


def _descriptors(model, params, verts, faces, face_mask, vert_mask, mvps,
                 znear, zfar, h: int = 512, w: int = 512, S: int = 8,
                 view_batch: int = 8):
    """Per-vertex 16-D descriptors averaged over all views, and each
    vertex's pixel count (reference loop core/sdf.py:126-150)."""
    reg = regularize_verts(verts, vert_mask)
    ids, depth8 = render_views(reg, faces, face_mask, mvps, znear, zfar, h,
                               w, S)
    feats = network(model, params, depth8, view_batch)
    return scatter(ids, feats, verts.shape[0])


class CnnCorrespondence:
    """Driver-facing wrapper (the reference's cnnInitialize +
    compute_correspondence pair, core/sdf.py:75-150), on ``device``
    (default the card)."""

    def __init__(self, weights_npz: str | None = None, image_size: int = 512,
                 n_views: int = 24, znear: float = 1.0, zfar: float = 3.5,
                 normalize_input: bool | None = None,
                 feature_norm: bool | None = None,
                 view_batch: int = 8,
                 samples: int = 4, device="cuda"):
        """``normalize_input``: None = the contract recorded in the weights
        npz; a file without the marker (a converted reference checkpoint)
        means False, the reference's raw 0..255 feed
        (core/sdf.py:135-136); random init means True. ``feature_norm``:
        match L2-normalized descriptors (cosine-head weights); None = the
        npz's ``__feature_norm__`` marker. ``samples`` is the
        rasterizer's S: hole-free while triangle bounding boxes fit in S×S
        pixels (JAX's default 4; ``benchmarks/bench_cnn.py`` measures the
        coverage at 8, 4 and 2)."""
        self.device = resolve_device(device)
        if normalize_input is None:
            if weights_npz is not None:
                stored = npz_normalize_input(weights_npz)
                normalize_input = False if stored is None else stored
            else:
                normalize_input = True
        if feature_norm is None:
            feature_norm = (npz_feature_norm(weights_npz)
                            if weights_npz is not None else False)
        self.normalize_input = normalize_input
        self.feature_norm = feature_norm
        self.model, self.params = init_dhbc(
            h=image_size, w=image_size, normalize_input=normalize_input,
            device=self.device)
        if weights_npz is not None:
            self.params = load_npz_params(self.params, weights_npz)
        self.image_size = image_size
        self.mvps = torch.from_numpy(view_mvps(n_views, znear, zfar)).to(
            self.device)
        self.znear, self.zfar = znear, zfar
        self.view_batch = view_batch
        self.samples = samples

    def compute_correspondence(self, verts, faces, face_mask, vert_mask):
        """(descriptors (N,16), masked slots 0; pixel counts (N,))."""
        feats, cnt = _descriptors(
            self.model, self.params, verts, faces, face_mask, vert_mask,
            self.mvps, self.znear, self.zfar, h=self.image_size,
            w=self.image_size, S=self.samples, view_batch=self.view_batch)
        if self.feature_norm:
            feats = feats / torch.clamp_min(
                torch.linalg.vector_norm(feats, dim=-1, keepdim=True), 1e-6)
        return torch.where(vert_mask[:, None], feats, 0.0), cnt

    def _mesh_descriptors(self, mesh, mask):
        nf = mesh["faces"].shape[0]
        fmask = torch.arange(nf, device=mask.device) < mesh["n_faces"]
        return self.compute_correspondence(mesh["verts"], mesh["faces"],
                                           fmask, mask)[0]

    def match(self, canon_mesh, live_mesh, vmask, lmask):
        """Feature-space matching canonical → live
        (core/fusion.py:280-285). Returns (corr (V,3), valid (V,))."""
        cf = self._mesh_descriptors(canon_mesh, vmask)
        lf = self._mesh_descriptors(live_mesh, lmask)
        # invalid live descriptors must never win the search
        lf = torch.where(lmask[:, None], lf, 1e10)
        return feature_correspondences(cf, vmask, lf, live_mesh["verts"],
                                       lmask)
