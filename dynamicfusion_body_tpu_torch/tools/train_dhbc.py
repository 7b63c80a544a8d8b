"""Train DHBC on synthetic ID-labelled depth renders, and the
correspondence ablation — the port of the repository's
``tools/train_dhbc.py``.

The reference's CNN mode restores an external TF checkpoint
(core/sdf.py:85-93) that the repository does not hold. This script makes
weights instead, by the DHBC recipe the reference's ``classify``/``_loss``
gestured at (core/net.py:58-87):

1. a body mesh: the reference's result mesh ``meshes/original.obj`` when
   the checkout has it, else a synthetic asymmetric blob (it prints which);
2. ``n_classes`` surface regions (furthest-point centres, nearest-centre
   labels);
3. (depth8, per-pixel region label) pairs rendered from yaw views by the
   port's rasterizer, optionally from randomly deformed copies too;
4. ``models.dhbc.make_train_step`` steps, keeping a copy of the
   best-loss parameters (the post-step parameters beside the pre-step
   loss, as the JAX script keeps them);
5. the weights saved to ``--out`` in the JAX package's npz format
   (loadable by ``Fusion(cnn_weights=...)`` in either package), the
   classifier head beside them as ``*_head.npy``;
6. with ``--ablate``, the mean 3D match error under large synthetic bends
   for closest points, a yaw-invariant geometric descriptor, and the CNN
   with random and with trained weights.

Runs on the card unless ``--device cpu`` is given.

    python -m dynamicfusion_body_tpu_torch.tools.train_dhbc
    python -m dynamicfusion_body_tpu_torch.tools.train_dhbc \\
        --steps 3 --size 32 --device cpu --out /tmp/w.npz
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..io.mesh_io import load_obj
from ..models.dhbc import (cosine_decay_schedule, init_dhbc,
                           load_npz_params, make_train_step,
                           save_npz_params)
from ..ops.marching_cubes import marching_cubes
from ..ops.sampling import furthest_point_sample
from ..pipeline.cnn_correspondence import (CnnCorrespondence,
                                           regularize_verts, view_mvps)
from ..pipeline.correspondence import (closest_point_correspondences,
                                       feature_correspondences)
from ..pipeline.fusion import resolve_device
from ..render.raster import render_id

ROOT = Path(__file__).resolve().parents[2]
REF_MESH = ROOT / "meshes" / "original.obj"
DEFAULT_OUT = ROOT / "data" / "dhbc_synth.npz"


def body_mesh(res=128, dev="cpu"):
    """Body-like mesh: the reference's ``original.obj`` if the checkout
    has it, else an asymmetric blob (MC of a bumpy sphere at ``res``³).
    Returns numpy (verts, faces) and prints which one it took."""
    if REF_MESH.exists():
        v, f = load_obj(str(REF_MESH))
        print(f"# body mesh: {REF_MESH.relative_to(ROOT)}", flush=True)
        return np.asarray(v, np.float32), np.asarray(f, np.int32)
    g = np.arange(res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (res - 1) / 2
    dx, dy, dz = x - c, y - c, z - c
    r = np.sqrt(dx * dx + dy * dy + dz * dz) + 1e-6
    th = np.arccos(np.clip(dz / r, -1, 1))
    ph = np.arctan2(dy, dx)
    bump = 4.0 * np.sin(3 * th + 0.5) * np.cos(2 * ph) + 2.5 * np.sin(
        5 * ph + 1.3)
    sdf = torch.from_numpy((r - (0.27 * res + bump)).astype(np.float32))
    m = marching_cubes(sdf.to(dev), vert_cap=1 << 15, face_cap=1 << 16,
                       use_kernels=torch.device(dev).type == "cuda")
    nv, nf = int(m["n_verts"]), int(m["n_faces"])
    print(f"# body mesh: the synthetic blob at {res}^3", flush=True)
    return (m["verts"][:nv].cpu().numpy().astype(np.float32),
            m["faces"][:nf].cpu().numpy().astype(np.int32))


def region_labels(verts, n_classes, seed=0, dev="cpu"):
    """FPS centres + nearest-centre region id (1-based; 0 = background)."""
    idx, _ = furthest_point_sample(torch.from_numpy(verts).to(dev),
                                   n_classes, start_idx=seed)
    centers = verts[idx.cpu().numpy()]
    d = np.linalg.norm(verts[:, None, :] - centers[None], axis=-1)
    return (np.argmin(d, axis=1) + 1).astype(np.int32)


def make_dataset(verts, faces, vlabels, mvps, size, znear=1.0, zfar=3.5,
                 vcoords=None, dev="cpu"):
    """Per view: (depth8 (H,W) f32, labels (H,W) int64[, coords (H,W,3)]),
    on ``dev``. ``vcoords``: per-vertex rest-pose normalized coordinates,
    which transfer unchanged to deformed copies of the mesh."""
    t = torch.from_numpy
    v = t(verts).to(dev)
    reg = regularize_verts(v, torch.ones(len(verts), dtype=torch.bool,
                                         device=dev))
    f = t(faces).to(dev).long()
    fmask = torch.ones(len(faces), dtype=torch.bool, device=dev)
    b = zfar * znear / (znear - zfar)
    a = -b / znear
    vl = t(np.concatenate([[0], vlabels]).astype(np.int64)).to(dev)
    vc = (None if vcoords is None else t(np.concatenate(
        [np.zeros((1, 3), np.float32), vcoords])).to(dev))
    out = []
    for m in mvps:
        ids, zwin = render_id(reg, f, fmask, t(m).to(dev), size, size, S=8)
        depth8 = torch.floor(torch.clamp(
            (zfar - b / (zwin - a)) / (zfar - znear) * 255.0, 0, 255))
        item = (depth8, vl[ids.long()])
        if vc is not None:
            item += (vc[ids.long()],)
        out.append(item)
    return out


def bend_mesh(verts, angle=0.7):
    """Large smooth deformation: bend the top half about x through the
    centroid, blended by height."""
    c = verts.mean(0)
    y = verts[:, 1] - c[1]
    h = (y.max() - y.min()) + 1e-6
    t = 1.0 / (1.0 + np.exp(-8.0 * (y / h)))  # 0 bottom → 1 top
    out = np.empty_like(verts)
    ca, sa = np.cos(angle * t), np.sin(angle * t)
    p = verts - c
    out[:, 0] = p[:, 0]
    out[:, 1] = ca * p[:, 1] - sa * p[:, 2]
    out[:, 2] = sa * p[:, 1] + ca * p[:, 2]
    return (out + c).astype(np.float32)


def random_deform(verts, rng):
    """Random large smooth deformation for training augmentation: one or
    two height-blended bends about random horizontal axes plus a small
    twist about the vertical (labels transfer unchanged)."""
    c = verts.mean(0)
    p = verts - c
    y = p[:, 1]
    h = (y.max() - y.min()) + 1e-6

    for _ in range(rng.integers(1, 3)):
        angle = rng.uniform(0.5, 3.2) * rng.choice([-1.0, 1.0])
        sharp = rng.uniform(5.0, 10.0)
        sign = rng.choice([-1.0, 1.0])
        t = 1.0 / (1.0 + np.exp(-sharp * sign * (y / h)))
        phi = rng.uniform(0.0, 2 * np.pi)
        cp, sp = np.cos(phi), np.sin(phi)
        xz = np.stack([cp * p[:, 0] + sp * p[:, 2],
                       -sp * p[:, 0] + cp * p[:, 2]], 1)
        ca, sa = np.cos(angle * t), np.sin(angle * t)
        py, pz = p[:, 1].copy(), xz[:, 1].copy()
        ny = ca * py - sa * pz
        nz = sa * py + ca * pz
        p = np.stack([cp * xz[:, 0] - sp * nz, ny,
                      sp * xz[:, 0] + cp * nz], 1)

    tw = rng.uniform(-0.6, 0.6) * (p[:, 1] / h)
    ct, st = np.cos(tw), np.sin(tw)
    p = np.stack([ct * p[:, 0] - st * p[:, 2], p[:, 1],
                  st * p[:, 0] + ct * p[:, 2]], 1)
    return (p + c).astype(np.float32)


def yaw_mesh(verts, yaw):
    """Rigid yaw about the vertical axis through the centroid: stacked on
    a bend, the loop-closure / tracking-loss regime."""
    c = verts.mean(0)
    p = verts - c
    cy, sy = np.cos(yaw), np.sin(yaw)
    out = np.stack([cy * p[:, 0] + sy * p[:, 2], p[:, 1],
                    -sy * p[:, 0] + cy * p[:, 2]], 1)
    return (out + c).astype(np.float32)


def match_error(corr, valid, gt_live, vmask):
    """Mean 3D distance between matched live points and the true deformed
    position of each canonical vertex, and the count of valid matches."""
    m = valid.cpu().numpy() & np.asarray(vmask)
    d = np.linalg.norm(corr.cpu().numpy() - gt_live, axis=1)
    return float(d[m].mean()), int(m.sum())


def ablation(verts, faces, params_trained, size, n_views=24, angle=0.7,
             feature_norm=False, yaw=0.0, dev="cpu"):
    """clpts vs a yaw-invariant geometric descriptor vs CNN(random) vs
    CNN(trained) under a large bend, optionally composed with a rigid
    yaw."""
    t = torch.from_numpy
    live_v = bend_mesh(verts, angle=angle)
    if yaw:
        live_v = yaw_mesh(live_v, yaw)
    V = len(verts)
    allv = np.ones(V, bool)
    vmask = torch.ones(V, dtype=torch.bool, device=dev)
    cv, lv = t(verts).to(dev), t(live_v).to(dev)
    f = t(faces).to(dev).long()
    canon = {"verts": cv, "faces": f, "n_faces": torch.tensor(len(faces))}
    live = {"verts": lv, "faces": f, "n_faces": torch.tensor(len(faces))}

    # normals for clpts point-to-plane: area-weighted vertex normals
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(verts)
    np.add.at(vn, faces.reshape(-1), np.repeat(fn, 3, axis=0))
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-9)

    out = {}
    corr, valid, _ = closest_point_correspondences(
        cv, t(vn).to(dev), vmask, lv, vmask, 4, tolerance=1e9)
    out["clpts"] = match_error(corr, valid, live_v, allv)

    # attribution arm: matching on (height, cylindrical radius) of the
    # normalized vertices, which is what averaging descriptors over the
    # full view circle alone buys
    def yawinv_desc(v):
        reg = regularize_verts(v, vmask)
        r_cyl = torch.sqrt(reg[:, 0] ** 2 + reg[:, 2] ** 2)
        return torch.stack([reg[:, 1], r_cyl], dim=-1)

    corr, valid = feature_correspondences(yawinv_desc(cv), vmask,
                                          yawinv_desc(lv), lv, vmask)
    out["clpts_yawinv"] = match_error(corr, valid, live_v, allv)

    for tag, p in (("cnn_random", None), ("cnn_trained", params_trained)):
        cc = CnnCorrespondence(image_size=size, n_views=n_views, device=dev)
        if p is not None:
            cc.params = p
            cc.feature_norm = feature_norm
        corr, valid = cc.match(canon, live, vmask, vmask)
        out[tag] = match_error(corr, valid, live_v, allv)
    return out


def arg_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # defaults = the JAX script's measured-stable recipe: 64px, 6 views,
    # constant 1e-3
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--n-classes", type=int, default=16)
    ap.add_argument("--n-views", type=int, default=6)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--bends", type=float, nargs="+", default=[0.7],
                    help="bend angles (rad) for the --ablate sweep")
    ap.add_argument("--decay", action="store_true",
                    help="cosine decay of the rate over --steps")
    ap.add_argument("--cosine", action="store_true",
                    help="cosine classifier head (needed for large "
                         "n_classes)")
    ap.add_argument("--tau", type=float, default=16.0)
    ap.add_argument("--init-from", default=None,
                    help="npz weights to warm-start the feature net from")
    ap.add_argument("--aug-poses", type=int, default=0,
                    help="extra randomly-deformed copies of the mesh to "
                         "render for training (labels transfer unchanged)")
    ap.add_argument("--batch", type=int, default=0,
                    help="minibatch size (views per step); 0 = full batch")
    ap.add_argument("--clip", type=float, default=0.0,
                    help="global-norm gradient clip (0 = off)")
    ap.add_argument("--coord-weight", type=float, default=0.0,
                    help="weight of the canonical-coordinate regression "
                         "auxiliary; 0 = classification only")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    """Trains and saves; returns a report (losses, accuracies, the step
    time, the weights' path)."""
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    verts, faces = body_mesh(dev=dev)
    print(f"# mesh: {len(verts)} verts, {len(faces)} faces", flush=True)
    labels = region_labels(verts, args.n_classes, dev=dev)
    vc = None
    if args.coord_weight > 0:
        c = verts.mean(0)
        h = (verts[:, 1].max() - verts[:, 1].min()) + 1e-6
        vc = ((verts - c) / h).astype(np.float32)
    mvps = view_mvps(args.n_views)
    data = make_dataset(verts, faces, labels, mvps, args.size, vcoords=vc,
                        dev=dev)
    rng = np.random.default_rng(7)
    for _ in range(args.aug_poses):
        dv = random_deform(verts, rng)
        data += make_dataset(dv, faces, labels, mvps, args.size,
                             vcoords=vc, dev=dev)
    print(f"# dataset: {len(data)} views at {args.size}^2 "
          f"({args.aug_poses} augmented poses)", flush=True)

    model, params = init_dhbc(h=args.size, w=args.size, device=dev)
    if args.init_from:
        params = load_npz_params(params, args.init_from)
        print(f"# warm-start from {args.init_from}", flush=True)
    lr = (cosine_decay_schedule(args.lr, args.steps) if args.decay
          else args.lr)
    step, init_opt = make_train_step(model, lr, args.n_classes,
                                     cosine=args.cosine, tau=args.tau,
                                     coord_weight=args.coord_weight,
                                     clip_norm=args.clip or None)
    gen = torch.Generator().manual_seed(1)
    head = (torch.randn(16, args.n_classes, generator=gen) * 0.1).to(dev)
    if args.coord_weight > 0:
        head = (head, (torch.randn(16, 3, generator=gen) * 0.1).to(dev),
                torch.zeros(3, device=dev))
    opt_state = init_opt(params, head)

    depth_b = torch.stack([d[0] for d in data])[:, None]
    lab_b = torch.stack([d[1] for d in data])
    coord_b = (torch.stack([d[2] for d in data])
               if args.coord_weight > 0 else None)
    nview = depth_b.shape[0]
    bsz = args.batch if 0 < args.batch < nview else nview
    brng = np.random.default_rng(11)

    def pix_acc(p, hd):
        with torch.no_grad():
            feats = torch.func.functional_call(model, p, (depth_b[:1],))
        cls = hd[0] if isinstance(hd, tuple) else hd
        pred = torch.argmax(feats[0].permute(1, 2, 0) @ cls, dim=-1) + 1
        lab = lab_b[0]
        fg = lab > 0
        return float((pred[fg] == lab[fg]).float().mean())

    def copy(p, hd):
        cl = (tuple(x.detach().clone() for x in hd)
              if isinstance(hd, tuple) else hd.detach().clone())
        return {k: v.detach().clone() for k, v in p.items()}, cl

    # keep (a copy of) the best-loss parameters: constant-rate Adam on this
    # net can diverge without warning after converging
    best = (np.inf, *copy(params, head))
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        if bsz < nview:
            sel = torch.from_numpy(
                brng.choice(nview, size=bsz, replace=False)).to(dev)
            db, lb = depth_b[sel], lab_b[sel]
            cb = coord_b[sel] if coord_b is not None else None
        else:
            db, lb, cb = depth_b, lab_b, coord_b
        params, head, opt_state, loss = step(params, head, opt_state, db,
                                             lb, cb)
        lv = float(loss)
        losses.append(lv)
        if lv < best[0]:
            best = (lv, *copy(params, head))
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {lv:.4f} "
                  f"acc0 {pix_acc(params, head):.3f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    train_s = time.perf_counter() - t0
    print(f"# best loss {best[0]:.4f}", flush=True)
    params, head = best[1], best[2]
    acc = pix_acc(params, head)
    print(f"# best acc0 {acc:.3f}", flush=True)

    out = args.out
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_npz_params(params, out, feature_norm=args.cosine)
    cls_head = head[0] if isinstance(head, tuple) else head
    np.save(out.replace(".npz", "_head.npy"), cls_head.cpu().numpy())
    print(f"# saved {out}", flush=True)

    ablations = {}
    if args.ablate:
        for ang in args.bends:
            res = ablation(verts, faces, params, args.size, angle=ang,
                           feature_norm=args.cosine, dev=dev)
            ablations[ang] = res
            print(f"# correspondence ablation at bend={ang} rad "
                  "(mean 3D match error, n_valid):")
            for k, v in res.items():
                print(f"#   {k:12s} err={v[0]:.4f} n={v[1]}", flush=True)
    return dict(losses=losses, best_loss=best[0], best_acc0=acc,
                step_ms=train_s / max(args.steps, 1) * 1e3, out=out,
                n_views=nview, ablations=ablations)


if __name__ == "__main__":
    main()
