"""Generate the result/ablation mesh grid the reference ships, on the port
— the counterpart of ``tools/make_ablation.py``.

The reference commits result meshes with an ablation README
(meshes/README): the canonical ``original`` plus fusions under {high
regularization, no pruning} / {low regularization, pruning} × {closest
point, CNN} correspondences. Its input sequence is not distributed, so
this drives the same grid over the synthetic deformable-body sequence
(``tools/_scene.py:bumpy_sdf``, the bench body), through the port's
``Fusion`` with the JAX tool's settings: subsample rate 2, knn 3, MC step
1, tolerance 0.2 with pruning and 1e9 without, regularization 5.0 or
0.5, CNN images of 64². Each arm prints its wall time, its mesh's counts
and the launches of K1 (``mc_case_cross``, every extraction) and K2
(``warp_trilerp_bricks_cached``, every ``updateTSDF``).

The meshes and a README go to ``--out-dir`` (default the git-ignored
``data/ablation/``); ``meshes/`` holds the JAX package's grid and is not
written. ``--compare DIR`` then prints each mesh's distance to the mesh
of the same name in DIR (``--compare meshes`` for the committed grid).
The CNN arm reads ``--cnn-weights`` (``tools/train_dhbc.py``'s default
output); without them it is skipped with the JAX tool's message. The
caps and solve depth are ``Fusion``'s defaults, as in the JAX tool: on
the CPU a fused arm takes minutes even at 32³ (the 65,536-vertex caps
size the search and the Jacobians).

    python -m dynamicfusion_body_tpu_torch.tools.make_ablation \\
        [--res 128] [--frames 3] [--compare meshes]
    python -m dynamicfusion_body_tpu_torch.tools.make_ablation \\
        --device cpu --res 32 --frames 2
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..io.mesh_io import load_obj
from ..ops.mc_cuda import mc_case_cross
from ..ops.trilerp_cuda import warp_trilerp_bricks_cached
from ..pipeline.fusion import Fusion, resolve_device
from ._scene import bumpy_sdf
from ._timing import device_label

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "data" / "ablation"
DEFAULT_WEIGHTS = ROOT / "data" / "dhbc_synth.npz"

README = """\
Result meshes from the synthetic deformable-body sequence
(dynamicfusion_body_tpu_torch/tools/make_ablation.py; analogue of the
reference's meshes/README grid).

original.obj                      mesh extracted from the first frame
                                  (canonical)
high_reg_no_pruning_clpts.obj     fused with HIGH regularization weight;
                                  bad closest-point correspondences were
                                  NOT rejected (tolerance prune off)
low_reg_with_pruning_clpts.obj    fused with LOW regularization weight;
                                  bad closest-point correspondences were
                                  rejected (plane-cost tolerance prune)
low_reg_with_pruning_cnn.obj      fused with LOW regularization weight;
                                  correspondences from trained DHBC
                                  descriptors (tools/train_dhbc.py), bad
                                  matches rejected
"""

# (name, regularization weight, prune, method) in the JAX tool's order
ARMS = (
    ("original", 0.5, True, "clpts"),
    ("high_reg_no_pruning_clpts", 5.0, False, "clpts"),
    ("low_reg_with_pruning_clpts", 0.5, True, "clpts"),
    ("low_reg_with_pruning_cnn", 0.5, True, "cnn"),
)
KERNELS = (mc_case_cross, warp_trilerp_bricks_cached)


def sequence(res: int, frames: int):
    """The ``frames`` + 1 volumes of the JAX tool (numpy): the bumpy body
    of radius 0.27·res moving 1 and 0.7 voxels a frame in x and y, its
    bumps turning 0.1 rad a frame."""
    r = res
    return [bumpy_sdf(r, (r / 2 + i, r / 2 + 0.7 * i, r / 2), 0.27 * r,
                      r / 64, 3.0, 0.1 * i)
            for i in range(frames + 1)]


def run_variant(vols, name, out_dir, reg, prune, method, tdist,
                cnn_weights=None, verbose=False, device="cuda"):
    """One arm of the grid, written to ``out_dir/<name>.obj``: the
    canonical mesh of ``vols[0]`` for ``original``, else ``vols[1:]``
    fused frame by frame (correspondences, solve, update, graph update),
    with ``Fusion``'s caps and solve depth as the JAX tool leaves them.
    Returns the arm's wall time (s, the card synced), its mesh counts and
    K1/K2 launches."""
    dev = resolve_device(device)
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    fus = Fusion(
        vols[0], tdist, subsample_rate=2.0, knn=3,
        marching_cubes_step_size=1, verbose=verbose,
        use_cnn=(method == "cnn"), cnn_weights=cnn_weights,
        cnn_image_size=64, write_warpfield=False, device=dev,
    )
    if name != "original":
        for vol in vols[1:]:
            fus.setupCorrespondences(
                vol, method=method, prune_result=prune,
                tolerance=0.2 if prune else 1e9,
            )
            fus.solve(regularization_weight=reg, method=method)
            fus.updateTSDF()
            fus.update_graph()
    path = os.path.join(out_dir, f"{name}.obj")
    fus.write_canonical_mesh(out_dir, f"{name}.obj")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    verts, faces = load_obj(path)[:2]
    out = dict(path=path, wall_s=wall, n_verts=len(verts),
               n_faces=len(faces), k1=mc_case_cross.launches,
               k2=warp_trilerp_bricks_cached.launches)
    print(f"# {name}.obj ({wall:.1f}s): {out['n_verts']} verts, "
          f"{out['n_faces']} faces; launches K1 {out['k1']} K2 "
          f"{out['k2']}", flush=True)
    return out


def nearest(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096):
    """For each point of ``a`` (N, 3), the distance to its nearest point
    of ``b`` (M, 3), by direct differences in chunks of ``chunk`` rows."""
    return torch.cat([torch.cdist(a[i:i + chunk], b,
                                  compute_mode="donot_use_mm_for_euclid_dist"
                                  ).min(1).values
                      for i in range(0, len(a), chunk)])


def mesh_distance(got_path, ref_path, device="cuda") -> dict:
    """The mesh at ``got_path`` against the one at ``ref_path``: vertex
    and face counts, the symmetric mean and p95 nearest-vertex distances
    (voxels; both directions pooled), and, for equal vertex counts, the
    largest vertex-position difference in file order."""
    dev = resolve_device(device)
    gv, gf = load_obj(str(got_path))[:2]
    rv, rf = load_obj(str(ref_path))[:2]
    g = torch.as_tensor(np.asarray(gv, np.float64), device=dev)
    r = torch.as_tensor(np.asarray(rv, np.float64), device=dev)
    d = torch.cat([nearest(g, r), nearest(r, g)]).cpu().numpy()
    out = dict(n_verts=(len(gv), len(rv)), n_faces=(len(gf), len(rf)),
               mean=float(d.mean()), p95=float(np.percentile(d, 95)),
               max_pos=None)
    if len(gv) == len(rv):
        out["max_pos"] = float(np.abs(np.asarray(gv, np.float64)
                                      - np.asarray(rv, np.float64)).max())
        out["faces_equal"] = bool(len(gf) == len(rf) and np.array_equal(
            np.asarray(gf), np.asarray(rf)))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out-dir", default=str(DEFAULT_OUT),
                    help="where the meshes and README go (default "
                         "data/ablation/, git-ignored)")
    ap.add_argument("--cnn-weights", default=str(DEFAULT_WEIGHTS))
    ap.add_argument("--compare", default=None, metavar="DIR",
                    help="print each mesh's distance to DIR's mesh of the "
                         "same name (e.g. meshes)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "twins run")
    args = ap.parse_args(argv)
    out_dir = os.path.abspath(args.out_dir)
    if Path(out_dir) == ROOT / "meshes":
        ap.error("meshes/ holds the JAX package's grid: choose another "
                 "--out-dir")
    dev = resolve_device(args.device)

    vols = sequence(args.res, args.frames)
    tdist = float(vols[0].max())
    os.makedirs(out_dir, exist_ok=True)
    print(f"# make_ablation: {args.res}^3, {args.frames} frames, on "
          f"{device_label(dev)}", flush=True)
    cw = args.cnn_weights if os.path.exists(args.cnn_weights) else None
    arms = {}
    for name, reg, prune, method in ARMS:
        if method == "cnn" and cw is None:
            print("# no trained DHBC weights found - skipping the CNN "
                  "variant (run tools/train_dhbc.py first)", flush=True)
            continue
        arms[name] = run_variant(
            vols, name, out_dir, reg, prune, method, tdist,
            cnn_weights=cw if method == "cnn" else None,
            verbose=args.verbose, device=dev)

    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write(README)
    print("# wrote", out_dir, flush=True)
    if args.compare:
        for name, arm in arms.items():
            ref = os.path.join(args.compare, f"{name}.obj")
            if not os.path.exists(ref):
                continue
            arm["vs_ref"] = c = mesh_distance(arm["path"], ref, dev)
            print(f"# {name} vs {ref}: verts {c['n_verts'][0]} / "
                  f"{c['n_verts'][1]}, faces {c['n_faces'][0]} / "
                  f"{c['n_faces'][1]}; symmetric nearest-vertex distance "
                  f"mean {c['mean']:.6f} p95 {c['p95']:.6f} voxels"
                  + ("" if c["max_pos"] is None else
                     f"; max |Δ position| {c['max_pos']:.3e}, faces equal "
                     f"{c['faces_equal']}"), flush=True)
    return dict(out_dir=out_dir, arms=arms)


if __name__ == "__main__":
    main()
