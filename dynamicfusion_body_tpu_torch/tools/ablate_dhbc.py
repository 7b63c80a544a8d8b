"""Score saved DHBC weights on the correspondence ablation without
retraining — the port of the repository's ``tools/ablate_dhbc.py``:
closest points vs CNN(random) vs CNN(weights), mean 3D match error under
synthetic bends of the body mesh (``train_dhbc.body_mesh``), the metric
``train_dhbc --ablate`` prints.

The net is fully convolutional, so ``--size`` may differ from the
training resolution (a larger render gives more pixels per vertex to the
per-vertex feature average; core/sdf.py:126-150 uses 512). Runs on the
card unless ``--device cpu`` (or the JAX script's ``--cpu``) is given.

    python -m dynamicfusion_body_tpu_torch.tools.ablate_dhbc \\
        --weights data/dhbc_synth.npz --bends 0.7 1.5 3.0 --size 64
"""

from __future__ import annotations

import argparse

from ..models.dhbc import init_dhbc, load_npz_params, npz_feature_norm
from ..pipeline.fusion import resolve_device
from .train_dhbc import ablation, body_mesh


def main(argv=None):
    """Prints each bend's errors; returns {bend: {arm: (err, n_valid)}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--bends", type=float, nargs="+", default=[0.7, 1.5, 3.0])
    ap.add_argument("--yaw", type=float, default=0.0,
                    help="rigid yaw (rad) composed on each bend: the "
                         "loop-closure / tracking-loss regime")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)

    verts, faces = body_mesh(dev=dev)
    print(f"# mesh: {len(verts)} verts; weights: {args.weights}", flush=True)
    _, params = init_dhbc(h=args.size, w=args.size, device=dev)
    params = load_npz_params(params, args.weights)
    fnorm = npz_feature_norm(args.weights)
    out = {}
    for ang in args.bends:
        res = ablation(verts, faces, params, args.size, angle=ang,
                       feature_norm=fnorm, yaw=args.yaw, dev=dev)
        out[ang] = res
        print(f"# ablation at bend={ang} rad, yaw={args.yaw} rad, "
              f"size={args.size} (mean 3D match error, n_valid):")
        for k, v in res.items():
            print(f"#   {k:12s} err={v[0]:.4f} n={v[1]}", flush=True)
    return out


if __name__ == "__main__":
    main()
