"""Command-line harness of the port — counterpart of
``dynamicfusion_body_tpu/cli.py`` (the reference's flag-gated test.py):

  fusion-dm   ← TEST_FUSION_DM / TEST_FUSION_DM_GPU: fuse <data>/*.npy depth
                maps with proj*.txt extrinsics into a canonical TSDF; write
                the world-space mesh.
  sequence    ← TEST_FUSION: the non-rigid loop over a directory of
                *.dist volumes; writes the per-phase profile (profile.json)
                and the program's spans (spans.json: count, total, self
                and mean time per span path) beside the mesh.
  dummy       ← TEST_FUSION_DUMMY: synthetic ellipsoid smoke frame.
  backproject ← TEST_CUSTOM: dump depth-map backprojections as point files.
  selftest    ← TEST_UTIL: DQ/trilerp numeric checks, asserted.

``fusion-dm``, ``sequence``, ``dummy`` and ``selftest`` run on the card
unless ``--device cpu`` is given. ``sequence --cnn --method cnn`` finds
correspondences with the DHBC network (``--cnn-weights`` an npz from
``tools/train_dhbc.py`` or the JAX package, else random weights;
``--cnn-image-size`` its render size, 512 by default).

Run: python -m dynamicfusion_body_tpu_torch.cli <subcommand> [options]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

def _load_depth_dir(data_path, K):
    """Depth .npy + proj*.txt pairing as in test.py:143-156 (extrinsic =
    K⁻¹·P for each projection matrix file)."""
    Kinv = np.linalg.inv(K)
    depths, lws = [], []
    for fname in sorted(os.listdir(data_path)):
        path = os.path.join(data_path, fname)
        if fname.endswith(".npy"):
            depths.append(np.load(path))
        elif fname.startswith("proj") and fname.endswith(".txt"):
            P = np.loadtxt(path, dtype=np.float64)
            lws.append((Kinv @ P).astype(np.float32))
    return depths, lws


def cmd_fusion_dm(args):
    from .config import FusionDMConfig
    from .pipeline.fusion import FusionDM

    cfg = FusionDMConfig(
        tsdf_res=args.res, verbose=args.verbose,
        use_auto_alignment=args.auto_align, use_icp=args.icp,
    )
    K = cfg.camera.matrix()
    depths, lws = _load_depth_dir(args.data, K)
    print(f"loaded ({len(depths)}, {len(lws)}) of depths and matrices")
    fus = FusionDM(
        cfg.trunc_distance, K, tsdf_res=cfg.tsdf_res, verbose=cfg.verbose,
        vert_cap=cfg.capacities.vert_cap, face_cap=cfg.capacities.face_cap,
        device=args.device,
    )
    fus.compute_live_tsdf(
        depths, lws, UseAutoAlignment=cfg.use_auto_alignment,
        useICP=cfg.use_icp, outputMesh=False, as_numpy=False,
    )
    fus.write_canonical_mesh(args.out_dir, args.out)
    print("wrote", os.path.join(args.out_dir, args.out))


def cmd_sequence(args):
    from .io.sdf_io import load_sdf
    from .pipeline.fusion import Fusion
    from .utils.profiling import RECORDER, PhaseTimer, tracing

    files = sorted(
        f for f in os.listdir(args.data) if f.endswith(args.suffix)
    )
    if not files:
        print("no volumes found", file=sys.stderr)
        return 1
    _, _, vol0, _ = load_sdf(os.path.join(args.data, files[0]))
    fus = Fusion(
        vol0, float(vol0.max()), subsample_rate=args.subsample_rate,
        knn=args.knn, marching_cubes_step_size=args.mc_step,
        verbose=args.verbose, use_cnn=args.cnn,
        cnn_weights=args.cnn_weights, cnn_image_size=args.cnn_image_size,
        warpfield_path=args.out_dir, vert_cap=args.vert_cap,
        face_cap=args.face_cap, node_cap=args.node_cap, device=args.device,
    )
    fus.write_canonical_mesh(args.out_dir, "original.obj")
    timer = PhaseTimer()
    RECORDER.reset()
    # like the reference harness, a failed or interrupted frame stops the
    # loop but still writes the accumulated mesh (test.py:133-138); the
    # exit code then says that the sequence did not finish
    rc = 0
    with tracing():
        for i, fname in enumerate(files[1 : args.max_frames + 1], start=1):
            try:
                _, _, vol, _ = load_sdf(os.path.join(args.data, fname))
                print(f"Processing iteration: {i} ({fname})")
                with timer.phase("setupCorrespondences"):
                    fus.setupCorrespondences(vol, method=args.method)
                with timer.phase("solve", sync=fus._warp.node_dq):
                    fus.solve(regularization_weight=args.reg_weight,
                              method=args.method)
                with timer.phase("updateTSDF", sync=fus.volume.values):
                    fus.updateTSDF()
                with timer.phase("update_graph"):
                    fus.update_graph()
            except ValueError as e:
                print(str(e), file=sys.stderr)
                rc = 1
                break
            except KeyboardInterrupt:
                rc = 130
                break
    fus.write_canonical_mesh(args.out_dir, args.out)
    timer.dump(os.path.join(args.out_dir, "profile.json"))
    RECORDER.dump_spans(os.path.join(args.out_dir, "spans.json"))
    print(timer.report())
    return rc


def cmd_dummy(args):
    from .pipeline.fusion import Fusion

    a, b, c = 6, 10, 16
    shape = (2 * a + 3, 2 * b + 3, 2 * c + 3)
    g = [np.arange(s) - (s - 1) / 2.0 for s in shape]
    x, y, z = np.meshgrid(*g, indexing="ij")
    vol = ((x / a) ** 2 + (y / b) ** 2 + (z / c) ** 2 - 1).astype(np.float32)
    vol2 = (((x - 0.8) / a) ** 2 + ((y - 0.5) / b) ** 2 + (z / c) ** 2
            - 1).astype(np.float32)
    fus = Fusion(
        vol[:-1], float(vol.max()), marching_cubes_step_size=1,
        subsample_rate=2, verbose=args.verbose, vert_cap=4096, face_cap=8192,
        node_cap=128, warpfield_path=args.out_dir, device=args.device,
    )
    print("Solving for a test iteration")
    fus.setupCorrespondences(vol2[:-1], method="clpts", tolerance=2.0)
    fus.solve(method="clpts", tukey_data_weight=1, regularization_weight=10)
    print("Updating TSDF...")
    fus.updateTSDF()
    print("Updating deformation graph...")
    fus.update_graph()
    fus.write_canonical_mesh(args.out_dir, args.out)
    print("wrote", os.path.join(args.out_dir, args.out))


def cmd_backproject(args):
    from .config import CameraConfig

    K = CameraConfig().matrix()
    depths, lws = _load_depth_dir(args.data, K)
    Kinv = np.linalg.inv(K)
    for idx in range(min(2, len(depths))):
        dm, lw = depths[idx], lws[idx]
        R, t = lw[:, :3], lw[:, 3]
        h, w = dm.shape
        vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        d = -dm
        mask = d > 0
        pts_cam = (np.stack([uu, vv, np.ones_like(uu)], -1) * d[..., None]) @ Kinv.T
        pts = (pts_cam - t) @ R  # R⁻¹ = Rᵀ
        out = os.path.join(args.out_dir, f"transformed_pts{idx}.txt")
        np.savetxt(out, pts[mask].reshape(-1, 3), fmt="%f")
        print("wrote", out)


def cmd_selftest(args):
    import torch

    from .ops.interp import trilinear
    from .ops.se3 import dq_to_se3, se3_to_dq
    from .pipeline.fusion import resolve_device

    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    M = np.eye(4)
    M[:3, :3] = q
    M[:3, 3] = [0.1, 0.4, 0.2]
    dq = se3_to_dq(torch.tensor(M, dtype=torch.float32, device=dev))
    M2 = dq_to_se3(dq).cpu().numpy()
    if not np.allclose(M2, M, atol=1e-4):
        raise AssertionError("SE3<->DQ roundtrip failed")

    vol = torch.tensor(rng.randn(8, 8, 8).astype(np.float32), device=dev)
    v, ok = trilinear(vol, torch.tensor([[3.0, 3.0, 3.0]], device=dev))
    if not (bool(ok[0]) and abs(float(v[0]) - float(vol[3, 3, 3])) < 1e-5):
        raise AssertionError("trilinear at a lattice point is not exact")
    _, bad = trilinear(vol, torch.tensor([[-0.5, 1.0, 1.0], [8.0, 1.0, 1.0]],
                                         device=dev))
    if bool(torch.any(bad)):
        raise AssertionError("out-of-bounds not masked")
    print("selftest ok")


def main(argv=None):
    from .config import CapacityConfig

    p = argparse.ArgumentParser(prog="dynamicfusion_body_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    dm = sub.add_parser("fusion-dm", help="multi-view depth fusion")
    dm.add_argument("--data", required=True)
    dm.add_argument("--res", type=int, default=256)
    dm.add_argument("--out", default="test.obj")
    dm.add_argument("--out-dir", default=".")
    dm.add_argument("--auto-align", action="store_true")
    dm.add_argument("--icp", action="store_true")
    dm.add_argument("--verbose", action="store_true")
    dm.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dm.set_defaults(fn=cmd_fusion_dm)

    sq = sub.add_parser(
        "sequence", help="non-rigid .dist sequence loop; writes profile.json "
        "(per phase) and spans.json (per program span) to --out-dir")
    sq.add_argument("--data", required=True)
    sq.add_argument("--suffix", default="64.dist")
    sq.add_argument("--max-frames", type=int, default=10)
    sq.add_argument("--subsample-rate", type=float, default=1.5)
    sq.add_argument("--knn", type=int, default=3)
    sq.add_argument("--mc-step", type=int, default=2)
    sq.add_argument("--method", default="clpts", choices=["clpts", "cnn"])
    sq.add_argument("--cnn", action="store_true")
    sq.add_argument("--cnn-weights", default=None,
                    help="DHBC weights npz (default: random weights)")
    sq.add_argument("--cnn-image-size", type=int, default=512)
    sq.add_argument("--reg-weight", type=float, default=0.5)
    # mesh and node-pool capacities (config.CapacityConfig's defaults); the
    # solver's tables and the correspondence search scale with them
    caps = CapacityConfig()
    sq.add_argument("--vert-cap", type=int, default=caps.vert_cap)
    sq.add_argument("--face-cap", type=int, default=caps.face_cap)
    sq.add_argument("--node-cap", type=int, default=caps.node_cap)
    sq.add_argument("--out", default="mesh.obj")
    sq.add_argument("--out-dir", default=".")
    sq.add_argument("--verbose", action="store_true")
    sq.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sq.set_defaults(fn=cmd_sequence)

    du = sub.add_parser("dummy", help="ellipsoid smoke frame")
    du.add_argument("--out", default="mesh.obj")
    du.add_argument("--out-dir", default=".")
    du.add_argument("--verbose", action="store_true")
    du.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    du.set_defaults(fn=cmd_dummy)

    bp = sub.add_parser("backproject", help="depth backprojection dump")
    bp.add_argument("--data", required=True)
    bp.add_argument("--out-dir", default=".")
    bp.set_defaults(fn=cmd_backproject)

    st = sub.add_parser("selftest", help="numeric self-checks (asserted)")
    st.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    st.set_defaults(fn=cmd_selftest)

    args = p.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
