"""benchmarks/suite.py config 6 through both packages on the CPU: the
reference's result mesh ``meshes/original.obj`` rendered from 8 yaw views
at 512², fused rigidly, extracted, and scored against the mesh surface
(suite.py:261-316).

The test runs it at 64³; run as a script it prints both packages' scores
at any grid (the JAX package's value at 256³ is the reference the port's
on-card score is read against, PERF.md):

    JAX_PLATFORMS=cpu python tests/test_torch_config6.py --res 256

The port renders with its own rasterizer (held to JAX's in
test_torch_render.py); to compare the fusion alone, both packages fuse
JAX's renders here, and the port takes JAX's alignment (see
test_torch_fusion_dm.py for why).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # run as a script from anywhere

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from scipy.spatial import cKDTree  # noqa: E402

from dynamicfusion_body_tpu.io.mesh_io import load_obj  # noqa: E402
from dynamicfusion_body_tpu.ops.interp import trilinear as j_trilinear  # noqa: E402
from dynamicfusion_body_tpu.ops.projection import (  # noqa: E402
    estimate_alignment as j_est)
from dynamicfusion_body_tpu.ops.transforms import (  # noqa: E402
    rotation_matrix as j_rot)
from dynamicfusion_body_tpu.pipeline.fusion import (  # noqa: E402
    FusionDM as JFusionDM)
from dynamicfusion_body_tpu.render.raster import (  # noqa: E402
    render_depth as j_render)
from dynamicfusion_body_tpu_torch.io.mesh_io import regularize_mesh  # noqa: E402
from dynamicfusion_body_tpu_torch.ops.interp import trilinear  # noqa: E402
from dynamicfusion_body_tpu_torch.pipeline import fusion as TF  # noqa: E402
from dynamicfusion_body_tpu_torch.benchmarks.suite import (  # noqa: E402
    _sample_surface as sample_surface)  # suite.py's sampler
from test_torch_tsdf_volume import edge_mask  # noqa: E402

# One intra-op thread (see tests/test_torch_marching_cubes.py)
torch.set_num_threads(1)

K = np.array([[400.0, 0, 256], [0, 400, 256], [0, 0, 1]], np.float32)


def config6_inputs():
    """The mesh (regularized to 1.8 units) and JAX's 8 renders of it
    (suite.py:53-72: yaw views, distance 2.5, 512², S=8)."""
    verts, faces = load_obj(os.path.join(ROOT, "meshes", "original.obj"))
    verts = regularize_mesh(verts)
    depths, lws = [], []
    fmask = jnp.ones(len(faces), bool)
    for i in range(8):
        R = j_rot(2 * np.pi * i / 8, [0, 1, 0])[:3, :3]
        t = np.array([0, 0, 2.5]) - R @ np.zeros(3)
        lw = np.concatenate([R, t[:, None]], 1).astype(np.float32)
        depths.append(np.asarray(j_render(
            jnp.asarray(verts), jnp.asarray(faces), fmask, jnp.asarray(K),
            jnp.asarray(lw), 512, 512, S=8)))
        lws.append(lw)
    return verts, faces, depths, lws


def score(tree, gv, ind, obs):
    """Mean and p95 distance (voxels) of the observed vertices to the
    sampled surface (suite.py:287-315)."""
    wv = gv @ ind[:3, :3].T + ind[:3, 3]
    d, _ = tree.query(wv[obs] if obs.any() else wv, k=1)
    voxel = float(ind[0, 0])
    return float(np.mean(d) / voxel), float(np.percentile(d, 95) / voxel)


def run_both(res, verts, faces, depths, lws):
    caps = dict(vert_cap=1 << 15, face_cap=1 << 16) if res <= 64 else \
        dict(vert_cap=1 << 17, face_cap=1 << 18)
    tdist = 8.0 / res * 1.3
    tree = cKDTree(sample_surface(verts, faces, 300_000))

    jfus = JFusionDM(tdist, K, tsdf_res=res, **caps)
    jv, jw = jfus.compute_live_tsdf(depths, lws, UseAutoAlignment=True)
    jfus.marching_cubes()
    jn = int(jfus._mesh["n_verts"])
    jgv = np.asarray(jfus._mesh["verts"])[:jn]
    jobs = np.asarray(j_trilinear(jfus.volume.weights, jnp.asarray(jgv))[0]) >= 3.0

    def est(d, kinv, l):
        a, s = j_est(jnp.asarray(d.numpy()), jnp.asarray(kinv.numpy()),
                     jnp.asarray(l.numpy()))
        return torch.from_numpy(np.array(a)), torch.from_numpy(np.array(s))

    port_est, TF.estimate_alignment = TF.estimate_alignment, est
    try:
        tfus = TF.FusionDM(tdist, K, tsdf_res=res, device="cpu", **caps)
        tv, tw = tfus.compute_live_tsdf(depths, lws, UseAutoAlignment=True)
    finally:
        TF.estimate_alignment = port_est
    tfus.marching_cubes()
    tn = int(tfus._mesh["n_verts"])
    tgv = tfus._mesh["verts"][:tn]
    tobs = (trilinear(tfus.volume.weights, tgv)[0] >= 3.0).numpy()
    return dict(
        jax=dict(zip(("mean_vox", "p95_vox"), score(tree, jgv, jfus._IND,
                                                   jobs)),
                 n_verts=jn, observed_frac=float(jobs.mean())),
        port=dict(zip(("mean_vox", "p95_vox"), score(tree, tgv.numpy(),
                                                    tfus._IND, tobs)),
                  n_verts=tn, observed_frac=float(tobs.mean())),
        volumes=((jv, jw), (tv, tw)), ind=(jfus._IND, tfus._IND),
        projs=[tfus._proj(lw) for lw in lws],
        verts=(jgv, tgv.numpy()),
        faces=(np.asarray(jfus._mesh["faces"]), tfus._mesh["faces"].numpy()),
    )


def test_config6_matches_jax_at_64():
    """Same volume, same mesh and the same score within 1e-4 voxel; both
    under the accuracy gate (mean < 1 voxel, p95 < 2 voxels).

    Weights are exact and values atol 2e-5, except where a voxel's bilinear
    taps straddle a depth edge (the silhouettes, ~2.6 m jumps): XLA
    contracts the projection into FMAs, so px differs by an ulp (3e-5 px
    near 512) and the sample by up to ulp·jump; there atol 2e-4 (measured
    8.8e-5 on 190 of 262,144 voxels). Faces are equal; a vertex on an edge
    between two such values moves by up to that difference over the
    edge's value step: vertices atol 5e-3 voxel (measured 3.0e-3), and at
    least 95% of them within 1e-5 (measured 97.3%)."""
    verts, faces, depths, lws = config6_inputs()
    out = run_both(64, verts, faces, depths, lws)
    np.testing.assert_array_equal(*out["ind"])
    (jv, jw), (tv, tw) = out["volumes"]
    np.testing.assert_array_equal(tw, jw)
    edge = edge_mask(tv.shape, depths, out["projs"])
    np.testing.assert_allclose(tv[~edge], jv[~edge], rtol=0, atol=2e-5)
    np.testing.assert_allclose(tv[edge], jv[edge], rtol=0, atol=2e-4)
    jgv, tgv = out["verts"]
    assert jgv.shape == tgv.shape
    np.testing.assert_array_equal(*out["faces"])
    np.testing.assert_allclose(tgv, jgv, rtol=0, atol=5e-3)
    assert np.mean(np.abs(tgv - jgv).max(1) <= 1e-5) >= 0.95
    for key in ("mean_vox", "p95_vox"):
        assert abs(out["port"][key] - out["jax"][key]) < 1e-4, out
    assert out["port"]["mean_vox"] < 1.0 and out["port"]["p95_vox"] < 2.0


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--res", type=int, default=256)
    args = p.parse_args()
    verts, faces, depths, lws = config6_inputs()
    out = run_both(args.res, verts, faces, depths, lws)
    print(json.dumps({"res": args.res, "jax": out["jax"],
                      "port": out["port"]}))
