"""The port's fusion_frame in its other correspondence modes against the
JAX package's: the cached candidates with the certificate-steered
refresh (``reuse_corr=True``, the default) on the large-motion scene of
tests/test_frame.py:158, then the grid-hash search and the 2-level pools
on the scene of tests/test_torch_frame.py, with that file's frame-0
tolerances.

Run as a script it puts the bench scene at ``--res`` through both
packages from the ``init_canonical`` state, one frame in each mode with
the bench's settings, and the 2-level search on the frame-entry warped
vertices, printing each package's costs, correspondences and risk:

    JAX_PLATFORMS=cpu python tests/test_torch_frame_modes.py --res 128
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]  # run as a script

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dynamicfusion_body_tpu.models.warp_field import WarpField  # noqa: E402
from dynamicfusion_body_tpu.ops.knn import (  # noqa: E402
    knn_2level as j_knn_2level)
from dynamicfusion_body_tpu.pipeline import frame as JF  # noqa: E402
from dynamicfusion_body_tpu_torch import convert  # noqa: E402
from dynamicfusion_body_tpu_torch.models.warp_field import (  # noqa: E402
    warp_points)
from dynamicfusion_body_tpu_torch.ops.knn import knn, knn_2level  # noqa: E402
from dynamicfusion_body_tpu_torch.pipeline import frame as TF  # noqa: E402
from dynamicfusion_body_tpu_torch.tools._scene import (  # noqa: E402
    bench_scene, bumpy, cap, meshes)
from fixtures import bumpy_levelset, sphere_levelset  # noqa: E402

# One intra-op thread (see tests/test_torch_frame.py)
torch.set_num_threads(1)

WF_FIELDS = ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
             "radius")
# tests/test_torch_frame.py's frame-0 bounds: cost rtol, pose atol, voxels
# whose update decision may flip, value atol on the others
COST_RTOL, POSE_ATOL, MAX_FLIPS, VAL_ATOL = 1e-3, 1e-4, 33, 5e-3
STATS = ("n_corr", "n_nodes", "n_verts", "overflow", "pool_risk",
         "corr_risk", "corr_refresh", "ell_overflow")


def to_port(values, weights, live, wf, lw):
    twf = convert.warp_field_from_jax(
        {f: np.asarray(getattr(wf, f)) for f in WF_FIELDS}, device="cpu")
    return (*(torch.from_numpy(np.array(a)) for a in (values, weights,
                                                       live)),
            twf, torch.from_numpy(np.array(lw)))


def test_certificate_steered_refresh_matches_jax():
    """tests/test_frame.py:158 on both packages: the large motion trips the
    certificate on every round, so each round refreshes (corr_refresh >= 2,
    equal to JAX's) and no uncertified match is used (corr_risk == 0); the
    final cost within COST_RTOL of JAX's (measured 1.9e-4)."""
    res = 64
    canonical = bumpy_levelset(res, (32, 32, 32), 18.0, 2.0, 3.0, 0.0)
    live = bumpy_levelset(res, (33, 32, 32), 18.0, 2.0, 3.0, 0.3)
    caps = dict(vert_cap=1 << 12, face_cap=1 << 13)
    wf, _ = JF.init_canonical(jnp.asarray(canonical), subsample_rate=1.5,
                              node_cap=512, mc_step=2, **caps)
    lw = jnp.array([1, 0, 0, 0, 0, 0.1, 0, 0], jnp.float32)
    h = dict(regularization_weight=0.5, knn_k=3, tdist=float(canonical.max()),
             mc_step=2, solve_iters=3, gn_iters=4, cg_iters=8, tolerance=5.0,
             n_candidates=16, **caps)
    args = (canonical, np.zeros((res,) * 3, np.float32), live, wf, lw)
    jst = JF.fusion_frame(*map(jnp.asarray, args[:3]), wf, lw, **h)[4]
    st = TF.fusion_frame(*to_port(*args), **h)[4]   # reuse_corr=True
    assert int(st.corr_refresh) >= 2
    assert int(st.corr_risk) == 0
    assert int(st.corr_refresh) == int(jst.corr_refresh)
    assert int(st.n_corr) == int(jst.n_corr)
    np.testing.assert_allclose(float(st.cost_after[-1]),
                               float(np.asarray(jst.cost_after)[-1]),
                               rtol=COST_RTOL)


@pytest.mark.parametrize("mode", [dict(use_grid_corr=True),
                                  dict(approx_knn="2level")],
                         ids=["grid", "2level"])
def test_frame_mode_matches_jax(mode):
    """One frame from the init state of tests/test_torch_frame.py's scene
    (32³: the grid's 2x2x2 cells of 16³ hold ~190 live vertices each,
    below the cap of 256, so it matches)."""
    res = 32
    canonical = sphere_levelset(res, (16, 16, 16), 9.0)
    live = sphere_levelset(res, (17.2, 16.4, 16.0), 9.0)
    caps = dict(vert_cap=2048, face_cap=4096)
    wf, _ = JF.init_canonical(jnp.asarray(canonical), subsample_rate=2.0,
                              node_cap=64, mc_step=1, **caps)
    lw = jnp.array([1, 0, 0, 0, 0, 0, 0, 0], jnp.float32)
    h = dict(regularization_weight=1.0, knn_k=3, mc_step=1, solve_iters=2,
             gn_iters=3, cg_iters=12, tolerance=2.0, brick=8, n_candidates=16,
             tdist=float(canonical.max()), reuse_corr=False, **caps, **mode)
    args = (canonical, np.zeros((res,) * 3, np.float32), live, wf, lw)
    jv, jw, _, jlw, jst, _ = JF.fusion_frame(*map(jnp.asarray, args[:3]), wf,
                                             lw, **h)
    v, w, _, tlw, st, _ = TF.fusion_frame(*to_port(*args), **h)
    for f in STATS:
        assert int(getattr(st, f)) == int(getattr(jst, f)), f
    assert int(st.n_corr) > 0
    np.testing.assert_allclose(st.cost_after.numpy(),
                               np.asarray(jst.cost_after), rtol=COST_RTOL)
    np.testing.assert_allclose(tlw.numpy(), np.asarray(jlw), atol=POSE_ATOL)
    jv, jw = np.asarray(jv), np.asarray(jw)
    same = np.abs(w.numpy() - jw) <= 1e-3 * np.maximum(jw, 1.0)
    assert (~same).sum() <= MAX_FLIPS
    np.testing.assert_allclose(v.numpy()[same], jv[same], atol=VAL_ATOL)


def bench_modes(res: int) -> None:
    """The script mode (module docstring): the bench scene at res³ (the
    live frame at bump phase 0.05), one frame of each mode in both
    packages, kernels off; then knn_2level (kc 16 and k 3) on the
    frame-entry warped vertices against the flat search."""
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = torch.device("cpu")
    sc = bench_scene(res, cpu)
    live = torch.from_numpy(bumpy(res, (130, 129, 128), 0.05))
    hyper = dict(regularization_weight=0.5, knn_k=3, tdist=sc.tdist,
                 mc_step=2, solve_iters=1, gn_iters=12, cg_iters=16,
                 tolerance=5.0, reuse_corr=False, n_candidates=16,
                 vert_cap=sc.vert_cap, face_cap=sc.face_cap,
                 live_vert_cap=cap(1 << 17, res),
                 live_face_cap=cap(1 << 18, res, 4096))
    jwf = WarpField(**{f: jnp.asarray(getattr(sc.wf, f).numpy())
                       for f in WF_FIELDS})
    jargs = (jnp.asarray(sc.canonical.numpy()),
             jnp.zeros(sc.canonical.shape), jnp.asarray(live.numpy()), jwf,
             jnp.asarray(sc.lw.numpy()))
    for mode in (dict(), dict(reuse_corr=True), dict(approx_knn="2level"),
                 dict(approx_knn=True), dict(use_grid_corr=True)):
        h = dict(hyper, **mode)
        st = TF.fusion_frame(sc.canonical, torch.zeros_like(sc.canonical),
                             live, sc.wf, sc.lw, **h)[4]
        jst = JF.fusion_frame(*jargs, **h)[4]
        for name, x in (("port", st), ("jax", jst)):
            nc, ca = int(x.n_corr), float(np.asarray(x.cost_after)[-1])
            print(f"{res}^3 {mode or 'fresh'} {name}: n_corr {nc} corr_risk "
                  f"{int(x.corr_risk)} corr_refresh {int(x.corr_refresh)} "
                  f"cost {float(np.asarray(x.cost_before_h)[-1]):.4f} -> "
                  f"{ca:.4f} ({ca / max(nc, 1):.3g} per corr)", flush=True)
    ms = meshes(sc)
    q = warp_points(sc.wf, ms.mesh["verts"], ms.nbr_idx, m_lw=sc.lw)
    p, vm, lm = ms.live_mesh["verts"], ms.vmask, ms.lmask
    for k in (16, 3):
        d, _ = knn(q, p, k, valid=lm)
        d2, i2, risk = knn_2level(q, p, k, qvalid=vm, valid=lm)
        _, ji, jrisk = j_knn_2level(*(jnp.asarray(a.numpy())
                                      for a in (q, p)), k,
                                    qvalid=jnp.asarray(vm.numpy()),
                                    valid=jnp.asarray(lm.numpy()))
        off = (torch.abs(d2 - d).amax(1) > 1e-3) & vm
        same = np.all(np.asarray(ji) == i2.numpy(), 1)[vm.numpy()].mean()
        print(f"{res}^3 knn_2level k {k} over {int(vm.sum())} warped "
              f"vertices: risk port {int(risk)} jax {int(jrisk)}; indices "
              f"equal to JAX's on {same:.4f}; {int(off.sum())} queries off "
              f"the flat search's distances (by > 1e-3)", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=128)
    bench_modes(ap.parse_args().res)
