"""Decompose config 7's tracking error knob by knob — the port of
``tools/diag_config7.py``.

Each arm runs the suite's config 7 (:func:`..benchmarks.suite.
run_config7`: ``meshes/original.obj`` bent over the given angles, the
non-rigid ``Fusion`` loop per frame) at ``--res`` with one knob
overridden, and prints one JSON line with the per-frame point-to-surface
errors in voxels:

  --tolerance     point-plane prune, in grid units
  --live-mc-step  live surface sampling stride (the suite's: 1 up to 64³,
                  2 above)
  --mc-step       canonical sampling stride (the suite's: 2 up to 64³, 3
                  above)
  --gn, --cg, --solve-iters   solver depth per relaxation round, rounds
  --reg           regularization weight
  --angles        per-frame bend angles (rad)
  --ell-cap       the solver's block-ELL degree cap (``solvers/nonrigid.py:
                  ELL_DEGREE_CAP``, 24) for this arm only: the JᵀWJ
                  couplings past the cap are dropped from the CG operator
                  (a port-only knob; each line reports the dropped count)

With no knob given an arm is the suite's config 7 at ``--res`` (the JAX
tool's defaults are its 256³ settings, the same as the suite's there).
``--sweep`` runs the JAX tool's presets one after another.

    python -m dynamicfusion_body_tpu_torch.tools.diag_config7 --tolerance 10
    python -m dynamicfusion_body_tpu_torch.tools.diag_config7 --res 64 --sweep
"""

from __future__ import annotations

import contextlib
import json
import re
import warnings

import numpy as np

from ..benchmarks import bench, suite
from ..pipeline.fusion import resolve_device
from ..solvers import nonrigid

SWEEP = (
    ("base", {}),
    ("tolerance10", dict(tolerance=10.0)),
    ("mcstep2", dict(mc_step=2)),
    ("reg.25", dict(reg=0.25)),
    ("iters6", dict(solve_iters=6)),
    ("halfstep_motion", dict(angles=(0.04, 0.08, 0.12, 0.16, 0.20, 0.24))),
    ("ell48", dict(ell_cap=48)),
)
_DROPPED = re.compile(r"solve: (\d+) JtWJ contributions exceeded")


@contextlib.contextmanager
def degree_cap(cap):
    """The solver's ELL degree cap set to ``cap`` inside the block (None:
    left as it is); yields a list that collects the number of JᵀWJ
    contributions each solve dropped past the cap."""
    old = nonrigid.ELL_DEGREE_CAP
    dropped = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cap is not None:
            nonrigid.ELL_DEGREE_CAP = int(cap)
        try:
            yield dropped
        finally:
            nonrigid.ELL_DEGREE_CAP = old
    for w in caught:
        m = _DROPPED.match(str(w.message))
        if m:
            dropped.append(int(m.group(1)))
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)


def run_arm(dev, res, verts, faces, label="arm", img=suite.IMG,
            ell_cap=None, **knobs):
    """One arm: config 7 at ``res`` with ``knobs`` (``run_config7``'s)
    and the ELL degree cap ``ell_cap`` (None: the solver's); prints and
    returns its JSON line."""
    with degree_cap(ell_cap) as dropped:
        c = suite.run_config7(dev, res, verts, faces, img=img, **knobs)
    vox = c["voxel"]
    out = {
        "metric": "diag_config7",
        "label": label,
        "res": res,
        **c["settings"],
        "ell_cap": ell_cap or nonrigid.ELL_DEGREE_CAP,
        "ell_dropped": dropped,
        "per_frame_voxels": [round(float(np.mean(x) / vox), 3)
                             for x in c["serr"]],
        "final_voxels": round(float(np.mean(c["serr"][-1]) / vox), 3),
        "final_p95_voxels": round(
            float(np.percentile(c["serr"][-1], 95) / vox), 3),
        "untracked_voxels": round(float(np.mean(c["untracked"]) / vox), 3),
        "total_s": round(c["frames_s"], 1),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> list:
    ap = bench.arg_parser(__doc__)
    ap.add_argument("--tolerance", type=float, default=5.0)
    ap.add_argument("--live-mc-step", type=int, default=None)
    ap.add_argument("--mc-step", type=int, default=None)
    ap.add_argument("--gn", type=int, default=8)
    ap.add_argument("--cg", type=int, default=32)
    ap.add_argument("--solve-iters", type=int, default=3)
    ap.add_argument("--reg", type=float, default=0.5)
    ap.add_argument("--angles", type=str, default="0.08,0.16,0.24")
    ap.add_argument("--ell-cap", type=int, default=None)
    ap.add_argument("--label", type=str, default="arm")
    ap.add_argument("--sweep", action="store_true",
                    help="run the preset one-knob-at-a-time sweep")
    a = bench.parse(ap, argv)
    dev = resolve_device(a.device)
    verts, faces = suite.reference_mesh()
    common = dict(dev=dev, res=a.res, verts=verts, faces=faces)
    if a.sweep:
        return [run_arm(label=label, **common, **knobs)
                for label, knobs in SWEEP]
    return [run_arm(
        label=a.label, tolerance=a.tolerance, live_mc_step=a.live_mc_step,
        mc_step=a.mc_step, gn_iters=a.gn, cg_iters=a.cg,
        solve_iters=a.solve_iters, reg=a.reg, ell_cap=a.ell_cap,
        angles=tuple(float(x) for x in a.angles.split(",")), **common)]


if __name__ == "__main__":
    main()
