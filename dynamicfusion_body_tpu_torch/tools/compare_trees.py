"""Time K1, K5 and K6 of two checkouts of the repository in turns, on one
card.

Each turn is one process in the root of one checkout, which builds that
checkout's kernels and runs its own code:
- ``profile_mc --reps 20 --trace`` at 256³: the ``mc_case_cross`` row, the
  device time of one traced K1 launch (and the CUDA-event mean of 20);
- ``chip_smoke.config6_views`` and ``chip_smoke.phase_k5``: config 6's
  8 views of 512² rendered on the card, K5 held to its twin, and its
  kernel line, the CUDA-event mean of 10 launches into 256³;
- K6, ``trilerp_ablation(..., "full", 256)`` on the trilerp profiler's
  256³ inputs (``tools/_scene.py:trilerp_inputs``, 16.8 M samples): the
  CUDA-event mean of 10 launches (``chip_smoke.cuda_ms``).
The turns go A, B, B, A, so that a drift of the card's clock shows as a
difference between a checkout's two turns.

    python -m dynamicfusion_body_tpu_torch.tools.compare_trees A_DIR B_DIR

A directory is the root of a checkout (for example the parent commit
unpacked with ``git archive``); both need the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# what one turn runs, in the checkout's root: the checkout's chip_smoke
# and package, and one JSON line of results
TURN = r"""
import json, tempfile, torch
import chip_smoke as cs
from dynamicfusion_body_tpu_torch.ops.trilerp_cuda import trilerp_ablation
from dynamicfusion_body_tpu_torch.tools import profile_mc
from dynamicfusion_body_tpu_torch.tools._scene import trilerp_inputs
with tempfile.TemporaryDirectory() as tmp:
    row = profile_mc.main(["--reps", "20", "--trace", tmp])["mc_case_cross"]
dev = torch.device("cuda", 0)
_, _, depths, lws = cs.config6_views(torch, dev)
k5 = cs.phase_k5(torch, dev, depths, lws)
del depths
live, *coords = trilerp_inputs(256, dev)
k6 = cs.cuda_ms(torch, lambda: trilerp_ablation(live, *coords, "full", 256))
print("TURN " + json.dumps(dict(k1_device_ms=row.get("device_ms"),
                                k1_event_ms=row["event_ms"],
                                k5_ms=k5["ms"], k6_full_ms=k6)))
"""


def turn(root: Path) -> dict:
    """Run one turn in ``root``; its output goes to this process's, and its
    results come back as a dict."""
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=root,
                          capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    sys.stdout.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise SystemExit(f"compare_trees: the turn in {root} failed "
                         f"({proc.returncode})")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    return json.loads(line[-1][5:])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", type=Path, help="root of checkout A")
    ap.add_argument("b", type=Path, help="root of checkout B")
    args = ap.parse_args(argv)
    runs = {"A": [], "B": []}
    for name in "ABBA":
        root = args.a if name == "A" else args.b
        res = turn(root.resolve())
        runs[name].append(res)
        print(f"# turn {name} ({root}): {res}", flush=True)
    for key in ("k1_device_ms", "k1_event_ms", "k5_ms", "k6_full_ms"):
        print(f"# {key}: A {[r[key] for r in runs['A']]} "
              f"B {[r[key] for r in runs['B']]}")
    return runs


if __name__ == "__main__":
    main()
