"""The control of a cell's ``correct``: the check with the reference,
computed in bfloat16 (the precision below the configurations' float32),
put in the place of the program's outputs, on several seeds at the cell's
own size. Every seed has to come out not correct; the compared numbers
it gives are the upper readings the limits are set below.

    python -m h100bench.control --workload <name> --seeds 1,2,3 \\
        --seconds 10 [--program]

``--program`` runs the same seeds without the control, in the same
process, for the lower readings. The cells of ``deferred.json`` are
taken too. One JSON line per run on standard
output: the seed, whether it was the control, ``correct`` and the
compared numbers.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--program", action="store_true",
                    help="also run each seed without the control")
    args = ap.parse_args(argv)
    from .run import run_cell, set_env

    set_env()
    import torch

    from . import manifest

    cell = manifest.cell(args.workload, manifest.load(deferred=True))
    if not torch.cuda.is_available():
        print("h100bench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in ((False, True) if args.program else (True,)):
            out = run_cell(cell, seed, args.seconds, False, dev,
                           t0=time.perf_counter(), control=control)
            print(json.dumps({"seed": seed, "control": control,
                              "correct": out["correct"],
                              "checks": {k: c["value"] for k, c in
                                         out["checks"].items()}}),
                  flush=True)
            bad += control and out["correct"]
            torch.cuda.empty_cache()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
