"""Runs one cell of the benchmark of ``dynamicfusion_body_tpu_torch`` once.

    python -m h100bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell's configuration, traffic and metrics are found by the names
in ``BENCHMARK.json`` (``manifest.py``). The run:

1. makes its inputs on the card from ``--seed``, builds the program's
   state through the configuration's driver (``drivers/<entry>.py``) and
   warms every shape up: all of that, from the start of the process, is
   ``setup_s``;
2. with ``--trace 0``, runs requests back to back, each synced, for
   ``--seconds`` (the last one started ends the window) and reports the
   cell's end-to-end metrics; with ``--trace 1``, runs a bounded number of
   requests under ``torch.profiler`` and reports its per-layer metrics,
   the device's busy time and a breakdown;
3. reads the peak device memory, frees the program's state but what the
   check needs, and holds a sample of the window's outputs, drawn from the
   seed, to the plain reference (``reference/``): each compared number
   goes to standard error beside its limit, and into the result line under
   ``checks``, its last key;
4. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device`` (and ``breakdown``).

It exits with 2 and prints no result when the card or the cards are
missing, and with 3 when a module of JAX or of the JAX package was loaded.
Build and kernel caches stay in fixed directories of the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / "cache"
# top-level module names the run may not hold (compared whole: the port's
# name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "dynamicfusion_body_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def set_env() -> None:
    """Before torch loads: kernel and build caches at fixed paths inside
    the checkout (the port builds its own library into its package's
    ``_build/``), and one CPU thread for the host's own operations (the
    card does the work; idle worker threads only contend with the thread
    that drives it)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def card_label() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, dev,
             t0: float = T_START, control: bool = False):
    """One run of ``cell`` on ``dev`` (module docstring). Returns the
    result line's dict. ``control`` puts the reference computed in
    bfloat16 in the program's place in the check."""
    import torch

    from . import manifest
    from . import trace as tr

    cuda = dev.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    mod = importlib.import_module(f"h100bench.drivers.{cfg['entry']}")
    drv = mod.Driver(cfg, traffic, seed, dev)
    drv.warm_up()
    if cuda:
        torch.cuda.synchronize(dev)
    ctx = SimpleNamespace(unit=mod.UNIT, setup_s=time.perf_counter() - t0,
                          trace=None, traced=0, bounds={}, n=0,
                          window_s=0.0, latencies=[])
    log(f"# {cell.name} seed {seed}: set-up {ctx.setup_s:.3f} s")
    if trace:
        path = tr.trace_path(str(ROOT))
        ctx.traced = tr.run_traced(drv.request, cfg["trace_requests"],
                                   seconds, path)
        ctx.n = ctx.traced
        t2 = time.perf_counter()
        ctx.trace = tr.summarize(path)
        log(f"# trace of {os.path.getsize(path) / 2 ** 20:.0f} MiB read in "
            f"{time.perf_counter() - t2:.1f} s")
        os.remove(path)
    else:
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < seconds:
            a = time.perf_counter()
            drv.request(ctx.n)
            ctx.latencies.append(time.perf_counter() - a)
            ctx.n += 1
        ctx.window_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    failed = drv.failed()
    if trace:
        for i in range(ctx.traced):
            for k, b in drv.kernel_bounds(i).items():
                ctx.bounds.setdefault(k, []).extend(b)
    keep = drv.sample()
    drv.release(set(keep))
    if cuda:
        torch.cuda.empty_cache()
    t3 = time.perf_counter()
    checks = {}
    for i in keep:
        for name, v in drv.check(i, control=control).items():
            checks[name] = max(checks.get(name, float("-inf")), v)
    log(f"# check of {len(keep)} requests: {time.perf_counter() - t3:.1f} s")
    limits = cfg["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in compared.values())
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = manifest.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": ctx.n, "failed": failed,
           "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=ctx.trace["busy_s"],
                      window_s=ctx.trace["window_s"])
        out["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                            "idle_gaps": ctx.trace["idle_gaps"]}
        log(f"# traced {ctx.traced} requests: launches "
            f"{ctx.trace['launches']} (without a device record "
            f"{ctx.trace['lost_launches']}), bounds ms "
            f"{ {k: sum(v) for k, v in ctx.bounds.items()} }")
    else:
        lat = sorted(x * 1e3 for x in ctx.latencies)
        log(f"# window {ctx.window_s:.3f} s, {ctx.n} requests; ms a request "
            f"min {lat[0]:.1f} median {lat[len(lat) // 2]:.1f} max "
            f"{lat[-1]:.1f}; first ten "
            + ", ".join(f"{x * 1e3:.1f}" for x in ctx.latencies[:10]))
    log(f"# card {card_label() if cuda else 'cpu'}; peak device memory "
        f"{peak} bytes; failed {failed}")
    log(f"# metrics {json.dumps(metrics)}")
    for k, c in compared.items():
        log(f"{k} {c['value']:.6g} limit {c['limit']:.6g}"
            f"{'' if c['value'] <= c['limit'] else ' FAIL'}")
    out["checks"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_env()
    import torch

    from . import manifest

    cell = manifest.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"h100bench: {args.workload} needs {cell.chips} CUDA device(s); "
            f"this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = banned_modules()
    if found:
        log(f"h100bench: the run loaded {found}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
