"""The traced window: ``torch.profiler`` over a bounded run of requests,
and what the per-layer readers take from it.

The window opens with a pre-roll of tiny kernels, synchronized, before the
marked range starts (a profiler window opened in a process that has run
for a while can drop its first device records), then the requests run
inside ``record_function(WINDOW)``. From the Chrome trace it keeps the
window's host calls into CUDA and the device activity (kernels, copies,
fills) they started:

* ``busy_s``: the union of the device intervals inside the window;
* ``launches``: the kernel-launch calls;
* ``kernels``: {name: [durations]} of the device kernels;
* ``device_ops``: the device names that took most time;
* ``idle_gaps``: the gaps between device intervals, summed by what the
  host was doing when each began (the innermost host event covering the
  gap's start).
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict

import torch

WINDOW = "h100bench_window"
PREROLL = 32
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
HOST_CATS = ("cpu_op", "user_annotation") + RUNTIME_CATS


def run_traced(fn, n_requests: int, seconds: float, path: str):
    """Run ``fn(i)`` for i = 0, 1, ... under the profiler until
    ``n_requests`` are done or ``seconds`` have passed; write the trace
    to ``path``. Returns the number of requests run."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(PREROLL):
            x.add_(1.0)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            while n < n_requests and time.perf_counter() - t0 < seconds:
                fn(n)
                n += 1
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    return n


def _union(intervals):
    total, end = 0.0, None
    out = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            out.append([a, b])
            end = b
        elif b > end:
            out[-1][1] = b
            end = b
    for a, b in out:
        total += b - a
    return total, out


def summarize(path: str, top: int = 10) -> dict:
    """What the readers take from the trace at ``path`` (module
    docstring); times in seconds."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    w0, w1 = next((e["ts"], e["ts"] + e["dur"]) for e in ev
                  if e["name"] == WINDOW)
    calls = [e for e in ev if e.get("cat") in RUNTIME_CATS
             and w0 <= e["ts"] <= w1]
    corr = {e.get("args", {}).get("correlation") for e in calls}
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS
           and e.get("args", {}).get("correlation") in corr]
    kernels = defaultdict(list)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
        if e["cat"] == "kernel":
            kernels[e["name"]].append(e["dur"] * 1e-6)
    busy, merged = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                           for e in dev if e["ts"] < w1])
    launches = sum(e["name"] in LAUNCH_CALLS for e in calls)
    ran = {e.get("args", {}).get("correlation") for e in dev
           if e["cat"] == "kernel"}
    lost = sum(e["name"] in LAUNCH_CALLS
               and e.get("args", {}).get("correlation") not in ran
               for e in calls)
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                  if e.get("cat") in HOST_CATS and e["name"] != WINDOW
                  and e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    gaps = []
    prev = w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle = defaultdict(float)
    starts = [h[0] for h in host]
    for a, b in gaps:
        label = "no host event"
        i = bisect.bisect_right(starts, a)
        for j in range(i - 1, max(i - 4000, -1), -1):
            if host[j][1] >= a:      # the latest-starting event covering a
                label = host[j][2]
                break
        idle[label] += (b - a) * 1e-6
    rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps_ranked = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "launches": launches, "lost_launches": lost,
            "kernels": dict(kernels),
            "device_ops": [[k, v] for k, v in rank],
            "idle_gaps": [[k, v] for k, v in gaps_ranked]}


def trace_path(root: str) -> str:
    base = os.environ.get("TMPDIR") or os.path.join(root, "h100bench",
                                                    "out")
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, "h100bench_trace.json")
